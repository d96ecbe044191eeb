"""Device time of the match finder's four kernels per MiB of input."""

LAYER = "Match finder"
UNIT = "us/MiB"
MOVES = "encode_MBps"
KERNELS = ("match_keys_kernel", "match_chain_kernel", "match_bucket_kernel", "match_select_kernel")


def read(t):
    us = t.kernel_us(KERNELS)
    return None if us is None or t.device_mib <= 0 else us / t.device_mib
