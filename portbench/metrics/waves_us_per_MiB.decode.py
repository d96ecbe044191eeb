"""Device time of the decode waves' kernels (K1 stage A with its table
kernel, K2 stage B, stage C, K3 stage DC, K4 compaction in either mode)
per MiB decompressed."""

LAYER = "Decode waves"
UNIT = "us/MiB"
MOVES = "decode_GBps"
KERNELS = ("stage_a_tables_kernel", "stage_a_kernel", "stage_b_kernel", "stage_c_kernel", "stage_dc_kernel",
           "compact_kernel", "compact_pull_kernel")


def read(t):
    us = t.kernel_us(KERNELS)
    return None if us is None or t.device_mib <= 0 else us / t.device_mib
