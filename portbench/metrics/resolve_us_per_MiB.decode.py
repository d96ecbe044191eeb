"""Device time of the resolve's kernels (K5 expand, K6 sweep, the tile
split, the lane CRC-32) per MiB decompressed."""

LAYER = "Resolve"
UNIT = "us/MiB"
MOVES = "decode_GBps"
KERNELS = ("expand_kernel", "sweep_kernel", "split_kernel", "crc32_lanes_kernel")


def read(t):
    us = t.kernel_us(KERNELS)
    return None if us is None or t.device_mib <= 0 else us / t.device_mib
