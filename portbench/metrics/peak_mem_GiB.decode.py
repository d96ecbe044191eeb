"""Peak of the device memory PyTorch's allocator held over the traced
window (torch.cuda.max_memory_allocated after reset_peak_memory_stats),
in GiB."""

LAYER = "Device"
UNIT = "GiB"
MOVES = "decode_GBps"


def read(t):
    return None if t.peak_bytes is None else t.peak_bytes / 2**30
