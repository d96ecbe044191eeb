"""Share of the traced window in which no operation ran on the device
(kernels, copies and fills, their union), over the encode calls profiled."""

LAYER = "Device"
UNIT = "%"
MOVES = "encode_MBps"


def read(t):
    if not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
