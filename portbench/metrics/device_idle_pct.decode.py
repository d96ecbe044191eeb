"""Share of the traced window in which no operation ran on the device
(kernels, copies and fills, their union), over the decode calls profiled."""

LAYER = "Device"
UNIT = "%"
MOVES = "decode_GBps"


def read(t):
    if not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
