"""Share of the bandwidth roofline that all kernels of the profiled encode
calls reach together: the bytes the calls must move at least (compressed
bytes read once and uncompressed bytes written once, every member counted
whatever route takes it, from the data, not from the kernels' shapes) over
the card's published HBM bandwidth, divided by the summed device time of
every kernel. Null without a kernel event or without the card's peak."""

LAYER = "Kernels"
UNIT = "%"
MOVES = "encode_MBps"


def read(t):
    us = t.all_kernels_us()
    if us is None or not t.peak_bw:
        return None
    return 100.0 * (t.device_bytes_moved / t.peak_bw) / (us / 1e6)
