"""Host time of the encoder's code planning (cProfile's cumulative time of
encode._plan_codes) per MiB of input."""

LAYER = "Host planning"
UNIT = "ms/MiB"
MOVES = "encode_MBps"
FUNCTIONS = (("codec/encode.py", "_plan_codes"),)


def read(t):
    s = t.host_s(FUNCTIONS)
    return None if s is None or t.host_mib <= 0 else 1e3 * s / t.host_mib
