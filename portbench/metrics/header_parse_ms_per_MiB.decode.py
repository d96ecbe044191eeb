"""Host time of the decode's header parse and wave prep (cProfile's
cumulative time, a nested call counted once) per MiB decompressed."""

LAYER = "Decode host prep"
UNIT = "ms/MiB"
MOVES = "decode_GBps"
FUNCTIONS = (("codec/decode_np.py", "parse_headers_batch"), ("codec/wave_prep.py", "_k1_groups"),
             ("codec/wave_prep.py", "_wave_arrays"))


def read(t):
    s = t.host_s(FUNCTIONS)
    return None if s is None or t.host_mib <= 0 else 1e3 * s / t.host_mib
