"""RFC 1951 constant tables, built programmatically as NumPy arrays (a copy
of ``tpu_deflate.format.tables``).

The host codec (the serial inflater, the strategy encoder), the device
decode's host prep and the device encoder's planning all index into these
arrays: the length and distance symbol tables and their inverses, the
fixed Huffman code lengths and the code-length-code order.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Length (a.k.a. "run") symbols: 257..285 -> base length and extra bit count.
# Symbols 286, 287 are reserved (their use is a data-format error).
# ---------------------------------------------------------------------------

MIN_RUN = 3
MAX_RUN = 258
MIN_DIST = 1
MAX_DIST = 32 * 1024
WINDOW_SIZE = 32 * 1024

NUM_LITLEN_SYMS = 288  # 0..255 literals, 256 EOB, 257..285 lengths, 286/287 reserved
NUM_DIST_SYMS = 32  # 0..29 valid, 30/31 reserved
NUM_CLEN_SYMS = 19

EOB_SYMBOL = 256

MAX_CODE_LEN = 15  # litlen / dist codes
MAX_CLEN_CODE_LEN = 7  # code-length code

# Order in which code-length-code lengths are transmitted (RFC 1951 §3.2.7).
CLEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15], dtype=np.int32
)


def _build_length_tables():
    base = np.zeros(29, dtype=np.int32)
    extra = np.zeros(29, dtype=np.int32)
    for i in range(29):
        sym = i + 257
        if sym <= 264:
            e, b = 0, sym - 254
        elif sym <= 284:
            e = (sym - 261) // 4
            b = (((sym - 1) % 4 + 4) << e) + 3
        else:  # 285
            e, b = 0, 258
        base[i], extra[i] = b, e
    return base, extra


def _build_distance_tables():
    base = np.zeros(30, dtype=np.int32)
    extra = np.zeros(30, dtype=np.int32)
    for sym in range(30):
        if sym <= 3:
            e, b = 0, sym + 1
        else:
            e = sym // 2 - 1
            b = ((sym % 2 + 2) << e) + 1
        base[sym], extra[sym] = b, e
    return base, extra


#: LENGTH_BASE[sym-257] = smallest run length encoded by length symbol `sym`
LENGTH_BASE, LENGTH_EXTRA = _build_length_tables()
#: DIST_BASE[sym] = smallest distance encoded by distance symbol `sym`
DIST_BASE, DIST_EXTRA = _build_distance_tables()


def _inverse_length_table():
    """run length (3..258) -> (symbol, extra-bits value)."""
    sym = np.zeros(MAX_RUN + 1, dtype=np.int32)
    ebits = np.zeros(MAX_RUN + 1, dtype=np.int32)
    extra_val = np.zeros(MAX_RUN + 1, dtype=np.int32)
    for i in range(29):
        lo = LENGTH_BASE[i]
        hi = MAX_RUN if i == 28 else LENGTH_BASE[i + 1] - 1
        # Symbol 284 covers 227..257 even though base(285)=258; symbol 285 is
        # exactly 258 and takes precedence.
        for run in range(lo, hi + 1):
            sym[run] = i + 257
            ebits[run] = LENGTH_EXTRA[i]
            extra_val[run] = run - lo
    sym[MAX_RUN] = 285
    ebits[MAX_RUN] = 0
    extra_val[MAX_RUN] = 0
    return sym, ebits, extra_val


def _inverse_distance_table():
    """distance (1..32768) -> (symbol, extra-bits count, extra-bits value).

    Returned as arrays indexed by distance; 32769 entries (index 0 unused).
    """
    sym = np.zeros(MAX_DIST + 1, dtype=np.int32)
    ebits = np.zeros(MAX_DIST + 1, dtype=np.int32)
    extra_val = np.zeros(MAX_DIST + 1, dtype=np.int32)
    for i in range(30):
        lo = DIST_BASE[i]
        hi = MAX_DIST if i == 29 else DIST_BASE[i + 1] - 1
        sym[lo : hi + 1] = i
        ebits[lo : hi + 1] = DIST_EXTRA[i]
        extra_val[lo : hi + 1] = np.arange(lo, hi + 1) - lo
    return sym, ebits, extra_val


LENGTH_TO_SYMBOL, LENGTH_TO_EXTRA_BITS, LENGTH_TO_EXTRA_VAL = _inverse_length_table()
DIST_TO_SYMBOL, DIST_TO_EXTRA_BITS, DIST_TO_EXTRA_VAL = _inverse_distance_table()


# ---------------------------------------------------------------------------
# Fixed (static) Huffman code lengths (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------

FIXED_LITLEN_LENGTHS = np.concatenate(
    [
        np.full(144, 8, dtype=np.int32),  # 0..143
        np.full(112, 9, dtype=np.int32),  # 144..255
        np.full(24, 7, dtype=np.int32),  # 256..279
        np.full(8, 8, dtype=np.int32),  # 280..287
    ]
)
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)
