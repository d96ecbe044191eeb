"""RFC 1951 constant tables the port's host prep uses (a copy, trimmed, of
``tpu_deflate.format.tables``): the code-length-code order, the fixed
Huffman code lengths and the length-symbol base/extra-bits table."""

from __future__ import annotations

import numpy as np

MAX_CODE_LEN = 15  # litlen / dist codes

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


#: LENGTH_BASE[sym-257] = smallest run length encoded by length symbol `sym`
LENGTH_BASE, LENGTH_EXTRA = _build_length_tables()

# Fixed (static) Huffman code lengths (RFC 1951 §3.2.6).
FIXED_LITLEN_LENGTHS = np.concatenate(
    [
        np.full(144, 8, dtype=np.int32),  # 0..143
        np.full(112, 9, dtype=np.int32),  # 144..255
        np.full(24, 7, dtype=np.int32),  # 256..279
        np.full(8, 8, dtype=np.int32),  # 280..287
    ]
)
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)
