"""gzip members written by Python's ``zlib`` deflater (the deflate stream
of gzip at the same ``level``), each wrapped in a gzip header whose
``TD`` FEXTRA subfield holds the member's size: one member per
``member_bytes`` of input, or one member for the whole input where the
layout has no ``member_bytes``. zlib's own blocks, 15-bit codes and
32 KiB window, as gzip writes them."""

from __future__ import annotations

import zlib

import numpy as np


def write(data: np.ndarray, layout: dict) -> bytes:
    from gen import core

    raw = memoryview(np.ascontiguousarray(data, np.uint8)).cast("B")
    step = int(layout.get("member_bytes") or max(len(raw), 1))
    out = []
    for at in range(0, len(raw), step):
        part = raw[at : at + step]
        z = zlib.compressobj(int(layout["level"]), zlib.DEFLATED, -15, int(layout.get("mem_level", 8)))
        payload = z.compress(part) + z.flush()
        out += [core.member_header(20 + len(payload) + 8), payload,
                zlib.crc32(part).to_bytes(4, "little"), (len(part) & 0xFFFFFFFF).to_bytes(4, "little")]
    return b"".join(out)
