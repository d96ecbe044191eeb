"""The TD member profile, written by the benchmark's frozen encoder
(``gen/deflate_core.c``): one gzip member per ``member_bytes`` of input,
each one final block with code lengths of at most ``max_code_len`` (or
stored blocks where that is smaller), matches found on hash chains of
``max_chain``, the member's size in the ``TD`` FEXTRA subfield."""

from __future__ import annotations

import numpy as np


def write(data: np.ndarray, layout: dict) -> bytes:
    from gen import core

    return core.members(data, member_bytes=int(layout["member_bytes"]), max_code_len=int(layout["max_code_len"]),
                        max_chain=int(layout["max_chain"]))
