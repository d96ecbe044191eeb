"""The TD stream profile's host encoder (a copy of
``tpu_deflate.codec.profile``): standard gzip, shaped for data-parallel
decode.

A profile stream is a fully RFC 1952-compliant multi-member gzip file
(readable by any gzip tool) with extra structure that makes it
O(members)-splittable and lane-decodable:

- the input is cut into fixed 64 KiB chunks, one gzip member each;
- each member's header carries a bgzf-style FEXTRA subfield ``'TD'`` whose
  payload is the u32 total compressed size of that member, so member
  boundaries are found without decoding;
- each member's payload is a single final DEFLATE block (dynamic, fixed,
  or stored) whose Huffman code lengths are <= 12 bits.

``profile_compress_host`` is the host encoder of that profile; the
device encoder (``codec/encode.py``) and the C core write the same framing
(``member_header``, ``build_member``).
"""

from __future__ import annotations

import numpy as np

from ..kernels.bitio import BitWriter
from ..kernels.checksum import crc32
from .deflate_encode import HuffmanPlan, StoredPlan, _tokenize

MEMBER_DATA = 64 * 1024
TD_SUBFIELD = b"TD"

# Base header: magic, CM=8, FLG=FEXTRA, mtime=0, XFL=0, OS=255,
# XLEN=8, subfield 'TD' len 4, u32 member size placeholder.
_HEADER_LEN = 10 + 2 + 8
_TRAILER_LEN = 8


def member_header(member_total_size: int) -> bytes:
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + (8).to_bytes(2, "little")
        + TD_SUBFIELD
        + (4).to_bytes(2, "little")
        + member_total_size.to_bytes(4, "little")
    )


def build_member(payload: bytes, isize: int, crc: int) -> bytes:
    total = _HEADER_LEN + len(payload) + _TRAILER_LEN
    return (
        member_header(total)
        + payload
        + crc.to_bytes(4, "little")
        + (isize & 0xFFFFFFFF).to_bytes(4, "little")
    )


def profile_compress_host(
    data: bytes,
    *,
    member_data: int = MEMBER_DATA,
    max_code_len: int = 12,
    lazy: bool = True,
    max_candidates: int = 16,
) -> bytes:
    """Host implementation of the profile encoder."""
    out = bytearray()
    n = len(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    if n == 0:
        return bytes(_empty_member())
    for start in range(0, n, member_data):
        chunk = buf[start : start + member_data]
        out += _encode_member(chunk, max_code_len, lazy, max_candidates)
    return bytes(out)


def _empty_member() -> bytes:
    # A single stored empty final block.
    w = BitWriter()
    StoredPlan(np.zeros(0, np.uint8)).emit(w, True)
    w.align_to_byte()
    return build_member(w.getvalue(), 0, crc32(b""))


def _encode_member(chunk: np.ndarray, max_code_len: int, lazy: bool, k: int) -> bytes:
    tokens = _tokenize(
        chunk,
        0,
        min_run=3,
        max_run=258,
        min_dist=1,
        max_dist=32 * 1024,
        lazy=lazy,
        max_candidates=k,
    )
    plan = HuffmanPlan(tokens, dynamic=True, max_code_len=max_code_len)
    stored_cost = chunk.size * 8 + ((chunk.size // 65535) + 1) * 40
    w = BitWriter()
    if int(plan.bit_lengths[0]) >= stored_cost:
        StoredPlan(chunk).emit(w, True)
    else:
        plan.emit(w, True)
    w.align_to_byte()
    return build_member(w.getvalue(), chunk.size, crc32(chunk))
