"""The plain reference that decides ``correct``: a gzip reader written here
over Python's ``zlib`` inflater (RFC 1951), which shares no code with the
program and takes nothing it made.

:func:`read_stream` walks a gzip stream member by member: the header, the
``TD`` FEXTRA subfield that holds the member's size, the raw DEFLATE
payload (inflated by ``zlib`` until its final block ends), and the
trailer's CRC-32 and ISIZE. It counts every fault it meets and keeps
going where the stream lets it. :func:`block_fault` reads a member's
DEFLATE block headers (RFC 1951 3.2.3-3.2.7) to hold it to the member
profile: one final Huffman block with code lengths capped, or stored
blocks alone. :func:`compare_decode` and :func:`compare_encode` turn a
window's outputs into the numbers compared, each with its limit.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

FEXTRA, FNAME, FCOMMENT, FHCRC = 4, 8, 16, 2
FEED = 1 << 20  # bytes fed past a member's claimed end while its payload has not ended
CLEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
DEFLATE_MAX_BITS = 15
HEADER_BYTES = 320  # a dynamic block's header fits in (14 + 19 * 3 + 320 * 7) / 8 bytes


@dataclass
class Reading:
    """What the reference read from one stream."""

    out: bytes = b""
    members: int = 0
    isizes: list = field(default_factory=list)
    payloads: list = field(default_factory=list)  # each member's (payload start, payload end)
    bad_header: int = 0  # no gzip header where a member should start; the walk stops
    bad_td: int = 0  # TD subfield missing, or its size is not the member's length
    bad_payload: int = 0  # the inflater refused the payload, or it never ended; the walk stops
    bad_trailer: int = 0  # CRC-32 or ISIZE differs from the bytes inflated


def read_header(buf: memoryview, pos: int) -> tuple[int, int | None] | None:
    """(payload start, the TD subfield's size or None) of the member at
    ``pos``, or None where no gzip header is there."""
    n = len(buf)
    if n - pos < 10 or buf[pos] != 0x1F or buf[pos + 1] != 0x8B or buf[pos + 2] != 8:
        return None
    flg = buf[pos + 3]
    at = pos + 10
    td = None
    if flg & FEXTRA:
        if at + 2 > n:
            return None
        xlen = buf[at] | buf[at + 1] << 8
        end = at + 2 + xlen
        if end > n:
            return None
        sub = at + 2
        while sub + 4 <= end:
            slen = buf[sub + 2] | buf[sub + 3] << 8
            if bytes(buf[sub : sub + 2]) == b"TD" and slen == 4 and sub + 8 <= end:
                td = int.from_bytes(buf[sub + 4 : sub + 8], "little")
            sub += 4 + slen
        at = end
    for flag in (FNAME, FCOMMENT):
        if flg & flag:
            while at < n and buf[at] != 0:
                at += 1
            at += 1
    if flg & FHCRC:
        at += 2
    return (at, td) if at <= n else None


def td_spans(stream: bytes) -> list:
    """Each member's (start, end) by the TD sizes in its header, without
    inflating; the walk stops at a member without a usable TD size."""
    buf, pos, out = memoryview(stream), 0, []
    while pos < len(buf):
        head = read_header(buf, pos)
        if head is None or not head[1] or pos + head[1] > len(buf):
            break
        out.append((pos, pos + head[1]))
        pos += head[1]
    return out


def read_stream(stream: bytes) -> Reading:
    """Read every member of a gzip stream (see the module docstring)."""
    buf = memoryview(stream)
    r = Reading()
    parts = []
    pos = 0
    while pos < len(buf):
        head = read_header(buf, pos)
        if head is None:
            r.bad_header += 1
            break
        start, td = head
        inf = zlib.decompressobj(-15)
        # Feed up to the claimed end first; past it only while the payload goes on.
        claimed = pos + td - 8 if td is not None else 0
        end = min(claimed if claimed > start else start + FEED, len(buf))
        chunks = []
        fed = start
        try:
            while not inf.eof and fed < len(buf):
                chunks.append(inf.decompress(buf[fed:end]))
                fed, end = end, min(end + FEED, len(buf))
        except zlib.error:
            r.bad_payload += 1
            break
        if not inf.eof:
            r.bad_payload += 1
            break
        chunks.append(inf.flush())
        data = b"".join(chunks)
        tail = fed - len(inf.unused_data)  # the payload's end
        trailer = bytes(buf[tail : tail + 8])
        r.members += 1
        r.isizes.append(len(data))
        r.payloads.append((start, tail))
        if td is None or td != tail + 8 - pos:
            r.bad_td += 1
        if (len(trailer) < 8 or int.from_bytes(trailer[:4], "little") != zlib.crc32(data)
                or int.from_bytes(trailer[4:], "little") != len(data) & 0xFFFFFFFF):
            r.bad_trailer += 1
        parts.append(data)
        pos = tail + 8
    r.out = b"".join(parts)
    return r


class _Bits:
    """An LSB-first bit reader over the first bytes of a payload."""

    def __init__(self, data: bytes):
        self.v, self.n, self.at = int.from_bytes(data, "little"), len(data) * 8, 0

    def read(self, k: int) -> int:
        if self.at + k > self.n:
            raise EOFError
        x = (self.v >> self.at) & ((1 << k) - 1)
        self.at += k
        return x


def _code_lengths(bits: _Bits) -> list:
    """A dynamic block's literal/length and distance code lengths."""
    hlit, hdist, hclen = bits.read(5) + 257, bits.read(5) + 1, bits.read(4) + 4
    clen = [0] * 19
    for i in range(hclen):
        clen[CLEN_ORDER[i]] = bits.read(3)
    # The code-length code, canonical (RFC 1951 3.2.2): {(length, code): symbol}.
    codes, code = {}, 0
    for length in range(1, 8):
        for sym in range(19):
            if clen[sym] == length:
                codes[(length, code)] = sym
                code += 1
        code <<= 1
    lens: list = []
    while len(lens) < hlit + hdist:
        length = code = 0
        while (length, code) not in codes:
            if length == 7:
                raise ValueError("no code-length code matches")
            code = code << 1 | bits.read(1)  # Huffman codes are read MSB first
            length += 1
        sym = codes[(length, code)]
        if sym < 16:
            lens.append(sym)
        elif sym == 16:
            if not lens:
                raise ValueError("repeat with no previous length")
            lens += [lens[-1]] * (3 + bits.read(2))
        else:
            lens += [0] * ((3 + bits.read(3)) if sym == 17 else (11 + bits.read(7)))
    return lens[: hlit + hdist]


def block_fault(payload: bytes, max_code_len: int) -> int:
    """1 where a member's payload is neither one final Huffman block whose
    code lengths are at most ``max_code_len`` nor stored blocks alone, else 0."""
    try:
        first = payload[0]
        final, btype = first & 1, (first >> 1) & 3
        if btype == 0:  # stored blocks only, each byte-aligned, the last final
            at = 0
            while True:
                head = payload[at]
                if (head >> 1) & 3 != 0:
                    return 1
                size = int.from_bytes(payload[at + 1 : at + 3], "little")
                if size ^ int.from_bytes(payload[at + 3 : at + 5], "little") != 0xFFFF:
                    return 1
                at += 5 + size
                if head & 1:
                    return int(at != len(payload))
        if not final:
            return 1
        if btype == 1:
            return int(max_code_len < 9)
        if btype == 3:
            return 1
        bits = _Bits(payload[:HEADER_BYTES])
        bits.read(3)
        return int(max(_code_lengths(bits)) > max_code_len)
    except (IndexError, EOFError, ValueError):
        return 1


def differing_bytes(a: bytes, b: bytes) -> int:
    """Bytes at which ``a`` and ``b`` differ, the longer one's excess included."""
    if a == b:
        return 0
    m = min(len(a), len(b))
    x, y = np.frombuffer(a, np.uint8, m), np.frombuffer(b, np.uint8, m)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def compare_decode(stream: bytes, expected: bytes, outputs: list) -> dict:
    """Numbers compared for a decode window: the reference reads the input
    stream (it has to come back whole and sound, and equal to the data set
    it was made from), then each call's output is held to the reference's
    bytes. Returns {name: (value, limit)}."""
    ref = read_stream(stream)
    ref_faults = ref.bad_header + ref.bad_td + ref.bad_payload + ref.bad_trailer + int(ref.out != expected)
    wrong = [differing_bytes(o, ref.out) for o in outputs]
    return {
        "input_faults": (ref_faults, 0),
        "wrong_calls": (sum(w > 0 for w in wrong), 0),
        "wrong_bytes": (sum(wrong), 0),
    }


def compare_encode(data: bytes, outputs: list, layout: dict) -> dict:
    """Numbers compared for an encode window: each distinct output stream
    is read back by the reference and held to the input and to the
    configuration's layout: with ``member_bytes``, one member per so many
    input bytes, each one final block or stored blocks alone (``bad_blocks``:
    members that are not; code lengths are held to DEFLATE's 15 bits, the
    cap the program's encoder writes to: the layout's ``max_code_len`` is
    that of the benchmark's own writer of decode inputs); else one member.
    Identical outputs are read once. Returns {name: (value, limit)}."""
    seen: list = []  # (a distinct output stream, its faults)
    totals = {"wrong_calls": 0, "wrong_bytes": 0, "bad_td": 0, "bad_trailer": 0, "bad_layout": 0, "bad_blocks": 0}
    mb = layout.get("member_bytes")
    want = -(-len(data) // mb) if mb else 1
    for o in outputs:
        faults = next((f for s, f in seen if s == o), None)
        if faults is None:
            r = read_stream(o)
            faults = {
                "wrong_bytes": differing_bytes(r.out, data),
                "bad_td": r.bad_td,
                "bad_trailer": r.bad_trailer + r.bad_header + r.bad_payload,
                "bad_layout": int(r.members != want or (mb is not None and any(s != mb for s in r.isizes[:-1]))),
                "bad_blocks": 0 if mb is None else sum(block_fault(o[s:e], DEFLATE_MAX_BITS) for s, e in r.payloads),
            }
            seen.append((o, faults))
        for k, v in faults.items():
            totals[k] += v
        totals["wrong_calls"] += int(any(faults.values()))
    return {k: (v, 0) for k, v in totals.items()}
