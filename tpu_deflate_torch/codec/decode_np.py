"""Member index and batched host-side header parse (NumPy; a copy, trimmed,
of ``tpu_deflate.codec.decode_jax``, which is NumPy-only despite its name,
plus ``validate_code_lengths`` from ``tpu_deflate.kernels.huffman``).

- ``split_members``: walk the 'TD' FEXTRA member index -> MemberIndex.
- ``parse_headers_batch``: lock-step parse of one fixed/dynamic block
  header per lane with the reference's Reasons and their order.
- ``build_luts_batch``: batched canonical decode LUTs (the header parse
  decodes the code-length code with them).
- ``_decode_stored_member``: host copy-out of stored-block members.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native
from ..format.errors import DataFormatError, Reason
from ..format.tables import CLEN_ORDER, FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS, MAX_CODE_LEN

TD_SUBFIELD = b"TD"


# ---------------------------------------------------------------------------
# Member splitting
# ---------------------------------------------------------------------------


@dataclass
class MemberIndex:
    """Offsets of one gzip member within a stream."""

    start: int  # offset of the gzip header
    payload_start: int  # offset of the DEFLATE payload
    end: int  # offset one past the trailer
    isize: int  # uncompressed size (trailer, mod 2^32)
    crc32: int  # expected CRC (trailer)


def split_members(gz: np.ndarray) -> list[MemberIndex] | None:
    """Walk a multi-member stream via the TD FEXTRA subfields; None if any
    member lacks the subfield (the caller falls back to a serial decode)."""
    members = []
    pos = 0
    n = gz.size
    buf = gz
    while pos < n:
        if pos + 10 > n or buf[pos] != 0x1F or buf[pos + 1] != 0x8B:
            return None
        flags = int(buf[pos + 3])
        if not flags & 0x04:  # no FEXTRA
            return None
        p = pos + 10
        if p + 2 > n:
            return None
        xlen = int(buf[p]) | int(buf[p + 1]) << 8
        extra = buf[p + 2 : p + 2 + xlen]
        p += 2 + xlen
        member_len = None
        q = 0
        while q + 4 <= xlen:
            sid = bytes(extra[q : q + 2])
            slen = int(extra[q + 2]) | int(extra[q + 3]) << 8
            if sid == TD_SUBFIELD and slen == 4:
                member_len = int.from_bytes(bytes(extra[q + 4 : q + 8]), "little")
            q += 4 + slen
        if member_len is None:
            return None
        if flags & 0x08:  # FNAME
            while p < n and buf[p] != 0:
                p += 1
            p += 1
        if flags & 0x10:  # FCOMMENT
            while p < n and buf[p] != 0:
                p += 1
            p += 1
        if flags & 0x02:  # FHCRC
            p += 2
        end = pos + member_len
        if end > n or end - 8 < p:
            return None
        isize = int.from_bytes(bytes(buf[end - 4 : end]), "little")
        crc = int.from_bytes(bytes(buf[end - 8 : end - 4]), "little")
        members.append(MemberIndex(pos, p, end, isize, crc))
        pos = end
    return members


# ---------------------------------------------------------------------------
# Code-length validation (tpu_deflate.kernels.huffman.validate_code_lengths)
# ---------------------------------------------------------------------------


def validate_code_lengths(lengths: np.ndarray) -> None:
    """Raise HUFFMAN_CODE_UNDER_FULL / OVER_FULL unless the lengths form a
    complete canonical code, with the reference's precedence."""
    lengths = np.asarray(lengths)
    used = lengths[lengths > 0]
    n = used.size
    under = DataFormatError(
        Reason.HUFFMAN_CODE_UNDER_FULL,
        "This canonical code produces an under-full Huffman code tree",
    )
    if n < 2:
        raise under
    counts = np.bincount(used, minlength=MAX_CODE_LEN + 1)
    max_present = int(used.max())
    open_slots = 2  # the root's two children
    internals = 1  # the root
    remaining = n
    for level in range(1, max_present + 1):
        c = int(counts[level])
        if c > open_slots:
            raise DataFormatError(
                Reason.HUFFMAN_CODE_OVER_FULL,
                "This canonical code produces an over-full Huffman code tree",
            )
        open_slots -= c
        remaining -= c
        if remaining == 0:
            break
        internals += open_slots
        if internals > n - 1:
            raise under
        open_slots *= 2
    if open_slots > 0:
        raise under


# ---------------------------------------------------------------------------
# Batched header parse (host, NumPy lock-step)
# ---------------------------------------------------------------------------


def _u32_view(payload: np.ndarray) -> np.ndarray:
    """(L, P) uint8 -> (L, P) uint32 little-endian 4-byte windows."""
    L, P = payload.shape
    ext = np.concatenate([payload, np.zeros((L, 4), dtype=np.uint8)], axis=1).astype(
        np.uint32
    )
    return ext[:, :P] | (ext[:, 1 : P + 1] << 8) | (ext[:, 2 : P + 2] << 16) | (
        ext[:, 3 : P + 3] << 24
    )


def _peek(u32v: np.ndarray, bitpos: np.ndarray) -> np.ndarray:
    """>=25 valid bits at each lane's bit position."""
    lanes = np.arange(u32v.shape[0])
    byte = np.minimum(bitpos >> 3, u32v.shape[1] - 1)
    return u32v[lanes, byte] >> (bitpos & 7).astype(np.uint32)


@dataclass
class HeaderParse:
    litlen_lengths: np.ndarray  # (L, 288)
    dist_lengths: np.ndarray  # (L, 32) padded, with reference dist semantics
    dist_empty: np.ndarray  # (L,) bool: empty distance code
    body_bitpos: np.ndarray  # (L,) first bit of block body
    btype: np.ndarray  # (L,) 1=fixed, 2=dynamic (0=stored handled earlier)
    bfinal: np.ndarray  # (L,) bool


def parse_headers_batch(
    payload: np.ndarray, payload_bits: np.ndarray, start_bits: np.ndarray | None = None
) -> HeaderParse:
    """Parse one fixed/dynamic block header per lane, vectorized.

    ``start_bits`` (per lane, in [0, 8)) locates the 3-bit block header
    inside byte 0. Raises DataFormatError (first failing lane wins, in lane
    order) with the reference's taxonomy.
    """
    L = payload.shape[0]
    u32v = _u32_view(payload)
    if start_bits is None:
        bitpos = np.zeros(L, dtype=np.int64)
    else:
        bitpos = np.asarray(start_bits, dtype=np.int64).copy()

    w = _peek(u32v, bitpos)
    bfinal = (w & 1).astype(bool)
    btype = ((w >> 1) & 3).astype(np.int32)
    bitpos += 3
    if (btype == 3).any():
        lane = int(np.nonzero(btype == 3)[0][0])
        raise DataFormatError(Reason.RESERVED_BLOCK_TYPE, f"Reserved block type (member {lane})")
    dyn = btype == 2

    litlen = np.tile(FIXED_LITLEN_LENGTHS, (L, 1)).astype(np.int32)
    dist = np.tile(FIXED_DIST_LENGTHS, (L, 1)).astype(np.int32)
    dist_empty = np.zeros(L, dtype=bool)

    if dyn.any():
        d_idx = np.nonzero(dyn)[0]
        dl = _parse_dynamic_headers(u32v[d_idx], bitpos[d_idx], payload_bits[d_idx])
        litlen[d_idx] = dl["litlen"]
        dist[d_idx] = dl["dist"]
        dist_empty[d_idx] = dl["dist_empty"]
        bitpos[d_idx] = dl["bitpos"]
    return HeaderParse(litlen, dist, dist_empty, bitpos, btype, bfinal)


def _parse_dynamic_headers(u32v, bitpos, payload_bits):
    """Vectorized dynamic header parse for the selected lanes."""
    L = u32v.shape[0]
    w = _peek(u32v, bitpos)
    hlit = (w & 31).astype(np.int64) + 257
    hdist = ((w >> 5) & 31).astype(np.int64) + 1
    hclen = ((w >> 10) & 15).astype(np.int64) + 4
    bitpos = bitpos + 14

    # Code-length-code lengths: up to 19 3-bit fields in CLEN_ORDER.
    clen_lengths = np.zeros((L, 19), dtype=np.int64)
    for i in range(19):
        active = i < hclen
        w = _peek(u32v, bitpos)
        val = (w & 7).astype(np.int64)
        clen_lengths[active, CLEN_ORDER[i]] = val[active]
        bitpos = bitpos + np.where(active, 3, 0)

    for l in range(L):
        validate_code_lengths(clen_lengths[l])
    clen_lut = build_luts_batch(clen_lengths, lut_bits=7)
    clen_lut_sym = (clen_lut & 511).astype(np.int64)
    clen_lut_len = (clen_lut >> 9).astype(np.int64)

    # Lock-step decode of the code-length symbol stream: one symbol per
    # active lane per step, recorded as (value, count) and expanded after.
    total = hlit + hdist
    max_steps = int(total.max()) if L else 0
    vals = np.zeros((L, max_steps), dtype=np.int64)
    counts = np.zeros((L, max_steps), dtype=np.int64)
    produced = np.zeros(L, dtype=np.int64)
    prev_val = np.full(L, -1, dtype=np.int64)
    lanes = np.arange(L)
    step = 0
    while True:
        active = produced < total
        if not active.any() or step >= max_steps:
            break
        w = _peek(u32v, bitpos)
        sym = clen_lut_sym[lanes, w & 127]
        ln = clen_lut_len[lanes, w & 127]
        consumed = ln.copy()
        if (active & (bitpos + consumed > payload_bits)).any():
            raise DataFormatError.unexpected_end()
        is_lit = sym < 16
        is_16, is_17, is_18 = sym == 16, sym == 17, sym == 18
        w2 = w >> ln
        run = np.where(is_16, 3 + (w2 & 3), 0)
        run = np.where(is_17, 3 + (w2 & 7), run)
        run = np.where(is_18, 11 + (w2 & 127), run)
        consumed = consumed + np.where(is_16, 2, 0) + np.where(is_17, 3, 0) + np.where(is_18, 7, 0)
        # Symbol 16 checks for a previous length before reading its extra
        # bits, so NO_PREVIOUS precedes the extra-bits end check.
        if (active & is_16 & (prev_val < 0)).any():
            raise DataFormatError(
                Reason.NO_PREVIOUS_CODE_LENGTH_TO_COPY, "No code length value to copy"
            )
        if (active & (bitpos + consumed > payload_bits)).any():
            raise DataFormatError.unexpected_end()
        val = np.where(is_lit, sym, np.where(is_16, prev_val, 0))
        cnt = np.where(is_lit, 1, run)
        if (active & (produced + cnt > total)).any():
            raise DataFormatError(Reason.CODE_LENGTH_CODE_OVER_FULL, "Run exceeds number of codes")
        vals[active, step] = val[active]
        counts[active, step] = cnt[active]
        produced = produced + np.where(active, cnt, 0)
        prev_val = np.where(active & (is_lit | is_17 | is_18), np.where(is_lit, sym, 0), prev_val)
        bitpos = bitpos + np.where(active, consumed, 0)
        step += 1

    expanded = np.repeat(vals.ravel(), counts.ravel())
    lane_totals = counts.sum(axis=1)
    assert (lane_totals == total).all()
    starts = np.concatenate([[0], np.cumsum(lane_totals)[:-1]])

    litlen = np.zeros((L, 288), dtype=np.int32)
    dist = np.zeros((L, 32), dtype=np.int32)
    dist_empty = np.zeros(L, dtype=bool)
    for l in range(L):
        code_lens = expanded[starts[l] : starts[l] + lane_totals[l]]
        ll = code_lens[: hlit[l]]
        dd = code_lens[hlit[l] :]
        if ll[256] == 0:
            raise DataFormatError(
                Reason.END_OF_BLOCK_CODE_ZERO_LENGTH, "End-of-block symbol has zero code length"
            )
        full_ll = np.zeros(288, dtype=np.int64)
        full_ll[: ll.size] = ll
        validate_code_lengths(full_ll)
        litlen[l] = full_ll
        if dd.size == 1 and dd[0] == 0:
            dist_empty[l] = True
            continue
        one = int((dd == 1).sum())
        other = int((dd > 1).sum())
        full_dd = np.zeros(32, dtype=np.int64)
        full_dd[: dd.size] = dd
        if one == 1 and other == 0:
            full_dd[31] = 1  # the reference's dummy completion of a 1-code tree
        validate_code_lengths(full_dd)
        dist[l] = full_dd
    return {"litlen": litlen, "dist": dist, "dist_empty": dist_empty, "bitpos": bitpos}


def build_luts_batch(lengths: np.ndarray, lut_bits: int) -> np.ndarray:
    """(L, N) code lengths -> (L, 2^lut_bits) int32 packed (len<<9 | sym);
    every lane's longest code must be at most lut_bits."""
    L, N = lengths.shape
    assert lengths.max(initial=0) <= lut_bits
    counts = np.zeros((L, lut_bits + 2), dtype=np.int64)
    for l in range(1, lut_bits + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    next_code = np.zeros((L, lut_bits + 2), dtype=np.int64)
    code = np.zeros(L, dtype=np.int64)
    for l in range(1, lut_bits + 1):
        code = (code + counts[:, l - 1]) << 1
        next_code[:, l] = code
    # rank within (lane, length) class by symbol order
    order = np.argsort(lengths, axis=1, kind="stable")
    sorted_lens = np.take_along_axis(lengths, order, axis=1)
    group_first = np.zeros((L, lut_bits + 2), dtype=np.int64)
    for l in range(lut_bits + 2):
        group_first[:, l] = np.argmax(sorted_lens >= l, axis=1)
    pos_in_sorted = np.empty((L, N), dtype=np.int64)
    np.put_along_axis(pos_in_sorted, order, np.arange(N)[None, :].repeat(L, 0), axis=1)
    ranks = pos_in_sorted - np.take_along_axis(group_first, lengths.astype(np.int64), axis=1)
    codes = np.take_along_axis(next_code, lengths.astype(np.int64), axis=1) + ranks
    # bit-reverse codes within their length
    rev = np.zeros((L, N), dtype=np.int64)
    c = codes.copy()
    for _ in range(lut_bits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    rev = rev >> (lut_bits - np.maximum(lengths, 1))

    lut = np.zeros((L, 1 << lut_bits), dtype=np.int32)
    lane_idx, sym_idx = np.nonzero(lengths > 0)
    lens_nz = lengths[lane_idx, sym_idx]
    revs_nz = rev[lane_idx, sym_idx]
    for l in range(1, lut_bits + 1):
        sel = lens_nz == l
        if not sel.any():
            continue
        reps = 1 << (lut_bits - l)
        entry = (l << 9) | sym_idx[sel]
        idx = revs_nz[sel][:, None] + (np.arange(reps)[None, :] << l)
        lut[lane_idx[sel][:, None], idx] = entry[:, None].astype(np.int32)
    return lut


# ---------------------------------------------------------------------------
# Stored members (host copy-out)
# ---------------------------------------------------------------------------


def _decode_stored_member(buf: np.ndarray, m: MemberIndex, *, verify_crc: bool) -> np.ndarray:
    """Copy out a member whose blocks are all stored; a member that mixes
    in a Huffman block decodes through the C core instead."""
    pos = m.payload_start
    out = []
    while True:
        hdr = int(buf[pos])
        bfinal, btype = hdr & 1, (hdr >> 1) & 3
        if btype != 0:
            member = native.gzip_decompress_serial(buf[m.start : m.end].tobytes())
            return np.frombuffer(member, np.uint8)
        pos += 1  # stored block header consumes 3 bits; align skips the rest
        ln = int(buf[pos]) | int(buf[pos + 1]) << 8
        nlen = int(buf[pos + 2]) | int(buf[pos + 3]) << 8
        if ln != (nlen ^ 0xFFFF):
            raise DataFormatError(
                Reason.UNCOMPRESSED_BLOCK_LENGTH_MISMATCH, "len/nlen mismatch in uncompressed block"
            )
        pos += 4
        out.append(buf[pos : pos + ln])
        pos += ln
        if bfinal:
            break
    result = np.concatenate(out) if out else np.zeros(0, np.uint8)
    if result.size != m.isize:
        raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "Decompressed size mismatch")
    if verify_crc and native.crc32(result.tobytes()) != m.crc32:
        raise DataFormatError(
            Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
        )
    return result
