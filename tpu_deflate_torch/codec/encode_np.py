"""Host planning and framing of the device encoder, in NumPy (copies,
trimmed, of ``tpu_deflate.codec.encode_jax``'s host helpers; the
code-length RLE comes from ``codec/deflate_encode.py`` and the member
framing from ``codec/profile.py``).

- ``fix_histograms``: the EOB count and the reference's degenerate-
  histogram fixes, before the lengths are planned;
- ``pack_codes``: batched canonical codes packed as ``len << 16 | revcode``;
- ``build_headers``: per-lane dynamic block header slots;
- ``member_header``, ``build_member``, ``TD_SUBFIELD``: the profile's
  TD-indexed gzip member (``codec/profile.py``'s, imported here);
- ``stored_payload``: stored framing of one member's bytes.
"""

from __future__ import annotations

import numpy as np

from ..format.tables import CLEN_ORDER
from ..kernels.huffman import huffman_lengths_batch
from .deflate_encode import _CLEN_EXTRA_BITS, MAX_STORED_BLOCK, _clen_rle
from .profile import TD_SUBFIELD, build_member, member_header  # noqa: F401 (this module's names)

MEMBER_DATA = 64 * 1024  # bytes per member (one lane)
MAX_CODE_BITS = 15  # full RFC 1951 code range
MAX_HEADER_SLOTS = 384  # bfinal/btype + counts + 19 clens + <= 320 RLE syms/extras


def fix_histograms(litlen_hist: np.ndarray, dist_hist: np.ndarray):
    """(L, 288), (L, 30) token histograms -> int64 copies ready for length
    planning: one EOB per lane; a lane with a single used distance gets a
    neighbour bumped; a lane with no token but EOB gets one literal 0."""
    litlen_hist = np.asarray(litlen_hist).astype(np.int64)
    dist_hist = np.asarray(dist_hist).astype(np.int64)
    litlen_hist[:, 256] += 1
    for l in range(litlen_hist.shape[0]):
        used = np.nonzero(dist_hist[l])[0]
        if used.size == 1:
            i = int(used[0])
            if i + 1 < 30:
                dist_hist[l, i + 1] = 1
            else:
                dist_hist[l, i - 1] = 1
        if litlen_hist[l].sum() == litlen_hist[l, 256]:
            litlen_hist[l, 0] += 1
    return litlen_hist, dist_hist


def pack_codes(lengths: np.ndarray, nbits: int) -> np.ndarray:
    """Batched canonical codes packed as len << 16 | bit-reversed code."""
    L, N = lengths.shape
    counts = np.zeros((L, nbits + 2), dtype=np.int64)
    for l in range(1, nbits + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    next_code = np.zeros((L, nbits + 2), dtype=np.int64)
    code = np.zeros(L, dtype=np.int64)
    for l in range(1, nbits + 1):
        code = (code + counts[:, l - 1]) << 1
        next_code[:, l] = code
    order = np.argsort(lengths, axis=1, kind="stable")
    sorted_lens = np.take_along_axis(lengths, order, axis=1)
    group_first = np.zeros((L, nbits + 2), dtype=np.int64)
    for l in range(nbits + 2):
        group_first[:, l] = np.argmax(sorted_lens >= l, axis=1)
    pos_in_sorted = np.empty((L, N), dtype=np.int64)
    np.put_along_axis(pos_in_sorted, order, np.arange(N)[None, :].repeat(L, 0), axis=1)
    ranks = pos_in_sorted - np.take_along_axis(group_first, lengths.astype(np.int64), axis=1)
    codes = np.take_along_axis(next_code, lengths.astype(np.int64), axis=1) + ranks
    rev = np.zeros((L, N), dtype=np.int64)
    c = codes.copy()
    for _ in range(nbits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    rev = rev >> (nbits - np.maximum(lengths, 1))
    rev = np.where(lengths > 0, rev, 0)
    return ((lengths.astype(np.int64) << 16) | rev).astype(np.int32)


def build_headers(litlen_lengths: np.ndarray, dist_lengths: np.ndarray,
                  final: np.ndarray | None = None):
    """Per-lane dynamic block header slots: (vals (L, H) uint32, bits (L, H)
    int32). The header is bfinal(1) btype=10(2) hlit(5) hdist(5) hclen(4),
    hclen*3-bit clen lengths, then the RLE-coded code-length stream.
    ``final`` (L,) 0/1 is each lane's bfinal; None makes every lane a final
    block (the member-parallel profile)."""
    L = litlen_lengths.shape[0]
    if final is None:
        final = np.ones(L, np.int32)
    H = MAX_HEADER_SLOTS
    vals = np.zeros((L, H), dtype=np.uint32)
    bits = np.zeros((L, H), dtype=np.int32)
    # Per-lane RLE and clen histograms; the clen Huffman and code
    # assignment then run once, batched over lanes.
    lane_rle = []
    hists = np.zeros((L, 19), dtype=np.int64)
    for l in range(L):
        ll = litlen_lengths[l]
        dd = dist_lengths[l]
        hi = 288
        while hi > 257 and ll[hi - 1] == 0:
            hi -= 1
        hi_d = 30
        while hi_d > 1 and dd[hi_d - 1] == 0:
            hi_d -= 1
        syms, extras = _clen_rle(np.concatenate([ll[:hi], dd[:hi_d]]))
        clen_hist = np.bincount(np.asarray(syms, dtype=np.int64), minlength=19)
        if int((clen_hist > 0).sum()) < 2:
            i = int(np.nonzero(clen_hist)[0][0]) if clen_hist.any() else 0
            clen_hist[(i + 1) % 19] += 1
        hists[l] = clen_hist
        lane_rle.append((hi, hi_d, syms, extras))
    clen_lengths_all = huffman_lengths_batch(hists, 7)
    clen_codes_all = pack_codes(clen_lengths_all, 7)
    for l in range(L):
        hi, hi_d, syms, extras = lane_rle[l]
        clen_lengths = clen_lengths_all[l]
        clen_codes = clen_codes_all[l]
        reordered = clen_lengths[CLEN_ORDER]
        num_clen = 19
        while num_clen > 4 and reordered[num_clen - 1] == 0:
            num_clen -= 1
        slots = [(int(final[l]), 1), (2, 2), (hi - 257, 5), (hi_d - 1, 5), (num_clen - 4, 4)]
        for i in range(num_clen):
            slots.append((int(reordered[i]), 3))
        ei = iter(extras)
        for s in syms:
            slots.append((int(clen_codes[s]) & 0xFFFF, int(clen_lengths[s])))
            if s >= 16:
                slots.append((next(ei), _CLEN_EXTRA_BITS[s]))
        assert len(slots) <= H, len(slots)
        for j, (v, b) in enumerate(slots):
            vals[l, j] = v
            bits[l, j] = b
    return vals, bits


def stored_payload(data: bytes) -> bytes:
    """One member's bytes as final stored blocks of at most 65535 bytes,
    starting byte-aligned: per block a byte holding bfinal (btype 00 and
    the padding are zero), LEN and NLEN little-endian, then the bytes."""
    out = bytearray()
    index, end = 0, len(data)
    while True:
        n = min(end - index, MAX_STORED_BLOCK)
        out.append(1 if n == end - index else 0)
        out += n.to_bytes(2, "little") + (n ^ 0xFFFF).to_bytes(2, "little")
        out += data[index : index + n]
        index += n
        if index >= end:
            return bytes(out)
