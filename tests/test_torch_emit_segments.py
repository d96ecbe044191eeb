"""A mirror of K10's segmented algorithm (csrc/emit.cu), written here in
plain PyTorch, against the port's plain version ``emit.emit_body_plain``
and the JAX package's Pallas emit kernel in interpret mode: each position's
two slots, segment totals, each lane's exclusive prefix from the header's
length, every segment's words built from its own first bit and then ORed
into the lane's words at that bit (a funnel shift), dropping words past
the grid. Segment sizes 1024 and 4096, widths that are not a multiple of
the segment, segments that carry no bits, and a lane whose bits run past
the 22528-word grid. The emit is integer-only, so every comparison is
exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import emit_pallas as ep
from tpu_deflate_torch.codec import emit as em
from tpu_deflate_torch.codec import encode_np
from tpu_deflate_torch.format.tables import LENGTH_EXTRA
from tpu_deflate_torch.kernels.huffman import huffman_lengths_batch

FIELDS = ("sym", "flags", "leb", "lev", "dsym", "deb", "dev")
M32 = 0xFFFFFFFF


def _lanes(S: int, seed: int) -> dict:
    """Four lanes of S positions: random literals and matches with their
    extra bits under random Huffman codes; the same with two segments'
    worth of positions that carry no token; every position a match of 15-bit
    codes and full extra bits (48 bits each: past the word grid once S >=
    15020); and a lane of only literals."""
    rng = np.random.default_rng(seed)
    L = 4
    kind = rng.random((L, S))
    flags = np.where(kind < 0.5, 1, np.where(kind < 0.8, 3, 0)).astype(np.int32)
    flags[1, S // 8 : S // 8 + 2 * 1024] = 0
    flags[2] = 3
    flags[3] = np.where(kind[3] < 0.9, 1, 0)
    match = flags == 3
    msym = rng.integers(0, 29, (L, S))
    sym = np.where(match, 257 + msym, rng.integers(0, 256, (L, S))).astype(np.int32)
    leb = np.where(match, LENGTH_EXTRA[msym], 0).astype(np.int32)
    dsym = np.where(match, rng.integers(0, 30, (L, S)), 0).astype(np.int32)
    sym[2], dsym[2] = 284, 29  # 5 length and 13 distance extra bits
    leb[2] = LENGTH_EXTRA[284 - 257]
    deb = np.where(match, np.maximum(dsym // 2 - 1, 0), 0).astype(np.int32)
    lev = (rng.integers(0, 1 << 16, (L, S)) & ((1 << leb) - 1)).astype(np.int32)
    dev = (rng.integers(0, 1 << 16, (L, S)) & ((1 << deb) - 1)).astype(np.int32)
    ll_len = huffman_lengths_batch(rng.integers(1, 1000, (L, 288)), 15)
    d_len = huffman_lengths_batch(rng.integers(1, 1000, (L, 30)), 15)
    ll_len[2], d_len[2] = 15, 15  # not a prefix code, but a 15-bit slot each
    return {
        "sym": sym, "flags": flags, "leb": leb, "lev": lev, "dsym": dsym, "deb": deb, "dev": dev,
        "ll": encode_np.pack_codes(ll_len, 15), "dc": encode_np.pack_codes(d_len, 15),
        "hdr": rng.integers(0, 2000, L).astype(np.int32),
    }


def _torch(x: dict) -> tuple:
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    return (*(t[k] for k in FIELDS), t["ll"], t["dc"], t["hdr"])


def mirror_emit(sym, flags, leb, lev, dsym, deb, dev, ll_codes, d_codes, hdr_bits, seg: int):
    """K10's algorithm with segments of ``seg`` positions."""
    L, S = sym.shape
    i64 = torch.int64
    tok, match = (flags & 1) != 0, (flags & 2) != 0
    ll = torch.where(tok, ll_codes.to(i64).gather(1, sym.clamp(0, 287).to(i64)), 0)
    dd = d_codes.to(i64).gather(1, dsym.clamp(0, 29).to(i64))
    b0 = ll >> 16
    va = (ll & 0xFFFF) | torch.where(match, (lev.to(i64) << b0) & M32, 0)
    ba = b0 + torch.where(match, leb.to(i64), 0)
    vb = torch.where(match, (dd & 0xFFFF) | ((dev.to(i64) << (dd >> 16)) & M32), 0)
    bb = torch.where(match, (dd >> 16) + deb.to(i64), 0)
    nseg = -(-S // seg)
    pad = nseg * seg - S

    def segs(x):  # (L, S) -> (L, nseg, 2 seg): each segment's slots in order
        return torch.nn.functional.pad(x, (0, 2 * pad)).view(L, nseg, 2 * seg)

    vals = segs(torch.stack([va, vb], dim=2).view(L, 2 * S))
    bits = segs(torch.stack([ba, bb], dim=2).view(L, 2 * S))
    totals = bits.sum(dim=2)
    starts = hdr_bits.to(i64)[:, None] + torch.cumsum(totals, dim=1) - totals  # exclusive prefix
    nbuf = seg * 48 // 32 + 1
    words = torch.zeros((L, em.EMIT_WORDS + 1), dtype=i64)  # + 1: where dropped parts go
    lanes = torch.arange(L)[:, None]
    for j in range(nseg):
        # The segment's words from its own bit 0.
        offs = torch.cumsum(bits[:, j], dim=1) - bits[:, j]
        buf = em._or_words(offs, vals[:, j], bits[:, j], nbuf)
        # Funnel-shifted to its first bit, ORed in (first and last word shared).
        sh = (starts[:, j] & 31)[:, None]
        prev = torch.nn.functional.pad(buf, (1, 0))[:, :nbuf]
        out = ((buf << sh) & M32) | torch.where(sh > 0, prev >> (32 - sh), 0)
        k = torch.arange(nbuf)[None, :]
        nout = (sh + totals[:, j : j + 1] + 31) >> 5
        gw = (starts[:, j : j + 1] >> 5) + k
        keep = (k < nout) & (gw < em.EMIT_WORDS)
        gw = torch.where(keep, gw, em.EMIT_WORDS)
        words[lanes, gw] |= torch.where(keep, out, 0)
    body_end = hdr_bits.to(i64) + totals.sum(dim=1)
    return em.wrap_int32(words[:, : em.EMIT_WORDS]).to(torch.int32), body_end.to(torch.int32)


def _pallas(x: dict) -> tuple[np.ndarray, np.ndarray]:
    L, S = x["sym"].shape
    R = S // 128
    llc = np.pad(x["ll"], ((0, 0), (0, 384 - 288))).reshape(L, 3, 128)
    dc = np.pad(x["dc"], ((0, 0), (0, 128 - 30))).reshape(L, 1, 128)
    hb8 = np.broadcast_to(x["hdr"][:, None, None], (L, 8, 128))
    words, end = ep._emit_jit(*(jnp.asarray(x[k].reshape(L, R, 128)) for k in FIELDS),
                              jnp.asarray(llc), jnp.asarray(dc), jnp.asarray(hb8), interpret=True)
    return np.asarray(words).view(np.int32), np.asarray(end)


@pytest.fixture(scope="module", params=[6144, 16384])
def case(request):
    """(fields, the Pallas kernel's words and body ends)."""
    x = _lanes(request.param, request.param)
    return x, _pallas(x)


@pytest.mark.parametrize("seg", [1024, em.EMIT_SEGMENT])
def test_mirror_matches_plain_and_pallas(case, seg):
    x, (pw, pend) = case
    args = _torch(x)
    words, body_end = mirror_emit(*args, seg=seg)
    want_w, want_end = em.emit_body_plain(*args)
    assert torch.equal(body_end, want_end) and torch.equal(words, want_w)
    np.testing.assert_array_equal(body_end.numpy(), pend)
    np.testing.assert_array_equal(words.numpy(), pw)
    S = x["sym"].shape[1]
    if S * 48 > 32 * em.EMIT_WORDS:
        assert int(body_end[2]) > 32 * em.EMIT_WORDS  # the 48-bit lane runs past the grid


def test_segments_cut_slots_and_carry_no_bits(case):
    """The cases hold what the mirror is for: on every lane some segment
    starts inside a word, and lane 1 has segments that carry no bits."""
    x, _ = case
    args = _torch(x)
    L, S = x["sym"].shape
    seg = 1024
    _w, end = mirror_emit(*args, seg=seg)
    flags = torch.from_numpy(x["flags"])
    empty = (flags.view(L, -1, seg) == 0).all(dim=2)
    assert bool(empty[1].any()) and not bool(empty[0].any())
    # Segment starts from the plain version's cumulative bits.
    sym, fl, leb, lev, dsym, deb, dev, ll, dc, hdr = args
    ends = []
    for s_end in range(seg, S + 1, seg):
        _ww, e = em.emit_body_plain(*(t[:, :s_end].contiguous() for t in (sym, fl, leb, lev, dsym, deb, dev)),
                                    ll, dc, hdr)
        ends.append(e)
    starts = torch.stack([hdr, *ends[:-1]], dim=1)
    assert bool(((starts & 31) != 0).any(dim=1).all())
    assert torch.equal(ends[-1], end)
