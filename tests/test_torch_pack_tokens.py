"""The host route's packed token pull (``decode_kernels.pack_tokens``, K7's
pack mode in csrc/compact.cu) on the CPU: the plain version
``pack_tokens_plain`` against the JAX package's ``_pack_tokens_jit`` (run on
the CPU as the JAX package's tests run it), then a NumPy mirror of the pack
mode against the plain version.

The mirror follows the kernel: each lane cut into segments of 256 threads x
PER entries (PER = 16, or 4 on small waves), a thread holding groups of 4
consecutive entries (group g = k * 256 + thread); the groups' literal and
match counts packed as four 16-bit fields each and scanned over the
threads; a segment's two counts published as one 62-bit pair (literals in
the low 31 bits, matches above) and its exclusive prefix taken by a pair
look-back (two status words a lane of the warp a round, stopping at the
nearest inclusive prefix), run in segment order, in reverse and shuffled;
literals staged at their rank and stored as bytes from the lane's literal
prefix, matches likewise; each stream's k-th other entry of the lane at
M - 1 - k (255 in the literal stream, -1 in the match stream); each bitmap
word the 4-bit literal masks of 8 neighbouring threads, stored by the
first; the lane's literal count from its last segment. Every output byte
must be written exactly once. Inputs are the smoke's own edge lanes
(``chip_smoke.pack_edge_lanes``: literal ranks 0 and 255, match tokens of
256 and more, -1, -2 and INT_MIN, all-literal, all-match and all-padding
lanes, a literal at bit 31 of every bitmap word) at M not a multiple of 32
or 4, one lane alone, and a wave of K3-like tokens. Integer-only, so every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import decode_jax_v2 as v2

from tpu_deflate_torch.codec import decode_kernels as dk

THREADS = 256
SMALL_WAVE_BLOCKS = 4 * 132
COUNT = (1 << 31) - 1
AGG, PREFIX = 1, 2


def _reference(tok: np.ndarray) -> tuple:
    bitmap, lit, match, nlit = v2._pack_tokens_jit(jnp.asarray(tok))
    return (np.asarray(bitmap).view(np.int32), np.asarray(lit), np.asarray(match), np.asarray(nlit).astype(np.int32))


def _plain(tok: np.ndarray) -> tuple:
    return tuple(t.numpy() for t in dk.pack_tokens_plain(torch.from_numpy(tok)))


def _wave(L: int, M: int, seed: int) -> np.ndarray:
    """K3-like front-compacted tokens: literals and matches, then -1."""
    rng = np.random.default_rng(seed)
    tok = np.where(rng.random((L, M)) < 0.6, rng.integers(0, 256, (L, M)), rng.integers(256, 1 << 27, (L, M)))
    n = rng.integers(0, M + 1, L)
    return np.where(np.arange(M)[None, :] < n[:, None], tok, -1).astype(np.int32)


CASES = {
    "M=31": lambda: chip_smoke.pack_edge_lanes(31, seed=31),
    "M=100": lambda: chip_smoke.pack_edge_lanes(100, seed=100),
    "M=1001": lambda: chip_smoke.pack_edge_lanes(1001, seed=1001),
    "M=4099": lambda: chip_smoke.pack_edge_lanes(4099, seed=4099),
    "one lane": lambda: chip_smoke.pack_edge_lanes(2050, seed=7)[10:11],
    "wave": lambda: _wave(8, 13312, 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(case):
    tok = CASES[case]()
    want = _reference(tok)
    got = _plain(tok)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_edge_lanes_are_what_they_claim():
    """The edge lanes hold what the docstring says: an all-literal, an
    all-match and an all-padding lane, and bit 31 set in every bitmap word
    of the last lane."""
    tok = chip_smoke.pack_edge_lanes(1024, seed=3)
    bitmap, lit, match, nlit = _plain(tok)
    assert nlit[7] == 1024 and (lit[7] == tok[7]).all()
    assert nlit[8] == 0 and (match[8] == tok[8]).all() and (lit[8] == 255).all()
    assert nlit[9] == 0 and (match[9] == -1).all() and (bitmap[9] == 0).all()
    assert (bitmap[10] == np.int32(-(2**31))).all()


def _per(L: int, M: int) -> int:
    return 4 if L * -(-M // 4096) < SMALL_WAVE_BLOCKS else 16


def _look_back_pair(status: np.ndarray, seg: int, agg: int, items: int = 2) -> int:
    """The pair look-back of one segment (status: (nseg, 2) flag and packed
    value; every predecessor has published at least its aggregate): each
    of the warp's 32 lanes reads ``items`` status words a round."""
    if seg == 0:
        status[0] = PREFIX, agg
        return 0
    status[seg] = AGG, agg
    excl = 0
    top = seg - 1
    while True:
        j = top - np.arange(32 * items)  # lane l reads top - l * items - i, i < items
        flag = np.where(j >= 0, status[np.maximum(j, 0), 0], PREFIX)
        val = np.where(j >= 0, status[np.maximum(j, 0), 1], 0)
        assert (flag > 0).all(), "a look-back read a segment that has not published"
        prefix = np.flatnonzero(flag == PREFIX)
        stop = prefix[0] if prefix.size else 32 * items - 1
        excl += int(val[: stop + 1].sum())
        if prefix.size:
            break
        top -= 32 * items
    status[seg] = PREFIX, excl + agg
    return excl


def _segment(x: np.ndarray, per: int):
    """One segment as its block sees it: (literal bytes in order, matches in
    order, the pair it publishes, its bitmap words in segment order)."""
    groups = per // 4
    v = np.full(THREADS * per, -1, np.int64)
    v[: x.size] = x
    g = v.reshape(groups, THREADS, 4)  # group k * 256 + t holds entries 4 (k * 256 + t) ..
    is_lit = (g >= 0) & (g < 256)
    is_match = g >= 256
    nib = sum(is_lit[:, :, j].astype(np.int64) << j for j in range(4))  # (groups, THREADS)
    # word (k * 256 + t) / 8: the masks of threads t .. t + 7, 4 bits each
    words = (nib.reshape(groups, THREADS // 8, 8) << (4 * np.arange(8))).sum(2).reshape(-1)
    streams = []
    for mask in (is_lit, is_match):
        cnt = mask.sum(2)
        packed = sum(cnt[k].astype(np.int64) << (16 * k) for k in range(groups))
        excl = np.cumsum(packed) - packed  # the block scan of the packed fields
        fields = np.array([(int(packed.sum()) >> (16 * k)) & 0xFFFF for k in range(groups)])
        assert (fields == cnt.sum(1)).all(), "a 16-bit field overflowed"
        before = np.concatenate([[0], np.cumsum(fields)[:-1]])
        first = before[:, None] + ((excl[None, :] >> (16 * np.arange(groups)[:, None])) & 0xFFFF)
        rank = first[:, :, None] + np.cumsum(mask, axis=2) - mask  # each entry's rank in the segment
        n = int(fields.sum())
        ranks = rank[mask]
        assert np.array_equal(np.sort(ranks), np.arange(n)), "ranks not a permutation"
        out = np.empty(n, np.int64)
        out[ranks] = g[mask]
        streams.append(out)
    pair = len(streams[1]) << 31 | len(streams[0])
    return streams[0], streams[1], pair, words


def mirror_pack(tok: np.ndarray, order: str, seed: int = 0) -> tuple:
    """The pack mode over (L, M) tokens; order as in the K7 mirror: 'in',
    'reversed' or 'shuffled' look-backs. Every output must be written
    exactly once."""
    L, M = tok.shape
    per = _per(L, M)
    seg_n = THREADS * per
    nseg = -(-M // seg_n)
    Mw = -(-M // 32)
    rng = np.random.default_rng(seed)
    lit = np.full((L, M), -3, np.int64)
    match = np.full((L, M), -3, np.int64)
    bitmap = np.full((L, Mw), -3, np.int64)
    nlit = np.full(L, -3, np.int64)
    for lane in range(L):
        segs = [_segment(tok[lane, s * seg_n : (s + 1) * seg_n].astype(np.int64), per) for s in range(nseg)]
        status = np.zeros((nseg, 2), np.int64)
        for s, seg in enumerate(segs):
            status[s] = PREFIX if s == 0 else AGG, seg[2]
        runs = {"in": range(nseg), "reversed": range(nseg - 1, -1, -1)}.get(order, rng.permutation(nseg))
        for s in runs:
            lits, matches, pair, words = segs[s]
            before = _look_back_pair(status, int(s), pair)
            start_l, start_m = before & COUNT, before >> 31
            seg0 = int(s) * seg_n
            seg_len = min(seg_n, M - seg0)
            for out, vals, start, pad in ((lit, lits, start_l, 255), (match, matches, start_m, -1)):
                dst = out[lane, start : start + vals.size]
                assert (dst == -3).all(), "a slot written twice"
                out[lane, start : start + vals.size] = vals
                others = seg_len - vals.size  # the k-th other entry of the lane goes to M - 1 - k
                lo = M - (seg0 - start) - others
                assert (out[lane, lo : lo + others] == -3).all(), "a padding slot written twice"
                out[lane, lo : lo + others] = pad
            gw = seg0 // 32 + np.arange(words.size)
            keep = gw < Mw
            assert (bitmap[lane, gw[keep]] == -3).all(), "a bitmap word written twice"
            bitmap[lane, gw[keep]] = words[keep]
            if s == nseg - 1:
                nlit[lane] = start_l + lits.size
    for out in (lit, match, bitmap, nlit):
        assert (out != -3).all(), "an output never written"
    wrap = ((bitmap + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return wrap.astype(np.int32), lit.astype(np.uint8), match.astype(np.int32), nlit.astype(np.int32)


@pytest.mark.parametrize("case", ["M=31", "M=100", "M=1001", "M=4099", "one lane"])
@pytest.mark.parametrize("order", ["in", "reversed", "shuffled"])
def test_mirror_matches_plain(case, order):
    tok = CASES[case]()
    got = mirror_pack(tok, order, seed=len(case))
    for g, w in zip(got, _plain(tok)):
        np.testing.assert_array_equal(g, w)


def test_mirror_matches_plain_at_4096_entry_segments():
    """A wave of enough segments of 4096 entries for the kernel's larger
    segments (PER 16), M not a multiple of them, lanes of the edge kinds."""
    lanes = chip_smoke.pack_edge_lanes(8228, seed=2)
    tok = np.tile(lanes, (48, 1))[:176]
    assert _per(*tok.shape) == 16
    got = mirror_pack(tok, "shuffled", seed=1)
    for g, w in zip(got, _plain(tok)):
        np.testing.assert_array_equal(g, w)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    tok = chip_smoke.pack_edge_lanes(300, seed=11)
    before = dk.LAUNCHES["pack_tokens"]
    got = dk.pack_tokens(torch.from_numpy(tok))
    assert dk.LAUNCHES["pack_tokens"] == before
    for g, w in zip(got, dk.pack_tokens_plain(torch.from_numpy(tok))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        dk.pack_tokens(torch.from_numpy(tok.astype(np.int64)))
