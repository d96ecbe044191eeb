"""A mirror of K4's and K7's algorithm (csrc/compact.cu), written here in
NumPy: each lane cut into segments of 256 threads x PER entries (PER = 16,
or 4 on small waves), a thread holding groups of 4 consecutive entries, group
g = k * 256 + thread; one block scan of the groups' valid counts packed as
four 16-bit fields ranks the valid entries inside the segment; a decoupled
look-back over status words (32 predecessors a round, stopping at the
nearest inclusive prefix) gives the segment's first output slot; valid
entries go there in order, literal ranks mapped through a 256-byte rank ->
byte table built from the lane's 64 plane words; the segment's invalid
entries go to [M - I - n, M - I), I the invalid entries of the earlier
segments, so the -1 padding fills from the back without the lane's total.

The mirror runs the look-backs in segment order, in reverse and in shuffled
orders (every predecessor has published its aggregate, some their
prefixes), and
checks that every output slot is written exactly once. It is held equal to
the port's plain version ``compact_plain`` and to the JAX package's Pallas
kernels in interpret mode on the edge lanes that chip_smoke.py holds the
card to (``chip_smoke.compact_edge_lanes``: every entry valid and none, only
the last valid, valid entries only in the last segment, literal ranks 0 and
255 under random planes, match tokens of 256 passing through unmapped), at
M = 128 and M not a multiple of the segment size; M not a multiple of 4 or
128 (which the Pallas kernels do not take) against the plain version
alone. Compaction is
integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import decode_pallas as dp

from tpu_deflate_torch.codec import decode_kernels as dk

THREADS = 256
SMALL_WAVE_BLOCKS = 4 * 132
FLAG_AGG, FLAG_PREFIX = 1, 2


def segment_per(L: int, M: int) -> int:
    """Entries a thread of the kernel takes: 4 where the wave has fewer than
    SMALL_WAVE_BLOCKS segments of 4096 entries, else 16."""
    return 4 if L * -(-M // 4096) < SMALL_WAVE_BLOCKS else 16


def rank_table(planes: np.ndarray) -> np.ndarray:
    """The 256-byte rank -> byte table of one lane, as each block builds it:
    bit b of rank r's byte is bit r & 31 of plane word b * 8 + r >> 5."""
    r = np.arange(256)
    words = planes.astype(np.int64) & 0xFFFFFFFF
    return sum(((words[b * 8 + (r >> 5)] >> (r & 31)) & 1) << b for b in range(8)).astype(np.int64)


def _segment(x: np.ndarray, per: int) -> tuple[np.ndarray, int]:
    """One segment's valid entries in order, from the kernel's groups and
    its packed scan; returns (entries, the segment's valid count)."""
    groups = per // 4
    seg = THREADS * per
    v = np.full(seg, -1, np.int64)
    v[: x.size] = x
    g = v.reshape(groups, THREADS, 4)  # group k * 256 + t holds entries 4 (k * 256 + t) ..
    cnt = (g >= 0).sum(2)  # (groups, THREADS), each <= 4
    packed = sum(cnt[k].astype(np.int64) << (16 * k) for k in range(groups))
    incl = np.cumsum(packed)
    excl = incl - packed
    tot = int(incl[-1])
    fields = [(tot >> (16 * k)) & 0xFFFF for k in range(groups)]
    assert fields == [int(cnt[k].sum()) for k in range(groups)], "a 16-bit field overflowed"
    out = np.full(seg, -2, np.int64)
    before = 0
    for k in range(groups):
        r = before + ((excl >> (16 * k)) & 0xFFFF)  # each thread's first rank in group k
        for t in range(THREADS):
            for j in range(4):
                if g[k, t, j] >= 0:
                    assert out[r[t]] == -2, "two entries staged at one rank"
                    out[r[t]] = g[k, t, j]
                    r[t] += 1
        before += fields[k]
    n = sum(fields)
    assert (out[:n] != -2).all() and (out[n:] == -2).all()
    return out[:n], n


def look_back(status: np.ndarray, seg: int, agg: int) -> int:
    """The kernel's look-back of one segment (status: (nseg, 2) flag and
    value; every predecessor has published at least its aggregate)."""
    if seg == 0:
        status[0] = FLAG_PREFIX, agg
        return 0
    status[seg] = FLAG_AGG, agg
    excl = 0
    top = seg - 1
    while True:
        j = top - np.arange(32)
        flag = np.where(j >= 0, status[np.maximum(j, 0), 0], FLAG_PREFIX)
        val = np.where(j >= 0, status[np.maximum(j, 0), 1], 0)
        assert (flag > 0).all(), "a look-back read a segment that has not published"
        prefix = np.flatnonzero(flag == FLAG_PREFIX)
        stop = prefix[0] if prefix.size else 31
        excl += int(val[: stop + 1].sum())
        if prefix.size:
            break
        top -= 32
    status[seg] = FLAG_PREFIX, excl + agg
    return excl


def mirror_compact(tok: np.ndarray, planes: np.ndarray | None, per: int, order: str, seed: int = 0):
    """K4 (planes given) or K7 over (L, M) entries; order: 'in' runs the
    look-backs in segment order, 'reversed' from the last segment down (its
    look-back reads every other segment's aggregate), 'shuffled' in a random
    order per lane. Every output slot must be written exactly once."""
    L, M = tok.shape
    seg_n = THREADS * per
    nseg = -(-M // seg_n)
    rng = np.random.default_rng(seed)
    out = np.full((L, M), -3, np.int64)  # -3: not written
    for lane in range(L):
        table = rank_table(planes[lane]) if planes is not None else None
        status = np.zeros((nseg, 2), np.int64)
        segs = [_segment(tok[lane, s * seg_n : (s + 1) * seg_n].astype(np.int64), per) for s in range(nseg)]
        for s, (_vals, agg) in enumerate(segs):  # what each block publishes first
            status[s] = FLAG_PREFIX if s == 0 else FLAG_AGG, agg
        runs = {"in": range(nseg), "reversed": range(nseg - 1, -1, -1)}.get(order, rng.permutation(nseg))
        for s in runs:
            vals, agg = segs[s]
            start = look_back(status, int(s), agg)
            seg0 = int(s) * seg_n
            seg_len = min(seg_n, M - seg0)
            if table is not None:
                vals = np.where(vals < 256, table[np.clip(vals, 0, 255)], vals)
            dst = out[lane, start : start + agg]
            assert (dst == -3).all(), "a slot written twice"
            out[lane, start : start + agg] = vals
            inv_before, n_inv = seg0 - start, seg_len - agg
            pad = out[lane, M - inv_before - n_inv : M - inv_before]
            assert pad.size == n_inv and (pad == -3).all(), "a padding slot written twice"
            out[lane, M - inv_before - n_inv : M - inv_before] = -1
    assert (out != -3).all(), "a slot left unwritten"
    return out.astype(np.int32)


# (L, M) of chip_smoke.compact_edge_lanes, the lanes cut to L: M = 128; M a
# multiple of 1024 but not 4096; M past a segment edge by 128; 40 segments
# of 1024 (two look-back rounds), every entry valid and none.
PALLAS_SHAPES = [(7, 128), (7, 5120), (7, 4224), (2, 40960)]


@pytest.mark.parametrize("order", ["in", "reversed", "shuffled"])
@pytest.mark.parametrize("per", [4, 16])
@pytest.mark.parametrize("L,M", PALLAS_SHAPES)
def test_mirror_matches_plain_and_pallas(L, M, per, order):
    tok, planes = (a[:L] for a in chip_smoke.compact_edge_lanes(M, 1, seed=M + per))
    for p in (planes, None):
        got = mirror_compact(tok, p, per, order, seed=L)
        want = dk.compact_plain(torch.from_numpy(tok), None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(got, want.numpy())
        ref = (dp.compact_any_pallas(jnp.asarray(tok), interpret=True) if p is None
               else dp.compact_flat_pallas(jnp.asarray(tok), jnp.asarray(p), interpret=True))
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("per", [4, 16])
@pytest.mark.parametrize("M", [1, 1001, 4099])
def test_mirror_matches_plain_off_the_grid(M, per):
    """M not a multiple of 4 (the kernel's scalar loads) or of 128."""
    tok, planes = chip_smoke.compact_edge_lanes(M, 1, seed=M)
    for p in (planes, None):
        got = mirror_compact(tok, p, per, "shuffled", seed=M)
        want = dk.compact_plain(torch.from_numpy(tok), None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(got, want.numpy())


def test_rank_table_and_segment_choice():
    """The rank table equals the plain literal map on every rank; segments
    of 1024 on the main path's 4-lane waves and of 4096 on its 256-lane
    waves."""
    rng = np.random.default_rng(2)
    planes = rng.integers(-(2**31), 2**31, (3, 64), dtype=np.int64).astype(np.int32)
    ranks = np.tile(np.arange(256, dtype=np.int32), (3, 1))
    want = dk.map_literals_plain(torch.from_numpy(ranks), torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(np.stack([rank_table(p) for p in planes]), want)
    assert [segment_per(L, NT * 104) for L, NT in ((4, 128), (4, 1024))] == [4, 4]
    assert [segment_per(256, NT * k1) for NT, k1 in ((128, 176), (256, 104), (384, 104))] == [16, 16, 16]
    assert dk.COMPACT_MIN_SEGMENT == THREADS * 4
