"""A NumPy mirror of K4's pull mode (``compact_pull_kernel`` in
csrc/compact.cu), shared by ``test_torch_compact_pack.py`` (the map on: the
host route's compaction and packed pull in one pass, ``compact_pack``) and
``test_torch_pack_tokens.py`` (the map off: the pull alone,
``pack_tokens``).

The mirror follows the kernel: each lane cut into segments of 256 threads x
PER entries (PER = 16, or 4 on waves of fewer than 264 segments of 4096), a thread holding groups of 4
consecutive entries (group g = k * 256 + thread); the groups' literal and
match counts packed as four 16-bit fields each and scanned over the
threads; a segment's two counts published as one 62-bit pair (literals in
the low 31 bits, matches above) and its exclusive prefix taken by a pair
look-back (two status words a lane of the warp a round, stopping at the
nearest inclusive prefix), run in segment order, in reverse and shuffled;
literals staged at their rank (mapped through the lane's rank -> byte table
with the map on) and stored as bytes from the lane's literal prefix,
matches likewise; each stream's k-th other entry of the lane at M - 1 - k
(255 in the literal stream, -1 in the match stream); the literal flags
staged in bitmap order (the valid rank, which is the literal rank plus the
match rank, with the map on; the entry with it off) and each word of the
segment's bitmap range [b0, b0 + bn) built from 32 of them. With the map on
b0 is the segment's first slot in the compacted lane (the pair's two
prefixes added), a word wholly inside the range is stored, a word at its
ends is ORed into a bitmap that starts at 0 (the C entry's memset), and a
zero word is not written at all; with the map off b0 is the segment's first
entry and every word is stored. The lane's last segment writes the literal
count.

The mirror asserts what the kernel relies on: the ranks are a permutation,
no 16-bit field overflows, every look-back reads published words only,
every byte of the literal and match streams and every nlit is written
exactly once, a stored bitmap word is touched by no other segment (so a
plain store and an atomicOr never meet), with the map off every word is
stored once, and the bits past a lane's count are 0."""

from __future__ import annotations

import numpy as np

THREADS = 256
PULL_SMALL_WAVE_BLOCKS = 2 * 132
COUNT = (1 << 31) - 1
AGG, PREFIX = 1, 2


def pull_per(L: int, M: int) -> int:
    """Entries a thread of the kernel takes: 4 where the wave has fewer than
    PULL_SMALL_WAVE_BLOCKS segments of 4096 entries, else 16."""
    return 4 if L * -(-M // 4096) < PULL_SMALL_WAVE_BLOCKS else 16


def rank_table(planes: np.ndarray) -> np.ndarray:
    """The 256-byte rank -> byte table of one lane, as each block builds it:
    bit b of rank r's byte is bit r & 31 of plane word b * 8 + r >> 5."""
    r = np.arange(256)
    words = planes.astype(np.int64) & 0xFFFFFFFF
    return sum(((words[b * 8 + (r >> 5)] >> (r & 31)) & 1) << b for b in range(8)).astype(np.int64)


def look_back_pair(status: np.ndarray, seg: int, agg: int, items: int = 2) -> int:
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


def _ranks(mask: np.ndarray, groups: int) -> np.ndarray:
    """Each entry's count of earlier entries of its stream in the segment,
    from the packed 16-bit fields' block scan, as a thread computes it."""
    cnt = mask.sum(2)
    packed = sum(cnt[k].astype(np.int64) << (16 * k) for k in range(groups))
    excl = np.cumsum(packed) - packed
    fields = np.array([(int(packed.sum()) >> (16 * k)) & 0xFFFF for k in range(groups)])
    assert (fields == cnt.sum(1)).all(), "a 16-bit field overflowed"
    before = np.concatenate([[0], np.cumsum(fields)[:-1]])
    first = before[:, None] + ((excl[None, :] >> (16 * np.arange(groups)[:, None])) & 0xFFFF)
    return first[:, :, None] + np.cumsum(mask, axis=2) - mask


def _segment(x: np.ndarray, per: int, table: np.ndarray | None):
    """One segment as its block sees it: (literal bytes in order, matches in
    order, the pair it publishes, its literal flags in bitmap order)."""
    groups = per // 4
    v = np.full(THREADS * per, -1, np.int64)
    v[: x.size] = x
    g = v.reshape(groups, THREADS, 4)  # group k * 256 + t holds entries 4 (k * 256 + t) ..
    is_lit = (g >= 0) & (g < 256)
    is_match = g >= 256
    rank_l, rank_m = _ranks(is_lit, groups), _ranks(is_match, groups)
    n_l, n_m = int(is_lit.sum()), int(is_match.sum())
    lits, matches = np.empty(n_l, np.int64), np.empty(n_m, np.int64)
    for out, mask, rank, n in ((lits, is_lit, rank_l, n_l), (matches, is_match, rank_m, n_m)):
        assert np.array_equal(np.sort(rank[mask]), np.arange(n)), "ranks not a permutation"
        out[rank[mask]] = g[mask]
    if table is not None:
        lits = table[lits]
        valid = is_lit | is_match
        vrank = (rank_l + rank_m)[valid]  # the entry's slot in the segment's compacted run
        assert np.array_equal(np.sort(vrank), np.arange(n_l + n_m)), "valid ranks not a permutation"
        flags = np.zeros(n_l + n_m, bool)
        flags[vrank] = is_lit[valid]
    else:
        flags = is_lit.reshape(-1)[: x.size]  # entry order: group k * 256 + t, then j
    return lits, matches, n_m << 31 | n_l, flags


def mirror_pull(tok: np.ndarray, planes: np.ndarray | None, order: str, seed: int = 0,
                per: int | None = None) -> tuple:
    """K4's pull mode over (L, M) tokens, with the literal map (planes (L,
    64) int32) or without it (None); order as in the K4 mirror: 'in',
    'reversed' or 'shuffled' look-backs; per defaults to the kernel's
    choice. Returns (bitmap, lit, match, nlit) as the wrapper does."""
    L, M = tok.shape
    per = per or pull_per(L, M)
    seg_n = THREADS * per
    nseg = -(-M // seg_n)
    Mw = -(-M // 32)
    rng = np.random.default_rng(seed)
    lit = np.full((L, M), -3, np.int64)  # -3: not written
    match = np.full((L, M), -3, np.int64)
    nlit = np.full(L, -3, np.int64)
    bitmap = np.zeros((L, Mw), np.int64) if planes is not None else np.full((L, Mw), -3, np.int64)
    stored = np.zeros((L, Mw), np.int64)  # plain stores of each word
    ored = np.zeros((L, Mw), np.int64)  # atomicOr's of each word
    for lane in range(L):
        table = rank_table(planes[lane]) if planes is not None else None
        segs = [_segment(tok[lane, s * seg_n : (s + 1) * seg_n].astype(np.int64), per, table)
                for s in range(nseg)]
        status = np.zeros((nseg, 2), np.int64)
        for s, seg in enumerate(segs):  # what each block publishes first
            status[s] = PREFIX if s == 0 else AGG, seg[2]
        runs = {"in": range(nseg), "reversed": range(nseg - 1, -1, -1)}.get(order, rng.permutation(nseg))
        for s in runs:
            lits, matches, pair, flags = segs[s]
            before = look_back_pair(status, int(s), pair)
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
            b0, bn = (start_l + start_m, flags.size) if planes is not None else (seg0, seg_len)
            assert flags.size == bn
            if bn:
                ws = np.arange(b0 >> 5, ((b0 + bn - 1) >> 5) + 1)
                p = 32 * ws[:, None] + np.arange(32)[None, :] - b0
                bits = (p >= 0) & (p < bn) & flags[np.clip(p, 0, bn - 1)]
                words = (bits.astype(np.int64) << np.arange(32)).sum(1)
                if planes is None:
                    assert (stored[lane, ws] == 0).all(), "a bitmap word stored twice"
                    bitmap[lane, ws] = words
                    stored[lane, ws] += 1
                else:
                    own = (32 * ws >= b0) & (32 * ws + 32 <= b0 + bn) & (words != 0)
                    shared = ~own & (words != 0)
                    bitmap[lane, ws[own]] = words[own]
                    stored[lane, ws[own]] += 1
                    bitmap[lane, ws[shared]] |= words[shared]
                    ored[lane, ws[shared]] += 1
            if s == nseg - 1:
                assert nlit[lane] == -3
                nlit[lane] = start_l + lits.size
    for out in (lit, match, nlit, bitmap):
        assert (out != -3).all(), "an output never written"
    assert (stored <= 1).all() and not ((stored > 0) & (ored > 0)).any(), "a stored word met another writer"
    # the bits past each lane's count (its valid entries with the map on,
    # M with it off) are 0
    count = (tok >= 0).sum(1) if planes is not None else np.full(L, M)
    pos = 32 * np.arange(Mw)[None, :, None] + np.arange(32)[None, None, :]
    bits = (bitmap[:, :, None] >> np.arange(32)) & 1
    assert not (bits.astype(bool) & (pos >= count[:, None, None])).any(), "a bit past the lane's count"
    wrap = ((bitmap + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return wrap.astype(np.int32), lit.astype(np.uint8), match.astype(np.int32), nlit.astype(np.int32)


def k3_tokens(L: int, NT: int, k1: int, seed: int):
    """(L, NT * k1) int32 tokens shaped as K3 leaves them (each tile's k1
    slots: its tokens, then -1) and (L, 64) int32 random literal planes.
    Lanes cycle through: random tiles (literal ranks, 0 and 255 among them,
    and match tokens of 256 and more; empty and full tiles), every token a
    literal, every token a match, every slot padding, and random tiles with
    -2 and INT_MIN among the padding."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, k1 + 1, (L, NT))
    n[:, ::7] = 0
    n[:, 3::7] = k1
    kind = np.arange(L) % 5
    n[kind == 1] = k1
    n[kind == 2] = k1
    n[kind == 3] = 0
    val = np.where(rng.random((L, NT, k1)) < 0.6, rng.integers(0, 256, (L, NT, k1)),
                   (1 << 26) | rng.integers(0, 1 << 25, (L, NT, k1)))
    val[kind == 1] = rng.integers(0, 256, (int((kind == 1).sum()), NT, k1))
    val[kind == 2] = 256 + rng.integers(0, 1 << 27, (int((kind == 2).sum()), NT, k1))
    val[:, 0, :2] = [0, 255][: min(2, k1)]
    pad = np.full((L, NT, k1), -1, np.int64)
    pad[kind == 4] = rng.choice(np.array([-1, -1, -2, -(2**31)]), (int((kind == 4).sum()), NT, k1))
    tok = np.where(np.arange(k1)[None, None, :] < n[:, :, None], val, pad)
    planes = rng.integers(-(2**31), 2**31, (L, 64), dtype=np.int64).astype(np.int32)
    return tok.reshape(L, NT * k1).astype(np.int32), planes
