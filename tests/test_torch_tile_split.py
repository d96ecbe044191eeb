"""The tile split (``resolve.split_tiles_device``, ``csrc/tile_split.cu``)
on the CPU: the plain version ``resolve.split_tiles_plain`` (which the
wrapper runs on CPU tensors) against the JAX package's NumPy split
``resolve_pallas.split_tokens_tiles`` on many streams and against its
jitted ``split_tiles_device`` at two small shapes, and a NumPy mirror of
the kernel's two launches against the plain version.

The mirror repeats the kernel's decomposition: each lane cut into
segments, each segment's runs summed by threads of consecutive tokens and a
block scan, its prefix from a decoupled look-back whose sum saturates at T
* N_POS + 1024 (run in any order the kernel allows: each predecessor has
published its aggregate or its inclusive prefix), the crossing token of
every seam writing the tile's first index, head and the tile before's
straddler, the lane's last segment the seams past its total; then a block
a tile ranking its range's valid tokens round by round (items of
consecutive threads, warp ballots, one scan of the (item, warp) counts).
It checks that every scratch word and every output word is written exactly
once. Segment lengths put a straddler, a token ending on a seam and a -1
run on a segment's edge. Inputs are made from a numpy seed; the split is
integer-only, so every comparison is exact equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_deflate.codec import resolve_pallas as rp

from tpu_deflate_torch.codec import resolve as rs

N = rs.N_POS
MATCH = rs.TOKEN_MATCH_BIT
FIELDS = 0x07FFFFFF


def match(run: int, dist_m1: int = 0) -> int:
    return MATCH | run << 16 | dist_m1


def _stream(total: int, seed: int, *, lit_share: float = 0.1) -> list[int]:
    """Tokens of ``total`` output bytes: matches of 3..258 and literals."""
    rng = np.random.default_rng(seed)
    toks, out = [], 0
    while out < total:
        if rng.random() < lit_share or total - out < 3:
            toks.append(int(rng.integers(0, 256)))
            out += 1
        else:
            run = int(rng.integers(3, min(258, total - out) + 1))
            toks.append(match(run, int(rng.integers(0, 32768))))
            out += run
    return toks


def _seams(tiles: int) -> list[int]:
    """A 258-run straddling every seam, 100 bytes before it (matches of 250
    fill the rest, then literals)."""
    toks, out = [], 0
    for t in range(tiles):
        gap = (t + 1) * N - 100 - out
        toks += [match(250, 7)] * (gap // 250) + [3] * (gap % 250) + [match(258, t)]
        out += gap + 258
    return toks + [1, 2]


def _on_seam() -> list[int]:
    """A 258-run that ends exactly on seam 1, a literal that ends on seam 2,
    a straddler on seam 3."""
    toks = [match(254, 1)] * 257 + [match(258, 2)]  # 257 * 254 + 258 = 65536
    toks += [match(255, 3)] * 257 + [9]  # 257 * 255 + 1 = 65536
    toks += [match(200, 4)] * 327 + [match(200, 5)]  # 327 * 200 + 136 = 65536, 64 past the seam
    return toks + [1, 2, 3]


def _batch(streams: list[list[int]], pad: int = 0, seed: int = 0, holes: int = 0) -> np.ndarray:
    """(L, K) int32, each stream front-packed then -1; with ``holes``, runs
    of -1 and other negative values inserted at random places mid-stream."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in streams:
        s = list(s)
        for _ in range(holes if s else 0):
            at = int(rng.integers(0, len(s) + 1))
            s[at:at] = [-1] * int(rng.integers(1, 40)) + [int(rng.choice([-5, -(1 << 31)]))]
        rows.append(s)
    K = max((len(r) for r in rows), default=0) + pad
    out = np.full((len(rows), K), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = np.array(r, np.int64).astype(np.int32)
    return out


CASES = {
    "random": lambda: (_batch([_stream(3 * N + 1234, 1), _stream(N // 3, 2), _stream(2 * N, 3)], pad=50), 4),
    "seams": lambda: (_batch([_seams(4), _stream(1000, 4)], pad=7), 5),
    "on_seam": lambda: (_batch([_on_seam()]), 4),
    "holes": lambda: (_batch([_stream(2 * N + 99, 5), _seams(2)], pad=30, seed=5, holes=12), 3),
    "past_T": lambda: (_batch([_stream(5 * N + 7, 6), _seams(3)]), 2),
    "T1": lambda: (_batch([_stream(3 * N, 7), [5, 6], _stream(N - 1, 8)]), 1),
    "empty_lane": lambda: (_batch([[], _stream(N + 5, 9), []], pad=20), 2),
    "literals": lambda: (_batch([[k & 0xFF for k in range(N + 300)], _stream(N, 10)]), 3),
    "K0": lambda: (np.zeros((3, 0), np.int32), 2),
}


def _host_tiles(tok: np.ndarray, T: int) -> np.ndarray:
    """split_tokens_tiles of each lane, cut or padded to T tiles."""
    out = np.full((tok.shape[0], T, N), -1, np.int32)
    for i in range(tok.shape[0]):
        host = rp.split_tokens_tiles(tok[i])
        t = min(T, host.shape[0])
        out[i, :t] = host[:t]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_host_split(case):
    tok, T = CASES[case]()
    got = rs.split_tiles_plain(torch.from_numpy(tok), T).numpy()
    assert got.shape == (tok.shape[0], T, N)
    np.testing.assert_array_equal(got, _host_tiles(tok, T))
    # the wrapper takes its plain version on CPU tensors
    np.testing.assert_array_equal(rs.split_tiles_device(torch.from_numpy(tok), T).numpy(), got)


@pytest.mark.parametrize("case", ["on_seam", "holes"])
def test_plain_matches_reference_jit(case):
    tok, T = CASES[case]()
    got = rs.split_tiles_plain(torch.from_numpy(tok), T).numpy()
    np.testing.assert_array_equal(got, np.asarray(rp.split_tiles_device(tok, T)))


def _zero_runs() -> tuple[np.ndarray, int]:
    """Runs of 0 (matches of run 0): a tile's slots overflow past N_POS
    (lane 0), some follow a straddler (lane 0) and one starts on a seam
    (lane 2); and matches with bits 27-30 set, which the split drops from
    every match it writes (lane 1)."""
    a = [match(0, 5)] * 65600 + [match(200, 1)] * 327 + [match(200, 2), match(0, 9)] + [match(0, 3)] * 3 + [7]
    b = _stream(N + 500, 11)
    b = [x | (0x78000000 if x & MATCH and i % 3 == 0 else 0) for i, x in enumerate(b)]
    c = [match(256, 6)] * 256 + [match(0, 4), 5]
    return _batch([a, b, c], pad=5), 3


def test_plain_drops_slots_past_n_pos():
    tok, T = _zero_runs()
    got = rs.split_tiles_plain(torch.from_numpy(tok), T).numpy()
    assert (got[0, 0] == match(0, 5)).all()  # 65600 zero runs: the first N_POS kept
    assert list(got[0, 1, :7]) == [match(64, 2), match(0, 9)] + [match(0, 3)] * 3 + [7, -1]
    assert ((got[1] < 0) | ((got[1] & ~FIELDS) == 0)).all()  # no bit above 26 in any written token
    assert list(got[2, 1, :3]) == [match(0, 4), 5, -1]


# ---------------------------------------------------------------------------
# NumPy mirror of csrc/tile_split.cu
# ---------------------------------------------------------------------------

UNSET = np.iinfo(np.int64).min


def _runs(tok: np.ndarray) -> np.ndarray:
    x = tok.astype(np.int64)
    return np.where(x < 0, 0, np.where(x & MATCH, (x >> 16) & 0x3FF, 1))


def _look_back(aggs: list[int], seg: int, incl: list[int], rng, sat) -> int:
    """The segment's exclusive prefix as the kernel's warp finds it: rounds
    of 32 predecessors back from seg - 1, each round folding the aggregates
    down to its nearest published inclusive prefix. Any predecessor may
    still show only its aggregate (a coin flip); segment 0 publishes its
    prefix at once."""
    if seg == 0:
        return 0
    excl, top = 0, seg - 1
    while True:
        x, stop = 0, False
        for j in range(top, top - 32, -1):
            if j <= 0 or rng.random() < 0.5:  # before segment 0: nothing to add
                x = sat(x, incl[j] if j >= 0 else 0)
                stop = True
                break
            x = sat(x, aggs[j])
        excl = sat(excl, x)
        if stop:
            return excl
        top -= 32


def mirror_split(tok: np.ndarray, T: int, seg_len: int, per: int, seed: int,
                 threads: int = 64, fill_per: int = 4) -> np.ndarray:
    L, K = tok.shape
    cap = T * N + 1024
    TN = T * N

    def sat(a, b):
        return min(a + b, cap)

    first = np.full((L, T + 1), UNSET, np.int64)
    head = np.full((L, T), UNSET, np.int64)
    tail = np.full((L, T), UNSET, np.int64)
    writes = [np.zeros(a.shape, np.int64) for a in (first, head, tail)]

    def put(which: int, arr, lane: int, t: int, v: int):
        arr[lane, t] = v
        writes[which][lane, t] += 1

    rng = np.random.default_rng(seed)
    if K:
        nseg = -(-K // seg_len)
        runs = _runs(tok)
        for lane in range(L):
            aggs = [int(runs[lane, s * seg_len : (s + 1) * seg_len].sum()) for s in range(nseg)]
            incl: list = [None] * nseg
            for seg in range(nseg):
                prefix = _look_back(aggs, seg, incl, rng, sat)
                incl[seg] = sat(prefix, aggs[seg])
                seg0 = seg * seg_len
                x = tok[lane, seg0 : seg0 + seg_len].astype(np.int64)
                r = runs[lane, seg0 : seg0 + seg_len]
                # threads of `per` consecutive tokens: exclusive sums, then each thread's chain
                sums = np.add.reduceat(r, np.arange(0, len(r), per))
                excl = np.concatenate([[0], np.cumsum(sums)[:-1]])
                if seg == 0:
                    put(0, first, lane, 0, 0)
                    put(1, head, lane, 0, -1)
                for th in range(len(sums)):
                    s = sat(prefix, int(excl[th]))
                    for k in range(th * per, min((th + 1) * per, len(r))):
                        if s < TN:
                            e = s + int(r[k])
                            c = (s // N + 1) * N
                            if c <= e:
                                t, d = c // N, int(x[k]) & 0xFFFF
                                put(0, first, lane, t, seg0 + k + 1)
                                if t < T:
                                    put(1, head, lane, t, match(e - c, d) if e > c else -1)
                                put(2, tail, lane, t - 1, match(c - s, d) if e > c else -1)
                        s = sat(s, int(r[k]))
                if seg == nseg - 1:
                    for t in range(incl[seg] // N + 1, T + 1):
                        put(0, first, lane, t, K)
                        if t < T:
                            put(1, head, lane, t, -1)
                        put(2, tail, lane, t - 1, -1)
        for w in writes:
            assert (w == 1).all(), "a scratch word written other than once"

    out = np.full((L, T, N), UNSET, np.int64)
    out_writes = np.zeros((L, T, N), np.int64)
    rnd = threads * fill_per
    warps = threads // 32
    for lane in range(L):
        for t in range(T):
            lo, hi, hd, st = (0, 0, -1, -1) if K == 0 else (
                int(first[lane, t]), int(first[lane, t + 1]), int(head[lane, t]), int(tail[lane, t]))
            o, ow = out[lane, t], out_writes[lane, t]
            if hd >= 0:
                o[0] = hd
                ow[0] += 1
            base = int(hd >= 0)
            c = lo
            while c < hi and base < N:
                idx = c + np.arange(fill_per)[:, None] * threads + np.arange(threads)[None, :]  # (item, thread)
                v = np.where(idx < hi, tok[lane, np.minimum(idx, K - 1)].astype(np.int64), -1)
                v = np.where((v >= 0) & ((v & MATCH) != 0), v & FIELDS, v)
                v = np.where((idx == hi - 1) & (st >= 0), st, v)
                ok = v >= 0
                by_warp = ok.reshape(fill_per, warps, 32)
                counts = by_warp.sum(2).ravel()  # (item, warp), item-major
                wexcl = np.concatenate([[0], np.cumsum(counts)[:-1]]).reshape(fill_per, warps)
                lane_rank = np.cumsum(by_warp, 2) - by_warp  # valid lanes below, in the warp
                rank = base + wexcl[:, :, None] + lane_rank
                keep = by_warp & (rank < N)
                o[rank[keep]] = v.reshape(fill_per, warps, 32)[keep]
                np.add.at(ow, rank[keep], 1)
                base += int(counts.sum())
                c += rnd
            n = min(base, N)
            o[n:] = -1
            ow[n:] += 1
    assert (out_writes == 1).all(), "an output word written other than once"
    return out.astype(np.int32)


def _edge_lengths(tok: np.ndarray, T: int) -> list[int]:
    """Segment lengths that put lane 0's first straddler, first token
    ending on a seam and first -1 run at a segment's start or end."""
    x = tok[0].astype(np.int64)
    r = _runs(tok[:1])[0]
    e = np.cumsum(r)
    s = e - r
    cross = (s // N + 1) * N
    lens = {4096, 7}
    last = np.flatnonzero(x >= 0)[-1] if (x >= 0).any() else -1
    for hits in ((cross < e) & (s < T * N), (cross == e) & (r > 0), (x < 0) & (np.arange(len(x)) < last)):
        idx = np.flatnonzero(hits)
        if idx.size:
            lens |= {int(idx[0]), int(idx[0]) + 1}
    return sorted(n for n in lens if n > 0)


MIRROR_CASES = {**{k: CASES[k] for k in ("seams", "on_seam", "holes", "past_T", "T1", "empty_lane", "K0")},
                "zero_runs": _zero_runs}


@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_mirror_matches_plain(case):
    tok, T = MIRROR_CASES[case]()
    want = rs.split_tiles_plain(torch.from_numpy(tok), T).numpy()
    lens = _edge_lengths(tok, T) if tok.shape[1] else [4096]
    for i, seg_len in enumerate(lens):
        got = mirror_split(tok, T, seg_len, per=4 if seg_len % 4 == 0 else 3, seed=i)
        np.testing.assert_array_equal(got, want, err_msg=f"segments of {seg_len}")


def test_wrapper_checks():
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 5), dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 10), dtype=torch.int32)[:, ::2], 1)
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 5), dtype=torch.int32), 0)
