"""The tile split (``resolve.split_tiles_device``, ``csrc/tile_split.cu``)
on the CPU: the plain version ``resolve.split_tiles_plain`` (which the
wrapper runs on CPU tensors) against the JAX package's NumPy split
``resolve_pallas.split_tokens_tiles`` on many streams and against its
jitted ``split_tiles_device`` at two small shapes, and a NumPy mirror of
the kernel's two launches against the plain version.

The mirror repeats the kernel's decomposition and runs its blocks in a
random interleaving, at most a few at once and started in ticket order:
each lane cut into segments, each segment's runs and valid tokens summed by
threads of consecutive tokens and a block scan, its two prefixes from a
decoupled look-back over (bytes, count) pairs whose bytes saturate at T *
N_POS + 1024 (rounds of 32 or 128 predecessors folded down to the nearest
inclusive prefix, a block blocked where any word of its round is still
unpublished), the crossing token of every seam publishing its tile's base
less its head and writing the head, each block waiting for the base of the
tile it opens in, every valid token placed at its slot by rank, the
crossing tokens and the lane's last segment publishing each tile's filled
length; the later tickets padding a chunk of a tile each once its filled
length is published. It checks that every output word is written exactly
once, every filled length once, every tile word at most once, and that no
interleaving hangs. Segment lengths put a straddler, a token ending on a
seam and a -1 run on a segment's edge. Inputs are made from a numpy seed;
the split is integer-only, so every comparison is exact equality."""

from __future__ import annotations

import random

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
WARP = 32


def _runs(tok: np.ndarray) -> np.ndarray:
    x = tok.astype(np.int64)
    return np.where(x < 0, 0, np.where(x & MATCH, (x >> 16) & 0x3FF, 1))


class _Block:
    """One block of the place pass: its segment's staged tokens and sums,
    advanced phase by phase (``step``) in whatever order the scheduler
    picks, blocked where the kernel would spin."""

    def __init__(self, sim, ticket: int):
        self.sim, self.lane, self.seg = sim, ticket // sim.nseg, ticket % sim.nseg
        seg0 = self.seg * sim.seg_len
        sl = slice(seg0, seg0 + sim.seg_len)
        self.x, self.run, self.valid = sim.tok[self.lane, sl].astype(np.int64), sim.runs[self.lane, sl], \
            sim.valid[self.lane, sl]
        self.agg = (int(self.run.sum()), int(self.valid.sum()))
        if self.agg[1]:
            # threads of `per` consecutive tokens: their sums, a block scan, then each thread's chain
            starts = np.arange(0, len(self.x), sim.per)
            ex_b = np.concatenate([[0], np.cumsum(np.add.reduceat(self.run, starts))[:-1]])
            ex_c = np.concatenate([[0], np.cumsum(np.add.reduceat(self.valid, starts))[:-1]])
            th = np.arange(len(self.x)) // sim.per
            first = starts[th]
            cb, cv = np.cumsum(self.run) - self.run, np.cumsum(self.valid) - self.valid
            self.ex_bytes = ex_b[th] + cb - cb[first]
            self.ex_count = ex_c[th] + cv - cv[first]
        self.phase, self.excl, self.top = "publish", (0, 0), self.seg - 1

    def step(self) -> bool:
        """Advance one phase; False where the kernel would spin."""
        return getattr(self, "_" + self.phase)()

    def _publish(self):
        st = self.sim.status[self.lane]
        st[self.seg] = ("P", self.agg) if self.seg == 0 else ("A", self.agg)
        self.phase = "seams" if self.seg == 0 else "look_back"
        return True

    def _look_back(self):
        """One round: WARP lanes of `items` status words each, 32 * items
        predecessors back from top, folded down to the nearest inclusive
        prefix; every word of the round must be published."""
        sim, st = self.sim, self.sim.status[self.lane]
        lo = self.top - WARP * sim.items  # the round reads (lo, top]
        if any(w is None for w in st[max(lo + 1, 0) : self.top + 1]):
            return False
        x, found = (0, 0), lo < 0
        for j in range(self.top, max(lo, -1), -1):  # nearest first, down to the nearest prefix
            flag, v = st[j]
            x = sim.op(x, v)
            if flag == "P":
                found = True
                break
        self.excl = sim.op(self.excl, x)
        if found:
            st[self.seg] = ("P", sim.op(self.excl, self.agg))
            self.phase = "seams"
        else:
            self.top = lo
        return True

    def _seams(self):
        """Each crossing token publishes its tile's off and head, from the
        prefixes alone."""
        sim = self.sim
        pb, pc = self.excl
        self.s_off = {}
        self.phase = "wait"
        if not self.agg[1]:  # no valid token: no seam
            return True
        self.s = np.minimum(pb + self.ex_bytes, sim.cap)
        self.r = pc + self.ex_count
        e = self.s + self.run
        c = (self.s // N + 1) * N
        for k in np.flatnonzero((self.s < sim.TN) & (c <= e) & (c < sim.TN)):
            t, hd = int(c[k] // N), bool(e[k] > c[k])
            off = int(self.r[k]) + 1 - hd
            self.s_off[t] = off
            sim.put(sim.tiles, sim.tile_writes, (self.lane, t), off)
            if hd:
                sim.put(sim.out, sim.out_writes, (self.lane, t, 0), match(int(e[k] - c[k]), int(self.x[k]) & 0xFFFF))
        return True

    def _wait(self):
        """off(tf) of the tile the segment opens in, from an earlier block."""
        sim = self.sim
        pb, _pc = self.excl
        tf = pb // N
        if pb < sim.TN and tf > 0:
            if sim.tiles[self.lane, tf] == UNSET:
                return False
            self.s_off[tf] = int(sim.tiles[self.lane, tf])
        else:
            self.s_off[tf] = 0
        self.phase = "place"
        return True

    def _place(self):
        """Every valid token's value and slot, staged by rank and stored;
        the crossing tokens and the lane's last segment publish the filled
        lengths of the tiles they end."""
        sim, lane = self.sim, self.lane
        pb, pc = self.excl
        self.phase = "done"
        total = min(pb + self.agg[0], sim.cap)
        if self.seg == sim.nseg - 1 and total < sim.TN:
            tl = total // N
            sim.put(sim.fills, sim.fill_writes, (lane, tl), min(N, pc + self.agg[1] - self.s_off[tl]))
            for t in range(tl + 1, sim.T):
                sim.put(sim.fills, sim.fill_writes, (lane, t), 0)
        if self.agg[1]:
            self._store()
        return True

    def _store(self):
        sim, lane = self.sim, self.lane
        pb, pc = self.excl
        keep = (self.x >= 0) & (self.s < sim.TN)
        s, r, x, run = self.s[keep], self.r[keep], self.x[keep], self.run[keep]
        t = s // N
        off = np.array([self.s_off[int(u)] for u in t], np.int64)
        e, c = s + run, (t + 1) * N
        is_m = (x & MATCH) != 0
        val = np.where(is_m, np.where(c < e, MATCH | (c - s) << 16 | (x & 0xFFFF), x & FIELDS), x)
        for k in np.flatnonzero(c <= e):  # the token ends its tile
            sim.put(sim.fills, sim.fill_writes, (lane, int(t[k])), min(N, int(r[k]) + 1 - int(off[k])))
        slot = r - off
        ok = slot < N
        flat = sim.out[lane].reshape(-1)
        idx = t[ok] * N + slot[ok]
        flat[idx] = val[ok]
        np.add.at(sim.out_writes[lane].reshape(-1), idx, 1)


class _PadBlock:
    """A padding block: -1 over [max(n_t, lo), hi) of its tile once the
    tile's fill word is published (no wait for K = 0: n_t = 0)."""

    def __init__(self, sim, q: int):
        chunks = N // sim.pad
        self.sim, self.lane, self.t = sim, q // chunks // sim.T, q // chunks % sim.T
        self.lo, self.hi = q % chunks * sim.pad, (q % chunks + 1) * sim.pad
        self.phase = "pad"

    def step(self) -> bool:
        sim = self.sim
        n = 0
        if sim.tok.shape[1]:
            if sim.fills[self.lane, self.t] == UNSET:
                return False
            n = int(sim.fills[self.lane, self.t])
        lo = max(n, self.lo)
        sim.out[self.lane, self.t, lo : self.hi] = -1
        sim.out_writes[self.lane, self.t, lo : self.hi] += 1
        self.phase = "done"
        return True


class _SplitSim:
    """The kernel's blocks scheduled in a random interleaving (at most
    `resident` blocks at once, started in ticket order): the placing blocks,
    then the padding blocks."""

    def __init__(self, tok, T, seg_len, per, items, seed, pad=16384, resident=6):
        self.tok, self.T, self.seg_len, self.per, self.items, self.pad = tok, T, seg_len, per, items, pad
        L, K = tok.shape
        self.cap, self.TN = T * N + 1024, T * N
        self.nseg = -(-K // seg_len)
        self.runs, self.valid = _runs(tok), (tok >= 0).astype(np.int64)
        self.status = [[None] * self.nseg for _ in range(L)]
        self.tiles = np.full((L, T), UNSET, np.int64)
        self.tile_writes = np.zeros((L, T), np.int64)
        self.fills = np.full((L, T), UNSET, np.int64)
        self.fill_writes = np.zeros((L, T), np.int64)
        self.blocks = L * self.nseg + L * T * (N // pad)
        self.out = np.full((L, T, N), UNSET, np.int64)
        self.out_writes = np.zeros((L, T, N), np.int64)
        self.rng = random.Random(seed)
        self.resident = resident

    def op(self, a, b):
        """(bytes, count) pairs: bytes add saturating at cap, counts add."""
        return min(a[0] + b[0], self.cap), a[1] + b[1]

    def put(self, arr, writes, at, v):
        arr[at] = v
        writes[at] += 1

    def run(self):
        L, K = self.tok.shape
        place = L * self.nseg
        tickets, active = iter(range(self.blocks)), []
        more = True
        while more or active:
            while more and len(active) < self.resident:
                t = next(tickets, None)
                more = t is not None
                if more:
                    active.append(_Block(self, t) if t < place else _PadBlock(self, t - place))
            first = self.rng.randrange(len(active))
            for i in [(first + d) % len(active) for d in range(len(active))]:  # the first that can move moves
                b = active[i]
                if b.step():
                    if b.phase == "done":
                        active.pop(i)
                    break
            else:
                raise AssertionError("no block can move: the kernel would hang")
        assert (self.tile_writes[:, 1:] <= 1).all(), "a tile word written more than once"
        assert K == 0 or (self.fill_writes == 1).all(), "a fill word written other than once"
        assert (self.out_writes == 1).all(), "an output word written other than once"
        return self.out.astype(np.int32)


def mirror_split(tok: np.ndarray, T: int, seg_len: int, per: int, seed: int, items: int = 1,
                 pad: int = 16384) -> np.ndarray:
    return _SplitSim(tok, T, seg_len, per, items, seed, pad).run()


def _edge_lengths(tok: np.ndarray, T: int) -> list[int]:
    """Segment lengths that put lane 0's first straddler, first token
    ending on a seam and first -1 run at a segment's start or end."""
    x = tok[0].astype(np.int64)
    r = _runs(tok[:1])[0]
    e = np.cumsum(r)
    s = e - r
    cross = (s // N + 1) * N
    lens = {rs.TILE_SPLIT_SEGMENT, 7}
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
    lens = _edge_lengths(tok, T) if tok.shape[1] else [rs.TILE_SPLIT_SEGMENT]
    for i, seg_len in enumerate(lens):
        got = mirror_split(tok, T, seg_len, per=4 if seg_len % 4 == 0 else 3, seed=i, items=1 + 3 * (i % 2),
                           pad=16384 >> (i % 2))
        np.testing.assert_array_equal(got, want, err_msg=f"segments of {seg_len}")


def test_wrapper_checks():
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 5), dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 10), dtype=torch.int32)[:, ::2], 1)
    with pytest.raises(ValueError):
        rs.split_tiles_device(torch.zeros((2, 5), dtype=torch.int32), 0)
