"""Rows, references, NumPy mirrors and the shared tests of the port's match
finder (``tpu_deflate_torch.codec.encode._match_find``) on the CPU, where
its four kernel wrappers (``match_keys``, ``match_chain``, ``match_bucket``,
``match_select``) run their plain versions. ``test_torch_match_find.py``
runs the shared tests at quality 0 (with the tests of one quality only),
``test_torch_match_find_q1.py`` and ``_q2.py`` at qualities 1 and 2: one
file a quality, because the reference's ``jax.jit`` trace and compile
take most of each file's time and grow with the quality.

The port's plain pieces, composed, are held against:

- the eager ``_match_find`` they were factored from (copied below as
  ``_match_find_before``), on every row, lazy on and off;
- the JAX package's ``encode_jax._match_find`` under ``jax.jit`` on the
  CPU, lazy on and off (except on the head lane whose payload starts with
  zeros, where the reference's F1 fires: there the reference must differ);
- NumPy mirrors of ``csrc/match.cu``: ``td_match_chain``'s walk (each
  chunk split into a list a hash part, each list walked 32 entries a step
  with the peers of each step, the 16-bit heads and the rewrite of the
  stale ones every epoch), ``td_match_bucket``'s blocks (the tile's staged window of bytes
  and links, each thread's hops, early exits and byte compare of the
  zero-extended row, four bytes at a time) and ``td_match_select``'s
  blocks (equality bits, run lengths read a word at a time, the lazy
  neighbour at each block seam).

Two batches: 11 member rows of 4096 columns (text, records and runs of
``bench.make_corpus``, random bytes, zeros, two hash collisions, matches
running past ``lengths`` and past the row, lanes of length 0, 1 and 3) and
4 halo rows of 32 KiB + 16 KiB with ``hist`` = 32768 (a lane with some
history and a length below the row, a head lane, a lone repeat at distance
32768 and one at 32769, F1's head lane). The reference takes both in one
call a quality: the member rows zero-extended to the halo rows' width with
``hist`` = ``hstart`` = 0, which it treats as the rows alone (positions past
a lane's length are no candidates, the compare reads zeros past the row
either way, and ``limit`` clamps every run at the lane's length). The match
finder is integer-only: exact equality everywhere."""

from __future__ import annotations

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tpu_deflate.codec import encode_jax as ej
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.codec import parse as pp
from tpu_deflate_torch.codec.decode_kernels import wrap_int32

S_MEMBER = 4096
H = 32768
S_HALO = H + 16384
M32 = 0xFFFFFFFF
BATCHES = ("member", "halo")


def _cu_const(name: str) -> int:
    """A constant of csrc/match.cu, so that the mirrors follow the kernels."""
    path = os.path.join(os.path.dirname(pe.__file__), "..", "csrc", "match.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


SEL_B = _cu_const("SEL_B")
MAX_WORDS = _cu_const("MAX_WORDS")
MAX_DIST = _cu_const("MAX_DIST")
CHAIN_PART_BITS = _cu_const("CHAIN_PART_BITS")
CHAIN_CHUNK = _cu_const("CHAIN_CHUNK")
CHAIN_EPOCH = _cu_const("CHAIN_EPOCH")
CHAIN_SENTINEL_BACK = _cu_const("CHAIN_SENTINEL_BACK")
BUCKET_TILE = _cu_const("BUCKET_TILE")


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _corpus() -> np.ndarray:
    return np.frombuffer(bench.make_corpus(8), np.uint8)


def _collision(rng, mask: int) -> tuple[np.ndarray, np.ndarray]:
    """Two little-endian windows (4 bytes) whose 16-bit hashes of ``w &
    mask`` are equal while their first bytes differ."""
    w = rng.integers(0, 2**32, 1 << 17, dtype=np.uint64)
    h = (((w & mask) * 2654435761) & M32) >> 16
    first = {}
    for i, hv in enumerate(h.tolist()):
        j = first.setdefault(hv, i)
        if j != i and (int(w[i]) ^ int(w[j])) & 0xFF:
            return (np.array([w[j]], "<u4").view(np.uint8), np.array([w[i]], "<u4").view(np.uint8))
    raise AssertionError("no collision found")


def _member_batch():
    """(data (11, S_MEMBER) uint8, lengths (11,) int32): the lanes of the
    module docstring, each with bytes past its length."""
    corpus = _corpus()
    rng = np.random.default_rng(14)
    S = S_MEMBER
    rows = [corpus[:S], corpus[(2 << 20) + 5000 :][:S], corpus[(4 << 20) + 3000 :][:S],
            rng.integers(0, 256, S, dtype=np.uint8), np.zeros(S, np.uint8)]
    lengths = [S] * 5
    # Hash collisions: at base + 400 the nearest same-hash candidate (base
    # + 200) matches no byte and the next (base) matches 16; the same for
    # the 3-byte hash, whose windows differ in their fourth byte.
    coll = rng.integers(0, 256, S, dtype=np.uint8)
    for (a, b), base, mask in ((_collision(rng, M32), 200, M32), (_collision(rng, 0xFFFFFF), 2000, 0xFFFFFF)):
        tail = rng.integers(0, 256, 12, dtype=np.uint8)
        for at, w in ((base, a), (base + 200, b), (base + 400, a)):
            coll[at : at + 4] = w
            coll[at + 4 : at + 16] = tail
            if mask != M32:
                coll[at + 3] = at & 0xFF
    rows.append(coll)
    lengths.append(S)
    # Matches and a run crossing the lane's length (the row's own bytes after it).
    past_len = corpus[100_000 :][:S].copy()
    past_len[2950:3100] = ord("a")
    rows.append(past_len)
    lengths.append(3000)
    # A match running past the row: its source is followed by zeros, its
    # copy ends at column S and compares with the zero extension.
    past_s = rng.integers(1, 256, S, dtype=np.uint8)
    past_s[1040:1110] = 0
    past_s[S - 40 :] = past_s[1000:1040]
    rows.append(past_s)
    lengths.append(S)
    for n in (0, 1, 3):
        rows.append(corpus[n * 777 :][:S])
        lengths.append(n)
    return np.stack(rows), np.asarray(lengths, np.int32)


# Halo lanes: (hstart, length) of each.
HALO_LANES = ((12345, H + 16000), (H, S_HALO), (0, S_HALO), (H, S_HALO))
F1_LANE = 3
NEAR, FAR = (100, H), (5000, H + 1)  # (source column, distance) of the two lone repeats


def _halo_batch():
    """(data (4, S_HALO) uint8, lengths, hist, hstart) as the continuous
    encode's rows: row padding before hstart is zeros."""
    corpus = _corpus()
    rng = np.random.default_rng(15)
    data = np.zeros((4, S_HALO), np.uint8)
    hstart = np.array([h for h, _n in HALO_LANES], np.int32)
    lengths = np.array([n for _h, n in HALO_LANES], np.int32)
    data[0, hstart[0] :] = corpus[50_000 :][: S_HALO - hstart[0]]
    data[1, H:] = corpus[900_000 :][: S_HALO - H]
    data[2] = rng.integers(0, 256, S_HALO, dtype=np.uint8)
    for src, dist in (NEAR, FAR):
        data[2, src + dist : src + dist + 16] = data[2, src : src + 16]
    data[3, H + 50 :] = corpus[300_000 :][: S_HALO - H - 50]
    return data, lengths, np.full(4, H, np.int32), hstart


@functools.lru_cache(maxsize=None)
def batch(name: str):
    """(data, lengths, hist, hstart) of a batch as numpy arrays (hist and
    hstart None for the member rows)."""
    if name == "member":
        return (*_member_batch(), None, None)
    return _halo_batch()


def torch_args(name: str):
    return tuple(None if a is None else torch.from_numpy(a) for a in batch(name))


# ---------------------------------------------------------------------------
# The match finder as it was
# ---------------------------------------------------------------------------


def _bucket_best_before(h, w32i, K, nwords):
    """``encode._bucket_best`` as it was: the stable sort of the hashes
    inside, the window words gathered into sorted order."""
    L, S = h.shape
    cap = 4 * nwords
    sorted_h, order = torch.sort(h, dim=1, stable=True)
    sw = []
    for j in range(nwords):
        src = order + 4 * j
        sw.append(torch.where(src < S, w32i.gather(1, src.clamp(max=S - 1)), 0))
    si = torch.arange(S).expand(L, S)
    changed = torch.ones_like(sorted_h, dtype=torch.bool)
    changed[:, 1:] = sorted_h[:, 1:] != sorted_h[:, :-1]
    rank = si - torch.cummax(torch.where(changed, si, -1), dim=1).values
    live = sorted_h != -1

    def lcpv(k):
        total = pe._word_eqlen(sw[0] ^ pe._shr(sw[0], k))
        full = total == 4
        for j in range(1, nwords):
            lj = pe._word_eqlen(sw[j] ^ pe._shr(sw[j], k))
            total = total + torch.where(full, lj, 0)
            full = full & (lj == 4)
        return total

    blen = torch.zeros((L, S), dtype=torch.int32)
    bcand = torch.full((L, S), -1, dtype=torch.int64)
    for k in range(1, K + 1):
        cand = pe._shr(order, k, -1)
        dist = order - cand
        ok = live & (rank >= k) & (dist >= 1) & (dist <= 32 * 1024)
        lc = torch.where(ok, lcpv(k), 0)
        better = lc > blen
        blen = torch.where(better, lc, blen)
        bcand = torch.where(better, cand, bcand)
    p1 = (bcand + 1) | (blen.clamp(max=cap).to(torch.int64) << 32)
    return torch.empty_like(p1).scatter_(1, order, p1)


def _match_find_before(data, lengths, quality, hist=None, hstart=None) -> dict:
    """``encode._match_find`` as it was (one chain of eager ops), for lazy
    False and True from one pass: {lazy: (use, dist, step, valid)}."""
    q = pe._QUALITY[quality]
    L, S = data.shape
    idx = torch.arange(S, dtype=torch.int32).expand(L, S)
    valid = idx < lengths[:, None]
    if hstart is not None:
        valid &= idx >= hstart[:, None]
    w32 = pe._u32_windows(data)
    w32i = wrap_int32(w32).to(torch.int32)

    q1 = _bucket_best_before(pe._hash(w32, valid), w32i, q["K4"], q["W4"])
    q3 = _bucket_best_before(pe._hash(w32 & 0xFFFFFF, valid), w32i, q["K3"], q["W3"])
    limit = (lengths[:, None] - idx).clamp(max=258)
    l1, d1 = pe._unpack_best(q1, idx)
    l3, d3 = pe._unpack_best(q3, idx)
    take3 = (l3 > l1) | ((l3 == l1) & (l3 > 0) & (d3 < d1))
    run = torch.minimum(torch.where(take3, l3, l1), limit)
    dist = torch.where(take3, d3, d1)
    if "K6" in q:
        ext6 = torch.cat([data, data.new_zeros((L, 6))], dim=1).to(torch.int64)
        b45 = ext6[:, 4 : S + 4] | (ext6[:, 5 : S + 5] << 8)
        q6 = _bucket_best_before(pe._hash(w32 ^ pe._mul32(b45, pe._H6_MUL), valid), w32i, q["K6"], q["W6"])
        l6, d6 = pe._unpack_best(q6, idx)
        l6 = torch.minimum(l6, limit)
        take6 = (l6 > run) | ((l6 == run) & (l6 > 0) & (d6 < dist))
        run = torch.where(take6, l6, run)
        dist = torch.where(take6, d6, dist)
    d32 = data.to(torch.int32)
    rle_run = torch.zeros((L, S), dtype=torch.int32)
    rle_dist = torch.zeros((L, S), dtype=torch.int32)
    for d in range(1, 5):
        eq = d32 == pe._shr(d32, d, -1)
        if hstart is not None:
            eq &= idx >= hstart[:, None] + d
        rl = torch.minimum(pe._suffix_runlen(eq), limit)
        better = rl > rle_run
        rle_run = torch.where(better, rl, rle_run)
        rle_dist = torch.where(better, d, rle_dist)
    take_rle = (rle_run >= 3) & ((rle_run > run) | ((rle_run == run) & (rle_dist < dist)))
    run = torch.where(take_rle, rle_run, run).clamp(max=pp.PARSE_MAX_STEP)
    dist = torch.where(take_rle, rle_dist, dist)
    good = (run >= 4) | ((run == 3) & (dist <= 4096))
    filtered = torch.where(good, run, 0)
    dist = torch.where(good, dist, 0)
    out = {}
    for lazy in (False, True):
        use, v, dd = filtered, valid.clone(), dist
        if lazy:
            nxt_run = torch.cat([use[:, 1:], use.new_zeros((L, 1))], dim=1)
            use = torch.where((use > 0) & (nxt_run > use), 0, use)
        if hist is not None:
            in_payload = idx >= hist[:, None]
            use = torch.where(in_payload, use, 0)
            dd = torch.where(in_payload, dd, 0)
            v &= in_payload
        out[lazy] = (use, dd, torch.where(use > 0, use, 1), v)
    return out


# ---------------------------------------------------------------------------
# Outputs of one quality
# ---------------------------------------------------------------------------


class MatchFind:
    """The port's, the eager copy's and the reference's outputs on both
    batches at one quality, each computed once (a module's fixture)."""

    def __init__(self, quality: int):
        self.quality = quality
        self.q = pe._QUALITY[quality]

    @functools.cache
    def families(self) -> tuple:
        """(family, K, nwords) of each hash family at this quality."""
        return tuple((fam, self.q[k], self.q[w]) for fam, k, w in pe._FAMILIES if k in self.q)

    @functools.cache
    def keys(self, name: str) -> torch.Tensor:
        """The batch's hash keys (F, L, S), as ``_match_find`` takes them."""
        data, lengths, _hist, hstart = torch_args(name)
        return pe.match_keys(data, lengths, tuple(f for f, _k, _w in self.families()), hstart)

    @functools.cache
    def links(self, name: str) -> torch.Tensor:
        """``match_chain`` on the keys: (F, L, S) uint16."""
        return pe.match_chain(self.keys(name))

    @functools.cache
    def packs(self, name: str) -> dict:
        """{family: packed best matches} (``match_bucket`` on the links)."""
        fams = self.families()
        out = pe.match_bucket(self.links(name), torch_args(name)[0], tuple(k for _f, k, _w in fams),
                              tuple(w for _f, _k, w in fams))
        return {fam: out[i] for i, (fam, _k, _w) in enumerate(fams)}

    @functools.cache
    def port(self, name: str, lazy: bool):
        """(use, dist, step, valid) of the three plain pieces composed."""
        data, lengths, hist, hstart = torch_args(name)
        p = self.packs(name)
        return pe.match_select(data, lengths, lazy, p[pe.FAMILY_4], p[pe.FAMILY_3], p.get(pe.FAMILY_6), hist,
                               hstart)

    @functools.cache
    def before(self, name: str) -> dict:
        return _match_find_before(*torch_args(name)[:2], self.quality, *torch_args(name)[2:])

    @functools.cache
    def reference(self) -> dict:
        """{(batch, lazy): (use, dist, step, valid)} of ``encode_jax._match_find``
        under one ``jax.jit`` for both batches and lazy settings, as numpy
        arrays (the member rows zero-extended, with hist = hstart = 0)."""
        member, halo = batch("member"), batch("halo")
        L = member[0].shape[0]
        data = np.zeros((L + halo[0].shape[0], S_HALO), np.uint8)
        data[:L, :S_MEMBER] = member[0]
        data[L:] = halo[0]
        zeros = np.zeros(L, np.int32)
        hist, hstart = np.concatenate([zeros, halo[2]]), np.concatenate([zeros, halo[3]])
        arrays = [jnp.asarray(a) for a in (data, np.concatenate([member[1], halo[1]]), hist, hstart)]
        quality = self.quality

        def both(d, n, hi, hs):
            return {lazy: ej._match_find(d, n, lazy, quality, hi, hs) for lazy in (False, True)}

        # XLA's backend optimisations change no integer result and take a
        # third of the compile.
        compiled = jax.jit(both).lower(*arrays).compile(compiler_options={"xla_backend_optimization_level": 0})
        # The reference leaves the history columns in valid (its
        # analyze_device masks its tokens with hist); the port's valid
        # excludes them.
        payload = np.arange(S_HALO)[None, :] >= hist[:, None]
        out = {}
        for lazy, (use, dist, step, valid) in compiled(*arrays).items():
            arr = [np.asarray(use), np.asarray(dist), np.asarray(step), np.asarray(valid) & payload]
            out["member", lazy] = tuple(a[:L, :S_MEMBER] for a in arr)
            out["halo", lazy] = tuple(a[L:] for a in arr)
        return out


@pytest.fixture(scope="module")
def mf(request):
    """The outputs at the test module's ``QUALITY``."""
    return MatchFind(request.module.QUALITY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the module runs (several test workers
    share a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_equal(got, want, lanes=None) -> None:
    for name, g, w in zip(("use", "dist", "step", "valid"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        if lanes is not None:
            g, w = g[lanes], w[lanes]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{name} differs at {bad[:5].tolist()}: {g[tuple(bad[0])]} != {w[tuple(bad[0])]}"


# ---------------------------------------------------------------------------
# NumPy mirrors of csrc/match.cu
# ---------------------------------------------------------------------------


def _low_bit(x: np.ndarray) -> np.ndarray:
    """Index of the lowest set bit of each nonzero x (``__ffs(x) - 1``)."""
    return np.log2((x & (~x + np.uint64(1))).astype(np.float64)).astype(np.int64)


def _prefix_len(rw: np.ndarray, lane: np.ndarray, a: np.ndarray, b: np.ndarray, nwords: int) -> np.ndarray:
    """``prefix_len`` for each (lane, a, b): two aligned words and a funnel
    shift a side, stopping at the first differing word."""
    pa, pb = a >> 2, b >> 2
    sa, sb = ((a & 3) * 8).astype(np.uint64), ((b & 3) * 8).astype(np.uint64)
    out = np.full(a.shape, 4 * nwords, np.int64)
    live = np.arange(a.size)
    for w in range(nwords):
        la, lb = lane[live], lane[live]
        va = ((rw[la, pa[live] + w + 1] << 32 | rw[la, pa[live] + w]) >> sa[live]) & M32
        vb = ((rw[lb, pb[live] + w + 1] << 32 | rw[lb, pb[live] + w]) >> sb[live]) & M32
        x = va ^ vb
        hit = x != 0
        out[live[hit]] = 4 * w + (_low_bit(x[hit]) >> 3)
        live = live[~hit]
    return out


def chain_mirror(keys: np.ndarray, rewrite: bool = True) -> np.ndarray:
    """``match_chain_kernel``: keys (F, L, S) -> links (F, L, S) uint16, a
    row at a time, a chunk of CHAIN_CHUNK positions at a time. At each
    epoch's start the heads more than MAX_DIST behind it (all of them at 0)
    become the sentinel; the chunk's valid positions are split by hash part
    (the hash's top bits) into lists in position order, and each part's
    list is walked 32 entries a step: an entry's predecessor is its highest
    peer lane below it, else its 16-bit head, decoded as 1..65536 back; the
    group's last lane writes its position into the head. The links go to
    the chunk's stage, which must be written once at every position
    (0xFFFFF marks a position not written), then to the row.
    ``rewrite=False`` skips the rewrite of stale heads after the first
    epoch (to show what it prevents)."""
    F, L, S = keys.shape
    rows = keys.reshape(F * L, S).astype(np.int64)
    out = np.zeros((F * L, S), np.int64)
    lane = np.arange(32)
    below_mask = lane[None, :] < lane[:, None]  # [i, j]: j is below i
    above_mask = lane[None, :] > lane[:, None]
    shift = 16 - CHAIN_PART_BITS
    for r, row in enumerate(rows):
        head = np.zeros(65536, np.int64)
        for c0 in range(0, S, CHAIN_CHUNK):
            if c0 % CHAIN_EPOCH == 0:
                back = ((c0 - head - 1) & 0xFFFF) + 1
                stale = (c0 == 0) | (rewrite & (back > MAX_DIST))
                head = np.where(stale, (c0 - CHAIN_SENTINEL_BACK) & 0xFFFF, head)
            chunk = row[c0 : c0 + CHAIN_CHUNK]
            stage = np.full(chunk.size, 0xFFFFF, np.int64)
            stage[chunk < 0] = 0
            for part in range(1 << CHAIN_PART_BITS):
                offs = np.nonzero((chunk >= 0) & (chunk >> shift == part))[0]
                for s0 in range(0, offs.size, 32):
                    q = c0 + offs[s0 : s0 + 32]
                    h = row[q]
                    peers = h[:, None] == h[None, :]
                    below = peers & below_mask[: q.size, : q.size]
                    has_below = below.any(axis=1)
                    pred = q.size - 1 - np.argmax(below[:, ::-1], axis=1)
                    back = ((q - head[h] - 1) & 0xFFFF) + 1
                    d = np.where(has_below, q - q[pred], np.where(back <= MAX_DIST, back, 0))
                    last = ~(peers & above_mask[: q.size, : q.size]).any(axis=1)
                    head[h[last]] = q[last]
                    assert (stage[q - c0] == 0xFFFFF).all(), "a position written twice"
                    stage[q - c0] = d
            assert (stage <= 0xFFFF).all(), "a position not written"
            out[r, c0 : c0 + chunk.size] = stage
    return out.astype(np.uint16).reshape(F, L, S)


def bucket_mirror(prev: np.ndarray, data: np.ndarray, ks: tuple, ws: tuple) -> np.ndarray:
    """``match_bucket_kernel``, block by block of BUCKET_TILE positions: the
    block's window w0 = max(0, t0 - MAX_DIST) staged (the bytes to 68 past
    the tile, rounded to 16, zeros past S; the links up to the tile's end),
    then each position's hops along the staged links: stop at a link of 0
    or a candidate more than MAX_DIST back; a longer prefix replaces the
    best; stop once the cap matched."""
    F, L, S = prev.shape
    out = np.zeros((F, L, S), np.int64)
    for t0 in range(0, S, BUCKET_TILE):
        t1 = min(S, t0 + BUCKET_TILE)
        w0 = max(0, t0 - MAX_DIST)
        nb = (t1 - w0 + 4 * MAX_WORDS + 4 + 15) & ~15
        win = np.zeros((L, nb), np.uint8)
        win[:, : min(S, w0 + nb) - w0] = data[:, w0 : w0 + nb]
        rw = win.view("<u4").astype(np.uint64)
        for f in range(F):
            links = prev[f, :, w0:t1].astype(np.int64)
            cap = 4 * ws[f]
            lane, p = np.nonzero(np.ones((L, t1 - t0), bool))
            p = p + t0
            c = p.copy()
            blen = np.zeros(lane.size, np.int64)
            bcand = np.full(lane.size, -1, np.int64)
            live = np.arange(lane.size)
            for _k in range(ks[f]):
                d = links[lane[live], c[live] - w0]
                live = live[d > 0]
                c[live] -= links[lane[live], c[live] - w0]
                live = live[p[live] - c[live] <= MAX_DIST]
                lc = _prefix_len(rw, lane[live], p[live] - w0, c[live] - w0, ws[f])
                better = lc > blen[live]
                blen[live[better]] = lc[better]
                bcand[live[better]] = c[live[better]]
                live = live[blen[live] < cap]
            out[f, lane, p] = np.where(blen > 0, (bcand + 1) | (blen << 32), 0)
    return out


def _run_lengths(bits: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``run_length``: the run of set bits from bit r of each lane's words
    (L, W), a word at a time, capped at 258."""
    lanes = np.arange(bits.shape[0])[:, None]
    w = r >> 5
    cur = bits[lanes, w] >> (r & 31).astype(np.uint64)
    avail = 32 - (r & 31)
    run = np.zeros(r.shape, np.int64)
    out = np.full(r.shape, -1, np.int64)
    while (out < 0).any():
        miss = ~cur & ((np.uint64(1) << avail.astype(np.uint64)) - np.uint64(1))
        hit = (out < 0) & (miss != 0)
        out = np.where(hit, np.minimum(run + _low_bit(np.where(hit, miss, 1)), 258), out)
        run = run + avail
        out = np.where((out < 0) & (run >= 258), 258, out)
        w = np.minimum(w + 1, bits.shape[1] - 1)
        cur = bits[lanes, w]
        avail = np.full(r.shape, 32)
    return out


def select_mirror(data, lengths, lazy, q4, q3, q6=None, hist=None, hstart=None):
    """``match_select_kernel``, block by block of SEL_B positions: the
    equality bits from the staged bytes, each position's filtered run (the
    block's last neighbour computed by the block), then the lazy deferral
    against the neighbour and the history masks."""
    L, S = data.shape
    nw = (SEL_B + 1 + 258 + 31) // 32 + 1
    d16 = data.astype(np.int16)
    hs = np.zeros(L, np.int64) if hstart is None else hstart.astype(np.int64)
    lanes = np.arange(L)[:, None]
    out = [np.zeros((L, S), np.int32) for _ in range(3)] + [np.zeros((L, S), bool)]
    for b0 in range(0, S, SEL_B):
        j = b0 + np.arange(32 * nw)[None, :]
        jc = np.minimum(j, S - 1)
        bits = []
        for d in range(1, 5):
            e = (j < S) & (j >= d) & (d16[lanes, jc] == d16[lanes, np.maximum(jc - d, 0)])
            if hstart is not None:
                e &= j >= hs[:, None] + d
            bits.append((e.reshape(L, nw, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=2))
        p = b0 + np.arange(SEL_B + 1)[None, :]
        inrow = p < S
        pc = np.minimum(p, S - 1)
        limit = np.minimum(258, lengths.astype(np.int64)[:, None] - p)

        def unpack(q):
            v = q[lanes, pc]
            cand = (v & M32) - 1
            return v >> 32, np.where(cand >= 0, p - cand, 0)

        l1, d1 = unpack(q4)
        l3, d3 = unpack(q3)
        take3 = (l3 > l1) | ((l3 == l1) & (l3 > 0) & (d3 < d1))
        run = np.minimum(np.where(take3, l3, l1), limit)
        dist = np.where(take3, d3, d1)
        if q6 is not None:
            l6, d6 = unpack(q6)
            l6 = np.minimum(l6, limit)
            take6 = (l6 > run) | ((l6 == run) & (l6 > 0) & (d6 < dist))
            run, dist = np.where(take6, l6, run), np.where(take6, d6, dist)
        r = np.broadcast_to(p - b0, run.shape)
        rle_run, rle_dist = np.zeros(run.shape, np.int64), np.zeros(run.shape, np.int64)
        for d in range(1, 5):
            rl = np.minimum(_run_lengths(bits[d - 1], r), limit)
            better = rl > rle_run
            rle_run, rle_dist = np.where(better, rl, rle_run), np.where(better, d, rle_dist)
        take = (rle_run >= 3) & ((rle_run > run) | ((rle_run == run) & (rle_dist < dist)))
        run = np.minimum(np.where(take, rle_run, run), pp.PARSE_MAX_STEP)
        dist = np.where(take, rle_dist, dist)
        good = (run >= 4) | ((run == 3) & (dist <= 4096))
        use_s = np.where(good & inrow, run, 0)
        dist = np.where(good, dist, 0)
        n = min(SEL_B, S - b0)
        u, dd = use_s[:, :n], dist[:, :n]
        if lazy:
            u = np.where((u > 0) & (use_s[:, 1 : n + 1] > u), 0, u)
        pn = p[:, :n]
        v = (pn < lengths[:, None]) & (pn >= hs[:, None])
        if hist is not None:
            inp = pn >= hist[:, None]
            u, dd, v = np.where(inp, u, 0), np.where(inp, dd, 0), v & inp
        for o, x in zip(out, (u, dd, np.where(u > 0, u, 1), v)):
            o[:, b0 : b0 + n] = x
    return tuple(out)


# ---------------------------------------------------------------------------
# The tests of one quality (each test module sets QUALITY and imports them)
# ---------------------------------------------------------------------------

LAZY_CASES = [(b, lazy) for b in BATCHES for lazy in (False, True)]


@pytest.mark.parametrize("name,lazy", LAZY_CASES)
def test_plain_pieces_equal_before(mf, name, lazy):
    """The three plain pieces, composed, equal the eager match finder they
    were factored from."""
    assert_equal(mf.port(name, lazy), mf.before(name)[lazy])


@pytest.mark.parametrize("name,lazy", LAZY_CASES)
def test_plain_pieces_equal_reference(mf, name, lazy):
    """... and the reference's jitted ``_match_find`` (F1's lane aside)."""
    lanes = [i for i in range(len(batch(name)[1])) if not (name == "halo" and i == F1_LANE)]
    assert_equal(mf.port(name, lazy), mf.reference()[name, lazy], lanes)


def test_f1_lane_differs_from_reference(mf):
    """On the head lane whose payload starts with 50 zeros the reference's
    RLE lanes match the row padding before it (F1); the port's do not."""
    use = mf.port("halo", True)[0][F1_LANE].numpy()
    ref = mf.reference()["halo", True][0][F1_LANE]
    assert ref[H] == 50 and use[H] == 0 and use[H + 1] == 49


def test_distance_limit(mf):
    """A lone repeat at distance 32768 is found; one at 32769 is not."""
    use, dist, _step, _valid = (t[2].numpy() for t in mf.port("halo", True))
    (src, d_near), (src_far, d_far) = NEAR, FAR
    assert dist[src + d_near] == d_near and use[src + d_near] >= 16
    assert dist[src_far + d_far] != d_far


def test_match_find_composes_the_pieces(mf):
    """``_match_find`` on CPU tensors is the pieces composed (member rows)."""
    data, lengths, _hist, _hs = torch_args("member")
    assert_equal(pe._match_find(data, lengths, True, mf.quality), mf.port("member", True))


@pytest.mark.parametrize("name", BATCHES)
def test_bucket_mirror(mf, name):
    """The bucket kernel's blocks equal the plain version for every family."""
    fams = mf.families()
    mirror = bucket_mirror(mf.links(name).numpy(), batch(name)[0], tuple(k for _f, k, _w in fams),
                           tuple(w for _f, _k, w in fams))
    for i, (fam, _k, _w) in enumerate(fams):
        assert np.array_equal(mirror[i], mf.packs(name)[fam].numpy()), f"family {fam}"


@pytest.mark.parametrize("name,lazy", LAZY_CASES)
def test_select_mirror(mf, name, lazy):
    """The select kernel's blocks equal the plain version, seams included."""
    data, lengths, hist, hstart = batch(name)
    p = {f: v.numpy() for f, v in mf.packs(name).items()}
    mirror = select_mirror(data, lengths, lazy, p[pe.FAMILY_4], p[pe.FAMILY_3], p.get(pe.FAMILY_6), hist, hstart)
    assert_equal(mirror, [t.numpy() for t in mf.port(name, lazy)])
