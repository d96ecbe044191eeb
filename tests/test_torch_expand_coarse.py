"""A mirror of K5's algorithm (csrc/expand.cu), written here in NumPy: one
block of 512 threads per lane, a thread taking 16 consecutive token slots
or positions, one block scan per chunk of 8192, and the lane's positions in
two halves of 32768. Pass 1 gives each token its start (a sum scan of token
sizes), writes one record at the start if it lies in the half, a bit per
oversized-distance match start, and the token's record as the cover of
position b - 1 for each 16-position boundary b it reaches; the first half
stops after the chunk whose tokens reach past it, and the second half reads
again from that chunk. Pass 2 walks each thread's 16 positions from the
cover of its first position's predecessor: distances, region breaks, a block
max-scan of each thread's last break for the region start A, then y0 and
src, with (p - A) / d divided at most once a thread and stepped after, and
32768 / d divided only where the cap on k binds.

The mirror is held equal to the port's plain version ``resolve.expand_plain``
and to the JAX package's Pallas kernel in interpret mode on the resolve
tests' cases, a lane of only 258-runs, literal-only lanes, a long
constant-distance region that crosses every chunk and the halves, a total
above 65536, history of 0 and 32768, and lanes whose tokens put starts and
covers on the chunk, half and 16-position edges; and to the plain version
alone on a lane with size-0 tokens between real ones. The resolve is
integer-only, so every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_deflate.codec import resolve_pallas as rp

from test_torch_resolve import CASES, _case, _lane
from tpu_deflate_torch.codec import resolve as rs

N = rs.N_POS
MATCH = rs.TOKEN_MATCH_BIT
THREADS, PER = 512, 16
CHUNK = THREADS * PER  # 8192 token slots or positions
N_CHUNKS = N // CHUNK
HALF = N // 2
LIT = 0x8100  # a literal record: LIT | byte; a match record is (dist-1 & 0x7FFF) + 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_parse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(v: np.ndarray) -> np.ndarray:
    return np.where(v < 0, 0, np.where(v >= 256, (v >> 16) & 0x3FF, 1))


def _excl(x: np.ndarray, op, identity: int) -> np.ndarray:
    """A block's exclusive scan over its threads (axis 0)."""
    return np.concatenate([[identity], op.accumulate(x)[:-1]])


def _pass1(v, total, lo, hi, ent, big, cov):
    """One chunk of pass 1 (v: (THREADS, PER) token values): records,
    big-distance bits and covers of the half [lo, hi); returns the chunk's
    output bytes."""
    size = _sizes(v)
    mine = size.sum(1)
    starts = total + _excl(mine, np.add, 0)[:, None] + np.cumsum(size, 1) - size
    e = np.where(v >= 256, (v & 0x7FFF) + 1, LIT | (v & 0xFF))
    placed = (size > 0) & (starts < hi)
    here = placed & (starts >= lo)
    ent[starts[here] - lo] = e[here]
    big[starts[here & (v >= 256) & ((v & 0xFFFF) >= 0x8000)] - lo] = True
    # Covers: each boundary b of the half with start < b <= start + size.
    b0 = np.maximum((starts // PER + 1) * PER, lo)
    last = np.minimum(starts + size, hi - 1)
    n = np.where(placed & (last >= b0), (last - b0) // PER + 1, 0).ravel()
    owner = np.repeat(np.arange(n.size), n)
    b = b0.ravel()[owner] + PER * (np.arange(owner.size) - np.repeat(np.cumsum(n) - n, n))
    assert (cov[(b - lo) // PER] == -1).all(), "a boundary's cover written twice in one half"
    cov[(b - lo) // PER] = e.ravel()[owner]
    return int(mine.sum())


def mirror_expand_lane(tok: np.ndarray, hist: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """K5 on one lane: (y0, src, summary row, what ran: the chunks each
    half's pass 1 read, the divisions pass 2 made at threads' first
    positions and where the cap on k bound)."""
    tok = tok.astype(np.int64)
    y0 = np.zeros(N, np.int64)
    src = np.zeros(N, np.int64)
    cross, pre_cross, total = N_CHUNKS, 0, 0
    a_carry, err_pos, unres = -1, N, 0
    ran = {"chunks": ([], []), "divisions": 0, "cap_divisions": 0}
    for h in range(2):
        lo, hi = h * HALF, (h + 1) * HALF
        ent = np.zeros(HALF, np.int64)
        big = np.zeros(HALF, bool)
        cov = np.full(HALF // PER, -1, np.int64)  # -1: not written
        c = 0 if h == 0 else cross
        if c < N_CHUNKS:
            total = 0 if h == 0 else pre_cross
        while c < N_CHUNKS:
            ran["chunks"][h].append(c)
            chunk_total = _pass1(tok[c * CHUNK : (c + 1) * CHUNK].reshape(THREADS, PER), total, lo, hi,
                                 ent, big, cov)
            if h == 0 and total + chunk_total >= HALF:
                cross, pre_cross = c, total
                total += chunk_total
                break
            total += chunk_total
            c += 1

        for pc in range(HALF // CHUNK):
            b = lo + pc * CHUNK + PER * np.arange(THREADS)
            e = ent[(b - lo)[:, None] + np.arange(PER)]
            bigs = big[(b - lo)[:, None] + np.arange(PER)]
            need = (b > 0) & (b - 1 < total)
            assert (cov[(b - lo) // PER][need] >= 0).all(), "a cover read before it was written"
            before = np.where(need, cov[(b - lo) // PER], 0)
            cd_before = np.where(b == 0, -1, np.where(before < LIT, before, 0))

            def dist(cur, j):
                cur = np.where(e[:, j] != 0, e[:, j], cur)
                cd = np.where((b + j < total) & (e[:, j] < LIT), cur, 0)
                assert ((cd >= 0) & (cd <= 0x8000)).all(), "an in-stream position without a match cover"
                return cur, cd

            # The thread's last break, over all its positions; the kernel
            # looks at its records only (inside the stream only a record
            # can break, past it every position does), which must agree.
            cur, cdp, last_brk = before, cd_before, np.full(THREADS, -1)
            rec_cdp, by_records = cd_before, np.full(THREADS, -1)
            for j in range(PER):
                cur, cd = dist(cur, j)
                last_brk = np.where((cd != cdp) | (cd == 0), b + j, last_brk)
                cdp = cd
                rec = e[:, j] != 0
                rec_cd = np.where(e[:, j] < LIT, e[:, j], 0)
                by_records = np.where(rec & ((rec_cd == 0) | (rec_cd != rec_cdp)), b + j, by_records)
                rec_cdp = np.where(rec, rec_cd, rec_cdp)
            by_records = np.where(b + PER - 1 >= total, b + PER - 1, by_records)
            np.testing.assert_array_equal(by_records, last_brk)
            A = np.maximum(a_carry, _excl(last_brk, np.maximum, -1))
            a_carry = max(a_carry, int(last_brk.max()))

            cur, cdp = before, cd_before
            r = np.zeros(THREADS, np.int64)  # (p - A) mod d
            kd = np.zeros(THREADS, np.int64)  # ((p - A) // d + 1) d
            for j in range(PER):
                p = b + j
                cur, cd = dist(cur, j)
                brk = (cd != cdp) | (cd == 0)
                safe = np.maximum(cd, 1)
                A = np.where(brk, p, A)
                if j == 0:  # a region that goes on from the thread before: divide once
                    ran["divisions"] += int((~brk).sum())
                    r = np.where(brk, 0, (p - A) % safe)
                    kd = np.where(brk, cd, ((p - A) // safe + 1) * cd)
                else:
                    r = np.where(brk, 0, r + 1)
                    wrap = ~brk & (r == cd)
                    r = np.where(wrap, 0, r)
                    kd = np.where(brk, cd, np.where(wrap, kd + cd, kd))
                cdp = cd
                m = cd > 0
                err = m & ((A - cd + r < -hist) | bigs[:, j])
                ok = m & ~err
                cap = ok & (kd > rs.W_CAP)  # only here is W_CAP / d divided
                ran["cap_divisions"] += int(cap.sum())
                y0[p] = np.where(ok, -1, np.where(m, 0, np.where(p < total, e[:, j] & 0xFF, 0)))
                src[p] = np.where(ok, p - np.where(cap, rs.W_CAP // safe * cd, kd), p)
                if err.any():
                    err_pos = min(err_pos, int(p[err].min()))
                unres += int(ok.sum())
    summ = np.array([err_pos, total, unres, 0, 0, 0, 0, 0], np.int64)
    return y0, src, summ, ran


def mirror_expand(tok: np.ndarray, hist: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    outs = [mirror_expand_lane(row, hist)[:3] for row in tok]
    return tuple(np.stack([o[i] for o in outs]).astype(np.int32) for i in range(3))


def _edge_case(name: str) -> np.ndarray:
    """(L, N_POS) int32 token lanes at K5's own edges."""
    rng = np.random.default_rng(13)
    if name == "runs_258":  # only 258-runs, near and far, from position 0
        dists = [0, 3, 257, 4095, 32767]
        return np.stack([_lane([MATCH | 258 << 16 | d] * 300) for d in dists])
    if name == "literals":  # a full lane of literals (total exactly N), a short one
        return np.stack([_lane(rng.integers(0, 256, N).tolist()), _lane(rng.integers(0, 256, 5000).tolist())])
    if name == "long_region":  # one distance from position 5 past every chunk and the halves
        return np.stack([_lane([1, 2, 3, 4, 5] + [MATCH | 258 << 16 | 4] * 300),
                         _lane([9] * 40 + [MATCH | 200 << 16 | 39] * 400)])
    if name == "over_64k":  # totals far above N, with big runs of 1023 bytes
        lits = rng.integers(0, 256, 20000).tolist()
        return np.stack([_lane(lits + [MATCH | 1023 << 16 | 7] * 200),
                         _lane([MATCH | 300 << 16 | 1] * 60000)])
    if name == "half_edges":
        # The first half ends on a chunk's end (4 x 8192 literals) and
        # inside a chunk's last token; a run crosses position 32768; a
        # match straddles every 16-position boundary from a start of 15.
        lits = rng.integers(0, 256, 4 * CHUNK).tolist()
        return np.stack([
            _lane(lits + [MATCH | 100 << 16 | 9] * 200),
            _lane(lits[: 4 * CHUNK - 1] + [MATCH | 258 << 16 | 2] + lits[:3000]),
            _lane(lits[:15] + [MATCH | 17 << 16 | 14] * 2000 + [MATCH | 9 << 16 | 0x8003]),
        ])
    if name == "empty_tokens":  # size-0 tokens (padding, a run of 0) between real ones
        toks = np.where(rng.random(30000) < 0.6, rng.integers(0, 256, 30000),
                        MATCH | rng.integers(3, 259, 30000) << 16 | rng.integers(0, 2000, 30000))
        toks[rng.random(30000) < 0.1] = -1
        toks[rng.random(30000) < 0.05] = MATCH | 0 << 16 | 5
        return np.stack([_lane(toks.tolist())])
    raise KeyError(name)


EDGE_CASES = ("runs_258", "literals", "long_region", "over_64k", "half_edges", "empty_tokens")


def _check(tok: np.ndarray, hist: int, pallas: bool) -> None:
    got = mirror_expand(tok, hist)
    want = rs.expand_plain(torch.from_numpy(tok), hist)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    if not pallas:
        return
    ref = [np.asarray(a) for a in rp._expand_jit(tok, hist=hist, interpret=True)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2][:, :3], ref[2][:, :3])


@pytest.mark.parametrize("hist", [0, rs.TAIL])
@pytest.mark.parametrize("case", CASES + EDGE_CASES)
def test_mirror_matches_plain_and_pallas(case, hist):
    """Size-0 tokens between real ones are held against the plain version
    alone: the Pallas kernel moves each record by its start minus its slot,
    which assumes front-compacted tokens, and places them elsewhere."""
    _check(_case(case) if case in CASES else _edge_case(case), hist, pallas=case != "empty_tokens")


def test_halves_read_chunks_and_divide_as_designed():
    """The first half reads up to the chunk whose tokens reach past 32768
    and the second half from that chunk on; a lane whose output stays in
    the first half reads every chunk once; pass 2 divides at most once per
    thread and chunk."""
    tok = _edge_case("half_edges")
    _y0, _src, summ, ran = mirror_expand_lane(tok[0], 0)
    assert ran["chunks"] == ([0, 1, 2, 3], [3, 4, 5, 6, 7])  # 4 x 8192 literals end exactly at 32768
    _y0, _src, summ, ran = mirror_expand_lane(tok[1], 0)
    assert ran["chunks"] == ([0, 1, 2, 3], [3, 4, 5, 6, 7]) and summ[1] == 4 * CHUNK - 1 + 258 + 3000
    _y0, _src, summ, ran = mirror_expand_lane(_case("styles")[0], 0)
    assert summ[1] < HALF and ran["chunks"] == (list(range(N_CHUNKS)), [])
    _y0, _src, summ, ran = mirror_expand_lane(_edge_case("long_region")[0], 0)
    assert ran["chunks"] == ([0], [0, 1, 2, 3, 4, 5, 6, 7])  # 300 tokens fill both halves
    assert 0 < ran["divisions"] <= 2 * (HALF // CHUNK) * THREADS
    assert ran["cap_divisions"] > 0  # a region of one distance past 32 KiB
    _y0, _src, _summ, ran = mirror_expand_lane(_case("styles")[0], 0)
    assert ran["cap_divisions"] == 0
