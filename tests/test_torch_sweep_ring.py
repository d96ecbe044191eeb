"""A mirror of K6's algorithm (csrc/sweep.cu), written here in NumPy: one
block of 256 threads per lane walks the tile in 64 steps of 1024
positions, 4 consecutive ones a thread. A thread loads its own positions'
y0 and src two steps ahead (into registers on the card). The tile's
resolved bytes live in a 64 KiB buffer indexed by position; a source in the
tail is read from the tail itself. A position's initial state is its
literal byte, the final byte where its source lies before the step (and at
most 32768 back), a pointer where the source lies inside the step, or a
self pointer (an out-of-domain source, never resolved). A thread then
follows the in-step pointers through the initial states for up to CHASE
hops; what is left takes rounds of pointer doubling over the step until
nothing is pending (a pointer that reads itself back is stuck).

The mirror checks that each step reads the inputs prefetched for it and
that each read of a final byte finds a byte already written. It is held
equal to the port's plain version ``sweep_plain`` and to the JAX package's
Pallas kernel in interpret mode on the resolve tests' cases at hist 0 and
32768, and to the plain version on the sources written directly that
chip_smoke.py holds the card to (``chip_smoke.sweep_edge_inputs``): sources
exactly 32768 back at every step's edges, sources 700 back that cross
steps, chains of distance 1 (in-step chains of up to 1023 links, which need
the doubling rounds), random sources, and chains that hop back over each
step's edge.
Out-of-domain sources (more than 32768 back, forward, self) are held to a
serial walk with the same domain. The sweep is integer-only, so every
comparison is exact; the round count (status row 1) is a diagnostic and not
compared."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_deflate.codec import resolve_pallas as rp

from test_torch_resolve import CASES, _case
from tpu_deflate_torch.codec import resolve as rs

N = rs.N_POS
TAIL = rs.TAIL
STEP = 1024
AHEAD = 2  # steps loaded ahead
CHASE = 16
MAX_ROUNDS = 11


def mirror_sweep_lane(tail: np.ndarray, y0: np.ndarray, src: np.ndarray) -> tuple[np.ndarray, int, dict]:
    """K6 on one lane: (y, residue, what ran: steps whose chase left
    something pending, doubling rounds)."""
    tile = np.zeros(N, np.int64)
    written = np.zeros(N, bool)
    loaded = {s: (y0[s * STEP : (s + 1) * STEP], src[s * STEP : (s + 1) * STEP]) for s in range(AHEAD)}
    t = np.arange(STEP)
    y = np.zeros(N, np.int64)
    unres = 0
    ran = {"pending_steps": 0, "rounds": 0}
    for s in range(N // STEP):
        b0 = s * STEP
        p = b0 + t
        v, sr = loaded.pop(s)
        if s + AHEAD < N // STEP:
            loaded[s + AHEAD] = (y0[(s + AHEAD) * STEP : (s + AHEAD + 1) * STEP],
                                 src[(s + AHEAD) * STEP : (s + AHEAD + 1) * STEP])
        assert len(loaded) <= AHEAD
        before = (sr >= p - 32768) & (sr < b0)
        need = before & (v < 0) & (sr >= 0)
        assert written[sr[need]].all(), "a final byte read before it was written"
        fin = np.where(sr >= 0, tile[sr & (N - 1)], np.where(sr >= p - 32768, tail[np.clip(sr + TAIL, 0, TAIL - 1)] & 0xFF, 0))
        inside = (sr >= b0) & (sr < p)
        st = np.where(v >= 0, v, np.where(before, fin, np.where(inside, -1 - (sr - b0), -1 - t)))
        state = st.copy()
        cur = st.copy()
        active = cur < 0
        for _h in range(CHASE):
            if not active.any():
                break
            nxt = state[np.where(active, -1 - cur, 0)]
            stuck = active & (nxt == cur)
            cur = np.where(active & ~stuck, nxt, cur)
            active = active & ~stuck & (cur < 0)
        pend = (cur < 0) & (state[np.where(cur < 0, -1 - cur, 0)] != cur)
        ran["pending_steps"] += int(pend.any())
        r = 0
        while r < MAX_ROUNDS and pend.any():
            state = cur.copy()
            nxt = state[np.where(pend, -1 - cur, 0)]
            cur = np.where(pend, nxt, cur)
            pend = pend & (cur < 0) & (state[np.where(cur < 0, -1 - cur, 0)] != cur)
            r += 1
        ran["rounds"] += r
        unres += int((cur < 0).sum())
        out = np.where(cur < 0, 0, cur)
        assert not written[p].any()
        tile[p] = out & 0xFF
        written[p] = True
        y[p] = out
    return y, unres, ran


def mirror_sweep(tail, y0, src) -> tuple[np.ndarray, np.ndarray, list]:
    outs = [mirror_sweep_lane(*(np.asarray(a[i], np.int64) for a in (tail, y0, src))) for i in range(y0.shape[0])]
    return (np.stack([o[0] for o in outs]).astype(np.int32), np.array([o[1] for o in outs], np.int32),
            [o[2] for o in outs])


def _tail(L: int, hist: int) -> np.ndarray:
    rng = np.random.default_rng(9)
    return (rng.integers(0, 256, (L, TAIL)) if hist else np.zeros((L, TAIL))).astype(np.int32)


def _check_plain(tail, y0, src) -> list:
    y, resid, ran = mirror_sweep(tail, y0, src)
    want_y, want_st = rs.sweep_plain(*(torch.from_numpy(np.array(a)) for a in (tail, y0, src)))
    np.testing.assert_array_equal(y, want_y.numpy())
    np.testing.assert_array_equal(resid, want_st.numpy()[:, 0])
    return ran


@pytest.mark.parametrize("hist", [0, TAIL])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_plain_and_pallas(case, hist):
    tok = _case(case)
    y0, src, _summ = (np.asarray(a) for a in rp._expand_jit(tok, hist=hist, interpret=True))
    tail = _tail(tok.shape[0], hist)
    _check_plain(tail, y0, src)
    y, resid, _ran = mirror_sweep(tail, y0, src)
    ry, rst = (np.asarray(a) for a in rp._sweep_jit(tail, y0, src, interpret=True))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(resid, rst[:, 0])


@pytest.mark.parametrize("tail_bytes", [False, True])
@pytest.mark.parametrize("lane", range(5))
def test_mirror_matches_plain_on_direct_sources(lane, tail_bytes):
    """The lanes of chip_smoke.sweep_edge_inputs, one at a time."""
    y0, src = (a[lane : lane + 1] for a in chip_smoke.sweep_edge_inputs(N))
    ran = _check_plain(_tail(1, TAIL if tail_bytes else 0), y0, src)
    if lane == 2:  # distance-1 chains
        assert ran[0]["pending_steps"] > 0 and ran[0]["rounds"] > 0  # the chase alone does not finish


def serial_resolve(tail: np.ndarray, y0: np.ndarray, src: np.ndarray) -> tuple[np.ndarray, int]:
    """Position by position, in order: a literal, or the byte at a source in
    [p - 32768, p) that lies in an earlier step (final: an unresolved one
    holds 0) or that resolved; else unresolved (y = 0)."""
    byte = {q: int(tail[q + TAIL]) & 0xFF for q in range(-TAIL, 0)}
    ok = {q: True for q in range(-TAIL, 0)}
    y = np.zeros(N, np.int64)
    for q in range(N):
        s = int(src[q])
        if y0[q] >= 0:
            y[q], ok[q] = y0[q], True
        elif q - 32768 <= s < q and (ok[s] or s < q // STEP * STEP):
            y[q], ok[q] = (byte[s] if s < 0 else y[s]), True
        else:
            ok[q] = False
        byte[q] = int(y[q]) & 0xFF
    return y, sum(not ok[q] for q in range(N))


def test_out_of_domain_sources_stay_unresolved():
    """Sources 32769 back, forward, at the position itself, and positions
    whose sources are those (in the same step: unresolved too; in a later
    step: the 0 they hold): the mirror's residue and bytes equal a serial
    walk's."""
    rng = np.random.default_rng(4)
    p = np.arange(N)
    y0 = rng.integers(0, 256, N)
    src = p.copy()
    bad = rng.choice(np.arange(40000, N), 30, replace=False)
    y0[bad] = -1
    src[bad] = np.concatenate([bad[:10] - 32769, bad[10:20] + 5, bad[20:]])
    later = bad + rng.integers(1, 3000, bad.size)
    later = later[later < N]
    y0[later] = -1
    src[later] = later - (later - bad[: later.size])
    tail = _tail(1, TAIL)
    y, resid, _ran = mirror_sweep(tail, y0[None], src[None])
    want_y, want_resid = serial_resolve(tail[0], y0, src)
    assert resid[0] == want_resid > 0
    np.testing.assert_array_equal(y[0], want_y)
