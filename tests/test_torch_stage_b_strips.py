"""A mirror of K2's algorithm (csrc/stage_b.cu, stage B), written here in
NumPy. A lane's tiles are cut into strips of 32 neighbouring tiles (the
last one partial where NT is not a multiple of 32), a block each, a thread
per tile; the 512 positions into 4 segments of 128, a warp each. A warp
computes each position's exit from its segment's last position down, with
the exits of its last 64 positions in a ring: a hop of 1..63 reads the
ring, which starts out holding the exit offset k behind the last segment
and a marker 256 + k ("lands on position k of the next segment") behind the
others; EOB / error sentinels, deltas <= 0 and hops past the tile give
their own exit, and a hop of 64 or more that stays in the tile walks the
deltas forward. Then each entry 0..47 follows its markers through the next
segments' first 64 exits.

The mirror is held equal to the port's plain version
``decode_kernels.stage_b_plain`` and to the JAX package's Pallas kernel in
interpret mode on random deltas with sentinels, on a real wave (stage A of
profile streams with a garbage lane) and on a wave with deltas of 0 and 60,
hops of 200 and 5000 and dense sentinels; partial strips (NT of 1, 3, 45
and 100) against the plain version and the first NT tiles of the Pallas
kernel's 128-tile block; and deltas at the int32 limits against the plain
version alone (the reference adds in int32 there, the plain version does
not). The pipeline is integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import wave_prep as wp

TB = 32  # tiles per strip (block), a thread each
SEG = 128  # positions per segment (warp)
NSEG = 4
RING = 64  # exits a warp keeps per tile
MARK = 256  # marker base: lands on a position of the next segment
W_P, E_WIN = dk.W_P, dk.E_WIN
EOB, ERR = wp.SENT_EOB, wp.SENT_ERR


def strips(NT: int) -> list[tuple[int, int]]:
    """(first tile, tile count) of each strip of a lane, as the grid cuts them."""
    return [(t0, min(TB, NT - t0)) for t0 in range(0, NT, TB)]


def leave_exit(n: np.ndarray) -> np.ndarray:
    """The exit of a cursor at n >= 512."""
    return np.where(n >= 8192, ERR, np.where(n >= 4096, EOB, np.minimum(n - W_P, 255)))


def walk_exit(col: np.ndarray, n: int) -> int:
    """The exit of position n < 512 of one tile, walking its deltas."""
    while True:
        a = int(col[n])
        if a in (EOB, ERR):
            return a
        if a <= 0:
            return 0
        if n + a >= W_P:
            return int(leave_exit(np.int64(n + a)))
        n += a


def segment_ring(d: np.ndarray, s: int) -> tuple[np.ndarray, int]:
    """Warp s's pass over one strip's deltas d (L, 512, nt): (its ring, now
    the exits or markers of positions 128 s .. 128 s + 63, (L, 64, nt); the
    number of hops that walked)."""
    L, _W, nt = d.shape
    seed = 0 if s == NSEG - 1 else MARK
    ring = np.broadcast_to((seed + np.arange(RING))[None, :, None], (L, RING, nt)).copy()
    walks = 0
    for p in range(SEG * s + SEG - 1, SEG * s - 1, -1):
        a = d[:, p, :]
        n = p + a
        hop = np.take_along_axis(ring, (n & (RING - 1))[:, None, :], axis=1)[:, 0, :]
        own = np.where((a == EOB) | (a == ERR), a, np.where(a <= 0, 0, leave_exit(n)))
        far = (a >= RING) & (a != EOB) & (a != ERR) & (n < W_P)
        for l, j in zip(*np.nonzero(far)):
            own[l, j] = walk_exit(d[l, :, j], int(n[l, j]))
        walks += int(far.sum())
        ring[:, p & (RING - 1), :] = np.where((a >= 1) & (a < RING), hop, own)
    return ring, walks


def mirror_stage_b(delta: np.ndarray) -> tuple[np.ndarray, int]:
    """K2's strips, segments, rings and readout: (transfers (L, NT, 48)
    uint8, the number of hops that walked)."""
    L, _W, NT = delta.shape
    out = np.zeros((L, NT, E_WIN), np.uint8)
    covered = np.zeros(NT, np.int64)
    walks = 0
    for t0, nt in strips(NT):
        covered[t0 : t0 + nt] += 1
        d = delta[:, :, t0 : t0 + nt].astype(np.int64)  # the strip, read once
        rings = []
        for s in range(NSEG):
            ring, w = segment_ring(d, s)
            rings.append(ring)
            walks += w
        v = rings[0][:, :E_WIN, :]
        for g in range(1, NSEG):
            u = np.take_along_axis(rings[g], (v - MARK) & (RING - 1), axis=1)
            v = np.where(v >= MARK, u, v)
        assert (v < MARK).all(), "a marker left after the last segment"
        out[:, t0 : t0 + nt, :] = v.transpose(0, 2, 1)
    assert (covered == 1).all()
    return out, walks


def _tiles(a: np.ndarray, L: int, NT: int) -> np.ndarray:
    return np.ascontiguousarray(a.astype(np.int32).reshape(L, NT, W_P).transpose(0, 2, 1))


def _random_wave() -> np.ndarray:
    """Random deltas 1..48 with EOB / error sentinels, as in test_pallas."""
    rng = np.random.default_rng(7)
    L, NT = 2, 128
    d = rng.integers(1, 49, (L, W_P * NT))
    d[rng.random(d.shape) < 0.002] = EOB
    d[rng.random(d.shape) < 0.001] = ERR
    return _tiles(d, L, NT)


def _real_wave() -> np.ndarray:
    """Stage A (the port's plain version) of profile streams plus a garbage
    lane, as in test_torch_decode_kernels."""
    rng = np.random.default_rng(13)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, 30000)]).tobytes()[:100000]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    w = wp.wave_to_tensors(wp._prep_wave(payloads, 4), torch.device("cpu"))
    delta, _token = dk.stage_a(w["grid"], dk.build_meta(w))
    return delta.numpy()


def _odd_wave() -> np.ndarray:
    """Deltas of 0 (a cursor that stops) and 60 (a hop wider than any code),
    hops of 200 (walked) and 5000 (past the EOB advance), and dense
    sentinels."""
    rng = np.random.default_rng(3)
    L, NT = 2, 128
    d = rng.integers(1, 49, (L, W_P * NT))
    u = rng.random(d.shape)
    d[u < 0.04] = 0
    d[(u >= 0.04) & (u < 0.08)] = 60
    d[(u >= 0.08) & (u < 0.09)] = -5
    d[(u >= 0.09) & (u < 0.10)] = 200
    d[(u >= 0.10) & (u < 0.11)] = 5000
    d[(u >= 0.11) & (u < 0.16)] = EOB
    d[(u >= 0.16) & (u < 0.21)] = ERR
    return _tiles(d, L, NT)


WAVES = {"random": _random_wave, "real": _real_wave, "odd": _odd_wave}


@pytest.fixture(scope="module")
def cases():
    """Each wave with the Pallas kernel's transfers, built once."""
    out = {}
    for name, make in WAVES.items():
        delta = make()
        out[name] = (delta, np.asarray(dp.stage_b_pallas(jnp.asarray(delta), interpret=True)))
    return out


@pytest.mark.parametrize("wave", list(WAVES))
def test_mirror_matches_plain_and_pallas(cases, wave):
    delta, pallas = cases[wave]
    got, walks = mirror_stage_b(delta)
    np.testing.assert_array_equal(got, dk.stage_b_plain(torch.from_numpy(delta)).numpy())
    np.testing.assert_array_equal(got, pallas)
    assert (walks > 0) == (wave == "odd")  # stage A's deltas never hop 64 or more


@pytest.mark.parametrize("NT", [1, 3, 45, 100])
def test_partial_strips_match_plain_and_pallas(cases, NT):
    """A last strip of fewer than 32 tiles (the whole lane for NT < 32);
    the Pallas kernel takes 128 tiles, and its first NT are the same tiles."""
    delta, pallas = cases["odd"]
    part = np.ascontiguousarray(delta[:, :, :NT])
    got, _ = mirror_stage_b(part)
    np.testing.assert_array_equal(got, dk.stage_b_plain(torch.from_numpy(part)).numpy())
    np.testing.assert_array_equal(got, pallas[:, :NT])
    assert strips(NT)[-1] == (TB * ((NT - 1) // TB), NT - TB * ((NT - 1) // TB))


@pytest.mark.parametrize("value", [1, 48, 63])
def test_uniform_deltas_cross_every_segment(value):
    """All deltas equal: the longest chains (1), the widest stage-A code
    (48) and the widest hop the ring holds (63). Each entry's markers lead
    through every later segment."""
    delta = np.full((1, W_P, 3), value, np.int32)
    got, walks = mirror_stage_b(delta)
    np.testing.assert_array_equal(got, dk.stage_b_plain(torch.from_numpy(delta)).numpy())
    ring0, _ = segment_ring(delta.astype(np.int64), 0)
    assert walks == 0 and (ring0[:, :E_WIN] >= MARK).all()


def test_mirror_matches_plain_at_the_int32_limits():
    """Hops at the int32 limits and past the sentinels' advances: the plain
    version adds them without wrapping, as the kernel does (unsigned)."""
    rng = np.random.default_rng(9)
    L, NT = 2, 37
    d = rng.integers(1, 49, (L, W_P * NT))
    u = rng.random(d.shape)
    vals = np.array([0, 60, 63, 64, -5, 128, 254, 4096, 8191, 9000, 2**31 - 1, -(2**31)])
    d = np.where(u < 0.15, vals[rng.integers(0, len(vals), d.shape)], d)
    delta = _tiles(d, L, NT)
    got, walks = mirror_stage_b(delta)
    np.testing.assert_array_equal(got, dk.stage_b_plain(torch.from_numpy(delta)).numpy())
    assert walks > 0 and {EOB, ERR} <= set(np.unique(got).tolist())
