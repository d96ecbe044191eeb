"""Stage C (``decode_kernels.stage_c``, ``csrc/stage_c.cu``): a NumPy
mirror of the kernel's chunked composition held against the port's plain
version ``decode_kernels.stage_c_plain``, and the plain version against the
JAX package's ``decode_jax_v2.stage_c_entries``.

The kernel takes one lane a block and walks its tiles in windows of WIN
tiles staged in shared memory. Inside a window, thread k composes the maps
of its chunk of C = ceil(nt / THREADS) neighbouring tiles into one 48-entry
map, one thread walks the chunk maps from the state carried into the
window, and each thread replays its chunk from its chunk's entry. The
mirror repeats those steps with the same window, chunk and thread counts,
on every lane at once.

The plain version's contract holds for any value: a state of 127 or more
passes through, one below 48 is looked up (a negative entry0 as 0), one of
48..126 becomes 255, and the outputs are the low byte. The reference
documents maps of [0, 48) plus the sentinels 127 and 255 and entry0 in [0,
48): outside that its two branches (NT a multiple of 128 or not) answer
differently, so it is compared there only. The pipeline is integer-only,
so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax_v2 as v2

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2

E = dk.E_WIN
EOB, ERR = dk.SENT_EOB, dk.SENT_ERR
THREADS = 128  # threads a block of csrc/stage_c.cu
WIN = 512  # tiles a window


def apply(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's apply per lane: m (L, 48) maps, v (L,) or (L, n) int64
    states."""
    vv = v.reshape(v.shape[0], -1)
    got = np.take_along_axis(m, np.clip(vv, 0, E - 1), axis=1).astype(np.int64)
    return np.where(vv >= EOB, vv, np.where(vv < E, got, ERR)).reshape(v.shape)


def mirror(maps: np.ndarray, entry0: np.ndarray):
    """The kernel's method on (L, NT, 48) uint8 maps and (L,) int32 entry0
    -> (entries uint8, final uint8, entries int32)."""
    L, NT, _E = maps.shape
    ent = np.zeros((L, NT), np.int64)
    carry = entry0.astype(np.int64)
    for w0 in range(0, NT, WIN):
        win = maps[:, w0 : w0 + WIN].astype(np.int64)
        nt = win.shape[1]
        C = -(-nt // THREADS)
        nchunks = -(-nt // C)
        # Thread k composes tiles [k C, min(k C + C, nt)) into one map.
        chunk_maps = []
        for k in range(nchunks):
            m = win[:, k * C].copy()
            for t in range(k * C + 1, min(k * C + C, nt)):
                m = apply(win[:, t], m)  # the 48 entries at once
            chunk_maps.append(m)
        # One thread walks the chunk maps from the carried state.
        chunk_entry = []
        for k in range(nchunks):
            chunk_entry.append(carry)
            carry = apply(chunk_maps[k], carry)
        # Each thread replays its own chunk.
        for k in range(nchunks):
            s = chunk_entry[k]
            for t in range(k * C, min(k * C + C, nt)):
                ent[:, w0 + t] = s
                s = apply(win[:, t], s)
    low = ent & 0xFF
    return low.astype(np.uint8), (carry & 0xFF).astype(np.uint8), low.astype(np.int32)


def edge_maps(rng, L: int, NT: int) -> np.ndarray:
    """Maps mostly in [0, 48), with 127 and 255 and the values outside the
    domain, 48..126 and 128..254, mixed in."""
    maps = rng.integers(0, E, (L, NT, E)).astype(np.uint8)
    u = rng.random(maps.shape)
    maps[u < 0.004] = EOB
    maps[(u >= 0.004) & (u < 0.007)] = ERR
    out = (u >= 0.007) & (u < 0.009)
    maps[out] = rng.integers(E, EOB, int(out.sum()))
    high = (u >= 0.009) & (u < 0.011)
    maps[high] = rng.integers(EOB + 1, ERR, int(high.sum()))
    return maps


def entries_all_bytes(L: int) -> np.ndarray:
    """entry0 over every byte value, then -1 and 1000 (int32 beyond a byte)."""
    return np.concatenate([np.arange(256), [-1, 1000]])[:L].astype(np.int32)


def _check_plain(maps: np.ndarray, entry0: np.ndarray) -> None:
    want = mirror(maps, entry0)
    got = dk.stage_c_plain(torch.from_numpy(maps), torch.from_numpy(entry0))
    for g, w in zip(got, want[:2]):
        np.testing.assert_array_equal(g.numpy(), w)
    wrapped = dk.stage_c(torch.from_numpy(maps), torch.from_numpy(entry0))
    assert [t.dtype for t in wrapped] == [torch.uint8, torch.uint8, torch.int32]
    for g, w in zip(wrapped, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("NT", [1, 3, 128])
def test_mirror_every_entry_byte(NT):
    """Every entry0 byte value (and -1, 1000) on maps with every kind of
    value; NT of one tile, a partial chunk and a whole window of chunks
    of one."""
    rng = np.random.default_rng(NT)
    L = 258
    _check_plain(edge_maps(rng, L, NT), entries_all_bytes(L))


@pytest.mark.parametrize("NT", [384, 4224])
def test_mirror_windows(NT):
    """The main path's widest wave (384 tiles: chunks of 3) and the largest
    tile count (4224 = P 270336 / 64 bytes: 9 windows, the last partial)."""
    rng = np.random.default_rng(NT)
    L = 4
    entry0 = np.array([0, 5, 47, EOB], np.int32)
    _check_plain(edge_maps(rng, L, NT), entry0)


def test_mirror_dense_values():
    """Maps that are mostly sentinels and values outside the domain, and
    maps of one fixed point (every chunk map the identity on it)."""
    rng = np.random.default_rng(3)
    L, NT = 6, 700
    maps = rng.choice(np.array([0, 1, 47, 48, 100, 126, EOB, 128, 200, 254, ERR], np.uint8), (L, NT, E))
    maps[4] = 7
    maps[5] = np.arange(E, dtype=np.uint8)
    _check_plain(maps, np.array([0, 1, 47, 48, EOB, 7], np.int32))


def test_plain_matches_reference_every_entry():
    """The plain version against the JAX package on maps of [0, 48) with
    the sentinels, from every entry0 in [0, 48) (the reference's byte-wise
    branch; its packed branch, NT a multiple of 128, is held in
    test_torch_decode_kernels.py)."""
    rng = np.random.default_rng(5)
    L, NT = E, 3
    maps = rng.integers(0, E, (L, NT, E)).astype(np.uint8)
    maps[rng.random(maps.shape) < 0.02] = EOB
    maps[rng.random(maps.shape) < 0.02] = ERR
    entry0 = np.arange(E, dtype=np.int32)
    got_e, got_f = pv2.stage_c_entries(torch.from_numpy(maps), torch.from_numpy(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(maps), jnp.asarray(entry0).astype(jnp.uint8))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_plain_matches_reference_outside_domain():
    """Where NT is not a multiple of 128 the reference composes byte by
    byte, and there it agrees with the plain version on map values of
    48..126 and 128..254 too."""
    rng = np.random.default_rng(11)
    L, NT = 4, 45
    maps = edge_maps(rng, L, NT)
    entry0 = np.array([0, 3, 30, 47], np.int32)
    got_e, got_f = pv2.stage_c_entries(torch.from_numpy(maps), torch.from_numpy(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(maps), jnp.asarray(entry0).astype(jnp.uint8))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_wrapper_checks():
    """The wrapper takes (L, NT, 48) uint8 maps and an (L,) int32 entry0."""
    maps = torch.zeros((2, 4, E), dtype=torch.uint8)
    with pytest.raises(ValueError):
        dk.stage_c(maps, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        dk.stage_c(maps[:, :, :40].contiguous(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.stage_c(maps, torch.zeros(3, dtype=torch.int32))
