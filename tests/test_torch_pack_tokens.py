"""The host route's packed token pull alone (``decode_kernels.pack_tokens``,
csrc/compact.cu's pull mode with the literal map off; the route itself runs
it with the map on, inside K4's launch: ``test_torch_compact_pack.py``) on
the CPU: the plain version ``pack_tokens_plain`` against the JAX package's
``_pack_tokens_jit`` (run on the CPU as the JAX package's tests run it),
then the NumPy mirror of the pull mode (``compact_pull_cases.mirror_pull``
with the map off) against the plain version.

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
word built from 32 literal flags staged in entry order, stored by the
segment that holds its entries; the lane's literal count from its last
segment. Every output byte must be written exactly once. Inputs are the
smoke's own edge lanes (``chip_smoke.pack_edge_lanes``: literal ranks 0
and 255, match tokens of 256 and more, -1, -2 and INT_MIN, all-literal,
all-match and all-padding lanes, a literal at bit 31 of every bitmap word)
at M not a multiple of 32 or 4, one lane alone, and a wave of K3-like
tokens. Integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from compact_pull_cases import mirror_pull, pull_per
from tpu_deflate.codec import decode_jax_v2 as v2

from tpu_deflate_torch.codec import decode_kernels as dk


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


def mirror_pack(tok: np.ndarray, order: str, seed: int = 0) -> tuple:
    """The kernel's pull mode with the map off over (L, M) tokens
    (``compact_pull_cases.mirror_pull``); order as in the K7 mirror: 'in',
    'reversed' or 'shuffled' look-backs. Every output must be written
    exactly once."""
    return mirror_pull(tok, None, order, seed)


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
    assert pull_per(*tok.shape) == 16
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
