"""A mirror of K8's algorithm (csrc/parse.cu, parse transfers), written here
in NumPy: every position of a tile gets its first hop (the next position
``p + step``, or, where the walk leaves the tile or stops, a terminal that
holds the exit byte), and nine rounds of pointer jumping ``nxt[p] <-
nxt[nxt[p]]`` over the tile's 512 positions, with terminals as fixed
points, carry every position to its exit; entries 0..255 are read out. The
mirror is held equal to the port's plain version ``parse.parse_transfers_plain``
and to the JAX package's Pallas kernel in interpret mode, on the encoder's
literal-heavy, all-1, all-250 and random 1..250 step fields, and to the
plain version alone on a field with steps <= 0 (the reference's lock-step
cursor stops there) and past the tile. The parse is integer-only, so every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import parse_pallas as ref
from tpu_deflate_torch.codec import parse as pp

L, NT = 2, 128  # the Pallas kernel's block of 128 tiles
TERM = 0x8000  # marks a terminal hop; its low byte is the exit
ROUNDS = 9  # ceil(log2(512)): a chain has at most 512 hops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_parse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def first_hops(steps: np.ndarray) -> np.ndarray:
    """(L, NT, 512) steps -> each position's first hop: p + step inside the
    tile, or TERM | exit byte where the walk ends there, which it does when
    p + step >= 512 or when the step is <= 0 (a lock-step cursor that does
    not move forward stays where it landed)."""
    p = np.arange(pp.T_P)
    s = steps.astype(np.int64)
    term = (s <= 0) | (s >= pp.T_P - p)
    return np.where(term, TERM | ((p + s) & 0xFF), p + s)


def jump_round(nxt: np.ndarray) -> np.ndarray:
    """One round, as a warp runs it: every non-terminal position reads the
    hop of the position it points at (all reads before any write)."""
    live = (nxt & TERM) == 0
    return np.where(live, np.take_along_axis(nxt, np.where(live, nxt, 0), axis=-1), nxt)


def mirror_transfers(steps: np.ndarray) -> tuple[np.ndarray, int]:
    """K8's pointer jumping: (transfers (L, NT, 256) uint8, the rounds the
    tile that needs the most ran before every position was terminal)."""
    nxt = first_hops(steps)
    rounds = 0
    while not (nxt & TERM).all():
        assert rounds < ROUNDS, "pointer jumping did not converge in nine rounds"
        nxt = jump_round(nxt)
        rounds += 1
    return (nxt[..., : pp.E_P] & 0xFF).astype(np.uint8), rounds


def _field(name: str) -> np.ndarray:
    """(L, S) step fields as the encoder's parse sees them."""
    rng = np.random.default_rng(21)
    S = NT * pp.T_P
    if name == "literal_heavy":
        step = rng.integers(1, pp.PARSE_MAX_STEP + 1, (L, S)).astype(np.int32)
        step[rng.random((L, S)) < 0.7] = 1
        return step
    if name == "random":
        return rng.integers(1, pp.PARSE_MAX_STEP + 1, (L, S)).astype(np.int32)
    if name == "all_1":
        return np.ones((L, S), np.int32)
    if name == "all_250":
        return np.full((L, S), pp.PARSE_MAX_STEP, np.int32)
    raise KeyError(name)


def _plain(step: np.ndarray) -> np.ndarray:
    return pp.parse_transfers_plain(pp.step_tiles(torch.from_numpy(step))).numpy()


@pytest.mark.parametrize("field", ["literal_heavy", "random", "all_1", "all_250"])
def test_mirror_matches_plain_and_pallas(field):
    step = _field(field)
    got, rounds = mirror_transfers(step.reshape(L, NT, pp.T_P))
    np.testing.assert_array_equal(got, _plain(step))
    want = np.asarray(ref.parse_transfers(ref.step_tiles(jnp.asarray(step)), interpret=True))
    np.testing.assert_array_equal(got, want)
    # A chain of 1-steps crosses the whole tile: 512 hops take all nine
    # rounds; 250-steps leave it within three hops, two rounds.
    assert 1 <= rounds <= ROUNDS
    if field in ("all_1", "all_250"):
        assert rounds == {"all_1": ROUNDS, "all_250": 2}[field]


def test_mirror_matches_plain_on_steps_that_stop_or_leave():
    """Steps of 0 and below stop a lock-step cursor where it lands (its
    exit is (p + step - 512) & 0xFF, wrapping); steps past the tile and at
    the int32 limits end the walk at once."""
    rng = np.random.default_rng(8)
    step = rng.integers(1, pp.PARSE_MAX_STEP + 1, (3, 4 * pp.T_P)).astype(np.int32)
    u = rng.random(step.shape)
    step[u < 0.5] = 1
    for lo, hi, value in ((0.50, 0.53, 0), (0.53, 0.56, -7), (0.56, 0.57, 600),
                          (0.57, 0.58, 2**31 - 1), (0.58, 0.59, -(2**31))):
        step[(u >= lo) & (u < hi)] = value
    got, _rounds = mirror_transfers(step.reshape(3, 4, pp.T_P))
    np.testing.assert_array_equal(got, _plain(step))
    assert (step <= 0).any() and (got != 0).any()


def test_terminals_are_fixed_points_and_every_entry_follows_a_serial_walk():
    """After the rounds each position holds a terminal; a round changes no
    terminal; and every one of the 256 entries of a tile, also those no
    chain from position 0 reaches, exits where a serial walk leaves."""
    step = _field("literal_heavy")[:1, : 2 * pp.T_P].reshape(1, 2, pp.T_P)
    nxt = first_hops(step)
    for _ in range(ROUNDS):
        before = nxt.copy()
        nxt = jump_round(nxt)
        fixed = (before & TERM) != 0
        np.testing.assert_array_equal(nxt[fixed], before[fixed])
    assert (nxt & TERM).all()
    for t in range(2):
        s = step[0, t]
        for e in range(pp.E_P):
            cur = e
            while cur < pp.T_P:
                cur += int(s[cur])
            assert nxt[0, t, e] & 0xFF == cur - pp.T_P
