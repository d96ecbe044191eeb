"""A mirror of K9's algorithm (csrc/parse.cu, parse replay), written here in
NumPy: each of a tile's 512 positions gets K8's first hop (the next position
``p + step``, or a terminal where the walk leaves the tile or stops), the
entry is marked if it lies in the tile, and in round r, while v[p] is p's
2^r-th successor, every marked position whose hop is live marks v[p] before
the jump ``v[p] <- v[v[p]]``; a tile stops once no marked position has a
live hop (the chain has then no member left to mark). The mirror is
held equal to the port's plain version ``parse.parse_replay_plain`` and to
the JAX package's Pallas kernel in interpret mode on the encoder's
literal-heavy, random, all-1 and all-250 step fields with the host's
entries, and on a field with steps of 0, -7, 600 and the int32 limits with
entries of -1, 0, 255, 511 and 512 (the reference's int32 cursor wraps
there and stops, as the kernel's unsigned hop does). The parse is
integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import parse_pallas as ref

from test_torch_parse_jumps import ROUNDS, TERM, _field, first_hops, jump_round
from tpu_deflate_torch.codec import parse as pp

L, NT = 2, 128  # the Pallas kernel's block of 128 tiles
ENTRY_EDGES = (-1, 0, 255, 511, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see test_torch_parse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mark_round(v: np.ndarray, mark: np.ndarray) -> np.ndarray:
    """One round's marks, as a warp makes them before the jump: every
    marked position whose hop is live marks the position it points at
    (reading the marks as the round found them)."""
    lead = mark & ((v & TERM) == 0)
    idx = np.nonzero(lead)
    out = mark.copy()
    out[idx[:-1] + (v[lead],)] = True
    return out


def mirror_replay(steps: np.ndarray, entries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K9: steps (L, NT, 512), entries (L, NT) -> (is-token (L, NT * 512)
    bool, the rounds each tile jumped before no marked hop was live)."""
    v = first_hops(steps)
    mark = np.zeros(v.shape, bool)
    li, ti = np.nonzero((entries >= 0) & (entries < pp.T_P))
    mark[li, ti, entries[li, ti]] = True
    rounds = np.zeros(entries.shape, np.int64)
    live = np.ones(entries.shape, bool)  # tiles whose chain goes on
    for _r in range(ROUNDS):
        live &= (mark & ((v & TERM) == 0)).any(-1)
        mark = np.where(live[..., None], mark_round(v, mark), mark)
        v = np.where(live[..., None], jump_round(v), v)
        rounds += live
    L_, NT_, _T = steps.shape
    return mark.reshape(L_, NT_ * pp.T_P), rounds


def _entries(step: np.ndarray) -> np.ndarray:
    tiles = pp.step_tiles(torch.from_numpy(step))
    return pp.host_entries(pp.parse_transfers_plain(tiles).numpy())


def _stop_field() -> tuple[np.ndarray, np.ndarray]:
    """Steps that stop a lock-step cursor (0, -7), leave the tile at once
    (600) or sit at the int32 limits, with entries at and past the tile's
    edges in the first tiles and the host's entries elsewhere."""
    rng = np.random.default_rng(8)
    step = rng.integers(1, pp.PARSE_MAX_STEP + 1, (L, NT * pp.T_P)).astype(np.int32)
    u = rng.random(step.shape)
    step[u < 0.5] = 1
    for lo, hi, value in ((0.50, 0.53, 0), (0.53, 0.55, -7), (0.55, 0.56, 600),
                          (0.56, 0.57, 2**31 - 1), (0.57, 0.58, -(2**31))):
        step[(u >= lo) & (u < hi)] = value
    entries = _entries(step)
    entries[:, : len(ENTRY_EDGES)] = ENTRY_EDGES
    return step, entries


def _pallas(step: np.ndarray, entries: np.ndarray) -> np.ndarray:
    return np.asarray(ref.parse_replay(ref.step_tiles(jnp.asarray(step)), jnp.asarray(entries), interpret=True))


@pytest.mark.parametrize("field", ["literal_heavy", "random", "all_1", "all_250", "stop"])
def test_mirror_matches_plain_and_pallas(field):
    if field == "stop":
        step, entries = _stop_field()
    else:
        step = _field(field)
        entries = _entries(step)
    got, rounds = mirror_replay(step.reshape(L, NT, pp.T_P), entries)
    tiles = pp.step_tiles(torch.from_numpy(step))
    np.testing.assert_array_equal(got, pp.parse_replay_plain(tiles, torch.from_numpy(entries)).numpy())
    np.testing.assert_array_equal(got, _pallas(step, entries))
    # A chain of 1-steps crosses the whole tile: all nine rounds; 250-steps
    # leave it within three members, at most two rounds.
    assert rounds.max() <= ROUNDS
    if field == "all_1":
        assert (rounds == ROUNDS).all()
    if field == "all_250":
        assert rounds.min() >= 1 and rounds.max() == 2
    if field == "stop":
        for t, e in enumerate(ENTRY_EDGES):
            assert got[:, t * pp.T_P : (t + 1) * pp.T_P].any(1).tolist() == [0 <= e < pp.T_P] * L


def test_marks_made_and_read_in_one_round_add_only_chain_members():
    """The kernel's threads may read a mark that another thread makes in
    the same round. Marking each round in one serial order, where every
    position reads the marks made before it, gives the same flags as
    marking from the round's starting marks."""
    step = _field("literal_heavy")[:1, : 4 * pp.T_P]
    steps = step.reshape(1, 4, pp.T_P)
    entries = _entries(step)
    want, _rounds = mirror_replay(steps, entries)
    rng = np.random.default_rng(3)
    v = first_hops(steps)
    mark = np.zeros(v.shape, bool)
    mark[0, np.arange(4), entries[0]] = True
    for _r in range(ROUNDS):
        for t in range(4):
            for p in rng.permutation(pp.T_P):
                if mark[0, t, p] and not v[0, t, p] & TERM:
                    mark[0, t, v[0, t, p]] = True
        v = jump_round(v)
    np.testing.assert_array_equal(mark.reshape(1, -1), want)


def test_every_entry_follows_a_serial_walk():
    """Every entry of a tile, also those no chain from position 0 reaches,
    and the entries outside [0, 512), marks exactly the positions a serial
    walk from it visits."""
    step, _entries_ = _stop_field()
    tile = step[:1, : pp.T_P].reshape(1, 1, pp.T_P)
    s = tile[0, 0].astype(np.int64)
    for e in list(range(pp.T_P)) + [-1, 512, 2**31 - 1]:
        got, _rounds = mirror_replay(tile, np.array([[e]], np.int64))
        want = np.zeros(pp.T_P, bool)
        cur = e
        while 0 <= cur < pp.T_P:
            want[cur] = True
            if s[cur] <= 0:
                break
            cur += s[cur]
        np.testing.assert_array_equal(got[0], want)
