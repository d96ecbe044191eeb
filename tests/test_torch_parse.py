"""The port's encoder parse (tpu_deflate_torch.codec.parse: plain K8,
host_entries, plain K9 on CPU tensors) against the JAX package's
parse_pallas, whose Pallas kernels run in interpret mode as
tests/test_pallas.py runs them, and against a serial walk. Step fields are
made with numpy from a seed at the encoder's lane width (L = 2, S = 65536);
the parse is integer-only, so every comparison is exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import parse_pallas as ref
from tpu_deflate_torch.codec import parse as pp

L, S = 2, pp.T_P * 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name == "literal_heavy":  # as tests/test_pallas.py::test_parse_pallas_matches_serial
        step = rng.integers(1, pp.PARSE_MAX_STEP + 1, (L, S)).astype(np.int32)
        step[rng.random((L, S)) < 0.7] = 1
        return step
    if name == "all_250":
        return np.full((L, S), pp.PARSE_MAX_STEP, np.int32)
    if name == "all_1":
        return np.ones((L, S), np.int32)
    raise KeyError(name)


def _serial(step: np.ndarray) -> np.ndarray:
    want = np.zeros(step.shape, bool)
    for l in range(step.shape[0]):
        p = 0
        while p < step.shape[1]:
            want[l, p] = True
            p += int(step[l, p])
    return want


FIELDS = ("literal_heavy", "all_250", "all_1")


def test_constants_match_reference():
    assert (pp.T_P, pp.E_P, pp.PARSE_MAX_STEP) == (ref.T_P, ref.E_P, ref.PARSE_MAX_STEP)


@pytest.mark.parametrize("field", FIELDS)
def test_parse_matches_pallas_and_serial_walk(field):
    step = _field(field)
    tiles = pp.step_tiles(torch.from_numpy(step))
    rtiles = ref.step_tiles(jnp.asarray(step))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(rtiles))

    transfers = pp.parse_transfers(tiles)
    assert transfers.dtype == torch.uint8 and tuple(transfers.shape) == (L, S // pp.T_P, pp.E_P)
    rtransfers = np.asarray(ref.parse_transfers(rtiles, interpret=True))
    np.testing.assert_array_equal(transfers.numpy(), rtransfers)

    entries = pp.host_entries(transfers.numpy())
    np.testing.assert_array_equal(entries, ref.host_entries(rtransfers))

    tok = pp.parse_replay(tiles, torch.from_numpy(entries))
    assert tok.dtype == torch.bool and tuple(tok.shape) == (L, S)
    rtok = np.asarray(ref.parse_replay(rtiles, jnp.asarray(entries), interpret=True))
    np.testing.assert_array_equal(tok.numpy(), rtok)
    np.testing.assert_array_equal(tok.numpy(), _serial(step))


def test_transfers_of_every_entry_follow_a_serial_walk():
    """Every one of the 256 entries of every tile, also those no chain
    reaches, exits where a serial walk from it leaves the tile."""
    step = _field("literal_heavy")
    transfers = pp.parse_transfers(pp.step_tiles(torch.from_numpy(step))).numpy()
    for l in range(L):
        for t in (0, 1, 77, S // pp.T_P - 1):
            s = step[l, t * pp.T_P : (t + 1) * pp.T_P]
            for e in range(pp.E_P):
                cur = e
                while cur < pp.T_P:
                    cur += int(s[cur])
                assert transfers[l, t, e] == cur - pp.T_P


def test_step_tiles_is_a_view_and_kernels_take_contiguous_tiles():
    """The tile layout is a view of the position-major steps; a contiguous
    (L, 512, NT) tensor gives the same answers."""
    step = torch.from_numpy(_field("literal_heavy"))
    tiles = pp.step_tiles(step)
    assert tiles.data_ptr() == step.data_ptr() and not tiles.is_contiguous()
    dense = tiles.contiguous()
    assert torch.equal(pp.parse_transfers(dense), pp.parse_transfers(tiles))
    entries = torch.from_numpy(pp.host_entries(pp.parse_transfers(tiles).numpy()))
    assert torch.equal(pp.parse_replay(dense, entries), pp.parse_replay(tiles, entries))


def test_wrappers_check_their_inputs():
    step = torch.from_numpy(_field("all_1"))
    tiles = pp.step_tiles(step)
    with pytest.raises(ValueError):
        pp.parse_transfers(pp.step_tiles(step.to(torch.int64)))
    with pytest.raises(ValueError):
        pp.parse_replay(tiles, torch.zeros((L, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        pp.parse_replay(tiles, torch.zeros((L, S // pp.T_P), dtype=torch.int64))
