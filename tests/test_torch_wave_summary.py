"""The wave's summary fold (``decode_kernels.wave_summary``, the
``wave_summary_kernel`` of ``csrc/stage_dc.cu``) on the CPU: the plain
version ``decode_kernels.wave_summary_plain`` (which the wrapper runs on CPU
tensors) against the JAX package's own code on K3 summary rows made from a
numpy seed: the tail of ``decode_jax_v2._run_wave_pallas_impl`` (its stages
before the fold stubbed to hand it the rows) and ``_pack_small``. Then the
plain version's 64-bit semantics (sums past int32, signed tests) against
NumPy, which the kernel's 64-bit sums repeat. The fold is integer-only, so
every comparison is exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import decode_pallas as dp

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import wave_prep as wp


def _rows(L: int, NT: int, seed: int, *, eob=(), err=(), overflow=()) -> np.ndarray:
    """K3-like summary rows (L, 8, NT) int32: counts and sizes, an EOB hit in
    one tile of each lane of ``eob`` (with its position and token), an error
    hit in one tile of each lane of ``err``, a tile over k1 in each lane of
    ``overflow``."""
    rng = np.random.default_rng(seed)
    s = np.zeros((L, 8, NT), np.int32)
    s[:, wp.ROW_COUNT] = rng.integers(0, 105, (L, NT))
    s[:, wp.ROW_SIZE_SUM] = rng.integers(0, 30000, (L, NT))
    for lane in eob:
        t = int(rng.integers(0, NT))
        s[lane, wp.ROW_EOB_HIT, t] = 1
        s[lane, wp.ROW_EOB_POS, t] = rng.integers(0, wp.W_P)
        s[lane, wp.ROW_EOB_TOK, t] = -int(rng.integers(1, 16))
    for lane in err:
        t = int(rng.integers(0, NT))
        s[lane, wp.ROW_ERR_HIT, t] = 1
        s[lane, wp.ROW_ERR_TOK, t] = -(100 + int(rng.integers(0, 19)))
    for lane in overflow:
        s[lane, wp.ROW_OVERFLOW, int(rng.integers(0, NT))] = 1
    return s


def _reference(summ: np.ndarray, nlit: np.ndarray | None, monkeypatch) -> np.ndarray:
    """The JAX package's fold of ``summ``: ``_run_wave_pallas_impl`` with its
    stages before the fold stubbed to hand it these rows, then
    ``_pack_small``."""
    L, _, NT = summ.shape
    k1 = dp.K1_CHOICES[0]
    monkeypatch.setattr(dp, "build_meta", lambda w: None)
    monkeypatch.setattr(dp, "stage_a_pallas", lambda grid, meta: (jnp.zeros((L, 1, NT), jnp.int32), None))
    monkeypatch.setattr(dp, "stage_b_pallas", lambda dt: None)
    monkeypatch.setattr(v2, "stage_c_entries", lambda tr, e0: (jnp.zeros((L, NT), jnp.uint8), None))
    monkeypatch.setattr(dp, "stage_dc_pallas",
                        lambda dt, tt, entries, *, k1: (jnp.zeros((L, NT, k1), jnp.int32), jnp.asarray(summ)))
    monkeypatch.setattr(dp, "compact_flat_pallas", lambda tok, planes: tok)
    w = {"grid": np.zeros((L, 1, NT + 1), np.int32), "rem": np.zeros(L, np.int32),
         "lit_planes": np.zeros((L, 64), np.int32), "_min_tok_bits": wp.W_P // k1}
    _tokens, *rest = v2._run_wave_pallas_impl(w)
    nl = None if nlit is None else jnp.asarray(nlit)
    return np.asarray(v2._pack_small(*rest, nl))


CASES = {
    # one 1-lane wave and the main path's 256 x 1152 shape
    "one_lane": dict(L=1, NT=1, eob=(0,)),
    "wide": dict(L=256, NT=1152, eob=range(0, 256, 2), err=range(1, 256, 3)),
    "overflow_one_lane": dict(L=8, NT=37, eob=range(8), overflow=(3,)),
    "overflow_padding_lane": dict(L=8, NT=37, eob=range(6), overflow=(7,)),
    "eob_and_error": dict(L=4, NT=128, eob=(0, 1, 2), err=(1, 3)),
    "nothing_hit": dict(L=4, NT=5),
}


@pytest.mark.parametrize("with_nlit", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(case, with_nlit, monkeypatch):
    c = dict(CASES[case])
    L, NT = c.pop("L"), c.pop("NT")
    summ = _rows(L, NT, seed=L * 1000 + NT, **c)
    nlit = np.random.default_rng(L).integers(0, 5000, L).astype(np.int32) if with_nlit else None
    want = _reference(summ, nlit, monkeypatch)
    nl = None if nlit is None else torch.from_numpy(nlit)
    got = dk.wave_summary_plain(torch.from_numpy(summ), nl)
    assert got.dtype == torch.int32 and got.shape == (7, L)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes its plain version on CPU tensors
    np.testing.assert_array_equal(dk.wave_summary(torch.from_numpy(summ), nl).numpy(), want)
    if "overflow" in c:
        assert (got[5] == 1).all()


def _fold_np(summ: np.ndarray, nlit: np.ndarray | None) -> np.ndarray:
    """The fold in NumPy int64: the sums, their signed tests, cut to int32."""
    s = summ.astype(np.int64)
    L, _, NT = s.shape
    hit = s[:, wp.ROW_EOB_HIT]
    has_eob = hit.sum(1) > 0
    eob_pos = (s[:, wp.ROW_EOB_POS] + hit * (np.arange(NT) * wp.W_P)).sum(1)
    err = s[:, wp.ROW_ERR_HIT].sum(1) > 0
    rows = [
        s[:, wp.ROW_COUNT].sum(1),
        has_eob,
        np.where(has_eob, eob_pos - s[:, wp.ROW_EOB_TOK].sum(1) - 1, 0),
        np.where(err, -s[:, wp.ROW_ERR_TOK].sum(1) - 100, 0),
        s[:, wp.ROW_SIZE_SUM].sum(1),
        np.full(L, s[:, wp.ROW_OVERFLOW].sum() > 0),
        np.zeros(L, np.int64) if nlit is None else nlit,
    ]
    return np.stack([np.asarray(r, np.int64) for r in rows]).astype(np.int32)


def test_plain_int64_semantics():
    """Rows at the int32 limits: sums past int32 are cut after a 64-bit sum,
    and the hit and overflow tests are signed (a row summing to a negative
    number is no hit)."""
    rng = np.random.default_rng(7)
    L, NT = 5, 300
    summ = rng.integers(-(1 << 31), 1 << 31, (L, 8, NT), dtype=np.int64).astype(np.int32)
    summ[0] = np.iinfo(np.int32).max
    summ[1] = np.iinfo(np.int32).min
    summ[2, wp.ROW_EOB_HIT] = -1  # a negative hit sum
    summ[3, wp.ROW_OVERFLOW] = -3
    for nlit in (None, rng.integers(0, 1 << 20, L).astype(np.int32)):
        got = dk.wave_summary_plain(torch.from_numpy(summ), None if nlit is None else torch.from_numpy(nlit))
        np.testing.assert_array_equal(got.numpy(), _fold_np(summ, nlit))


def test_wrapper_checks():
    summ = torch.zeros((2, 8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        dk.wave_summary(torch.zeros((2, 7, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.wave_summary(summ.to(torch.int64))
    with pytest.raises(ValueError):
        dk.wave_summary(summ, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.wave_summary(summ, torch.zeros(2, dtype=torch.int64))
