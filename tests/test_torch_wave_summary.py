"""The wave's summary fold (K3's epilogue in ``csrc/stage_dc.cu``,
``fold_strip``; ``decode_kernels.wave_summary`` runs it alone on given rows)
on the CPU: the plain version ``decode_kernels.wave_summary_plain`` (which
the wrapper runs on CPU tensors) against the JAX package's own code on K3
summary rows made from a numpy seed: the tail of
``decode_jax_v2._run_wave_pallas_impl`` (its stages before the fold stubbed
to hand it the rows) and ``_pack_small``. Then the plain version's 64-bit
semantics (sums past int32, signed tests) against NumPy, which the kernel's
64-bit sums repeat, and a NumPy model of the epilogue against the plain
version: strips of K3's widths ending in random order, each adding its
64-bit partial sums to its lane's totals and counting itself done, the
lane's last strip waiting for the others, then writing its lane's rows and
adding its lane's overflow to the wave's, the wave's last lane to count
writing row 5 into every lane, and every total and count put back to 0 by
whoever reads it (one scratch carried across calls). The fold is
integer-only, so every comparison is exact equality."""

from __future__ import annotations

import collections

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


def _wild_rows() -> tuple[np.ndarray, np.random.Generator]:
    """Rows over the whole int32 range: sums past int32, a negative hit sum,
    a negative overflow sum."""
    rng = np.random.default_rng(7)
    L, NT = 5, 300
    summ = rng.integers(-(1 << 31), 1 << 31, (L, 8, NT), dtype=np.int64).astype(np.int32)
    summ[0] = np.iinfo(np.int32).max
    summ[1] = np.iinfo(np.int32).min
    summ[2, wp.ROW_EOB_HIT] = -1  # a negative hit sum
    summ[3, wp.ROW_OVERFLOW] = -3
    return summ, rng


def test_plain_int64_semantics():
    """Rows at the int32 limits: sums past int32 are cut after a 64-bit sum,
    and the hit and overflow tests are signed (a row summing to a negative
    number is no hit)."""
    summ, rng = _wild_rows()
    L = summ.shape[0]
    for nlit in (None, rng.integers(0, 1 << 20, L).astype(np.int32)):
        got = dk.wave_summary_plain(torch.from_numpy(summ), None if nlit is None else torch.from_numpy(nlit))
        np.testing.assert_array_equal(got.numpy(), _fold_np(summ, nlit))


# ---------------------------------------------------------------------------
# NumPy model of K3's epilogue (fold_strip)
# ---------------------------------------------------------------------------

U64 = (1 << 64) - 1


def _signed(x: int, bits: int) -> int:
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


STRIDE = 16  # csrc/stage_dc.cu's FOLD_STRIDE


def mirror_fold(summ: np.ndarray, nlit: np.ndarray | None, tb: int, rng, scratch: list) -> np.ndarray:
    """K3's epilogue over strips of ``tb`` tiles, the blocks ending in random
    order. ``scratch`` (Python ints, as the kernel's uint64 counts: each
    lane's 8 totals and its strips done, STRIDE apart, then the wave's
    overflow and its lanes done) is 0 before the call and after it."""
    L, _, NT = summ.shape
    strips = -(-NT // tb)
    assert len(scratch) >= STRIDE * (L + 1) and not any(scratch), "the counts were not left at 0"
    wave = STRIDE * L
    vec = np.zeros((7, L), np.int64)
    writes = np.zeros((7, L), np.int64)
    # each strip's 64-bit partial sums (the rows sign-extended; the zeros past NT add nothing)
    r = np.zeros((L, 8, strips * tb), np.int64)
    r[:, :, :NT] = summ
    hit = r[:, wp.ROW_EOB_HIT]
    pos = r[:, wp.ROW_EOB_POS] + hit * (np.arange(strips * tb) * wp.W_P)
    cols = [r[:, wp.ROW_COUNT], hit, pos, r[:, wp.ROW_EOB_TOK], r[:, wp.ROW_ERR_HIT], r[:, wp.ROW_ERR_TOK],
            r[:, wp.ROW_SIZE_SUM], r[:, wp.ROW_OVERFLOW]]
    parts = np.stack([c.reshape(L, strips, tb).sum(2) for c in cols], 2).tolist()  # (L, strips, 8)
    ending = collections.deque(rng.permutation(L * strips).tolist())
    added = set()
    while ending:
        b = ending.popleft()
        lane, x = divmod(b, strips)
        acc = STRIDE * lane
        if b not in added:  # its partial sums into its lane's totals
            added.add(b)
            for k in range(8):
                scratch[acc + k] = (scratch[acc + k] + int(parts[lane][x][k])) & U64
        if x != strips - 1:
            scratch[acc + 8] += 1
            continue
        if scratch[acc + 8] != strips - 1:  # the lane's last strip waits for the others
            ending.append(b)
            continue
        tot = [scratch[acc + k] for k in range(8)]  # read and put back to 0
        scratch[acc : acc + 9] = [0] * 9
        eob, err = _signed(tot[1], 64) > 0, _signed(tot[4], 64) > 0
        rows = {0: tot[0], 1: int(eob), 2: tot[2] - tot[3] - 1 if eob else 0,
                3: -tot[5] - 100 if err else 0, 4: tot[6], 6: 0 if nlit is None else int(nlit[lane])}
        for row, value in rows.items():
            vec[row, lane] = _signed(value, 32)
            writes[row, lane] += 1
        scratch[wave] = (scratch[wave] + tot[7]) & U64  # the lane's overflow into the wave's
        lanes_done, scratch[wave + 1] = scratch[wave + 1], scratch[wave + 1] + 1
        if lanes_done == L - 1:  # the wave's last lane: row 5 of every lane
            vec[5] = int(_signed(scratch[wave], 64) > 0)
            writes[5] += 1
            scratch[wave : wave + 2] = [0, 0]
    assert (writes == 1).all(), "a word of the vector written other than once"
    assert not any(scratch), "the counts not put back to 0"
    return vec.astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES) + ["int32_range"])
def test_fold_mirror_matches_plain(case):
    """The epilogue's model at both of K3's strip widths, with and without
    nlit, one scratch carried through all four calls."""
    if case == "int32_range":
        summ, _rng = _wild_rows()
    else:
        c = dict(CASES[case])
        L, NT = c.pop("L"), c.pop("NT")
        summ = _rows(L, NT, seed=L * 1000 + NT, **c)
    L = summ.shape[0]
    rng = np.random.default_rng(L)
    scratch = [0] * (STRIDE * (L + 1))
    nlit = rng.integers(0, 5000, L).astype(np.int32)
    for tb in (8, 32):
        for nl in (None, nlit):
            want = dk.wave_summary_plain(torch.from_numpy(summ), None if nl is None else torch.from_numpy(nl))
            np.testing.assert_array_equal(mirror_fold(summ, nl, tb, rng, scratch), want.numpy(),
                                          err_msg=f"strips of {tb}, nlit {nl is not None}")


def test_stage_dc_returns_the_fold():
    """``decode_kernels.stage_dc`` returns K3's vector beside its rows: on
    the CPU the plain fold of its plain rows."""
    rng = np.random.default_rng(3)
    L, NT = 3, 40
    delta = torch.from_numpy(rng.integers(1, 49, (L, wp.W_P, NT)).astype(np.int32))
    token = torch.from_numpy(rng.integers(0, 1 << 27, (L, wp.W_P, NT)).astype(np.int32))
    entries = torch.from_numpy(rng.integers(0, 48, (L, NT)).astype(np.int32))
    tok, summ, vec = dk.stage_dc(delta, token, entries, k1=104)
    want_t, want_s = dk.stage_dc_plain(delta, token, entries, 104)
    assert torch.equal(tok, want_t) and torch.equal(summ, want_s)
    assert torch.equal(vec, dk.wave_summary_plain(summ)) and not vec[6].any()


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
