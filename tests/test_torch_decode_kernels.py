"""The port's decode kernels (plain PyTorch versions, which the wrappers
run on CPU tensors) against the JAX package: the XLA twins and the Pallas
kernels in interpret mode, on the same inputs made with numpy. The
pipeline is integer-only, so every comparison is exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import wave_prep as wp


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.empty(0, want.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def real_wave():
    """Profile streams plus a garbage lane (random bytes behind a valid
    header), as in test_pallas.test_stage_a_pallas_matches_xla."""
    rng = np.random.default_rng(13)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, 30000)]).tobytes()[:100000]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    return wp._prep_wave(payloads, 4)


@pytest.fixture(scope="module")
def random_wave():
    """Random deltas with EOB/error sentinels and random tokens, as in
    test_pallas.small_wave; (L, 512, NT) tile layout."""
    rng = np.random.default_rng(7)
    L, NT = 2, 128
    B = dp.W_P * NT
    delta = rng.integers(1, 49, (L, B)).astype(np.uint8)
    delta[rng.random((L, B)) < 0.002] = 127
    delta[rng.random((L, B)) < 0.001] = 255
    token = rng.integers(0, 256, (L, B)).astype(np.int32)
    m = rng.random((L, B)) < 0.33
    runs = rng.integers(3, 259, (L, B))
    dists = rng.integers(0, 1024, (L, B))
    token = np.where(m, v2.TOKEN_MATCH_BIT | (runs << 16) | dists, token).astype(np.int32)
    token[delta == 127] = -(1 + 7)
    token[delta == 255] = -(100 + 13)

    def tiles(a):
        return np.ascontiguousarray(a.astype(np.int32).reshape(L, NT, dp.W_P).transpose(0, 2, 1))

    return tiles(delta), tiles(token)


def test_stage_a_matches_xla_and_pallas(real_wave):
    w = real_wave
    meta = dk.build_meta(wp.wave_to_tensors(w, torch.device("cpu")))
    got_d, got_t = dk.stage_a(_t(w["grid"]), meta)
    want_d, want_t = v2._stage_a_wave(w)
    _eq(got_d, want_d)
    _eq(got_t, want_t)
    pal_d, pal_t = dp.stage_a_pallas(jnp.asarray(w["grid"]), dp.build_meta(w), interpret=True)
    _eq(got_d, pal_d)
    _eq(got_t, pal_t)
    # the garbage lane reaches the error classification at most positions
    assert (got_d[3] == wp.SENT_ERR).sum() > 1000


def test_stage_b_matches_pallas(random_wave):
    delta, _ = random_wave
    got = dk.stage_b(_t(delta))
    assert got.shape == (2, 128, dp.E_WIN)
    _eq(got, dp.stage_b_pallas(jnp.asarray(delta), interpret=True))


def test_stage_b_matches_pallas_real(real_wave):
    want_d, _ = v2._stage_a_wave(real_wave)
    d = np.asarray(want_d)
    _eq(dk.stage_b(_t(d)), dp.stage_b_pallas(jnp.asarray(d), interpret=True))


@pytest.mark.parametrize("NT", [128, 3])
def test_stage_c_matches_xla(NT):
    """Both branches of the reference (NT % 128 == 0 or not), on transfer
    maps with values in [0, 48) plus EOB / error sentinels."""
    rng = np.random.default_rng(NT)
    L = 2
    tr = rng.integers(0, dp.E_WIN, (L, NT, dp.E_WIN)).astype(np.uint8)
    tr[rng.random(tr.shape) < 0.003] = 127
    tr[rng.random(tr.shape) < 0.002] = 255
    entry0 = rng.integers(0, 8, L).astype(np.int32)
    got_e, got_f = pv2.stage_c_entries(_t(tr), _t(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(tr), jnp.asarray(entry0).astype(jnp.uint8))
    _eq(got_e, want_e)
    _eq(got_f, want_f)


def test_stage_c_matches_xla_on_stage_b_output(random_wave):
    delta, _ = random_wave
    tr = np.asarray(dp.stage_b_pallas(jnp.asarray(delta), interpret=True))
    entry0 = np.array([0, 5], np.int32)
    got_e, got_f = pv2.stage_c_entries(_t(tr), _t(entry0))
    want_e, want_f = v2.stage_c_entries(jnp.asarray(tr), jnp.asarray(entry0).astype(jnp.uint8))
    _eq(got_e, want_e)
    _eq(got_f, want_f)


@pytest.mark.parametrize("k1", dp.K1_CHOICES + (dp.W_P,))
def test_stage_dc_matches_pallas(random_wave, k1):
    delta, token = random_wave
    L, _, NT = delta.shape
    rng = np.random.default_rng(11)
    entries = rng.integers(0, dp.E_WIN, (L, NT)).astype(np.int32)
    entries[:, 1::5] = 127  # dead tiles
    # tile 2 of lane 0: every position is a 1-bit literal from entry 0, so
    # the tile holds 512 tokens and overflows every k1 below 512
    delta = delta.copy()
    token = token.copy()
    delta[0, :, 2] = 1
    token[0, :, 2] = np.arange(dp.W_P) % 256
    entries[0, 2] = 0
    got_t, got_s = dk.stage_dc(_t(delta), _t(token), _t(entries), k1=k1)
    want_t, want_s = dp.stage_dc_pallas(
        jnp.asarray(delta), jnp.asarray(token), jnp.asarray(entries), k1=k1, interpret=True
    )
    _eq(got_t, want_t)
    _eq(got_s, want_s)
    assert int(got_s[0, wp.ROW_OVERFLOW, 2]) == int(k1 < dp.W_P)


@pytest.mark.parametrize("k1", (dp.K1_CHOICES[0], dp.W_P))
def test_stage_dc_matches_pallas_at_edge_deltas(random_wave, k1):
    """Deltas of 0 and below stop a cursor after its position; deltas of 60
    and at the int32 limits leave the tile (the kernel adds its hop
    unsigned, the references wrap in int32 or work in int64); dense EOB and
    error sentinels; entries 0, 47, 48 (a dead tile) and 255. The first
    lane's token counts are also held against a serial walk."""
    _delta, token = random_wave
    L, _, NT = token.shape
    rng = np.random.default_rng(19)
    delta = rng.integers(1, 49, (L, dp.W_P, NT)).astype(np.int64)
    u = rng.random(delta.shape)
    for lo, hi, value in ((0.00, 0.03, 0), (0.03, 0.06, -5), (0.06, 0.08, 60), (0.08, 0.10, 2**31 - 1),
                          (0.10, 0.12, -(2**31)), (0.12, 0.20, 127), (0.20, 0.26, 255)):
        delta[(u >= lo) & (u < hi)] = value
    delta = delta.astype(np.int32)
    entries = rng.integers(0, dp.E_WIN, (L, NT)).astype(np.int32)
    entries[:, :4] = (0, 47, 48, 255)
    got_t, got_s = dk.stage_dc(_t(delta), _t(token), _t(entries), k1=k1)
    want_t, want_s = dp.stage_dc_pallas(
        jnp.asarray(delta), jnp.asarray(token), jnp.asarray(entries), k1=k1, interpret=True
    )
    _eq(got_t, want_t)
    _eq(got_s, want_s)
    adv = {127: 4096, 255: 8192}
    for t in range(NT):
        cur, count = int(entries[0, t]), 0
        cur = cur if cur < dp.E_WIN else dp.W_P
        while 0 <= cur < dp.W_P:
            d = int(delta[0, cur, t])
            count += d < 127
            a = adv.get(d, d)
            if a <= 0:
                break
            cur += a
        assert int(got_s[0, wp.ROW_COUNT, t]) == count


def _compact_case(rng, L, M, density):
    tok = rng.integers(0, 1 << 20, (L, M)).astype(np.int32)
    tok[rng.random((L, M)) >= density] = -1
    lit_mask = (rng.random((L, M)) < 0.4) & (tok >= 0)
    tok[lit_mask] = rng.integers(0, 256, int(lit_mask.sum()))
    lit_map = rng.integers(0, 256, (L, 256), dtype=np.uint8)
    j32 = np.arange(32)[None, None, :]
    lm = lit_map.reshape(L, 8, 32).astype(np.int64)
    planes = np.zeros((L, 8, 8), np.int64)
    for b in range(8):
        planes[:, b, :] = (((lm >> b) & 1) << j32).sum(axis=2)
    return tok, planes.reshape(L, 64).astype(np.int32)


_COMPACT_CASES = [(4, 512, 0.3), (3, 2048, 0.05), (2, 128, 1.0), (2, 256, 0.0)]


@pytest.mark.parametrize("L,M,density", _COMPACT_CASES)
def test_compact_flat_matches_pallas(L, M, density):
    tok, planes = _compact_case(np.random.default_rng(3), L, M, density)
    got = dk.compact_flat(_t(tok), _t(planes))
    _eq(got, dp.compact_flat_pallas(jnp.asarray(tok), jnp.asarray(planes), interpret=True))


@pytest.mark.parametrize("L,M,density", _COMPACT_CASES)
def test_compact_any_matches_pallas(L, M, density):
    tok, _ = _compact_case(np.random.default_rng(5), L, M, density)
    got = dk.compact_any(_t(tok))
    _eq(got, dp.compact_any_pallas(jnp.asarray(tok), interpret=True))


def test_cpu_calls_count_no_launch(random_wave):
    delta, token = random_wave
    before = dict(dk.LAUNCHES)
    dk.stage_b(_t(delta))
    dk.compact_any(_t(token[:, 0, :]))
    assert dk.LAUNCHES == before


def test_wrappers_reject_bad_inputs(random_wave):
    delta, token = random_wave
    d = _t(delta)
    with pytest.raises(ValueError):
        dk.stage_b(d.to(torch.int64))
    with pytest.raises(ValueError):
        dk.stage_b(d[:, :256, :].contiguous())
    with pytest.raises(ValueError):
        dk.stage_b(d.transpose(1, 2))
    with pytest.raises(ValueError):
        dk.stage_dc(d, _t(token), torch.zeros((2, 127), dtype=torch.int32), k1=104)
    with pytest.raises(ValueError):
        dk.stage_dc(d, _t(token), torch.zeros((2, 128), dtype=torch.int32), k1=513)
    with pytest.raises(ValueError):
        dk.stage_a(torch.zeros((1, 64, 3), dtype=torch.uint8), torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.compact_flat(_t(token[:, 0, :]), torch.zeros((2, 63), dtype=torch.int32))
