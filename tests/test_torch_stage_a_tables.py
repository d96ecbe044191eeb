"""K1's decode tables (``decode_kernels.stage_a_tables_plain``, the plain
version of the table kernel in csrc/stage_a.cu) and a mirror of the stage-A
kernel's algorithm written here in plain PyTorch: short positions decoded
from the table entries and the extra bits read in place from the natural
stream window, long positions through the ladders. The mirror is held equal to ``stage_a_plain`` and to
the JAX package's Pallas kernel in interpret mode, on a real wave with a
garbage lane and on waves built from code lengths: litlen and distance
trees with 11-15-bit codes, fixed Huffman (reserved litlen 286/287 and
distance 30/31), a single distance code, a literal-only lane (empty
distance code) and payloads that end inside the last tile. The tables are
also held against the ladder at every 15-bit litlen prefix with random
tails. The pipeline is integer-only, so every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host

from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_np as dnp
from tpu_deflate_torch.codec import wave_prep as wp
from tpu_deflate_torch.format.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
from tpu_deflate_torch.kernels.huffman import huffman_lengths_batch

P = 8192  # payload bytes per lane: NT = 128 tiles, the Pallas kernel's block
SHIFT = 32 - dk.TAB_BITS


def _wave(ll: np.ndarray, d: np.ndarray, dist_empty, rng, row_bits=None) -> dict:
    """A wave of random payload bytes decoded with the given code lengths
    (L, 288) and (L, 32), as wave_prep builds it from a header parse."""
    L = ll.shape[0]
    rows = rng.integers(0, 256, (L, P), dtype=np.uint8)
    bits = np.full(L, 8 * P, np.int64) if row_bits is None else np.asarray(row_bits, np.int64)
    hp = dnp.HeaderParse(ll.astype(np.int32), d.astype(np.int32), np.asarray(dist_empty, bool),
                         np.zeros(L, np.int64), np.full(L, 2, np.int32), np.ones(L, bool))
    w, _ = wp._wave_arrays(rows, bits, hp)
    return w


def _skewed_lengths(rng, L: int, n_sym: int, width: int, ratio: float) -> np.ndarray:
    """Complete codes with many 11-15-bit codes: geometric frequencies over
    a random symbol order, length-limited to 15."""
    freqs = (1e12 * ratio ** np.stack([rng.permutation(n_sym) for _ in range(L)])).astype(np.int64) + 1
    out = np.zeros((L, width), np.int32)
    out[:, :n_sym] = huffman_lengths_batch(freqs, 15)
    return out


def _long_codes(rng) -> dict:
    """(a): litlen and distance trees with codes up to 15 bits."""
    return _wave(_skewed_lengths(rng, 3, 286, 288, 0.93), _skewed_lengths(rng, 3, 30, 32, 0.55),
                 [False] * 3, rng)


def _fixed(rng) -> dict:
    """(b): fixed Huffman, whose litlen 286/287 and distance 30/31 codes are
    reserved."""
    return _wave(np.tile(FIXED_LITLEN_LENGTHS, (2, 1)), np.tile(FIXED_DIST_LENGTHS, (2, 1)),
                 [False] * 2, rng)


def _one_dist_and_literal_only(rng) -> dict:
    """(c): a single distance code (with the header parse's dummy
    completion at symbol 31) and a lane with an empty distance code, both
    behind a litlen tree that has length codes; plus (e): payloads that end
    inside the last tile and one tile before it."""
    ll = _skewed_lengths(rng, 3, 286, 288, 0.97)
    d = np.zeros((3, 32), np.int32)
    d[0, 7] = 1
    d[0, 31] = 1
    d[2, :30] = 5
    return _wave(ll, d, [False, True, False], rng, row_bits=[8 * P - 37, 8 * P - 512 - 300, 8 * P])


@pytest.fixture(scope="module")
def real_wave():
    """Profile streams plus a garbage lane (random bytes behind a valid
    header), as in test_torch_decode_kernels.real_wave."""
    rng = np.random.default_rng(13)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, 30000)]).tobytes()[:100000]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    return wp._prep_wave(payloads, 4)


_SYNTHETIC = {"long_codes": _long_codes, "fixed": _fixed, "one_dist_literal_only": _one_dist_and_literal_only}


@pytest.fixture(scope="module", params=["real", *_SYNTHETIC])
def wave(request, real_wave):
    """(case name, wave dict)."""
    if request.param == "real":
        return request.param, real_wave
    return request.param, _SYNTHETIC[request.param](np.random.default_rng(len(request.param)))


def _meta(w: dict) -> torch.Tensor:
    return dk.build_meta(wp.wave_to_tensors(w, torch.device("cpu")))


def _rev32(x: torch.Tensor) -> torch.Tensor:
    """Bit reversal of 32-bit values held in int64."""
    return sum(dk._rev8((x >> (8 * k)) & 255) << (24 - 8 * k) for k in range(4))


def mirror_stage_a(grid: torch.Tensor, meta: torch.Tensor):
    """The stage-A kernel's algorithm: for a short position, two table
    gathers indexed by stream bits and the extra bits read in place from the
    natural window; a long position through the ladders (stage_a_plain).
    Returns (delta, token, long)."""
    m = meta.to(torch.int64)
    tab = dk.stage_a_tables_plain(meta).to(torch.int64)
    vR, vR2 = dk.stage_a_windows(grid)
    L, W, NT = vR.shape
    # Stream bits pos..pos+62 (the kernel reads no further than bit 41).
    nat = _rev32(vR) | ((_rev32(vR2) & 0x7FFFFFFF) << 32)

    def gather(part: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return part.gather(1, idx.reshape(L, -1)).view(L, W, NT)

    le = gather(tab[:, : dk.TAB_N], nat & (dk.TAB_N - 1))
    ln, kind, payload = le & 15, (le >> 4) & 7, (le >> 16) & 0xFFFF
    match = kind == dk.K_MATCH
    rb = torch.where(match, payload & 7, 0)
    run = (payload >> 3) + 3 + ((nat >> ln) & ((1 << rb) - 1))
    d1 = ln + rb
    de = gather(tab[:, dk.TAB_N :], (nat >> d1) & (dk.TAB_N - 1))
    long = ((le & dk.E_LONG) != 0) | (match & ((de & dk.E_LONG) != 0))
    dln, dbits = de & 15, (de >> 6) & 15
    dist = ((de >> 16) & 0xFFFF) + 1 + ((nat >> (d1 + dln)) & ((1 << dbits) - 1))

    pos = torch.arange(W).view(1, W, 1) + W * torch.arange(NT).view(1, 1, NT)
    bits = m[:, wp.MA_PBITS].view(L, 1, 1)
    end_len = pos + ln
    end_run = end_len + rb
    end_dcode = end_run + dln
    end_all = end_dcode + dbits
    errc = torch.zeros_like(ln)
    for cond, code in (
        ((kind == dk.K_MISSING) | (end_len > bits), wp._ERR_END),
        (kind == dk.K_RES, wp._ERR_RESERVED_LEN),
        (match & (end_run > bits), wp._ERR_END),
        (match & (m[:, wp.MA_DEMPTY].view(L, 1, 1) != 0), wp._ERR_EMPTY_DIST),
        (match & ((de & dk.E_DFOUND) == 0), wp._ERR_END),
        (match & (end_dcode > bits), wp._ERR_END),
        (match & ((de & dk.E_DRES) != 0), wp._ERR_RESERVED_DIST),
        (match & (end_all > bits), wp._ERR_END),
    ):
        errc = torch.where((errc == 0) & cond, code, errc)
    eob = kind == dk.K_EOB
    delta = torch.where(errc != 0, wp.SENT_ERR,
                        torch.where(eob, wp.SENT_EOB, torch.where(match, end_all, end_len) - pos))
    token = torch.where(kind == dk.K_LIT, payload,
                        wp.TOKEN_MATCH_BIT | (run.clamp(3, 258) << 16) | (dist - 1).clamp(0, 65535))
    token = torch.where(eob, -(1 + ln), token)
    token = torch.where(errc != 0, -(100 + errc), token)
    ladder_d, ladder_t = dk.stage_a_plain(grid, meta)
    delta = torch.where(long, ladder_d.to(torch.int64), delta)
    token = torch.where(long, ladder_t.to(torch.int64), token)
    return delta.to(torch.int32), token.to(torch.int32), long


def test_mirror_matches_plain_and_pallas(wave):
    name, wave = wave
    grid = torch.from_numpy(np.array(wave["grid"]))
    meta = _meta(wave)
    got_d, got_t, long = mirror_stage_a(grid, meta)
    want_d, want_t = dk.stage_a_plain(grid, meta)
    assert torch.equal(got_d, want_d) and torch.equal(got_t, want_t)
    pal_d, pal_t = dp.stage_a_pallas(jnp.asarray(wave["grid"]), dp.build_meta(wave), interpret=True)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(pal_d))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(pal_t))
    share = float(long.float().mean())
    assert share < 0.5  # the table route carries most positions
    if name != "fixed":  # fixed codes are at most 9 bits long: no long position
        assert share > 0.0


def test_tables_match_ladder_at_every_15_bit_prefix(wave):
    """Every left-aligned 15-bit window prefix, with a random 17-bit tail,
    per lane: where the entry of the window's first TAB_BITS stream bits is
    short, it holds exactly what the ladder gives for the window, for the
    litlen and the distance codes."""
    _name, wave = wave
    meta = _meta(wave)
    m = meta.to(torch.int64)
    tab = dk.stage_a_tables_plain(meta).to(torch.int64)
    L = m.shape[0]
    g = torch.Generator().manual_seed(L)
    v = (torch.arange(1 << 15).view(1, -1) << 17) | torch.randint(0, 1 << 17, (L, 1 << 15), generator=g)
    at = _rev32(v) & (dk.TAB_N - 1)  # the window's first stream bits, in stream order

    le = tab[:, : dk.TAB_N].gather(1, at)
    c = dk._litlen(m, v)
    short = (le & dk.E_LONG) == 0
    assert bool(short.any())
    kind = torch.where(~c["found"], dk.K_MISSING, torch.where(c["res"], dk.K_RES, torch.where(
        c["eob"], dk.K_EOB, torch.where(c["lit"], dk.K_LIT, dk.K_MATCH))))
    payload = torch.where(c["lit"], dk.wrap_int32(c["lit_rank"]), c["mdesc"])
    assert torch.equal((le & 15)[short], c["ln"][short])
    assert torch.equal(((le >> 4) & 7)[short], kind[short])
    assert torch.equal(((le >> 16) & 0xFFFF)[short], payload[short])
    # a code of at most TAB_BITS bits is always short
    assert bool(short[c["ln"] <= dk.TAB_BITS].all())

    de = tab[:, dk.TAB_N :].gather(1, at)
    d = dk._dist(m, v)
    dshort = (de & dk.E_LONG) == 0
    dist_bits = ((d["ds"] >> 1) - 1).clamp(min=0)
    dbase_m1 = torch.where(d["ds"] < 4, d["ds"], (2 + (d["ds"] & 1)) << dist_bits)
    assert torch.equal((de & 15)[dshort], d["ln"][dshort])
    assert torch.equal(((de & dk.E_DFOUND) != 0)[dshort], d["found"][dshort])
    assert torch.equal(((de & dk.E_DRES) != 0)[dshort], (d["ds"] >= 30)[dshort])
    assert torch.equal(((de >> 6) & 15)[dshort], dist_bits[dshort])
    assert torch.equal(((de >> 16) & 0xFFFF)[dshort], dbase_m1[dshort])


def test_long_codes_reach_15_bits():
    """The synthetic trees do have the codes the long route exists for."""
    rng = np.random.default_rng(1)
    ll = _skewed_lengths(rng, 3, 286, 288, 0.93)
    d = _skewed_lengths(rng, 3, 30, 32, 0.55)
    assert (ll.max(axis=1) == 15).all() and (d.max(axis=1) == 15).all()
    assert ((ll > 10).sum(axis=1) > 10).all() and ((d > 10).sum(axis=1) > 2).all()


def test_tables_wrapper_on_cpu(real_wave):
    meta = _meta(real_wave)
    before = dict(dk.LAUNCHES)
    tab = dk.stage_a_tables(meta)
    assert dk.LAUNCHES == before
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (meta.shape[0], dk.TAB_W)
    assert torch.equal(tab, dk.stage_a_tables_plain(meta))
    with pytest.raises(ValueError):
        dk.stage_a_tables(meta[:, :64].contiguous())
    with pytest.raises(ValueError):
        dk.stage_a_tables(meta.to(torch.int64))
