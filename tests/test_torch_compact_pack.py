"""The host route's compaction and packed pull in one pass
(``decode_kernels.compact_pack``, K4's pull mode in csrc/compact.cu) on the
CPU: its plain version ``compact_pack_plain`` against the JAX package's two
steps on the same inputs (``decode_pallas.compact_flat_pallas`` in
interpret mode, then ``decode_jax_v2._pack_tokens_jit``, as
``test_torch_decode_kernels.py`` and ``test_torch_pack_tokens.py`` run
them), a NumPy mirror of the kernel (``compact_pull_cases.mirror_pull``)
against the plain version, the wrapper on CPU tensors, and the ``"off"``
decode, whose waves take it.

Inputs: K3-like waves (each tile's tokens, then its -1 padding; -2 and
INT_MIN among the padding; literal ranks 0 and 255; all-literal, all-match
and all-padding lanes) at M a multiple of 128, of 4 but not 32, and of
neither, K3's own output on a real wave at k1 104 and 512, the smoke's edge
lanes (``chip_smoke.compact_edge_lanes``) and its seam lanes
(``chip_smoke.seam_lanes``: segments whose first slot is not a multiple of
32 and runs of segments with no valid entry between two seam words). The
Pallas compaction takes M % 128 == 0 only; at other M its input gets -1
columns up to the next multiple of 128, which land in the padding, and its
output is cut back to M. Integer-only, so every comparison is exact."""

from __future__ import annotations

import gzip as pygzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from compact_pull_cases import THREADS, k3_tokens, mirror_pull, pull_per
from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate.codec.profile import profile_compress_host

from tpu_deflate_torch import native
from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import wave_prep as wp

CPU = torch.device("cpu")


def _reference(tok: np.ndarray, planes: np.ndarray) -> tuple:
    L, M = tok.shape
    wide = np.full((L, -(-M // 128) * 128), -1, np.int32)
    wide[:, :M] = tok
    flat = dp.compact_flat_pallas(jnp.asarray(wide), jnp.asarray(planes), interpret=True)[:, :M]
    bitmap, lit, match, nlit = v2._pack_tokens_jit(flat)
    return (np.asarray(bitmap).view(np.int32), np.asarray(lit), np.asarray(match), np.asarray(nlit).astype(np.int32))


def _plain(tok: np.ndarray, planes: np.ndarray) -> tuple:
    return tuple(t.numpy() for t in dk.compact_pack_plain(torch.from_numpy(tok), torch.from_numpy(planes)))


def _eq(got: tuple, want: tuple) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def real_wave():
    """A real 4-lane wave: three profile members of text and a garbage lane
    (random bytes behind a valid header), as test_torch_decode_kernels'."""
    rng = np.random.default_rng(13)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(40)]
    data = np.concatenate([words[i] for i in rng.integers(0, 40, 8000)]).tobytes()[:30000]
    buf = np.frombuffer(profile_compress_host(data), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)][:3]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 1500, dtype=np.uint8).tobytes())
    return wp.wave_to_tensors(wp._prep_wave(payloads, 4), CPU)


def _k3(w: dict, k1: int) -> np.ndarray:
    dt, tt = dk.stage_a(w["grid"], dk.build_meta(w))
    _e, _f, entries = dk.stage_c(dk.stage_b(dt), w["rem"])
    tokc, _summ, _small = dk.stage_dc(dt, tt, entries, k1=k1)
    return tokc.reshape(tokc.shape[0], -1).numpy()


# name -> (tokens, planes)
CASES = {
    "k3 4x32 k1=104": lambda: k3_tokens(5, 32, 104, seed=1),
    "k3 5x9 k1=13 (M % 4 != 0)": lambda: k3_tokens(5, 9, 13, seed=2),
    "k3 5x7 k1=20 (M % 32 != 0)": lambda: k3_tokens(5, 7, 20, seed=3),
    "edge lanes M=1001": lambda: chip_smoke.compact_edge_lanes(1001, 1, seed=4),
    "edge lanes M=4224": lambda: chip_smoke.compact_edge_lanes(4224, 1, seed=5),
    "seam lanes M=9216": lambda: chip_smoke.seam_lanes(9216, 3, seed=6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(case):
    tok, planes = CASES[case]()
    _eq(_plain(tok, planes), _reference(tok, planes))


@pytest.mark.parametrize("k1", [104, wp.W_P])
def test_plain_matches_reference_on_k3_output(real_wave, k1):
    tok = _k3(real_wave, k1)
    planes = real_wave["lit_planes"].numpy()
    assert (tok == -1).any() and (tok >= 256).any() and ((tok >= 0) & (tok < 256)).any()
    _eq(_plain(tok, planes), _reference(tok, planes))


@pytest.mark.parametrize("per", [4, 16])
@pytest.mark.parametrize("order", ["in", "reversed", "shuffled"])
@pytest.mark.parametrize("case", ["k3 4x32 k1=104", "k3 5x9 k1=13 (M % 4 != 0)", "edge lanes M=4224",
                                  "seam lanes M=9216"])
def test_mirror_matches_plain(case, order, per):
    tok, planes = CASES[case]()
    _eq(mirror_pull(tok, planes, order, seed=len(case), per=per), _plain(tok, planes))


def test_seam_lanes_meet_the_seams():
    """The seam lanes hold what chip_smoke.seam_lanes says: at both segment
    sizes, segments whose first slot is not a multiple of 32 and a word
    that takes the bits of three segments or more (so runs of segments
    with no valid entry lie between its writers)."""
    tok, _planes = chip_smoke.seam_lanes(40960, 4, seed=8)
    for per in (4, 16):
        seg = THREADS * per
        counts = (tok >= 0).reshape(4, -1, seg).sum(2)
        starts = np.cumsum(counts, axis=1) - counts
        assert (starts[counts > 0] % 32 != 0).any()
        shared = 0
        for lane in range(4):
            live = counts[lane] > 0
            first, last = starts[lane][live] >> 5, (starts[lane][live] + counts[lane][live] - 1) >> 5
            _words, writers = np.unique(np.concatenate([np.arange(a, b + 1) for a, b in zip(first, last)]),
                                       return_counts=True)
            shared = max(shared, int(writers.max()))
            assert (~live).any()
        assert shared >= 3


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_mirror_matches_plain_on_a_wave_of_4096_entry_segments(order):
    """A wave of enough 4096-entry segments for the kernel's larger
    segments (PER 16), seam lanes among K3-like ones, M not a multiple of
    the segment."""
    tok, planes = k3_tokens(80, 96, 104, seed=9)
    seam, seam_planes = chip_smoke.seam_lanes(96 * 104, 8, seed=10)
    tok, planes = np.concatenate([tok, seam]), np.concatenate([planes, seam_planes])
    assert pull_per(*tok.shape) == 16
    _eq(mirror_pull(tok, planes, order, seed=11), _plain(tok, planes))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    tok, planes = k3_tokens(5, 8, 40, seed=12)
    small = torch.zeros((7, 5), dtype=torch.int32)
    small[:6] = torch.arange(30, dtype=torch.int32).view(6, 5)
    before = dict(dk.LAUNCHES)
    got = dk.compact_pack(torch.from_numpy(tok), torch.from_numpy(planes), small)
    assert dk.LAUNCHES == before
    want = _plain(tok, planes)
    _eq(tuple(t.numpy() for t in got), want)
    assert torch.equal(small[6], torch.from_numpy(want[3])) and got[3].data_ptr() == small[6].data_ptr()
    assert torch.equal(small[:6], torch.arange(30, dtype=torch.int32).view(6, 5))
    for bad in ((torch.from_numpy(tok).to(torch.int64), torch.from_numpy(planes), small),
                (torch.from_numpy(tok), torch.from_numpy(planes[:, :63].copy()), small),
                (torch.from_numpy(tok), torch.from_numpy(planes), small[:6].clone())):
        with pytest.raises(ValueError):
            dk.compact_pack(*bad)


def test_off_decode_takes_the_fused_pull():
    """The "off" decode on the CPU: byte-exact, one compact_pack a wave and
    no compact_flat, and the vector the host pulls holds each lane's
    literal count in row 6."""
    rng = np.random.default_rng(14)
    text = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta", b"x"], 30000))
    data = text[:150000] + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    gz = native.compress_members_native(data)
    seen, flats = [], []
    pack, flat = pv2.compact_pack, dk.compact_flat

    def pack_spy(tok, lit_planes, small):
        out = pack(tok, lit_planes, small)
        seen.append((tok.clone(), lit_planes.clone(), small))
        return out

    def flat_spy(tok, lit_planes):
        flats.append(tok.shape)
        return flat(tok, lit_planes)

    pv2.compact_pack, dk.compact_flat = pack_spy, flat_spy
    try:
        got = pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="off")
    finally:
        pv2.compact_pack, dk.compact_flat = pack, flat
    assert got == data == pygzip.decompress(gz)
    assert len(seen) == pv2.LAST_DECODE_STATS["waves"] > 0 and not flats
    for tok, planes, small in seen:
        want = dk.compact_pack_plain(tok, planes)
        assert torch.equal(small[6], want[3]) and int(small[6].sum()) > 0
