"""The port's member-parallel encoder (tpu_deflate_torch.codec.encode on
a CPU device, where every kernel wrapper runs its plain version) against
the JAX package's encode_jax on the same numpy inputs: the analysis dict
key by key, and compress_members byte for byte against
compress_members_tpu at efforts 1-3. Then the member CRC-32s against
zlib, round trips through gzip and the port's own decoder, and the
engine's front door. The encoder is integer-only: exact equality."""

from __future__ import annotations

import gzip
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_deflate.codec import encode_jax as ej
from tpu_deflate_torch import engine
from tpu_deflate_torch.codec import decode_np
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.kernels.checksum_lanes import crc32_members

CPU = torch.device("cpu")
M = 64 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members() -> bytes:
    """Four members (the encoder's smallest lane bucket): text (routes
    dynamic), random bytes (stored), runs then zeros, and a 60-byte
    printable tail (fixed)."""
    rng = np.random.default_rng(9)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(80)]
    text = np.concatenate([words[i] for i in rng.integers(0, 80, 30000)])[:M]
    rand = rng.integers(0, 256, M, dtype=np.uint8)
    runs = np.repeat(rng.integers(0, 4, 1000, dtype=np.uint8), rng.integers(1, 300, 1000))[: M // 2]
    zeros = np.zeros(M // 2, np.uint8)
    tail = rng.integers(33, 127, 60, dtype=np.uint8)
    return np.concatenate([text, rand, runs, zeros, tail]).tobytes()


DATA = _members()


def _batch(data: bytes):
    """One lane batch of data and its lengths, padded with empty lanes to
    the reference's lane bucket (4, 16 or 64), as analyze_device takes it."""
    n = len(data)
    L_real = -(-n // M)
    L = next(b for b in (4, 16, 64) if L_real <= b)
    lengths = np.zeros(L, np.int32)
    lengths[:L_real] = M
    lengths[L_real - 1] = n - (L_real - 1) * M
    padded = np.zeros((L, M), np.uint8)
    padded.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    return padded, lengths


_REF: dict = {}


def _reference(effort: int) -> bytes:
    if effort not in _REF:
        _REF[effort] = ej.compress_members_tpu(DATA, effort=effort)
    return _REF[effort]


@pytest.mark.parametrize("lazy,quality", [(False, 0), (True, 0), (True, 1), (True, 2)])
def test_analysis_matches_reference(lazy, quality):
    padded, lengths = _batch(DATA)
    want = ej.analyze_device(jnp.asarray(padded), jnp.asarray(lengths), lazy, quality)
    got = pe.analyze(torch.from_numpy(padded), torch.from_numpy(lengths), lazy, quality)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("effort", [1, 2, 3])
def test_compress_members_byte_identical(effort):
    got = pe.compress_members(DATA, device=CPU, effort=effort)
    assert got == _reference(effort)
    assert gzip.decompress(got) == DATA


def test_effort_0_is_effort_1():
    assert pe.compress_members(DATA, device=CPU, effort=0) == _reference(1)


def test_routes_dynamic_stored_and_fixed():
    buf = np.frombuffer(_reference(2), np.uint8)
    members = decode_np.split_members(buf)
    btypes = [(int(buf[m.payload_start]) >> 1) & 3 for m in members]
    assert btypes == [2, 0, 2, 1]


@pytest.mark.parametrize("data", [b"", b"\x7f"], ids=["empty", "one_byte"])
def test_tiny_inputs_byte_identical(data):
    got = pe.compress_members(data, device=CPU, effort=2)
    assert got == ej.compress_members_tpu(data, effort=2)
    assert gzip.decompress(got) == data


def test_crc32_members_match_zlib():
    padded, lengths = _batch(DATA)
    n = int((lengths > 0).sum())
    crcs = crc32_members(torch.from_numpy(padded[:n]), lengths[:n])
    assert crcs.dtype == np.uint32
    assert [int(c) for c in crcs] == [zlib.crc32(padded[i, : lengths[i]].tobytes()) for i in range(n)]


def test_round_trip_through_the_ports_decoder():
    """A device-encoded stream (15-bit codes) decodes with the port's own
    decode on the CPU, device resolve and lane CRC included."""
    gz = _reference(2)
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == DATA


def test_engine_compress_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.compress(b"abc")
    with pytest.raises(ValueError):
        engine.compress(b"abc", engine="tpu")


@pytest.mark.parametrize("effort", [4, 5])
def test_engine_continuous_raises_without_cuda(monkeypatch, effort):
    """The continuous-history encode needs CUDA, and never runs on the CPU."""
    from tpu_deflate_torch.codec import continuous

    def on_the_cpu(*args, **kwargs):
        raise AssertionError("the continuous encode ran without CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(continuous, "compress_continuous", on_the_cpu)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.compress(b"abc", effort=effort)


def test_engine_compress_not_ported(monkeypatch):
    """The sharded encode (mesh=) is ported: over a CPU mesh (the device
    the engine asks for monkeypatched to the CPU) it writes the unsharded
    member, and a mesh of other devices than the call's is refused."""
    from tpu_deflate_torch.codec import continuous
    from tpu_deflate_torch.dist.mesh import make_codec_mesh

    mesh = make_codec_mesh(devices=[CPU] * 2)
    monkeypatch.setattr(engine, "_cuda", lambda name: CPU)
    data = b"abc" * 3000
    assert engine.compress(data, effort=4, mesh=mesh) == continuous.compress_continuous(data, device=CPU)
    monkeypatch.setattr(engine, "_cuda", lambda name: torch.device("cuda"))
    with pytest.raises(ValueError, match="mesh"):
        engine.compress(b"abc", effort=4, mesh=mesh)
