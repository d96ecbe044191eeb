"""The port's decode slice end to end on the CPU (plain versions of the
kernels) against the JAX package: the wave body's 7-tuple, whole gzip
streams, error Reasons and the conformance vectors. Integer-only, so every
comparison is exact equality."""

from __future__ import annotations

import gzip as pygzip
import os
import random
import zlib

import numpy as np
import pytest
import torch

from tpu_deflate import native
from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec.profile import profile_compress_host
from tpu_deflate.format.errors import DataFormatError

from tpu_deflate_torch import engine
from tpu_deflate_torch.codec import decode_kernels as dk
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import wave_prep as wp

from vectors import BAD_VECTORS, GOOD_VECTORS, bits_to_bytes

CPU = torch.device("cpu")


def _structured(seed, n):
    rng = random.Random(seed)
    words = [bytes(rng.getrandbits(8) for _ in range(rng.randint(2, 9))) for _ in range(40)]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words)
    return bytes(out[:n])


def _compress(data):
    if native.available():
        return native.compress_members_native(data)
    return profile_compress_host(data)


def _port(gz: bytes, **kw) -> bytes:
    return pv2.gzip_decompress_v2(gz, device=CPU, **kw)


def _reason(fn, *args):
    try:
        fn(*args)
    except DataFormatError as e:
        return e.reason
    return None


def test_run_wave_matches_pallas_wave(monkeypatch):
    """The port's wave body vs the JAX Pallas wave body (interpret mode),
    over the whole 7-tuple."""
    monkeypatch.setattr(v2, "_use_pallas", lambda: True)
    rng = np.random.default_rng(3)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = np.concatenate([words[i] for i in rng.integers(0, 50, 20000)]).tobytes()[:40000]
    buf = np.frombuffer(profile_compress_host(data, member_data=16384), np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    w = wp._prep_wave(payloads, 4)
    got = pv2.run_wave(wp.wave_to_tensors(w, CPU))
    want = v2._run_wave_pallas(w)
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"field {i}")
    assert not bool(got[6]) and bool(got[2].all())


@pytest.mark.parametrize("n", [0, 1, 1000, 30000])
def test_gzip_roundtrip_matches_reference(n):
    data = _structured(n, n)
    gz = _compress(data)
    assert _port(gz) == v2.gzip_decompress_tpu_v2(gz, device_resolve="off") == data
    stats = pv2.LAST_DECODE_STATS
    assert stats["device_resolved"] == 0
    assert stats["members"] == stats["stored"] + stats["host_resolved"]


def test_gzip_mixed_stored_and_huffman():
    data = os.urandom(70000) + bytes(70000) + _structured(1, 70000)
    gz = _compress(data)
    assert _port(gz) == v2.gzip_decompress_tpu_v2(gz, device_resolve="off") == data
    stats = pv2.LAST_DECODE_STATS
    assert stats["stored"] >= 1 and stats["host_resolved"] >= 1
    assert stats["waves"] >= 1
    # on the CPU the plain versions run: no kernel launch is counted
    assert set(stats["launches"].values()) == {0}


def test_gzip_foreign_stream():
    data = _structured(8, 100_000)
    gz = pygzip.compress(data, compresslevel=9)
    assert _port(gz) == v2.gzip_decompress_tpu_v2(gz, device_resolve="off") == data


def test_raw_foreign_multiblock_stream():
    """A zlib raw DEFLATE stream (several dynamic blocks) through the
    port's block-chain decode and the reference's."""
    data = _structured(9, 200_000)
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    assert pv2.inflate_raw_v2(raw, device=CPU) == v2.inflate_raw_v2(raw) == data


def test_continuous_effort5_member():
    if not native.available():
        pytest.skip("native engine unavailable")
    from tpu_deflate.engine import compress

    data = _structured(7, 200_000)
    gz = compress(data, engine="native", effort=5)
    assert len(dj.split_members(np.frombuffer(gz, np.uint8))) == 1
    assert _port(gz) == v2.gzip_decompress_tpu_v2(gz, device_resolve="off") == data


@pytest.mark.parametrize("where", ["early", "middle", "trailer"])
def test_corruption_same_reason(where):
    data = _structured(5, 60000)
    gz = bytearray(_compress(data))
    m = dj.split_members(np.frombuffer(bytes(gz), np.uint8))[0]
    at = {"early": m.payload_start + 100, "middle": len(gz) // 2, "trailer": m.end - 6}[where]
    gz[at] ^= 0x55
    got = _reason(_port, bytes(gz))
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="off"), bytes(gz))
    assert got is not None and got == want


@pytest.mark.parametrize("name,bits,hexout", GOOD_VECTORS, ids=[v[0] for v in GOOD_VECTORS])
def test_good_vector(name, bits, hexout):
    assert pv2.inflate_raw_v2(bits_to_bytes(bits, "0"), device=CPU) == bytes.fromhex(hexout)


@pytest.mark.parametrize("name,bits,reason", BAD_VECTORS, ids=[v[0] for v in BAD_VECTORS])
def test_bad_vector(name, bits, reason):
    with pytest.raises(DataFormatError) as ei:
        pv2.inflate_raw_v2(bits_to_bytes(bits, "0"), device=CPU)
    assert ei.value.reason == reason


def test_vectors_batched_one_wave():
    """All vectors as one lane batch (padding bits set to 1): each lane
    lands on its own verdict."""
    payloads = [bits_to_bytes(b, "1") for _, b, _ in GOOD_VECTORS]
    payloads += [bits_to_bytes(b, "0") for _, b, _ in BAD_VECTORS]
    states = pv2.decode_deflate_streams_v2(payloads, CPU)
    for (name, _, hexout), st in zip(GOOD_VECTORS, states):
        assert pv2._resolve_lane(st, None) == bytes.fromhex(hexout), name
    for (name, _, reason), st in zip(BAD_VECTORS, states[len(GOOD_VECTORS) :]):
        with pytest.raises(DataFormatError) as ei:
            pv2._resolve_lane(st, None)
        assert ei.value.reason == reason, name


def test_overflow_rerun(monkeypatch):
    """A degenerate stream whose tiles hold more tokens than the largest
    k1 (1- and 2-bit literal codes) reruns its wave with k1 = 512."""
    k1s = []
    run_wave = pv2.run_wave

    def spy(w, *, k1=None):
        k1s.append(k1)
        return run_wave(w, k1=k1)

    monkeypatch.setattr(pv2, "run_wave", spy)
    data = bytes([0, 1]) * 40000
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    raw = co.compress(data) + co.flush()
    st = pv2.decode_deflate_streams_v2([raw], CPU)[0]
    assert pv2._resolve_lane(st, None) == data == v2.inflate_raw_v2(raw)
    assert wp.W_P in k1s


def test_engine_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gz = _compress(b"abc" * 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.decompress(gz, engine="cuda")
    with pytest.raises(ValueError):
        engine.decompress(gz, engine="native")


def test_device_resolve_on_not_ported():
    gz = _compress(b"abc" * 100)
    with pytest.raises(NotImplementedError, match="K5"):
        _port(gz, device_resolve="on")
    assert _port(gz, device_resolve="off") == _port(gz, device_resolve="auto") == b"abc" * 100


def test_wave_k1_matches_reference():
    for mtb in range(1, 20):
        assert v2._lane_k1(mtb) == wp._lane_k1(mtb)
    assert dk.LAUNCHES.keys() == {"stage_a", "stage_b", "stage_dc", "compact_flat", "compact_any"}
