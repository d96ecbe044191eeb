"""The port's decode slice end to end on the CPU (plain versions of the
kernels) against the JAX package: the wave body's 7-tuple, whole gzip
streams on the host-resolve route and on the device-resolve route
(``device_resolve="on"``, which the JAX package runs with its Pallas
resolve in interpret mode), routing counts, error Reasons, the
conformance vectors and the fallback for streams without a member index.
Integer-only, so every comparison is exact equality. The port's Reason is
its own enum: Reasons compare by name."""

from __future__ import annotations

import gzip as pygzip
import os
import random
import zlib

import numpy as np
import pytest
import torch

import tpu_deflate
from tpu_deflate import native
from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec.profile import profile_compress_host
from tpu_deflate.format.errors import DataFormatError

from tpu_deflate_torch import engine
from tpu_deflate_torch.format import errors as port_errors
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
    """The name of the Reason fn(*args) raises (either package's error), or
    None."""
    try:
        fn(*args)
    except (DataFormatError, port_errors.DataFormatError) as e:
        return e.reason.name
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
    with pytest.raises(port_errors.DataFormatError) as ei:
        pv2.inflate_raw_v2(bits_to_bytes(bits, "0"), device=CPU)
    assert ei.value.reason.name == reason.name


def test_vectors_batched_one_wave():
    """All vectors as one lane batch (padding bits set to 1): each lane
    lands on its own verdict."""
    payloads = [bits_to_bytes(b, "1") for _, b, _ in GOOD_VECTORS]
    payloads += [bits_to_bytes(b, "0") for _, b, _ in BAD_VECTORS]
    states = pv2.decode_deflate_streams_v2(payloads, CPU)
    for (name, _, hexout), st in zip(GOOD_VECTORS, states):
        assert pv2._resolve_lane(st, None) == bytes.fromhex(hexout), name
    for (name, _, reason), st in zip(BAD_VECTORS, states[len(GOOD_VECTORS) :]):
        with pytest.raises(port_errors.DataFormatError) as ei:
            pv2._resolve_lane(st, None)
        assert ei.value.reason.name == reason.name, name


def test_overflow_rerun(monkeypatch):
    """A degenerate stream whose tiles hold more tokens than the largest
    k1 (1- and 2-bit literal codes) reruns its wave with k1 = 512."""
    k1s = []
    wave_stages = pv2.wave_stages

    def spy(w, **kw):  # the host route's first run asks for the pull (pack=True)
        k1s.append(kw.get("k1"))
        return wave_stages(w, **kw)

    monkeypatch.setattr(pv2, "wave_stages", spy)
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


def test_wave_k1_matches_reference():
    for mtb in range(1, 20):
        assert v2._lane_k1(mtb) == wp._lane_k1(mtb)
    assert dk.LAUNCHES.keys() == {
        "stage_a_tables", "stage_a", "stage_b", "stage_c", "stage_dc", "compact_flat", "compact_any",
        "expand", "sweep", "crc32_lanes", "tile_split", "wave_summary", "pack_tokens", "compact_pack",
        "adler_sums",
    }


# ---------------------------------------------------------------------------
# The device-resolve route (device_resolve="on")
# ---------------------------------------------------------------------------


def _td_member(payload: bytes, isize: int, crc: int) -> bytes:
    """One gzip member with the TD member index around a raw DEFLATE payload."""
    total = 20 + len(payload) + 8
    return (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x08\x00TD\x04\x00"
        + total.to_bytes(4, "little")
        + payload
        + crc.to_bytes(4, "little")
        + (isize & 0xFFFFFFFF).to_bytes(4, "little")
    )


def _zlib_member(data: bytes) -> bytes:
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    return _td_member(co.compress(data) + co.flush(), len(data), zlib.crc32(data))


def _on_stream(kind: str) -> bytes:
    if kind == "profile":  # single-block members: the main path
        return _compress(_structured(21, 150_000))
    if kind == "mixed":  # stored and Huffman members
        return _compress(os.urandom(70000) + _structured(22, 100_000))
    if kind == "multiblock":  # a zlib -9 member of several blocks, > 64 KiB
        return _zlib_member(_structured(23, 200_000))
    if kind == "both":  # main-path members followed by a multi-block one
        return _compress(_structured(24, 80_000)) + _zlib_member(_structured(25, 90_000))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["profile", "mixed", "multiblock", "both"])
def test_device_resolve_on_matches_reference(kind):
    gz = _on_stream(kind)
    got = _port(gz, device_resolve="on")
    stats = dict(pv2.LAST_DECODE_STATS)
    want = v2.gzip_decompress_tpu_v2(gz, device_resolve="on")
    assert got == want == pygzip.decompress(gz)
    ref = v2.LAST_DECODE_STATS
    for k in ("members", "stored", "device_resolved", "host_resolved"):
        assert stats[k] == ref[k], k
    assert stats["device_resolved"] > 0 and stats["host_resolved"] == 0
    # on the CPU the plain versions run: no kernel launch is counted
    assert set(stats["launches"].values()) == {0}


def test_device_resolve_routes():
    """"auto" on a CPU device takes the host route; "on" resolves every
    Huffman member on the device; a bad mode raises."""
    gz = _on_stream("both")
    data = pygzip.decompress(gz)
    for mode, dev_count in (("off", 0), ("auto", 0), ("on", 3)):
        assert _port(gz, device_resolve=mode) == data
        stats = pv2.LAST_DECODE_STATS
        assert (stats["device_resolved"], stats["host_resolved"]) == (dev_count, 3 - dev_count)
    with pytest.raises(ValueError):
        _port(gz, device_resolve="yes")


@pytest.mark.parametrize("where", ["early", "middle", "trailer", "crc", "isize"])
def test_corruption_same_reason_device_resolve_on(where):
    data = _structured(5, 60000)
    gz = bytearray(_compress(data))
    m = dj.split_members(np.frombuffer(bytes(gz), np.uint8))[0]
    at = {
        "early": m.payload_start + 100,
        "middle": len(gz) // 2,
        "trailer": m.end - 6,
        "crc": m.end - 8,
        "isize": m.end - 4,
    }[where]
    gz[at] ^= 0x55
    got = _reason(lambda b: _port(b, device_resolve="on"), bytes(gz))
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="on"), bytes(gz))
    assert got is not None and got == want


@pytest.mark.parametrize("name,bits,reason", BAD_VECTORS, ids=[v[0] for v in BAD_VECTORS])
def test_bad_vector_device_resolve_on(name, bits, reason):
    """Each bad vector as a TD-indexed member through both packages' "on"
    routes: the same Reason."""
    gz = _td_member(bits_to_bytes(bits, "0"), 3, 0)
    got = _reason(lambda b: _port(b, device_resolve="on"), gz)
    want = _reason(lambda b: v2.gzip_decompress_tpu_v2(b, device_resolve="on"), gz)
    assert got is not None and got == want


def test_good_vectors_device_resolve_on():
    gz = b"".join(
        _td_member(bits_to_bytes(bits, "0"), len(bytes.fromhex(h)), zlib.crc32(bytes.fromhex(h)))
        for _, bits, h in GOOD_VECTORS
    )
    want = b"".join(bytes.fromhex(h) for _, _, h in GOOD_VECTORS)
    assert _port(gz, device_resolve="on") == v2.gzip_decompress_tpu_v2(gz, device_resolve="on") == want


# ---------------------------------------------------------------------------
# Streams without the TD member index: the C core's serial member walk
# ---------------------------------------------------------------------------


def _foreign(kind: str) -> bytes:
    data = _structured(31, 80_000)
    gz = pygzip.compress(data, compresslevel=9)
    two = gz + pygzip.compress(data[:5000], compresslevel=1)
    cases = {
        "whole": two,
        "truncated_header": gz[:6],
        "truncated_payload": gz[: len(gz) // 2],
        "truncated_trailer": gz[:-3],
        "corrupt_payload": gz[:40] + bytes([gz[40] ^ 0xFF]) + gz[41:],
        "corrupt_late": gz[:-400] + bytes([gz[-400] ^ 0x10]) + gz[-399:],
        "corrupt_crc": gz[:-8] + bytes([gz[-8] ^ 1]) + gz[-7:],
        "corrupt_isize": gz[:-4] + bytes([gz[-4] ^ 1]) + gz[-3:],
        "bad_magic": b"\x1f\x8c" + gz[2:],
        "bad_method": gz[:2] + b"\x07" + gz[3:],
        "reserved_flags": gz[:3] + b"\x20" + gz[4:],
        "trailing_garbage": gz + b"\x00\x01",
        "second_member_truncated": two[: len(gz) + 30],
        "empty": b"",
    }
    return cases[kind]


_FOREIGN = [
    "whole", "truncated_header", "truncated_payload", "truncated_trailer", "corrupt_payload",
    "corrupt_late", "corrupt_crc", "corrupt_isize", "bad_magic", "bad_method", "reserved_flags",
    "trailing_garbage", "second_member_truncated", "empty",
]


@pytest.mark.parametrize("kind", _FOREIGN)
def test_no_index_fallback_matches_host_decoder(kind):
    gz = _foreign(kind)
    want = _reason(tpu_deflate.gzip_decompress, gz)
    got = _reason(_port, gz)
    assert got == want
    if want is None:
        assert _port(gz) == tpu_deflate.gzip_decompress(gz)
        assert pv2.LAST_DECODE_STATS == {}  # no member index: no device routing
