"""The one-shot API and the member catalog on their default engine, the
card: with ``engine._cuda`` monkeypatched to the CPU they run the same code
with the kernels' plain versions. Every encode is read back by Python's
``gzip``/``zlib`` and by the host engine, every decode is held to the host
engine's bytes or Reason (``engine="host"``, the reference's host engine,
byte-identical to ``tpu_deflate``'s). Without a CUDA device the default
engine raises."""

from __future__ import annotations

import functools
import gzip
import zlib

import numpy as np
import pytest
import torch

import tpu_deflate_torch as port
from tpu_deflate_torch import engine
from tpu_deflate_torch.catalog import MemberCatalog
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.format.errors import DataFormatError

CPU = torch.device("cpu")


def data_of(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(100)]
    text = np.concatenate([words[i] for i in rng.integers(0, 100, n // 3 + 1)])[: n * 3 // 4]
    rest = n - text.size
    return text.tobytes() + bytes(rest // 2) + rng.integers(0, 256, rest - rest // 2, dtype=np.uint8).tobytes()


def outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


@pytest.fixture
def card_on_cpu(monkeypatch):
    monkeypatch.setattr(engine, "_cuda", lambda name: CPU)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_default_engine_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gz = port.gzip_compress(b"abc" * 100, engine="host")
    z = port.zlib_compress(b"abc" * 100, engine="host")
    calls = [
        (port.deflate, b"abc"),
        (port.gzip_compress, b"abc"),
        (port.zlib_compress, b"abc"),
        (port.gzip_decompress, gz),
        (port.zlib_decompress, z),
        (MemberCatalog, gz),
    ]
    for fn, arg in calls:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn(arg)
        with pytest.raises(ValueError, match="expected 'cuda' or 'host'"):
            fn(arg, engine="tpu")


@pytest.mark.parametrize("effort", [2, 4])
def test_encodes_on_the_card(card_on_cpu, effort):
    data = data_of(8000, seed=effort)
    gz = port.gzip_compress(data, effort=effort)
    assert gzip.decompress(gz) == port.gzip_decompress(gz, engine="host") == data
    raw = port.deflate(data, effort=effort)
    assert zlib.decompress(raw, -15) == data
    z = port.zlib_compress(data, effort=effort)
    assert z[2:-4] == raw and z[:2] == port.ZlibMetadata().to_bytes()
    assert zlib.decompress(z) == port.zlib_decompress(z, engine="host") == data
    assert port.zlib_compress(b"") == zlib.compress(b"")[:2] + port.deflate(b"") + (1).to_bytes(4, "big")


def test_host_only_options_raise_on_the_card(card_on_cpu):
    for fn in (port.deflate, port.gzip_compress, port.zlib_compress):
        with pytest.raises(ValueError, match="strategy is the host engine's"):
            fn(b"abc", strategy=port.FULL_STATIC)
    with pytest.raises(ValueError, match="preset dictionary is the host engine's"):
        port.zlib_compress(b"abc", preset_dictionary=b"dict")
    co = zlib.compressobj(zdict=b"dictionary")
    z = co.compress(b"dictionary words") + co.flush()
    for kw in ({}, {"preset_dictionary": b"dictionary"}):
        with pytest.raises(ValueError, match="preset dictionary is the host engine's"):
            port.zlib_decompress(z, **kw)
    with pytest.raises(ValueError, match="effort must be in 0..5"):
        port.gzip_compress(b"abc", effort=6)


@functools.cache
def gzip_cases() -> dict:
    data = data_of(12000, seed=7)
    one = gzip.compress(data[:5000], 6)
    indexed = port.gzip_compress(data, effort=2, engine="host")
    from tpu_deflate_torch.codec.profile import profile_compress_host

    prof = profile_compress_host(data, member_data=4096)
    bad = bytearray(prof)
    bad[200] ^= 0x40
    return {
        "python": gzip.compress(data, 9),
        "members": one + gzip.compress(data[5000:], 1),
        "trailing": one + b"\x00\x00garbage",
        "host_encoder": indexed,
        "profile": prof,
        "profile_trailing": prof + b"tail bytes",
        "profile_corrupt": bytes(bad),
        "cut": prof[:-5],
        "empty": b"",
    }


@pytest.mark.parametrize("name", list(gzip_cases()))
@pytest.mark.parametrize("multi", [True, False])
def test_gzip_decompress_on_the_card(card_on_cpu, name, multi):
    gz = gzip_cases()[name]
    want = outcome(port.gzip_decompress, gz, multi_member=multi, engine="host")
    assert outcome(port.gzip_decompress, gz, multi_member=multi) == want


@functools.cache
def zlib_cases() -> dict:
    data = data_of(8000, seed=9)
    z = zlib.compress(data, 6)
    return {
        "python": z,
        "level1_trailing": zlib.compress(data, 1) + b"more",
        "host_encoder": port.zlib_compress(data, effort=1, engine="host"),
        "bad_adler": z[:-1] + bytes([z[-1] ^ 1]),
        "short_trailer": z[:-2],
        "cut_payload": z[: len(z) // 2],
        "bad_header": bytes([z[0], z[1] ^ 1]) + z[2:],
        "bad_method": bytes([0x77, 31 - 0x7700 % 31]) + z[2:],  # CM 7
        "empty": b"",
    }


@pytest.mark.parametrize("name", list(zlib_cases()))
def test_zlib_decompress_on_the_card(card_on_cpu, name):
    z = zlib_cases()[name]
    assert outcome(port.zlib_decompress, z) == outcome(port.zlib_decompress, z, engine="host")


def test_catalog_on_the_card(card_on_cpu):
    from tpu_deflate_torch.codec.profile import profile_compress_host

    data = data_of(12000, seed=11)
    gz = profile_compress_host(data, member_data=4096)
    ours, host = MemberCatalog(gz), MemberCatalog(gz, engine="host")
    for a, b in ((-5, 3), (100, 100), (11000, 10**9), (4096 - 7, 2 * 4096 + 9)):
        assert ours.read_range(a, b) == host.read_range(a, b) == data[max(a, 0) : b]
    assert pv2.LAST_DECODE_STATS["members"] == 3  # one decode of the three members the last range needs
    assert ours.resume_point(5000) == host.resume_point(5000) == (ours.entries[1].index.start, 4096)
    assert ours.decode_all() == (data, [])
    bad = bytearray(gz)
    bad[ours.entries[1].index.payload_start + 50] ^= 0x5A
    ours, host = MemberCatalog(bytes(bad)), MemberCatalog(bytes(bad), engine="host")
    got = ours.decode_all(on_error="skip")
    assert got == host.decode_all(on_error="skip") and got[1] == [1]
    assert got[0] == data[:4096] + data[2 * 4096 :]
    with pytest.raises(DataFormatError) as e:
        ours.decode_all()
    with pytest.raises(DataFormatError) as e_host:
        host.decode_all()
    assert e.value.reason == e_host.value.reason
