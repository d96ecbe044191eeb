"""The port's member catalog and stream statistics against the JAX
package's: ``MemberCatalog.read_range`` inside a member, across member
seams and to the end, ``resume_point``, ``decode_all`` with one corrupted
member (``on_error`` given, or read from a config), and
``stream_stats(...).as_vector()`` on profile streams, Python ``gzip``
streams and the host encoder's stored, fixed and multi-block streams; the
port's ``dist.sharded.psum_stats`` over a 4-device CPU mesh sums per-shard
stat vectors to the vector of the concatenated stream. Inputs come from
seeded NumPy generators; every comparison is exact."""

from __future__ import annotations

import functools
import gzip

import numpy as np
import pytest
import torch

from tpu_deflate import catalog as ref_catalog
from tpu_deflate import config as ref_config
from tpu_deflate import stats as ref_stats
import tpu_deflate_torch as port
from tpu_deflate_torch import catalog, native, stats
from tpu_deflate_torch.codec.profile import profile_compress_host
from tpu_deflate_torch.config import DecoderConfig, FrameworkConfig
from tpu_deflate_torch.dist.mesh import make_codec_mesh
from tpu_deflate_torch.dist.sharded import psum_stats

MEMBER = 16384


def data_of(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(120)]
    text = np.concatenate([words[i] for i in rng.integers(0, 120, n // 3 + 1)])[: n // 2]
    rest = n - text.size
    return (text.tobytes() + bytes(rest // 3) + rng.integers(0, 256, rest - rest // 3, dtype=np.uint8).tobytes())


@pytest.fixture(scope="module")
def stream():
    data = data_of(150_000, seed=1)
    return data, native.compress_members_native(data, member_data=MEMBER)


def outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "raise", getattr(getattr(e, "reason", None), "name", type(e).__name__)


RANGES = [(0, 10), (5, MEMBER), (MEMBER - 3, MEMBER + 3), (MEMBER - 1, 3 * MEMBER + 7), (100, 150_000),
          (149_990, 10**9), (-50, 20), (70_000, 70_000), (90_000, 80_000), (0, 150_000)]


@pytest.mark.parametrize("a,b", RANGES)
def test_read_range(stream, a, b):
    data, gz = stream
    got = catalog.MemberCatalog(gz, engine="host").read_range(a, b)
    assert got == ref_catalog.MemberCatalog(gz).read_range(a, b) == data[max(a, 0) : b]


def test_catalog_index_and_resume_point(stream):
    data, gz = stream
    ours, theirs = catalog.MemberCatalog(gz, engine="host"), ref_catalog.MemberCatalog(gz)
    assert ours.total_uncompressed == theirs.total_uncompressed == len(data)
    assert [(e.index.start, e.index.payload_start, e.index.end, e.index.isize, e.index.crc32, e.out_start,
             e.out_end) for e in ours.entries] == [
        (e.index.start, e.index.payload_start, e.index.end, e.index.isize, e.index.crc32, e.out_start,
         e.out_end) for e in theirs.entries]
    for done in (0, 1, MEMBER - 1, MEMBER, MEMBER + 1, 5 * MEMBER + 11, len(data) - 1, len(data), 10**9):
        point = ours.resume_point(done)
        assert point == theirs.resume_point(done)
        start, out_start = point
        if start < len(gz):  # a restart from the point rebuilds the rest
            assert out_start <= done and gzip.decompress(gz[start:]) == data[out_start:]
    assert outcome(catalog.MemberCatalog, gzip.compress(data), engine="host") == outcome(
        ref_catalog.MemberCatalog, gzip.compress(data)) == ("raise", "ValueError")


def _corrupt(gz: bytes, member: int, where: str) -> bytes:
    entries = catalog.MemberCatalog(gz, engine="host").entries
    m = entries[member].index
    bad = bytearray(gz)
    at = {"payload": m.payload_start + 40, "crc": m.end - 8, "isize": m.end - 4}[where]
    bad[at] ^= 0x21
    return bytes(bad)


@pytest.mark.parametrize("where", ["payload", "crc", "isize"])
@pytest.mark.parametrize("member", [0, 4])
def test_decode_all_isolates_a_bad_member(stream, where, member):
    data, gz = stream
    bad = _corrupt(gz, member, where)
    ours, theirs = catalog.MemberCatalog(bad, engine="host"), ref_catalog.MemberCatalog(bad)
    got = ours.decode_all(on_error="skip")
    assert got == theirs.decode_all(on_error="skip")
    out, bad_members = got
    assert bad_members == [member]
    assert out == data[: member * MEMBER] + data[(member + 1) * MEMBER :]
    assert outcome(ours.decode_all) == outcome(theirs.decode_all)
    assert outcome(ours.decode_all)[0] == "raise"
    for cfg in (DecoderConfig(on_error="skip"), FrameworkConfig(decoder=DecoderConfig(on_error="skip")),
                ref_config.FrameworkConfig(decoder=ref_config.DecoderConfig(on_error="skip"))):
        assert ours.decode_all(config=cfg) == got
    assert outcome(ours.decode_all, config=DecoderConfig()) == outcome(ours.decode_all, on_error="raise")


def test_decode_all_clean_stream(stream):
    data, gz = stream
    assert catalog.MemberCatalog(gz, engine="host").decode_all() == (data, [])


# --- stats --------------------------------------------------------------------


def _blocks(st) -> list:
    return [(b.btype, b.compressed_bits, b.uncompressed_bytes, b.literals, b.matches, b.match_bytes,
             b.match_len_hist.tolist()) for b in st.blocks]


@functools.lru_cache(maxsize=1)
def _streams() -> dict:
    data = data_of(60_000, seed=2)
    return {
        "profile": native.compress_members_native(data, member_data=MEMBER),
        "profile_host": profile_compress_host(data[:20000], member_data=8192),
        "python_gzip": gzip.compress(data, 9),
        "python_members": gzip.compress(data[:7000], 1) + gzip.compress(data[7000:30000], 6),
        "stored": port.gzip_compress(data[:20000], effort=0, engine="host"),
        "fixed": port.gzip_compress(data[:12000], strategy=port.FULL_STATIC, engine="host"),
        "multi_block": port.gzip_compress(
            data[:12000], strategy=port.BinarySplitStrategy(port.FULL_DYNAMIC, min_block_len=1024), engine="host"
        ),
        "empty": gzip.compress(b""),
    }


@pytest.mark.parametrize("name", list(_streams()))
def test_stream_stats_match_reference(name):
    gz = _streams()[name]
    ours, theirs = stats.stream_stats(gz), ref_stats.stream_stats(gz)
    np.testing.assert_array_equal(ours.as_vector(), theirs.as_vector())
    assert ours.as_vector().dtype == np.int64 and ours.as_vector().shape == (19,)
    assert _blocks(ours) == _blocks(theirs)
    assert ours.block_type_histogram == theirs.block_type_histogram
    assert ours.ratio == theirs.ratio
    assert ours.uncompressed_bytes == len(gzip.decompress(gz))


def test_stream_stats_block_kinds():
    s = _streams()
    assert stats.stream_stats(s["stored"]).block_type_histogram["stored"] >= 1
    assert stats.stream_stats(s["fixed"]).block_type_histogram == {"stored": 0, "fixed": 1, "dynamic": 0}
    assert len(stats.stream_stats(s["multi_block"]).blocks) > 1
    assert stats.stream_stats(s["python_members"]).members == 2


def test_psum_stats_over_a_cpu_mesh():
    s = _streams()
    names = ["profile", "python_gzip", "python_members", "fixed"]
    vals = np.stack([stats.stream_stats(s[n]).as_vector() for n in names])
    mesh = make_codec_mesh(devices=[torch.device("cpu")] * 4)
    total = psum_stats(torch.from_numpy(vals), mesh)
    assert total.shape == (1, 19)
    np.testing.assert_array_equal(total.numpy()[0], vals.sum(axis=0))
    whole = stats.stream_stats(b"".join(s[n] for n in names)).as_vector()
    np.testing.assert_array_equal(total.numpy()[0], whole)
