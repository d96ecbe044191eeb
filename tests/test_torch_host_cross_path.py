"""The host codec against the device paths, on the CPU (the kernels' plain
versions): the host encoder's streams at efforts 0, 1, 2 and 5 and with
``FULL_STATIC``, each as it comes (no member index: the C core decodes it)
and with its DEFLATE payload under the TD member index, go through
``decode_v2.gzip_decompress_v2(device=cpu, device_resolve="on")`` (the
multi-block one also through ``inflate_raw_v2``); the profile encoder's members go through the main
path; and the device encoder's output (``encode.compress_members`` on the
CPU) is read back by the host ``GzipReader``, the member catalog and the
stream statistics. Every output is byte-exact."""

from __future__ import annotations

import io
import zlib

import numpy as np
import pytest
import torch

import tpu_deflate_torch as port
from tpu_deflate_torch.catalog import MemberCatalog
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.codec.profile import build_member, profile_compress_host
from tpu_deflate_torch.stats import stream_stats

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data_of(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(150)]
    text = np.concatenate([words[i] for i in rng.integers(0, 150, n // 3 + 1)])[: n * 3 // 4]
    rest = n - text.size
    return text.tobytes() + bytes(rest // 2) + rng.integers(0, 256, rest - rest // 2, dtype=np.uint8).tobytes()


SIZES = {"effort0": 70000, "effort5": 9000}  # the rest 40000
HOST_STREAMS = {
    "effort0": dict(effort=0),
    "effort1": dict(effort=1),
    "effort2": dict(effort=2),
    "effort5": dict(effort=5),
    "full_static": dict(strategy=port.FULL_STATIC),
}


@pytest.mark.parametrize("name", list(HOST_STREAMS))
def test_host_encoder_streams_on_the_device_paths(name):
    kw = HOST_STREAMS[name]
    data = data_of(SIZES.get(name, 40000), seed=len(name))
    gz = port.gzip_compress(data, **kw, engine="host")
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == data  # no index: the C core
    raw = gz[10:-8]  # the default header is 10 bytes
    indexed = build_member(raw, len(data), zlib.crc32(data))
    assert pv2.gzip_decompress_v2(indexed, device=CPU, device_resolve="on") == data
    st = pv2.LAST_DECODE_STATS
    blocks = stream_stats(gz).block_type_histogram
    if name == "effort0":
        assert st["stored"] == 1 and blocks["stored"] >= 2  # 70000 bytes: two stored blocks
    else:
        assert st["stored"] == 0 and st["device_resolved"] == 1 and st["waves"] > 0
    if name == "effort5":  # a multi-block member: the chained device route, and the raw stream's waves
        assert sum(blocks.values()) == 2
        assert pv2.inflate_raw_v2(raw, device=CPU) == data
    if name == "full_static":
        assert blocks == {"stored": 0, "fixed": 1, "dynamic": 0}


def test_profile_members_on_the_main_path():
    data = data_of(100_000, seed=3)
    gz = profile_compress_host(data, member_data=32768)
    assert pv2.gzip_decompress_v2(gz, device=CPU, device_resolve="on") == data
    st = pv2.LAST_DECODE_STATS
    assert st["members"] == 4 and st["device_resolved"] == 4 - st["stored"] >= 3


def test_device_encoder_read_by_the_host_codec():
    data = data_of(150_000, seed=4)
    gz = pe.compress_members(data, device=CPU, effort=2)
    assert port.gzip_decompress(gz, engine="host") == data
    reader = port.GzipReader(io.BytesIO(gz), multi_member=True)
    assert reader.read(70_000) + reader.read() == data
    cat = MemberCatalog(gz, engine="host")
    assert len(cat.entries) == 3
    for a, b in ((10, 500), (65536 - 7, 65536 + 9), (100_000, 10**9)):
        assert cat.read_range(a, b) == data[a:b]
    start, out_start = cat.resume_point(70_000)
    assert out_start == 65536 and port.gzip_decompress(gz[start:], engine="host") == data[out_start:]
    assert stream_stats(gz).members == 3
