"""The port against the OS ``gzip`` in both directions, on the CPU (the
kernels' plain versions): ``gzip -d`` reads the member encode's output at
efforts 0-3, the continuous-history encode's at efforts 4 and 5 and the
sharded encodes' (over a CPU mesh); the port's decode reads ``gzip -1``
and ``gzip -9`` output, with and without a CPU mesh: as it comes (no TD
member index, so the shared C core decodes it), and with its DEFLATE
payload under the TD member index, where the port's own waves and device
resolve decode it."""

from __future__ import annotations

import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_deflate_torch.codec import continuous as pc
from tpu_deflate_torch.codec import decode_v2 as pv2
from tpu_deflate_torch.codec import encode as pe
from tpu_deflate_torch.codec.encode_np import build_member
from tpu_deflate_torch.dist.mesh import make_codec_mesh
from tpu_deflate_torch.dist.sharded import sharded_continuous_compress

GZIP = shutil.which("gzip")
pytestmark = pytest.mark.skipif(GZIP is None, reason="no gzip on PATH")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n: int = 150_000, seed: int = 8) -> bytes:
    """Words, then a run and random bytes: every block type's input."""
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(200)]
    text = np.concatenate([words[i] for i in rng.integers(0, 200, n // 3)])[: n - 20000]
    return text.tobytes() + bytes(12000) + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()


def _gzip_d(gz: bytes) -> bytes:
    return subprocess.run([GZIP, "-dc"], input=gz, capture_output=True, check=True).stdout


@pytest.mark.parametrize("effort", [0, 1, 2, 3])
def test_os_gzip_reads_members(effort):
    data = _data()
    assert _gzip_d(pe.compress_members(data, device=CPU, effort=effort)) == data


@pytest.mark.parametrize("effort", [4, 5])
def test_os_gzip_reads_continuous(effort):
    data = _data(100_000, seed=9)
    assert _gzip_d(pc.compress_continuous(data, device=CPU, effort=effort, block_data=16384)) == data


def test_os_gzip_reads_sharded_encodes():
    data = _data(120_000, seed=10)
    mesh = make_codec_mesh(devices=[CPU] * 3)
    assert _gzip_d(pc.compress_continuous(data, mesh=mesh, block_data=16384)) == data
    assert _gzip_d(sharded_continuous_compress(data, mesh, block_data=16384)) == data


@pytest.mark.parametrize("level", ["-1", "-9"])
@pytest.mark.parametrize("shards", [0, 4])
def test_port_reads_os_gzip(level, shards):
    """OS gzip output as it comes: no TD member index, so the front door
    takes the shared C core's route, mesh or not (no wave runs)."""
    data = _data(200_000, seed=11)
    gz = _os_gzip(level, data)
    where = {"mesh": make_codec_mesh(devices=[CPU] * shards)} if shards else {"device": CPU}
    assert pv2.gzip_decompress_v2(gz, device_resolve="on", **where) == data
    assert pv2.LAST_DECODE_STATS == {}
    # two OS members back to back
    assert pv2.gzip_decompress_v2(gz + gz, device_resolve="on", **where) == data + data


def _os_gzip(level: str, data: bytes) -> bytes:
    return subprocess.run([GZIP, level, "-c"], input=data, capture_output=True, check=True).stdout


def _under_td_index(gz: bytes) -> bytes:
    """An OS gzip member's DEFLATE payload and trailer in a TD member (the
    member index the port's wave decode reads)."""
    assert gz[:3] == b"\x1f\x8b\x08" and gz[3] == 0  # from a pipe: no name, no extra field
    trailer = np.frombuffer(gz[-8:], "<u4")
    return build_member(gz[10:-8], int(trailer[1]), int(trailer[0]))


@pytest.mark.parametrize("level", ["-1", "-9"])
@pytest.mark.parametrize("shards", [0, 4])
def test_port_decodes_os_gzip_deflate(level, shards):
    """``gzip -1``/``-9``'s DEFLATE under the TD member index: a 40 KB
    member and a 200 KB one of several blocks (with a stored block among
    them) go through the port's waves and resolve on the device path,
    with and without a CPU mesh."""
    small, big = _data(200_000, seed=11)[:40_000], _data(200_000, seed=12)
    gz = _under_td_index(_os_gzip(level, small)) + _under_td_index(_os_gzip(level, big))
    where = {"mesh": make_codec_mesh(devices=[CPU] * shards)} if shards else {"device": CPU}
    assert pv2.gzip_decompress_v2(gz, device_resolve="on", **where) == small + big
    stats = pv2.LAST_DECODE_STATS
    assert stats["members"] == 2 and stats["waves"] > 0
    assert (stats["device_resolved"], stats["host_resolved"]) == (2, 0)
