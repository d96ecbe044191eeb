"""The port's distribution across ranks: 2 or 4 processes on the CPU,
joined by ``init_distributed`` (gloo, a ``file://`` store), each holding 2
shards of a (host, data) pod mesh whose host axis is the ranks. Each
collective, the sharded C-core encode and the sharded decode must give on
every rank exactly what the same shards give in one process (an 8- or
4-shard CPU mesh), and a corrupt member the same Reason. Each rank runs in
a subprocess with its own timeout, so a hang fails the test instead of
holding the suite."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
SHARDS_PER_RANK = 2
RANK_TIMEOUT_S = 180


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(150)]
    return np.concatenate([words[i] for i in rng.integers(0, 150, n // 3)])[:n].tobytes()


def _collectives(world: int, rank: int) -> None:
    from tpu_deflate_torch.dist import sharded as ds
    from tpu_deflate_torch.dist.mesh import make_codec_mesh, make_pod_mesh

    pod = make_pod_mesh(world, SHARDS_PER_RANK, devices=[CPU] * SHARDS_PER_RANK)
    assert pod.rank_axis == "host" and pod.rank == rank and pod.world == world
    flat = make_codec_mesh(devices=[CPU] * (world * SHARDS_PER_RANK))
    axes = ("host", "data")
    n = world * SHARDS_PER_RANK
    rng = np.random.default_rng(3)
    shards = rng.integers(0, 256, (2 * n, 40000), dtype=np.uint8)
    assert torch.equal(ds.halo_exchange(shards, pod, axes), ds.halo_exchange(shards, flat))
    d = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    # the broadcast takes rank 0's dictionary
    pd = ds.broadcast_preset_dict(d if rank == 0 else b"another one", pod)
    want = ds.halo_exchange(shards, flat, preset_dict=ds.broadcast_preset_dict(d, flat))
    assert torch.equal(ds.halo_exchange(shards, pod, axes, preset_dict=pd), want)
    vals = rng.integers(-1000, 1000, (3 * n, 5)).astype(np.int32)
    assert torch.equal(ds.psum_stats(vals, pod, axes), ds.psum_stats(vals, flat))
    payload = rng.integers(0, 256, (n, 300), dtype=np.uint8)
    lengths = rng.integers(0, 300, n).astype(np.int32)
    for got, want in zip(ds.ordered_ragged_gather(payload, lengths, pod, axes),
                         ds.ordered_ragged_gather(payload, lengths, flat)):
        assert np.array_equal(got, want)
    # text, then zeros and random bytes: stored blocks off a byte boundary (F13)
    for data in (_text(300_001, 4), _text(100_000, 6) + bytes(12000) + shards[0, :8000].tobytes()):
        gz = ds.sharded_continuous_compress(data, pod, axis=axes, block_data=16384)
        assert gz == ds.sharded_continuous_compress(data, flat, block_data=16384)
        assert __import__("gzip").decompress(gz) == data


def _decode(world: int, rank: int) -> None:
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.dist.mesh import make_codec_mesh, make_pod_mesh
    from tpu_deflate_torch.format.errors import DataFormatError

    engine._cuda = lambda name: CPU  # the front door on the CPU
    pod = make_pod_mesh(world, SHARDS_PER_RANK, devices=[CPU] * SHARDS_PER_RANK)
    flat = make_codec_mesh(devices=[CPU] * (world * SHARDS_PER_RANK))
    data = _text(500_000, 5)
    gz = native.compress_members_native(data)
    on = DecoderConfig(device_resolve="on")
    assert engine.decompress(gz, mesh=pod, config=on) == engine.decompress(gz, mesh=flat, config=on) == data
    st = pv2.LAST_DECODE_STATS
    assert st["device_resolved"] == st["members"] > 0 and st["host_resolved"] == 0
    for at in (len(gz) // 5, 4 * len(gz) // 5):  # a member of rank 0's share, then of the last rank's
        bad = bytearray(gz)
        bad[at] ^= 0x11
        reasons = []
        for m in (pod, flat):
            try:
                engine.decompress(bytes(bad), mesh=m, config=on)
                reasons.append(None)
            except DataFormatError as e:
                reasons.append(e.reason)
        assert reasons[0] is not None and reasons[0] == reasons[1], reasons
    foreign = b"".join(__import__("gzip").compress(data[i : i + 70000]) for i in (0, 70000))
    assert engine.decompress(foreign, mesh=pod, config=on) == data[:140000]


def _failure(world: int, rank: int) -> None:
    """The last rank's share fails with an error that is not a data format
    error: every rank raises (none waits in the exchange), the failing rank
    its own error and the others one naming it; the group then decodes on."""
    from tpu_deflate_torch import native
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.dist.mesh import make_pod_mesh
    from tpu_deflate_torch.format.errors import OutputCapacityError

    pod = make_pod_mesh(world, SHARDS_PER_RANK, devices=[CPU] * SHARDS_PER_RANK)
    data = _text(200_000, 7)
    gz = native.compress_members_native(data)
    single_block = pv2._decode_single_block_device
    if rank == world - 1:
        def fail(*_a, **_kw):
            raise OutputCapacityError("injected on the last rank")

        pv2._decode_single_block_device = fail
    try:
        pv2.gzip_decompress_v2(gz, mesh=pod, device_resolve="on")
        raise AssertionError("the decode did not raise")
    except RuntimeError as e:
        if rank == world - 1:
            assert isinstance(e, OutputCapacityError) and "injected" in str(e), repr(e)
        else:
            assert type(e) is RuntimeError and f"rank {world - 1} failed" in str(e), repr(e)
    pv2._decode_single_block_device = single_block
    assert pv2.gzip_decompress_v2(gz, mesh=pod, device_resolve="on") == data


def _worker(case: str, world: int, rank: int, store: str) -> None:
    """One rank: join the process group, run the case, leave it."""
    import torch.distributed as tdist

    from tpu_deflate_torch.dist.mesh import init_distributed

    torch.set_num_threads(1)
    assert init_distributed(coordinator_address=f"file://{store}", num_processes=world, process_id=rank,
                            device="cpu")
    assert tdist.get_backend() == "gloo"
    try:
        {"collectives": _collectives, "decode": _decode, "failure": _failure}[case](world, rank)
    finally:
        tdist.destroy_process_group()


def _spawn(case: str, world: int, tmp_path) -> None:
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for var in ("TD_COORDINATOR", "JAX_COORDINATOR_ADDRESS"):
        env.pop(var, None)
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_dist_ranks as t; "
            f"t._worker({case!r}, {world}, int(sys.argv[1]), {store!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    failures = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                failures.append(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    except subprocess.TimeoutExpired:
        failures.append(f"a rank ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n".join(failures)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_ranks(tmp_path, world):
    _spawn("collectives", world, tmp_path)


def test_decode_across_ranks(tmp_path):
    _spawn("decode", 2, tmp_path)


def test_failure_on_one_rank_raises_on_every_rank(tmp_path):
    _spawn("failure", 2, tmp_path)
