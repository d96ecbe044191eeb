"""The port's device measurement entry points (``codec.kernel_bench``) on the
CPU, where the kernels' plain versions run: each bench returns the keys of
its reference in the JAX package (read from the reference's source), counts
the members as the reference's ``split_members`` does, plans its waves as
the reference's Pallas runner does, verifies every member, and catches a
resolve that flips one byte. Inputs are slices of ``bench.make_corpus``.

Each bench runs once at a small size with ``reps=1``; the resolve batch
``RB`` is lowered to 4 lanes (256 lanes of plain resolve on the CPU take
seconds a pass), and the negative tests time single passes, since only
their verification is under test."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

import bench
from tpu_deflate.codec import decode_jax as dj
from tpu_deflate.codec import decode_jax_v2 as v2
from tpu_deflate.codec import decode_pallas as dp
from tpu_deflate_torch import native
from tpu_deflate_torch.codec import kernel_bench as kb
from tpu_deflate_torch.codec import resolve as rs

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on a few cores, and torch's thread pool would oversubscribe
    them (its threads wait spinning)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus() -> bytes:
    return bench.make_corpus(8)


@pytest.fixture(scope="module")
def mixed(corpus) -> bytes:
    """Three profile members: runs (Huffman), random bytes (stored) and a
    short text tail (Huffman, another k1 bucket): two waves."""
    runs, rand = 4 << 20, 5 << 20
    return corpus[runs : runs + 64 * K] + corpus[rand : rand + 64 * K] + corpus[: 8 * K]


def _ref_keys(path: str, func: str) -> set[str]:
    """The keys of the dict that ``func`` of the reference returns."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


DECODE_REF = "tpu_deflate/codec/decode_jax_v2.py"


@pytest.fixture(scope="module")
def small_rb():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kb, "RB", 4)
        yield


@pytest.fixture(scope="module")
def kob(mixed) -> dict:
    return kb.kernel_only_bench(mixed, device=CPU, reps=1)


@pytest.fixture(scope="module")
def full(mixed, small_rb) -> dict:
    return kb.kernel_only_bench_full(mixed, device=CPU, reps=1)


@pytest.fixture(scope="module")
def big(corpus) -> dict:
    return kb.kernel_only_bench_big(corpus, device=CPU, member_kb=72, n_members=2, reps=1)


def _members(data: bytes):
    """The reference's member split of the port's profile stream: (the
    Huffman members, the stored ones)."""
    buf = np.frombuffer(native.compress_members_native(data), np.uint8)
    ms = dj.split_members(buf)
    huff = [m for m in ms if (int(buf[m.payload_start]) >> 1) & 3 != 0]
    return buf, huff, [m for m in ms if m not in huff]


def _ref_waves(payloads: list[bytes], lanes: int = v2.V2_LANE_BATCH) -> int:
    """Waves of the reference's Pallas planning (decode_jax_v2.py:1683-1702)."""
    k1s = v2._k1_groups(payloads, [0] * len(payloads))
    groups: dict = {}
    for p, k1 in zip(payloads, k1s):
        groups.setdefault((v2._bucket(len(p), dp.P_BUCKETS_PALLAS), k1), []).append(p)
    return sum(-(-len(g) // min(lanes, v2._lane_cap(P, 1))) for (P, _k1), g in groups.items())


# decode_jax_v2.py:1727, :1932, :2387 and encode_jax.py:855 (the return dicts)
@pytest.mark.parametrize("row, path, func", [
    ("kob", DECODE_REF, "kernel_only_bench"),
    ("full", DECODE_REF, "kernel_only_bench_full"),
    ("big", DECODE_REF, "kernel_only_bench_big"),
])
def test_decode_rows_have_the_reference_keys(row, path, func, request):
    got = request.getfixturevalue(row)
    assert set(got) == _ref_keys(path, func)
    assert got["marginal_guard"] in ("ok", "floored")


def test_kernel_only_bench_counts(kob, mixed):
    buf, huff, stored = _members(mixed)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in huff]
    assert (len(huff), len(stored)) == (2, 1)
    assert kob["members"] == len(huff)
    assert kob["stored_members_excluded"] == len(stored)
    assert kob["uncompressed_mb"] == round(sum(m.isize for m in huff) / 2**20, 1)
    assert kob["payload_mb"] == round(sum(map(len, payloads)) / 2**20, 1)
    assert kob["waves"] == _ref_waves(payloads) == 2
    assert kob["runner"] == "plain"
    assert kob["lanes"] == v2.V2_LANE_BATCH
    assert kob["decode_gbps"] > 0 and kob["decode_gbps_single_pass"] > 0


def test_full_counts_and_verification(full, mixed):
    buf, huff, stored = _members(mixed)
    ms = huff + stored
    assert full["members"] == len(ms)
    assert (full["huff_members"], full["stored_members"]) == (len(huff), len(stored))
    assert full["uncompressed_mb"] == round(sum(m.isize for m in ms) / 2**20, 1)
    assert full["stored_mb"] == round(sum(m.isize for m in stored) / 2**20, 1)
    assert full["waves"] == _ref_waves([buf[m.payload_start : m.end - 8].tobytes() for m in huff])
    assert full["verified_members"] == full["members"]
    assert full["crc_or_size_mismatches"] == 0
    assert full["decode_gbps_stored"] is not None
    assert {full["marginal_guard_huff"], full["marginal_guard_stored"]} <= {"ok", "floored"}


def test_big_counts_and_verification(big):
    assert (big["members"], big["member_kb"], big["tiles_per_member"]) == (2, 72, 2)
    assert big["uncompressed_mb"] == round(2 * 72 * K / 2**20, 1)
    assert big["verified_members"] == big["members"]
    assert big["byte_mismatches"] == 0


def test_one_block_payload_is_one_dynamic_block(corpus):
    """The big row's members: one final dynamic block each (the C core's
    block encoder stops at 64 KiB), with matches at real distances."""
    import zlib

    chunk = corpus[: 72 * K]
    p = kb._one_block_payload(chunk)
    assert p[0] & 7 == 0b101
    assert zlib.decompress(p, -15) == chunk
    starts, run, dist = kb._greedy_tokens(np.frombuffer(chunk, np.uint8))
    assert int(run.sum()) == len(chunk) and starts[0] == 0
    assert (dist[run > 1] > 1).any() and dist.max() <= kb.WINDOW


def test_stage_waves_match_the_reference_planning(corpus):
    """Twelve members of every kind of the corpus, cut into waves as the
    reference's Pallas runner cuts them, at 256 and at 4 lanes a wave."""
    data = b"".join(corpus[s : s + 64 * K] for s in range(0, 8 << 20, 700 * K))
    buf, huff, _stored = _members(data)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in huff]
    for lanes in (v2.V2_LANE_BATCH, 4):
        waves, order = kb._stage_waves(payloads, lanes, CPU)
        assert len(waves) == _ref_waves(payloads, lanes)
        assert sorted(order) == list(range(len(payloads)))
        assert sum(w["_n_real"] for w in waves) == len(payloads)


def test_encode_kernel_bench(corpus):
    got = kb.encode_kernel_bench(corpus[: 72 * K], device=CPU, reps=1)
    assert set(got) == _ref_keys("tpu_deflate/codec/encode_jax.py", "encode_kernel_bench")
    assert got["batch_mb"] == round(72 * K / 2**20, 2) and got["encode_kernel_mbps"] > 0
    times = kb.LAST_PASS_TIMES["encode_kernel_bench"]
    assert times["enqueue_ms"] > 0 and times["event_ms"] is times["device_ms"] is times["queued"] is None


def test_link_probe_keys():
    got = kb.link_probe(CPU)
    assert set(got) == {"down_mbps", "rtt_ms"}  # decode_jax_v2.py:1982
    assert got["down_mbps"] > 0 and got["rtt_ms"] >= 0
    assert kb.link_probe(CPU) == got  # cached per device


def test_marginal_time_guard():
    times = {1: 1.0, 3: 2.0}
    assert kb._marginal_time(lambda n: times[n], 2) == (0.5, 1.0, "ok")
    times[3] = 1.2
    assert kb._marginal_time(lambda n: times[n], 2) == (1.0, 1.0, "floored")


@pytest.mark.parametrize("call", [
    lambda d: kb.kernel_only_bench(d),
    lambda d: kb.kernel_only_bench_full(d),
    lambda d: kb.kernel_only_bench_big(d),
    lambda d: kb.encode_kernel_bench(d),
    lambda d: kb.link_probe(),
])
def test_default_device_needs_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call(b"x" * 1000)


def _flip_one_byte(monkeypatch):
    """Resolve that flips the first byte of lane 0 of every call; one timed
    pass and no pass timed alone."""
    resolve = rs.resolve_tokens_device

    def flipped(tokens, **kw):
        y, summ = resolve(tokens, **kw)
        y[0, 0] ^= 1
        return y, summ

    monkeypatch.setattr(rs, "resolve_tokens_device", flipped)
    monkeypatch.setattr(kb, "_marginal_time", lambda run_n, reps: (run_n(1), run_n(1), "ok"))
    monkeypatch.setattr(kb, "_pass_times", lambda run_pass, device: {})


def test_full_catches_one_flipped_byte(mixed, small_rb, monkeypatch):
    _flip_one_byte(monkeypatch)
    got = kb.kernel_only_bench_full(mixed, device=CPU, reps=1)
    assert got["crc_or_size_mismatches"] == 1
    assert got["verified_members"] == got["members"] - 1


def test_big_catches_one_flipped_byte(corpus, monkeypatch):
    _flip_one_byte(monkeypatch)
    got = kb.kernel_only_bench_big(corpus, device=CPU, member_kb=72, n_members=2, reps=1)
    assert got["byte_mismatches"] == 1
    assert got["verified_members"] == 1
