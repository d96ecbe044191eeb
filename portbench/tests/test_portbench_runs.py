"""Whole runs on the CPU at a test size (``cpu_drive.py``): the program's
plain versions stand in for its kernels, and the harness's look for a
card is skipped. A sound run is correct; each fault a cell can have,
planted where the answer is produced, and each cell's control, come out
not correct. A configuration, a mix, a per-layer metric and an op added as
files with their manifest entries are taken up without editing any other
file."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, HERE, ROOT

CELLS = ["profile.decode", "archive.decode", "profile.encode", "archive.encode"]
TEST_BYTES = {"data_bytes": 196_608, "read_member_bytes": 131_072}  # 3 members; one member


def _copy(dst) -> str:
    """A checkout of the benchmark alone, its data sets cut to TEST_BYTES."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_build", "_cache", "__pycache__"))
    for name in os.listdir(os.path.join(dst, "portbench", "configs")):
        path = os.path.join(dst, "portbench", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update({k: v for k, v in TEST_BYTES.items() if k in cfg})
        with open(path, "w") as f:
            json.dump(cfg, f)
    return str(dst)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _copy(tmp_path_factory.mktemp("checkout"))


def _run(root: str, fault: str, cell: str, trace: int = 0, seed: int = 2**34 + 7, ok: bool = True) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "cpu_drive.py"), root, ROOT, fault, "--", "--workload", cell,
         "--seed", str(seed), "--seconds", "0.3", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=600)
    if not ok:
        assert proc.returncode != 0 and '"correct"' not in proc.stdout
        return {"stderr": proc.stderr}
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    lines = proc.stderr.strip().splitlines()
    assert lines[-len(result["checks"]):] == [f"check {k}: {v['value']} (limit {v['limit']})"
                                              for k, v in result["checks"].items()]
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(checkout, cell):
    r = _run(checkout, "none", cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == ({"decode_GBps", "setup_s"} if cell.endswith("decode")
                                 else {"encode_MBps", "ratio", "setup_s"})
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    if cell.endswith("decode"):
        assert r["checks"]["crc_fault_missed"] == {"value": 0, "limit": 0}
    else:
        assert r["checks"]["bad_blocks"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_and_controls_are_not_correct(checkout, cell, fault):
    r = _run(checkout, fault, cell)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values()) or r["failed"] > 0


@pytest.mark.parametrize("cell", ["profile.decode", "archive.decode"])
def test_a_decode_that_skips_its_crc_checks_is_not_correct(checkout, cell):
    """Every member of the window's stream is sound, so only the probe on a
    copy with one CRC-32 flipped shows a decode that no longer checks."""
    r = _run(checkout, "crc_blind", cell)
    assert r["correct"] is False and r["checks"]["crc_fault_missed"]["value"] == 1
    assert r["checks"]["wrong_bytes"]["value"] == 0


@pytest.mark.parametrize("cell, correct", [("profile.encode", False), ("archive.encode", True)])
def test_members_of_two_blocks_fail_the_profile_only(checkout, cell, correct):
    """The profile's members are one final block each; the archive's one
    member may hold any blocks."""
    r = _run(checkout, "two_blocks", cell)
    assert r["correct"] is correct
    assert (r["checks"]["bad_blocks"]["value"] > 0) is not correct


def test_control_script_runs_a_cell(checkout):
    proc = subprocess.run([sys.executable, "portbench/control.py", "--workload", "archive.decode", "--seed", "3",
                           "--seed", "4"], cwd=checkout, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [x["seed"] for x in lines] == [3, 4] and not any(x["control_correct"] for x in lines)


def _digests(root: str) -> dict:
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "_cache", "__pycache__")]
        for f in filenames:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


THROWAWAY_METRIC = '''"""Test metric: MiB of the cProfile half's calls."""

LAYER = "Front door"
UNIT = "MiB"
MOVES = "decode_GBps"


def read(t):
    return t.host_mib if t.host_mib > 0 else None
'''


def test_a_new_config_mix_and_metric_are_taken_up_by_adding_files(tmp_path):
    root = _copy(tmp_path)
    before = _digests(root)
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "td_profile64k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_members", data_bytes=100_000,
               layout={"kind": "td_members", "member_bytes": 32768, "max_code_len": 12, "max_chain": 8})
    with open(os.path.join(bench, "configs", "tiny_members.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "mixes", "read_twice.json"), "w") as f:
        json.dump({"op": "decode", "size": "data_bytes", "callers": 1, "loop": "closed", "think_s": 0.01}, f)
    with open(os.path.join(bench, "metrics", "throwaway_mib.decode.py"), "w") as f:
        f.write(THROWAWAY_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny_members", "source": cfg["source"], "file": "portbench/configs/tiny_members.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    m["workloads"].append({"name": "tiny.decode", "config": "tiny_members", "traffic": "read_twice", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "throwaway_mib.decode", "unit": "MiB", "better": "higher",
                           "source": "program_span", "layer": "Front door", "moves": "decode_GBps",
                           "workloads": ["tiny.decode"]})
    for e in m["end_to_end"]:
        if e["name"] == "decode_GBps":
            e["workloads"].append("tiny.decode")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    after = _digests(root)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {"portbench/configs/tiny_members.json", "portbench/mixes/read_twice.json",
                                        "portbench/metrics/throwaway_mib.decode.py"}
    r = _run(root, "none", "tiny.decode", trace=1)
    assert r["correct"] and r["metrics"]["throwaway_mib.decode"]["value"] > 0
    assert r["metrics"]["throwaway_mib.decode"]["unit"] == "MiB"
    assert _run(root, "none", "tiny.decode", trace=0)["metrics"]["decode_GBps"]["value"] > 0


NEW_OP = '''"""Test op: one member of the stream a request, decoded alone."""

import statistics
from dataclasses import dataclass

MIX_KEYS = {"size"}


@dataclass
class Inputs:
    data: bytes
    stream: bytes
    spans: list
    work_bytes: int


def make_inputs(config, mix, seed):
    import harness
    import refcheck
    from gen import corpus

    data = corpus.make(int(config[mix["size"]]), config["corpus"]["parts"], seed)
    stream = harness.load_part("layouts", config["layout"]["kind"]).write(data, config["layout"])
    return Inputs(data.tobytes(), stream, refcheck.td_spans(stream), int(config["layout"]["member_bytes"]))


def program_call(mix, inputs):
    from tpu_deflate_torch import engine

    def call(i):
        s, e = inputs.spans[i % len(inputs.spans)]
        return engine.decompress(inputs.stream[s:e], engine="cuda")

    return call


def moved_bytes(inputs, output):
    return 2 * len(output)


def end_to_end(inputs, window):
    lat = window.latency_s
    return {"member_p95_ms": statistics.quantiles(lat, n=20)[-1] * 1e3} if len(lat) >= 2 else {}


def probe(config, mix, inputs, seed):
    return {}, []


def notes():
    return []


def judge(config, mix, inputs, done):
    mb, n = inputs.work_bytes, len(inputs.spans)
    wrong = sum(o != inputs.data[(i % n) * mb : (i % n + 1) * mb] for i, o in done)
    return {"wrong_members": (wrong, 0)}


def control(config, mix, inputs):
    return b""
'''


def test_a_new_op_with_an_open_loop_is_taken_up_by_adding_files(tmp_path):
    """A request-by-request op (one member a request), served by two
    callers at a Poisson rate, with an end-to-end tail of its own: files
    and manifest entries alone."""
    root = _copy(tmp_path)
    before = _digests(root)
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "ops", "member_read.py"), "w") as f:
        f.write(NEW_OP)
    with open(os.path.join(bench, "mixes", "read_members.json"), "w") as f:
        json.dump({"op": "member_read", "size": "data_bytes", "loop": "open", "rate_per_s": 40, "callers": 2}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "profile.members", "config": "td_profile64k", "traffic": "read_members",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "member_p95_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                            "source": "host_clock", "workloads": ["profile.members"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    after = _digests(root)
    assert {k for k in before if before[k] != after.get(k)} == {"BENCHMARK.json"}
    assert set(after) - set(before) == {"portbench/ops/member_read.py", "portbench/mixes/read_members.json"}
    r = _run(root, "none", "profile.members", seed=11)
    assert r["correct"] and r["attempted"] >= 2
    assert set(r["metrics"]) == {"member_p95_ms", "setup_s"} and r["metrics"]["member_p95_ms"]["value"] > 0
    assert r["checks"]["wrong_members"]["value"] == 0
    bad = _run(root, "altered", "profile.members", seed=11)
    assert bad["correct"] is False and bad["checks"]["wrong_members"]["value"] > 0


@pytest.mark.parametrize("mix", [
    {"op": "decode", "size": "data_bytes", "loop": "closed", "callers": 1, "bogus": 1},
    {"op": "decode", "size": "data_bytes", "loop": "open", "callers": 1},
    {"op": "decode", "size": "data_bytes", "loop": "closed", "callers": 1, "rate_per_s": 5},
    {"op": "decode", "size": "data_bytes", "loop": "open", "callers": 1, "rate_per_s": 5, "think_s": 1},
    {"op": "no_such_op", "size": "data_bytes", "loop": "closed", "callers": 1},
], ids=["unread key", "open without rate", "closed with rate", "open with think", "no op file"])
def test_a_mix_the_harness_cannot_run_as_written_is_refused(tmp_path, mix):
    root = _copy(tmp_path)
    with open(os.path.join(root, "portbench", "mixes", "read_dataset.json"), "w") as f:
        json.dump(mix, f)
    r = _run(root, "none", "profile.decode", ok=False)
    assert "mix read_dataset" in r["stderr"] or "no ops file" in r["stderr"]
