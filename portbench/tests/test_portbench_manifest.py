"""BENCHMARK.json keeps to the benchmark's contract: its keys, names, units
and lengths; every per-layer entry agrees with its metric file; every
file of the benchmark is named from a name's characters."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import BENCH, ROOT

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    M = json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(M) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH_CHARS.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])


def test_command_names_files_under_paths_only():
    for word in M["command"][1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word == p or word.startswith(p + "/") for p in M["paths"]), word


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"]) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(k in cfg for k in c["reduced"])


def test_workloads():
    names, pairs = set(), set()
    configs = {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert w["name"] not in names and (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH, "mixes", f"{w['traffic']}.json"))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_end_to_end_metrics():
    names = set()
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("entry", M["per_layer"], ids=lambda e: e["name"])
def test_per_layer_entry_agrees_with_its_file(entry):
    assert set(entry) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"]) and _line(entry["layer"])
    assert entry["better"] in ("lower", "higher") and entry["source"] in SOURCES
    mod = harness.load_metric(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert callable(mod.read)
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for cell in entry.get("workloads", []):
        assert harness._reports(e2e[entry["moves"]], cell, set()), (entry["name"], cell)


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        cell = harness.load_cell(w["name"], ROOT, M)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer, w["name"]


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_files_under_paths_are_named_from_name_characters():
    for p in M["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d not in ("_build", "_cache", "__pycache__")]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH_CHARS.match(rel), rel
