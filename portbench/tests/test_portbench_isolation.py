"""What the benchmark loads: nothing it runs imports jax, jaxlib, flax or
the JAX package (names compared whole at the first dot, since the port's
name begins with the JAX package's), and the reference side imports
nothing of the program. Each import check runs in a fresh interpreter."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

import harness

REFERENCE_SIDE = ["refcheck.py", "control.py", "gen/corpus.py", "gen/core.py", "peaks.py", "layouts/td_members.py",
                  "layouts/td_zlib.py"]


@pytest.mark.parametrize("modules, bad", [
    (["tpu_deflate_torch", "tpu_deflate_torch.codec.decode_v2", "jaxtyping", "flaxen"], []),
    (["tpu_deflate", "tpu_deflate.codec.encode_jax"], ["tpu_deflate", "tpu_deflate.codec.encode_jax"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax.linen", "jax.numpy", "jaxlib"]),
])
def test_forbidden_names_compare_whole(modules, bad):
    assert harness.forbidden_modules(modules) == bad


def test_a_run_imports_no_jax_in_a_fresh_interpreter():
    """Everything a run imports: the harness, its reduction and reference,
    the program's front door and every module a decode and an encode reach,
    and the profiler."""
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]",
        "import run, harness, devtrace, refcheck, control, peaks",
        "from gen import core, corpus",
        "for kind, name in [('ops', 'decode'), ('ops', 'encode'), ('layouts', 'td_members'), ('layouts', 'td_zlib')]:",
        "    harness.load_part(kind, name)",
        "import torch.profiler, cProfile, pstats",
        "from tpu_deflate_torch import engine, _build",
        "from tpu_deflate_torch.codec import decode_v2, encode, continuous, decode_np, wave_prep",
        "bad = harness.forbidden_modules(sys.modules)",
        "assert not bad, bad",
        "assert 'tpu_deflate_torch' in sys.modules",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(path):
    with open(os.path.join(BENCH, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".", 1)[0] not in ("tpu_deflate_torch", *harness.FORBIDDEN), (path, n)


def test_harness_reaches_the_program_only_through_its_front_door():
    """The ops' imports of the program are engine (their calls and
    probes) and the decode's route counters, read after the window; the
    run's own is its launch counters; nothing else imports the program."""
    found = {}
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("tpu_deflate_torch"):
                found.setdefault(os.path.relpath(path, BENCH), set()).update(
                    f"{node.module}.{a.name}" for a in node.names)
    assert found == {"ops/decode.py": {"tpu_deflate_torch.engine", "tpu_deflate_torch.codec.decode_v2"},
                     "ops/encode.py": {"tpu_deflate_torch.engine"},
                     "run.py": {"tpu_deflate_torch._build"}}


def test_without_the_program_a_run_exits_nonzero_and_prints_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder:
    the run, past its look for a card (a stand-in here), finds no program
    to call."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("_build", "_cache", "__pycache__"))
    cfg = tmp_path / "portbench" / "configs" / "td_profile64k.json"
    cfg.write_text(cfg.read_text().replace('"data_bytes": 211938580', '"data_bytes": 262144'))
    code = ("import sys; sys.path[:0] = ['portbench', 'portbench/tests']; import cpu_drive, run; "
            "sys.exit(run.main(['--workload', 'profile.decode', '--seed', '1', '--seconds', '1', '--trace', '0'], "
            "card=cpu_drive.CpuCard()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "No module named 'tpu_deflate_torch'" in proc.stderr
    assert '"correct"' not in proc.stdout
