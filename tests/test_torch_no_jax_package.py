"""The port stands alone: importing every module of tpu_deflate_torch, or
everything chip_smoke.py imports, loads neither jax nor any module of the
JAX package (tpu_deflate.*). Each check runs in a fresh interpreter."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys

import tpu_deflate_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tpu_deflate.'))"
    " or m == 'tpu_deflate'); assert not bad, bad"
)


def _run(statements: list[str]) -> None:
    code = "import sys\n" + "".join(f"{st}\n" for st in statements) + CHECK
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


def _port_modules() -> list[str]:
    return ["tpu_deflate_torch"] + [
        m.name
        for m in pkgutil.walk_packages(tpu_deflate_torch.__path__, "tpu_deflate_torch.")
    ]


def test_port_modules_import_no_jax_package():
    mods = _port_modules()
    assert {"tpu_deflate_torch.codec.resolve", "tpu_deflate_torch.kernels.checksum_lanes",
            "tpu_deflate_torch.native", "tpu_deflate_torch.engine", "tpu_deflate_torch.cli",
            "tpu_deflate_torch.dist", "tpu_deflate_torch.dist.mesh", "tpu_deflate_torch.dist.sharded",
            "tpu_deflate_torch.dist.dryrun", "tpu_deflate_torch.streams.gzip_stream",
            "tpu_deflate_torch.streams.zlib_stream", "tpu_deflate_torch.codec.inflate_host",
            "tpu_deflate_torch.codec.deflate_encode", "tpu_deflate_torch.codec.profile",
            "tpu_deflate_torch.catalog", "tpu_deflate_torch.stats"} <= set(mods)
    _run([f"import {m}" for m in mods])


def test_chip_smoke_imports_no_jax_package():
    """Every import statement of chip_smoke.py (top level or inside its
    phases), run verbatim, then the script itself, without calling main."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    statements = sorted(
        {ast.unparse(n) for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))}
        - {"from __future__ import annotations"}
    )
    assert any("bench" in st for st in statements)
    assert any("tpu_deflate_torch" in st for st in statements)
    _run(statements + ["import chip_smoke"])
