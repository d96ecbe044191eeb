"""The port's CLI (``tpu_deflate_torch.cli``), the cases of ``test_cli.py``:
a round trip with the metadata on gzip and its report on gunzip, the OS
``gzip``'s output read back, and the error paths. The tools run in this
process with ``engine._cuda`` monkeypatched to the CPU (the kernels' plain
versions); the usage error runs as ``python -m``."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest
import torch

from tpu_deflate_torch import cli, engine
from tpu_deflate_torch.config import FrameworkConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GZIP = shutil.which("gzip")


@pytest.fixture(autouse=True)
def cpu_engine(monkeypatch):
    monkeypatch.setattr(engine, "_cuda", lambda name: CPU)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("effort", [1, 4])
def test_cli_roundtrip(tmp_path, capsys, effort):
    src = tmp_path / "in.bin"
    src.write_bytes(b"The quick brown fox jumps over the lazy dog. " * 2000)
    gz = tmp_path / "out.gz"
    assert cli.main_gzip(["--effort", str(effort), str(src), str(gz)]) == 0
    assert "MB/s" in capsys.readouterr().err
    if GZIP:  # the OS gzip accepts it
        subprocess.run([GZIP, "-t", str(gz)], check=True)
    dst = tmp_path / "back.bin"
    assert cli.main_gunzip(["--engine", "cuda", str(gz), str(dst)]) == 0
    err = capsys.readouterr().err
    assert dst.read_bytes() == src.read_bytes()
    assert "File name: in.bin" in err
    assert "Header CRC: present" in err
    assert "Operating system: UNIX" in err
    assert "Last modified: N/A" not in err and "Last modified:" in err
    assert "MB/s" in err


@pytest.mark.skipif(GZIP is None, reason="no gzip on PATH")
def test_cli_reads_os_gzip_output(tmp_path, capsys):
    src = tmp_path / "b.bin"
    src.write_bytes(b"hello world " * 5000)
    subprocess.run([GZIP, "-k", str(src)], check=True)
    dst = tmp_path / "b.out"
    assert cli.main_gunzip(["--no-verify", str(src) + ".gz", str(dst)]) == 0
    assert dst.read_bytes() == src.read_bytes()
    assert "File name: b.bin" in capsys.readouterr().err


def test_cli_options_make_the_config():
    cfg, eng, rest = cli.parse_opts(["--effort=5", "--no-verify", "a", "b"])
    assert isinstance(cfg, FrameworkConfig) and eng == "cuda" and rest == ["a", "b"]
    assert cfg.encoder.effort == 5 and cfg.decoder.verify_crc is False
    assert (cfg.mesh.hosts, cfg.mesh.chips_per_host) == (1, 1)


def test_cli_passes_its_config_to_the_front_doors(tmp_path, monkeypatch):
    """The whole FrameworkConfig reaches engine.compress/decompress, where
    mesh_from_config reads its MeshConfig."""
    seen = []
    compress, decompress = engine.compress, engine.decompress

    def spy(fn):
        def wrapped(data, **kw):
            seen.append(kw["config"])
            return fn(data, **kw)
        return wrapped

    monkeypatch.setattr(engine, "compress", spy(compress))
    monkeypatch.setattr(engine, "decompress", spy(decompress))
    src = tmp_path / "c.bin"
    src.write_bytes(b"abc" * 3000)
    assert cli.main_gzip(["--effort", "2", str(src), str(tmp_path / "c.gz")]) == 0
    assert cli.main_gunzip([str(tmp_path / "c.gz"), str(tmp_path / "c.out")]) == 0
    assert [type(c) for c in seen] == [FrameworkConfig] * 2 and seen[0].encoder.effort == 2


def test_cli_error_paths(tmp_path, monkeypatch, capsys):
    usage = subprocess.run([sys.executable, "-m", "tpu_deflate_torch.cli"], capture_output=True, text=True,
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert usage.returncode == 1 and "Usage" in usage.stderr
    monkeypatch.setattr(sys, "argv", ["cli", "zip"])
    assert cli.main() == 1
    assert cli.main_gzip(["/nonexistent", str(tmp_path / "x.gz")]) == 1
    assert "does not exist" in capsys.readouterr().err
    out = tmp_path / "exists.gz"
    out.write_bytes(b"")
    src = tmp_path / "c.bin"
    src.write_bytes(b"data")
    assert cli.main_gzip([str(src), str(out)]) == 1
    assert "already exists" in capsys.readouterr().err
    assert cli.main_gunzip([str(src)]) == 1
    with pytest.raises(ValueError, match="cuda"):
        cli.main_gzip(["--engine", "host", str(src), str(tmp_path / "y.gz")])


@pytest.mark.parametrize("mtime, shown", [(1 << 31, "1901-12-13 20:45:52 UTC"), ((1 << 32) - 1, "1969-12-31 23:59:59 UTC")])
def test_cli_reports_mtime_as_signed_int32(tmp_path, capsys, mtime, shown):
    """An MTIME of 2**31 or more is read as the reference reads it, a signed
    int32 (RFC 1952 has it unsigned), and reported as that date."""
    import gzip
    import io

    from tpu_deflate.format.gzip_meta import GzipMetadata as RefMetadata
    from tpu_deflate_torch.format.gzip_meta import GzipMetadata, header_bytes

    raw = gzip.compress(b"signed mtime " * 100, mtime=mtime)
    ours = GzipMetadata.read(io.BytesIO(raw))
    assert ours.modification_time_unix_s == RefMetadata.read(io.BytesIO(raw)).modification_time_unix_s == mtime - (1 << 32)
    assert header_bytes(ours) == raw[:10]
    src, dst = tmp_path / "m.gz", tmp_path / "m.out"
    src.write_bytes(raw)
    assert cli.main_gunzip([str(src), str(dst)]) == 0
    assert f"Last modified: {shown}" in capsys.readouterr().err
