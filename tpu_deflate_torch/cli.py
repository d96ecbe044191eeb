"""File CLI tools of the port (counterpart of ``tpu_deflate.cli``).

The reference's contract: exactly two positional arguments (input file,
output file), full metadata on compress (mtime, file name, header CRC), a
metadata report and MB/s throughput on stderr for decompress; an output
file that exists is refused.

Usage:
    python -m tpu_deflate_torch.cli gzip   [options] <input-file> <output-file.gz>
    python -m tpu_deflate_torch.cli gunzip [options] <input-file.gz> <output-file>

Options: ``--effort N`` (0-5), ``--engine cuda`` (the only engine; any
other raises) and ``--no-verify`` (skip the decode's CRC check). The flags
become a ``config.FrameworkConfig``, which ``engine.compress`` and
``engine.decompress`` take whole, mesh included (``dist.mesh.
mesh_from_config``).
"""

from __future__ import annotations

import datetime
import io
import os
import sys
import time
from dataclasses import replace


def _usage(tool: str) -> int:
    print(f"Usage: python -m tpu_deflate_torch.cli {tool} [options] InFile OutFile", file=sys.stderr)
    return 1


def _check_paths(in_path: str, out_path: str) -> bool:
    if not os.path.isfile(in_path):
        print(f"Input file does not exist: {in_path}", file=sys.stderr)
        return False
    if os.path.exists(out_path):
        print(f"Output file already exists: {out_path}", file=sys.stderr)
        return False
    return True


def _speeds(n_in: int, n_out: int, elapsed: float) -> None:
    print(f"Input  speed: {n_in / elapsed / 1e6:.2f} MB/s\n"
          f"Output speed: {n_out / elapsed / 1e6:.2f} MB/s", file=sys.stderr)


def main_gzip(args: list[str]) -> int:
    from .engine import compress
    from .format.gzip_meta import GzipMetadata, OperatingSystem

    cfg, engine, args = parse_opts(args)
    if len(args) != 2:
        return _usage("gzip")
    in_path, out_path = args
    if not _check_paths(in_path, out_path):
        return 1
    with open(in_path, "rb") as f:
        data = f.read()
    meta = GzipMetadata(
        modification_time_unix_s=int(os.path.getmtime(in_path)) or None,
        operating_system=OperatingSystem.UNIX,
        file_name=os.path.basename(in_path),
        has_header_crc=True,
    )
    start = time.monotonic()
    out = compress(data, engine=engine, metadata=meta, config=cfg)
    elapsed = max(time.monotonic() - start, 1e-9)
    with open(out_path, "xb") as f:
        f.write(out)
    _speeds(len(data), len(out), elapsed)
    return 0


def report_metadata(meta) -> None:
    """The first member's header on stderr (the reference's report)."""
    if meta.modification_time_unix_s:
        ts = datetime.datetime.fromtimestamp(meta.modification_time_unix_s, datetime.timezone.utc)
        print(f"Last modified: {ts.strftime('%Y-%m-%d %H:%M:%S UTC')}", file=sys.stderr)
    else:
        print("Last modified: N/A", file=sys.stderr)
    print(f"Extra flags: {meta.extra_flags}", file=sys.stderr)
    print(f"Operating system: {meta.operating_system.name}", file=sys.stderr)
    print(f"File mode: {'text' if meta.is_file_text else 'binary'}", file=sys.stderr)
    if meta.extra_field is not None:
        print(f"Extra field: {len(meta.extra_field)} bytes", file=sys.stderr)
    if meta.file_name is not None:
        print(f"File name: {meta.file_name}", file=sys.stderr)
    if meta.comment is not None:
        print(f"Comment: {meta.comment}", file=sys.stderr)
    print(f"Header CRC: {'present' if meta.has_header_crc else 'absent'}", file=sys.stderr)


def main_gunzip(args: list[str]) -> int:
    from .engine import decompress
    from .format.gzip_meta import read_gzip_header

    cfg, engine, args = parse_opts(args)
    if len(args) != 2:
        return _usage("gunzip")
    in_path, out_path = args
    if not _check_paths(in_path, out_path):
        return 1
    start = time.monotonic()
    with open(in_path, "rb") as f:
        raw = f.read()
    out = decompress(raw, engine=engine, config=cfg)
    meta = read_gzip_header(io.BytesIO(raw))
    elapsed = max(time.monotonic() - start, 1e-9)
    report_metadata(meta)
    with open(out_path, "xb") as f:
        f.write(out)
    _speeds(len(raw), len(out), elapsed)
    return 0


def parse_opts(args: list[str]):
    """Flags -> (a config.FrameworkConfig, the engine, the remaining
    arguments); an engine other than "cuda" raises ValueError."""
    from .config import DEFAULT

    effort, engine, verify = DEFAULT.encoder.effort, "cuda", DEFAULT.decoder.verify_crc
    rest = []
    it = iter(args)
    for a in it:
        name, eq, value = a.partition("=")
        if name in ("--effort", "--engine") and not eq:
            value = next(it, None)
            if value is None:
                raise ValueError(f"{name} needs a value")
        if name == "--effort":
            effort = int(value)
        elif name == "--engine":
            engine = value
        elif a == "--no-verify":
            verify = False
        else:
            rest.append(a)
    if engine != "cuda":
        raise ValueError(f"--engine {engine}: the port has only the cuda engine")
    cfg = replace(DEFAULT, encoder=replace(DEFAULT.encoder, effort=effort),
                  decoder=replace(DEFAULT.decoder, verify_crc=verify))
    return cfg, engine, rest


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("gzip", "gunzip"):
        print("Usage: python -m tpu_deflate_torch.cli {gzip|gunzip} [options] InFile OutFile", file=sys.stderr)
        return 1
    if sys.argv[1] == "gzip":
        return main_gzip(sys.argv[2:])
    return main_gunzip(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
