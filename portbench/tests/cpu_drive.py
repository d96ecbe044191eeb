"""Drive one benchmark run on the CPU, for the tests: the program runs its
plain PyTorch versions in place of its kernels (its front door's device is
patched to the CPU, as the repository's own CPU tests do), the harness's
look for a card is skipped by a stand-in, and a fault may be planted in
the program's output where it is produced.

    python cpu_drive.py <benchmark root> <program root> <fault> -- <run.py arguments>

<fault>: ``none``; ``unchanged`` (the call returns its input as it came);
``half`` (half of the members left out); ``altered`` (one byte of the
answer changed where it is produced); ``crc_blind`` (the decode with its
CRC-32 checks off); ``two_blocks`` (the encode's members each written as
two blocks, by zlib); ``control`` (each op's control in the program's
place). The run's exit code is this script's.
"""

from __future__ import annotations

import os
import sys


class CpuCard:
    """Stands in for harness.Card: no device to look for, wait on or measure."""

    def missing(self, chips: int) -> None:
        return None

    def kind(self) -> str:
        return "cpu stand-in"

    def synchronize(self) -> None:
        pass

    def reset_peak(self) -> None:
        pass

    def peak_bytes(self) -> int:
        return 0

    def free(self) -> None:
        pass


def _members(stream: bytes) -> int:
    pos, n = 0, 0
    while pos < len(stream):
        pos += int.from_bytes(stream[pos + 16 : pos + 20], "little")
        n += 1
    return n


def _half_members(stream: bytes) -> bytes:
    """The first half of a TD member stream's members (by their TD sizes)."""
    pos, ends = 0, []
    while pos < len(stream):
        pos += int.from_bytes(stream[pos + 16 : pos + 20], "little")
        ends.append(pos)
    return stream[: ends[len(ends) // 2 - 1]] if len(ends) > 1 else stream[: len(stream) // 2]


def _layout(kw) -> dict:
    """The layout an encode call of ``effort`` writes: members below 4."""
    return {"member_bytes": 65536} if kw.get("effort", 2) < 4 else {}


def _two_block_members(data: bytes, layout: dict) -> bytes:
    """The layout's members, each a non-final block and a final one (zlib,
    with a full flush at the member's middle), TD sizes in their headers."""
    import zlib

    from gen import core

    step = layout.get("member_bytes") or max(len(data), 1)
    out = []
    for at in range(0, len(data), step):
        part = data[at : at + step]
        z = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = z.compress(part[: len(part) // 2]) + z.flush(zlib.Z_FULL_FLUSH) + z.compress(part[len(part) // 2 :])
        payload += z.flush()
        out += [core.member_header(28 + len(payload)), payload, zlib.crc32(part).to_bytes(4, "little"),
                len(part).to_bytes(4, "little")]
    return b"".join(out)


def plant(engine, fault: str) -> None:
    from types import SimpleNamespace

    import harness

    decompress, compress = engine.decompress, engine.compress
    if fault == "control":
        dec, enc = harness.load_part("ops", "decode"), harness.load_part("ops", "encode")
        engine.decompress = lambda data, **kw: dec.control({}, {}, SimpleNamespace(stream=data))
        engine.compress = lambda data, **kw: enc.control({"layout": _layout(kw)}, {}, SimpleNamespace(data=data))
        return
    if fault == "crc_blind":
        from tpu_deflate_torch.config import DecoderConfig

        engine.decompress = lambda data, **kw: decompress(data, config=DecoderConfig(verify_crc=False), **kw)
        return
    if fault == "two_blocks":
        engine.compress = lambda data, **kw: _two_block_members(data, _layout(kw))
        return

    def faulty_decompress(data, **kw):
        if fault == "unchanged":
            return data
        if fault == "half":
            if _members(data) > 1:
                return decompress(_half_members(data), **kw)
            out = decompress(data, **kw)
            return out[: len(out) // 2]
        out = bytearray(decompress(data, **kw))
        out[len(out) // 2] ^= 0x20
        return bytes(out)

    def faulty_compress(data, **kw):
        if fault == "unchanged":
            return data
        if fault == "half":
            out = compress(data, **kw)
            return _half_members(out) if kw.get("effort", 2) < 4 else compress(data[: len(data) // 2], **kw)
        out = bytearray(compress(data, **kw))
        out[len(out) // 2] ^= 0x20
        return bytes(out)

    engine.decompress, engine.compress = faulty_decompress, faulty_compress


def main() -> int:
    root, program, fault = sys.argv[1:4]
    args = sys.argv[sys.argv.index("--") + 1 :]
    sys.path[:0] = [os.path.join(root, "portbench"), root]
    sys.path.append(program)
    import torch

    from tpu_deflate_torch import engine

    engine._cuda = lambda _engine: torch.device("cpu")
    if fault != "none":
        plant(engine, fault)
    import run

    return run.main(args, card=CpuCard())


if __name__ == "__main__":
    sys.exit(main())
