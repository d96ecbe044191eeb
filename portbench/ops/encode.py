"""The encode op: ``engine.compress(data, engine="cuda", effort=...)`` of
the data set, whole, each call. The names it gives are those of
``ops/decode.py``; it reads the mix keys ``size`` and ``effort``."""

from __future__ import annotations

import zlib
from dataclasses import dataclass

MIX_KEYS = {"size", "effort"}


@dataclass
class Inputs:
    data: bytes  # what a call compresses
    work_bytes: int  # input bytes a call


def make_inputs(config: dict, mix: dict, seed: int) -> Inputs:
    from gen import corpus

    size = int(config[mix["size"]])
    return Inputs(corpus.make(size, config["corpus"]["parts"], seed).tobytes(), size)


def program_call(mix: dict, inputs: Inputs):
    from tpu_deflate_torch import engine

    data, effort = inputs.data, int(mix["effort"])
    return lambda _i: engine.compress(data, engine="cuda", effort=effort)


def moved_bytes(inputs: Inputs, output: bytes) -> int:
    return inputs.work_bytes + len(output)


def end_to_end(inputs: Inputs, window) -> dict:
    """Input bytes of the window's calls (10^6 B) / its seconds, and the
    compressed bytes over the input bytes of all its calls."""
    n = len(window.done)
    out = {"encode_MBps": n * inputs.work_bytes / 1e6 / window.seconds}
    if n:
        out["ratio"] = sum(len(o) for _i, o in window.done) / (n * inputs.work_bytes)
    return out


def probe(config: dict, mix: dict, inputs: Inputs, seed: int) -> tuple[dict, list]:
    return {}, []  # the window's own outputs show every guarantee an encode gives


def notes() -> list:
    return []


def judge(config: dict, mix: dict, inputs: Inputs, done: list) -> dict:
    import refcheck

    return refcheck.compare_encode(inputs.data, [o for _i, o in done], config["layout"])


def control(config: dict, mix: dict, inputs: Inputs) -> bytes:
    """The reference deflater (zlib, level 6) writing the configuration's
    members, one per ``member_bytes`` or one in all, as plain gzip members
    without the ``TD`` size subfield. Breaks "each member's TD subfield is
    its byte length"."""
    step = config["layout"].get("member_bytes") or max(len(inputs.data), 1)
    members = []
    for at in range(0, len(inputs.data), step):
        z = zlib.compressobj(6, zlib.DEFLATED, 31)
        members.append(z.compress(inputs.data[at : at + step]) + z.flush())
    return b"".join(members)
