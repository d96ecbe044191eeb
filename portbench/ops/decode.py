"""The decode op: ``engine.decompress(stream, engine="cuda")`` of a stream
the benchmark wrote, whole, each call.

Every op file gives the harness the same few names:

- ``MIX_KEYS``: the mix keys the op reads (here ``size``: the
  configuration's key that holds the data's byte count);
- ``make_inputs(config, mix, seed)``: the inputs, made from the seed, with
  ``work_bytes``, a call's unit of work;
- ``program_call(mix, inputs)``: the one call into the program, taking the
  request's index;
- ``moved_bytes(inputs, output)``: bytes a call has to read or write once;
- ``end_to_end(inputs, window)``: the end-to-end values a window gives;
- ``probe(config, mix, inputs, seed)``: untimed calls after the window
  that hold the program to a guarantee the window's inputs cannot show,
  as ({name: (value, limit)}, lines to print);
- ``notes()``: the program's counters, printed on earlier lines;
- ``judge(config, mix, inputs, done)``: the numbers compared, each
  (value, limit), by the plain reference, for ``done``, the (request
  index, output) of every call that returned, the warm call's as
  request 0;
- ``control(config, mix, inputs)``: the reference in the program's place
  with one of the configuration's guarantees broken (``control.py``).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

MIX_KEYS = {"size"}
CUT_WBITS = -14  # the control's 16 KiB window, where the streams match up to 32 KiB back


@dataclass
class Inputs:
    data: bytes  # what a call must give back
    stream: bytes  # what a call decompresses
    work_bytes: int  # decompressed bytes a call
    moved: int  # compressed + decompressed bytes a call reads or writes once


def make_inputs(config: dict, mix: dict, seed: int) -> Inputs:
    """The data set (``config[mix["size"]]`` bytes of the seeded corpus)
    and its stream in the configuration's layout, written by
    ``layouts/<kind>.py``; the program's encoder writes none of it."""
    import harness
    from gen import corpus

    size = int(config[mix["size"]])
    data = corpus.make(size, config["corpus"]["parts"], seed)
    stream = harness.load_part("layouts", config["layout"]["kind"]).write(data, config["layout"])
    return Inputs(data.tobytes(), stream, size, len(stream) + size)


def program_call(mix: dict, inputs: Inputs):
    from tpu_deflate_torch import engine

    stream = inputs.stream
    return lambda _i: engine.decompress(stream, engine="cuda")


def moved_bytes(inputs: Inputs, _output) -> int:
    return inputs.moved


def end_to_end(inputs: Inputs, window) -> dict:
    """Decompressed bytes of the window's calls (10^9 B) / its seconds."""
    return {"decode_GBps": len(window.done) * inputs.work_bytes / 1e9 / window.seconds}


def probe(config: dict, mix: dict, inputs: Inputs, seed: int) -> tuple[dict, list]:
    """One call on a copy of the stream with one member's CRC-32 flipped,
    the member drawn from the seed: a decoder that checks every member's
    CRC refuses it (raises); one that returns bytes missed the fault."""
    import numpy as np

    import refcheck
    from tpu_deflate_torch import engine

    spans = refcheck.td_spans(inputs.stream)
    k = int(np.random.default_rng([seed & (2**63 - 1), 0xC2C]).integers(len(spans)))
    bad = bytearray(inputs.stream)
    bad[spans[k][1] - 8] ^= 0x01
    try:
        engine.decompress(bytes(bad), engine="cuda")
        missed, said = 1, "returned bytes"
    except Exception as e:  # the refusal this probe asks for
        missed, said = 0, f"raised {type(e).__name__}: {str(e)[:120]}"
    return {"crc_fault_missed": (missed, 0)}, [f"probe: member {k} of {len(spans)} with its CRC-32 flipped: {said}"]


def notes() -> list:
    """The last call's routes, from the program's own counters."""
    import json

    from tpu_deflate_torch.codec import decode_v2

    stats = {k: v for k, v in decode_v2.LAST_DECODE_STATS.items() if k != "launches"}
    return [f"routes: {json.dumps(stats)}"]


def judge(config: dict, mix: dict, inputs: Inputs, done: list) -> dict:
    import refcheck

    return refcheck.compare_decode(inputs.stream, inputs.data, [o for _i, o in done])


def control(config: dict, mix: dict, inputs: Inputs) -> bytes:
    """Every member inflated by the reference with a 16 KiB window, up to
    its first match that reaches further back (a decoder that keeps less
    history); members found by their TD sizes. Breaks "the bytes come
    back exactly"."""
    import refcheck

    buf, out = memoryview(inputs.stream), []
    for pos, end in refcheck.td_spans(inputs.stream):
        start = refcheck.read_header(buf, pos)[0]
        inf = zlib.decompressobj(CUT_WBITS)
        for at in range(start, end - 8, 4096):  # small steps keep what came before a failure
            try:
                out.append(inf.decompress(buf[at : min(at + 4096, end - 8)]))
            except zlib.error:
                break
    return b"".join(out)
