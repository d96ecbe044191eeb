"""The encoder's block routing and header/EOB, the "off" route's packed
token pull and Adler-32 on the card, for one tree or two in turns.

    python scripts/plan_pack_ab.py --tree DIR            # one tree: one JSON line
    python scripts/plan_pack_ab.py --ab PARENT CHANGE    # PARENT, CHANGE, CHANGE, PARENT

A tree is a checkout of this repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists, or the repository
itself). ``--ab`` runs each tree in a process of its own, in the order
above, prints each figure of the four runs side by side, then the JSON
lines.

For a tree:

- the encodes, ``engine.compress`` of the 48 MiB corpus at effort 2 (the
  member profile) and at effort 4 (the continuous encode), 12 lane batches
  each: one call's launches of the port's kernels (``_build``'s counters),
  host-side aten ops that launch device work and device events
  (``chip_smoke.call_record``), in all and a batch; the device time of one
  profiled call (every device event summed) and by name; the wall time
  (median of 3, host clock around a call that ends in a synchronize); the
  output's CRC;
- the ``"off"`` route, ``engine.decompress`` of the 8 MiB corpus's members
  with ``device_resolve="off"``: the same counts a wave; each wave's pull
  (the tree's ``decode_v2.pack_tokens``, its inputs captured and replayed):
  its device time summed over a profiled pass, its device events a wave,
  its CUDA-event time queued behind a spin kernel, and the pulls' CRC;
- ``adler32_device`` of 256 MiB on the card (a uint8 buffer uploaded by
  the call): CUDA-event time queued behind a spin kernel, the device
  memory peak above the buffer, the checksum against zlib.

Every figure stands beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from split_summary_ab import card, profiled, queued_us  # noqa: E402

ADLER_BYTES = 256 << 20
WALL_REPS = 3


def counts(cs, fn, per: int) -> dict:
    """One call of fn (``call_record``): the port's launches, the aten ops
    that launch device work and the device events, in all and per unit."""
    launches, ops, events = cs.call_record(fn)
    device_ops = sum(n for op, n in ops.items() if op not in cs.NO_LAUNCH_OPS)
    ports = sum(launches.values())
    return {"units": per, "port_launches": ports, "port_launches_a_unit": round(ports / per, 2),
            "aten_device_ops": device_ops, "aten_device_ops_a_unit": round(device_ops / per, 2),
            "device_events": len(events), "device_events_a_unit": round(len(events) / per, 2),
            "launches": launches}


def one_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    here = os.path.realpath(tree)
    assert os.path.realpath(pv2.__file__).startswith(here + os.sep), f"{pv2.__file__} is not under {tree}"
    corpus = bench.make_corpus(48)
    batches = -(-len(corpus) // (64 * 64 * 1024))
    out = {"tree": tree, "card": card(), "torch": torch.__version__}

    for effort in (2, 4):
        def encode(effort=effort):
            return engine.compress(corpus, engine="cuda", effort=effort)

        gz = encode()
        assert engine.decompress(gz, engine="cuda") == corpus
        walls = []
        for _ in range(WALL_REPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            encode()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        prof = profiled([encode])
        out[f"encode effort {effort}"] = {
            **counts(cs, encode, batches), "device_us": prof["us"],
            "device_us_a_batch": round(prof["us"] / batches, 3), "by_name": prof["by_name"],
            "wall_s_median": round(statistics.median(walls), 4), "crc": zlib.crc32(gz)}

    small = bench.make_corpus(8)
    gz_small = native.compress_members_native(small)
    off = DecoderConfig(device_resolve="off")
    pack, pulls = pv2.pack_tokens, []

    def spy(tokens):
        pulls.append(tokens.clone())
        return pack(tokens)

    pv2.pack_tokens = spy
    try:
        assert engine.decompress(gz_small, engine="cuda", config=off) == small
    finally:
        pv2.pack_tokens = pack
    waves = pv2.LAST_DECODE_STATS["waves"]
    assert len(pulls) == waves, (len(pulls), waves)
    calls = [lambda t=t: pack(t) for t in pulls]
    prof = profiled(calls)
    crc = 0
    for fn in calls:
        for t in fn():
            crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
    out["off route"] = {**counts(cs, lambda: engine.decompress(gz_small, engine="cuda", config=off), waves)}
    out["off route pull"] = {
        "waves": waves, "tokens": [list(t.shape) for t in pulls], "device_us": prof["us"],
        "device_us_a_wave": round(prof["us"] / waves, 3), "events_a_wave": round(prof["events"] / waves, 2),
        "by_name": prof["by_name"], "queued_us": [round(queued_us(fn), 3) for fn in calls], "crc": crc}
    del pulls, calls

    buf = np.random.default_rng(20).integers(0, 256, ADLER_BYTES, dtype=np.uint8)
    want = zlib.adler32(buf)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = cl.adler32_device(buf)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0 - ADLER_BYTES
    out["adler32_device"] = {"bytes": ADLER_BYTES, "equal_zlib": got == want,
                             "queued_us": [round(queued_us(lambda: cl.adler32_device(buf)), 3) for _ in range(3)],
                             "peak_above_buffer": peak, "crc": got}
    return out


FIGURES = [(f"encode effort {e}", k) for e in (2, 4) for k in (
    "port_launches_a_unit", "aten_device_ops_a_unit", "device_events_a_unit", "device_us_a_batch",
    "wall_s_median", "by_name")] + [
    ("off route", "units"), ("off route", "port_launches_a_unit"), ("off route", "aten_device_ops_a_unit"),
    ("off route", "device_events_a_unit"),
    ("off route pull", "tokens"), ("off route pull", "device_us"), ("off route pull", "device_us_a_wave"),
    ("off route pull", "events_a_wave"), ("off route pull", "queued_us"), ("off route pull", "by_name"),
    ("adler32_device", "queued_us"), ("adler32_device", "peak_above_buffer"), ("adler32_device", "equal_zlib"),
]
SAME = ("encode effort 2", "encode effort 4", "off route pull", "adler32_device")


def ab(parent: str, change: str) -> int:
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}; torch {runs[0]['torch']}; order: parent, change, change, parent")
    for part, key in FIGURES:
        print(f"{part} {key}: " + " / ".join(json.dumps(r[part][key]) for r in runs))
    same = {part: len({r[part]["crc"] for r in runs}) == 1 for part in SAME}
    print(f"outputs identical across the four runs: {json.dumps(same)}")
    for r in runs:
        print(json.dumps(r))
    return 0 if all(same.values()) and all(r["adler32_device"]["equal_zlib"] for r in runs) else 1


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--tree", metavar="DIR")
    group.add_argument("--ab", nargs=2, metavar=("PARENT", "CHANGE"))
    args = ap.parse_args(argv)
    if args.tree:
        print(json.dumps(one_tree(args.tree)))
        return 0
    return ab(*args.ab)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
