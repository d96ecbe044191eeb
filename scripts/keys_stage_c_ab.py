"""Stage C and the match finder's key pass on the card, for one tree or two
in turns.

    python scripts/keys_stage_c_ab.py --tree DIR            # one tree: one JSON line
    python scripts/keys_stage_c_ab.py --ab PARENT CHANGE    # PARENT, CHANGE, CHANGE, PARENT

A tree is a checkout of this repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists, or the repository
itself). ``--ab`` runs each tree in a process of its own, in the order
above, prints each figure of the four runs side by side, then the JSON
lines.

For a tree, on the 48 MiB corpus of ``bench.make_corpus(48)``:

- stage C (``decode_kernels.stage_c``) on the inputs of every wave of the
  decode's main path (``engine.decompress`` of the corpus's members: 5
  waves) and of the continuous member's decode (``engine.compress(corpus,
  effort=4)``, then its decode: one-lane waves), each captured from the
  wrapper during the run and replayed: the device time of each launch of
  ``stage_c_kernel`` (torch.profiler over one pass of the captured calls;
  where the profiler records none, CUDA events around each call queued
  behind a spin kernel, which then include the call's other device work),
  summed per path, beside its bytes bound (the maps and entry0 read once,
  the uint8 and int32 entries and the final state written once, at 3.35
  TB/s), and the device time of the other device work the calls launched
  (the zero fill of the look-back scratch where the tree has one);
- ``match_keys`` on the encode's first batch (64 x 65536 at effort 2: the
  4- and 3-byte families) and on the continuous encode's first batch (64 x
  98304 at effort 4: the 4-, 3- and 6-byte families with hstart): the
  median device time of ``match_keys_kernel`` over REPS launches beside its
  bytes bound (the row, lengths and hstart read once, 4 bytes a family a
  position written), and that of ``match_chain_kernel`` on the keys just
  written (it reads them next on the encode's path);
- what ptxas reported for both kernels (registers, spills) in the tree's
  build log.

Every figure stands beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import zlib

REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SPIN_CYCLES = 400_000  # ~0.2 ms at the H100's clock: longer than one call's enqueue


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_times(calls: list, kernel: str) -> dict:
    """Device us of each launch of ``kernel`` over one pass of calls (after
    a warm-up pass), in call order, and of the other device work of the
    pass; from torch.profiler, or CUDA events around each call where the
    profiler recorded fewer launches of the kernel. The session starts with
    one more call, synchronized, before the pass: a session on the card has
    dropped its first kernel's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls[0]()
        torch.cuda.synchronize()
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
    kernels = [e for e in events if kernel in e.name]
    mine = kernels[-len(calls):]
    if len(mine) == len(calls):
        # The pass's other work: after the kernel before its first (the extra call's), if recorded.
        after = kernels[-len(calls) - 1].time_range.end if len(kernels) > len(calls) else mine[0].time_range.start
        other = [e for e in events if kernel not in e.name and e.time_range.start >= after]
        return {"source": "profiler", "us": [e.time_range.elapsed_us() for e in mine],
                "other_us": round(sum(e.time_range.elapsed_us() for e in other), 3),
                "other_events": sorted({e.name[:60] for e in other})}
    mine = [e.time_range.elapsed_us() for e in kernels]
    us = []
    for fn in calls:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        us.append(a.elapsed_time(b) * 1000)
    return {"source": f"CUDA events a call (the profiler recorded {len(mine)} of {len(calls)})", "us": us,
            "other_us": None, "other_events": []}


def ptxas_lines(build_log: str, kernel: str) -> list:
    """The ptxas lines of the kernel's entry in a build log."""
    lines = open(build_log).read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            return [x.strip() for x in lines[i + 1 : i + 4] if "ptxas" in x]
    return []


def one_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import _build, engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import encode as pe

    here = os.path.realpath(tree)
    assert os.path.realpath(dk.__file__).startswith(here + os.sep), f"{dk.__file__} is not under {tree}"
    device = torch.device("cuda")
    corpus = bench.make_corpus(48)
    gz = native.compress_members_native(corpus)
    cont = engine.compress(corpus, engine="cuda", effort=4)
    out = {"tree": tree, "card": card(), "torch": torch.__version__}

    # Stage C: every wave's inputs, captured from the wrapper.
    stage_c = dk.stage_c

    def decode_inputs(stream: bytes) -> list:
        got = []

        def spy(t, e):
            got.append((t.clone(), e.clone()))
            return stage_c(t, e)

        dk.stage_c = spy
        try:
            assert engine.decompress(stream, engine="cuda") == corpus
        finally:
            dk.stage_c = stage_c
        return got

    for label, stream in (("stage C main path", gz), ("stage C continuous member", cont)):
        inputs = decode_inputs(stream)
        calls = [lambda t=t, e=e: stage_c(t, e) for t, e in inputs]
        times = device_times(calls, "stage_c_kernel")
        bound = [(t.numel() + 4 * e.numel() + 5 * t.shape[0] * t.shape[1] + t.shape[0]) / HBM_BYTES_PER_S * 1e6
                 for t, e in inputs]
        us = times["us"]
        shapes = sorted({tuple(t.shape[:2]) for t, _e in inputs})
        out[label] = {
            "launches": len(inputs), "shapes": [list(s) for s in shapes][:12], "source": times["source"],
            "us_sum": round(sum(us), 3), "bound_us_sum": round(sum(bound), 3),
            "share": round(sum(bound) / sum(us), 4),
            "us_each": [round(u, 3) for u in us] if len(us) <= 8 else
            {"min": round(min(us), 3), "median": round(statistics.median(us), 3), "max": round(max(us), 3)},
            "slowest": [list(inputs[i][0].shape[:2]) for i in sorted(range(len(us)), key=lambda i: -us[i])[:3]],
            "other_us": times["other_us"], "other_events": times["other_events"],
            "crc": zlib.crc32(b"".join(x.cpu().numpy().tobytes() for c in calls for x in c())),
        }
        del inputs, calls

    # match_keys on the first batches of both encodes.
    first = cs.encode_batch(corpus[: pe.ENC_LANE_BATCH * cs.MEMBER], device)
    rows4, lengths4, _hist4, hstart4 = cs.continuous_batch(corpus, device)["match"]
    batches = {
        "match_keys effort 2": (first["rows"], torch.from_numpy(first["lengths"]).to(device),
                                (pe.FAMILY_4, pe.FAMILY_3), None),
        "match_keys effort 4": (rows4, lengths4, (pe.FAMILY_4, pe.FAMILY_3, pe.FAMILY_6), hstart4),
    }
    for label, (data, lengths, families, hstart) in batches.items():
        call = lambda data=data, lengths=lengths, families=families, hstart=hstart: pe.match_keys(  # noqa: E731
            data, lengths, families, hstart)
        times = device_times([call] * REPS, "match_keys_kernel")
        L, S = data.shape
        nbytes = L * S + 4 * L * (1 + (hstart is not None)) + 4 * len(families) * L * S
        med = statistics.median(times["us"])
        chain = device_times([lambda: pe.match_chain(call())] * REPS, "match_chain_kernel")
        out[label] = {"shape": [L, S], "families": list(families), "source": times["source"],
                      "us": round(med, 3), "us_range": [round(min(times["us"]), 3), round(max(times["us"]), 3)],
                      "bound_us": round(nbytes / HBM_BYTES_PER_S * 1e6, 3),
                      "share": round(nbytes / HBM_BYTES_PER_S * 1e6 / med, 4),
                      "chain_us": round(statistics.median(chain["us"]), 3), "chain_source": chain["source"],
                      "crc": zlib.crc32(call().cpu().numpy().tobytes())}

    build_log = _build.library_path()[:-3] + ".log"
    out["ptxas"] = {k: ptxas_lines(build_log, k) for k in ("stage_c_kernel", "match_keys_kernel")}
    return out


FIGURES = (
    ("stage C main path", "us_sum"), ("stage C main path", "us_each"), ("stage C main path", "bound_us_sum"),
    ("stage C main path", "share"), ("stage C main path", "other_us"), ("stage C main path", "source"),
    ("stage C continuous member", "launches"), ("stage C continuous member", "us_sum"),
    ("stage C continuous member", "us_each"), ("stage C continuous member", "bound_us_sum"),
    ("stage C continuous member", "share"), ("stage C continuous member", "other_us"),
    ("stage C continuous member", "slowest"), ("stage C continuous member", "source"),
    ("match_keys effort 2", "us"), ("match_keys effort 2", "us_range"), ("match_keys effort 2", "bound_us"),
    ("match_keys effort 2", "share"), ("match_keys effort 2", "chain_us"), ("match_keys effort 4", "us"),
    ("match_keys effort 4", "us_range"), ("match_keys effort 4", "bound_us"), ("match_keys effort 4", "share"),
    ("match_keys effort 4", "chain_us"), ("match_keys effort 4", "source"),
)
SAME = ("stage C main path", "stage C continuous member", "match_keys effort 2", "match_keys effort 4")


def ab(parent: str, change: str) -> int:
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}; torch {runs[0]['torch']}; order: parent, change, change, parent")
    for part, key in FIGURES:
        print(f"{part} {key}: " + " / ".join(json.dumps(r[part][key]) for r in runs))
    for label, r in (("parent", runs[0]), ("change", runs[1])):
        print(f"ptxas {label}: {json.dumps(r['ptxas'])}")
    print(f"stage C main path shapes: {json.dumps(runs[1]['stage C main path']['shapes'])}; continuous member "
          f"shapes: {json.dumps(runs[1]['stage C continuous member']['shapes'])}")
    same = {part: len({r[part]["crc"] for r in runs}) == 1 for part in SAME}
    print(f"outputs identical across the four runs: {json.dumps(same)}")
    for r in runs:
        print(json.dumps(r))
    return 0 if all(same.values()) else 1


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
