"""The encoder's match finder on the card, for one tree or two in turns.

    python scripts/match_finder_ab.py --tree DIR            # one tree: one JSON line
    python scripts/match_finder_ab.py --ab PARENT CHANGE    # PARENT, CHANGE, CHANGE, PARENT

A tree is a checkout of this repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists). ``--ab`` runs each
tree in a process of its own, in the order above, and prints each figure
of the four runs side by side, then the JSON lines.

For a tree, on the 48 MiB corpus of ``bench.make_corpus(48)``:

- one batch of ``encode._match_find`` at effort 2 (the encode's first
  batch, 64 x 65536, quality 0, lazy) and at effort 4 (the continuous
  encode's first batch, 64 x 98304, quality 1, with the history masks):
  the CUDA-event median of 20 calls, and the device launches and device us
  by kernel of one call under ``torch.profiler`` (after a warm-up call);
- ``engine.compress`` of the corpus at effort 2 and at effort 4 (the
  continuous encode), one call each under ``torch.profiler``: each match
  finder kernel's launches and device us (summed; min, median and max a
  launch), the sort's kernels (names holding "sort", the parent's
  ``torch.sort``), and each kernel's bytes bound summed over the call (the
  wrapper's tensor arguments read once and results written once, over
  3.35 TB/s; the parent's sort: int32 keys read, int32 values and int64
  indices written, 16 bytes an element);
- the device memory peak of one unprofiled continuous encode above what was
  held before it (``torch.cuda.max_memory_allocated``).

Every figure stands beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)."""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import zlib

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
WRAPPERS = ("match_keys", "match_chain", "match_bucket", "match_select")
REPS = 20


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def tensor_bytes(x) -> int:
    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def device_events(prof) -> list:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda and not e.name.startswith("ProfilerStep")]


def by_kernel(events: list) -> dict:
    """{match finder kernel or "sort": {launches, device_us, min, median, max}}."""
    groups = collections.defaultdict(list)
    for e in events:
        name = next((w for w in WRAPPERS if f"{w}_kernel" in e.name), "sort" if "sort" in e.name.lower() else None)
        if name:
            groups[name].append(e.time_range.elapsed_us())
    return {k: {"launches": len(us), "device_us": round(sum(us), 1), "min_us": round(min(us), 1),
                "median_us": round(statistics.median(us), 1), "max_us": round(max(us), 1)}
            for k, us in groups.items()}


def one_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import encode as pe

    here = os.path.realpath(tree)
    assert os.path.realpath(pe.__file__).startswith(here + os.sep), f"{pe.__file__} is not under {tree}"
    device = torch.device("cuda")
    corpus = bench.make_corpus(48)
    out = {"tree": tree, "card": card(), "torch": torch.__version__}

    # Bytes of each wrapper call (and the sort's, from the keys).
    calls = collections.defaultdict(list)
    wrapped = [(name, getattr(pe, name)) for name in WRAPPERS if hasattr(pe, name)]

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            res = fn(*args, **kwargs)
            calls[name].append(tensor_bytes(args) + tensor_bytes(res))
            if name == "match_keys" and not hasattr(pe, "match_chain"):
                calls["sort"].append(4 * res.numel())  # 16 bytes an element
            return res
        return wrapper

    def recorded_bounds(run) -> dict:
        calls.clear()
        for name, fn in wrapped:
            setattr(pe, name, wrap(name, fn))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for name, fn in wrapped:
                setattr(pe, name, fn)
        return {k: round(sum(v) / HBM_BYTES_PER_S * 1e6, 2) for k, v in calls.items()}

    def profiled(run) -> list:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        return device_events(prof)

    first = cs.encode_batch(corpus[: pe.ENC_LANE_BATCH * cs.MEMBER], device)
    cont = cs.continuous_batch(corpus, device)["match"]
    batches = {"effort 2": (first["rows"], torch.from_numpy(first["lengths"]).to(device), True, 0, None, None),
               "effort 4": (*cont[:2], True, 1, *cont[2:])}
    for label, args in batches.items():
        def run(args=args):
            return pe._match_find(*args)
        events = profiled(run)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        out[f"batch {label}"] = {
            "shape": list(args[0].shape),
            "ms": round(cs.median_ms(run, REPS), 4),
            "launches": len(events),
            "device_us": round(sum(e.time_range.elapsed_us() for e in events), 1),
            "by_kernel": by_kernel(events),
            "names": dict(collections.Counter(e.name for e in events)),
            "peak_bytes": torch.cuda.max_memory_allocated() - mem0,
            "bound_us": recorded_bounds(run),
        }

    for label, effort in (("encode effort 2", 2), ("continuous effort 4", 4)):
        def run(effort=effort):
            return engine.compress(corpus, engine="cuda", effort=effort)
        gz = run()
        events = profiled(run)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        again = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - mem0
        assert again == gz, f"{label}: two encodes differ"
        out[label] = {"bytes": len(gz), "by_kernel": by_kernel(events), "bound_us": recorded_bounds(run),
                      "peak_bytes": peak, "crc": zlib.crc32(gz)}
    return out


FIGURES = (
    ("batch effort 2", "ms"), ("batch effort 2", "launches"), ("batch effort 2", "device_us"),
    ("batch effort 2", "peak_bytes"), ("batch effort 4", "ms"), ("batch effort 4", "launches"),
    ("batch effort 4", "device_us"), ("batch effort 4", "peak_bytes"), ("continuous effort 4", "peak_bytes"),
    ("encode effort 2", "peak_bytes"),
)


def ab(parent: str, change: str) -> int:
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    names = ["parent", "change", "change", "parent"]
    print(f"card: {runs[0]['card']}; torch {runs[0]['torch']}; order: {', '.join(names)}")
    for part, key in FIGURES:
        print(f"{part} {key}: " + " / ".join(str(r[part][key]) for r in runs))
    for part in ("batch effort 2", "batch effort 4", "encode effort 2", "continuous effort 4"):
        kernels = sorted({k for r in runs for k in r[part]["by_kernel"]})
        for k in kernels:
            cells = [r[part]["by_kernel"].get(k) for r in runs]
            bounds = [r[part]["bound_us"].get(k) for r in runs]
            print(f"{part} {k}: " + " / ".join(
                "-" if c is None else f"{c['launches']} launches, {c['device_us']} us (median {c['median_us']}, "
                f"max {c['max_us']}), bound {b} us" for c, b in zip(cells, bounds)))
    same = {part: len({(r[part]["bytes"], r[part]["crc"]) for r in runs}) == 1
            for part in ("encode effort 2", "continuous effort 4")}
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
