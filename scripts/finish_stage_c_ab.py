"""Stage C and the encoder's symbol-and-histogram pass on the card, for one
tree or two in turns.

    python scripts/finish_stage_c_ab.py --tree DIR            # one tree: one JSON line
    python scripts/finish_stage_c_ab.py --ab PARENT CHANGE    # PARENT, CHANGE, CHANGE, PARENT

A tree is a checkout of this repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists, or the repository
itself). ``--ab`` runs each tree in a process of its own, in the order
above, and prints each figure of the four runs side by side, then the JSON
lines.

For a tree, on the 48 MiB corpus of ``bench.make_corpus(48)``:

- the symbol pass (what the tree runs between K9 and the planning) on the
  encode's first batch (64 x 65536, effort 2) and on the continuous
  encode's first batch (64 x 98304, effort 4): the CUDA-event median of 20
  calls, and the device events of one call by name (torch.profiler, after
  a warm-up call). Where ``encode._finish_analysis`` is a kernel (it takes
  K9's bitmap and the mask) that is one call; in a tree where it is the
  eager chain (it takes ``is_token``), the ``& valid`` before it and the
  int32 flags after it, which the kernel took in, are timed with it.
  Beside them ``torch.bincount``'s median on the keys of each histogram
  (int64 ``lane * (bins + 1) + symbol``, as the eager chain builds them);
- stage C on every wave of the decode's main path (each wave's maps from
  K1 and K2 on the wave ``engine.decompress`` of the corpus's members ran):
  the CUDA-event median of 20 calls a wave of what the tree's wave body
  runs there (``decode_kernels.stage_c``; in a tree without it,
  ``decode_v2.stage_c_entries`` and the int32 cast of its entries), summed
  over the waves, and the device events of one pass over the waves;
- ``engine.compress`` at effort 2 and at effort 4 and ``engine.decompress``
  of the corpus's members (the decode's main path), one call each under
  torch.profiler: the device events' summed time, their count and their
  largest names; and the device memory peak of one unprofiled call above
  what was held before it;
- ``kernel_bench.kernel_only_bench``: one pass's CUDA-event and device time
  (``LAST_PASS_TIMES``) and its ``decode_gbps``.

Every figure stands beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)."""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import zlib

REPS = 20
TOP = 12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def profiled(run) -> list:
    """Device events of one call of run() after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda and not e.name.startswith("ProfilerStep")]


def summary(events: list) -> dict:
    """Summed device us, event count and the largest names (us, count)."""
    by = collections.defaultdict(list)
    for e in events:
        by[e.name[:90]].append(e.time_range.elapsed_us())
    top = sorted(by.items(), key=lambda kv: -sum(kv[1]))[:TOP]
    return {"device_us": round(sum(e.time_range.elapsed_us() for e in events), 1), "events": len(events),
            "top": [[name, round(sum(us), 1), len(us)] for name, us in top]}


def peak(run) -> int:
    import torch

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - mem0


def one_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import encode as pe
    from tpu_deflate_torch.codec import kernel_bench as kb
    from tpu_deflate_torch.codec import parse as pp

    here = os.path.realpath(tree)
    assert os.path.realpath(pe.__file__).startswith(here + os.sep), f"{pe.__file__} is not under {tree}"
    device = torch.device("cuda")
    corpus = bench.make_corpus(48)
    gz = native.compress_members_native(corpus)
    out = {"tree": tree, "card": card(), "torch": torch.__version__}
    i32 = torch.int32
    kernel = hasattr(pe, "_finish_analysis_plain")

    # The symbol pass on the first batches.
    first = cs.encode_batch(corpus[: pe.ENC_LANE_BATCH * cs.MEMBER], device)
    cont = cs.continuous_batch(corpus, device)
    batches = {
        "effort 2": (first["rows"], torch.from_numpy(first["lengths"]).to(device), True, 0, None, None,
                     first["tiles"], first["entries"]),
        "effort 4": (*cont["match"][:2], True, 1, *cont["match"][2:], cont["tiles"], cont["entries"]),
    }
    for label, (rows, lengths, lazy, quality, hist, hstart, tiles, entries) in batches.items():
        use, dist, _step, valid = pe._match_find(rows, lengths, lazy, quality, hist, hstart)
        tok = pp.parse_replay(tiles, entries)

        def run(rows=rows, use=use, dist=dist, tok=tok, valid=valid):
            if kernel:
                return pe._finish_analysis(rows, use, dist, tok, valid)
            a = pe._finish_analysis(rows, use, dist, tok & valid)
            return a, a["is_token"].to(i32) | (a["is_match"].to(i32) << 1)

        a, flags = run()
        L = rows.shape[0]
        lanes = torch.arange(L, device=device)[:, None]
        keys = ((torch.where(a["is_token"], a["litlen_sym"], 288).to(torch.int64) + lanes * 289).view(-1),
                (torch.where(a["is_match"], a["dist_sym"], 30).to(torch.int64) + lanes * 31).view(-1))
        out[f"symbols {label}"] = {
            "shape": list(rows.shape), "ms": round(cs.median_ms(run, REPS), 4), **summary(profiled(run)),
            "bincount_ms": [round(cs.median_ms(lambda k=k, n=n: torch.bincount(k, minlength=L * n), REPS), 4)
                            for k, n in zip(keys, (289, 31))],
            "crc": zlib.crc32(b"".join(t.cpu().numpy().tobytes() for t in (*a.values(), flags))),
        }
        del a, flags, keys, use, dist, valid, tok

    # Stage C on the main path's waves.
    waves = []
    wave_stages = pv2.wave_stages

    def spy(w, **kw):
        waves.append(w)
        return wave_stages(w, **kw)

    pv2.wave_stages = spy
    try:
        assert engine.decompress(gz, engine="cuda") == corpus
    finally:
        pv2.wave_stages = wave_stages
    inputs = [(dk.stage_b(dk.stage_a(w["grid"], dk.build_meta(w))[0]), w["rem"]) for w in waves]
    del waves

    def stage_c(t, e):
        if hasattr(dk, "stage_c"):
            return dk.stage_c(t, e)
        entries, final = pv2.stage_c_entries(t, e)
        return entries, final, entries.to(i32)

    def all_waves():
        return [stage_c(t, e) for t, e in inputs]

    out["stage C"] = {
        "waves": [list(t.shape) for t, _e in inputs],
        "ms": [round(cs.median_ms(lambda t=t, e=e: stage_c(t, e), REPS), 4) for t, e in inputs],
        **summary(profiled(all_waves)),
        "crc": zlib.crc32(b"".join(x.cpu().numpy().tobytes() for r in all_waves() for x in r)),
    }
    out["stage C"]["ms_sum"] = round(sum(out["stage C"]["ms"]), 4)
    del inputs

    for label, run in (("encode effort 2", lambda: engine.compress(corpus, engine="cuda", effort=2)),
                       ("continuous effort 4", lambda: engine.compress(corpus, engine="cuda", effort=4)),
                       ("decode main path", lambda: engine.decompress(gz, engine="cuda"))):
        res = run()
        out[label] = {**summary(profiled(run)), "peak_bytes": peak(run), "crc": zlib.crc32(res)}

    r = kb.kernel_only_bench(corpus)
    t = kb.LAST_PASS_TIMES["kernel_only_bench"]
    out["kernel_only_bench"] = {"decode_gbps": r["decode_gbps"], "event_ms": round(t["event_ms"], 3),
                                "device_ms": round(t["device_ms"], 3), "queued": t["queued"]}
    return out


FIGURES = (
    ("symbols effort 2", "ms"), ("symbols effort 2", "device_us"), ("symbols effort 2", "events"),
    ("symbols effort 2", "bincount_ms"), ("symbols effort 4", "ms"), ("symbols effort 4", "device_us"),
    ("symbols effort 4", "events"), ("symbols effort 4", "bincount_ms"),
    ("stage C", "ms"), ("stage C", "ms_sum"), ("stage C", "device_us"), ("stage C", "events"),
    ("encode effort 2", "device_us"), ("encode effort 2", "events"), ("encode effort 2", "peak_bytes"),
    ("continuous effort 4", "device_us"), ("continuous effort 4", "events"), ("continuous effort 4", "peak_bytes"),
    ("decode main path", "device_us"), ("decode main path", "events"), ("decode main path", "peak_bytes"),
    ("kernel_only_bench", "device_ms"), ("kernel_only_bench", "event_ms"), ("kernel_only_bench", "queued"),
    ("kernel_only_bench", "decode_gbps"),
)
SAME = ("symbols effort 2", "symbols effort 4", "stage C", "encode effort 2", "continuous effort 4",
        "decode main path")


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
    for part in SAME:
        for i, r in enumerate(runs):
            print(f"{part} run {i} largest device events: {json.dumps(r[part]['top'][:8])}")
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
