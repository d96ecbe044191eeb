"""The tile split and the wave's summary fold on the card, for one tree or
two in turns.

    python scripts/split_summary_ab.py --tree DIR            # one tree: one JSON line
    python scripts/split_summary_ab.py --ab PARENT CHANGE    # PARENT, CHANGE, CHANGE, PARENT

A tree is a checkout of this repository (``git archive`` of a commit
unpacked into a directory that ``.gitignore`` lists, or the repository
itself). ``--ab`` runs each tree in a process of its own, in the order
above, prints each figure of the four runs side by side, then the JSON
lines.

For a tree:

- the split (``resolve.split_tiles_device``) on the calls of the big
  members' route (``chip_smoke.big_members`` of the 48 MiB corpus through
  ``engine.decompress``: 2 groups) and of the continuous member's decode
  (``engine.compress(corpus, effort=4)``: one lane), captured from the
  wrapper and replayed: the device time of each call (every device event
  of one profiled pass, summed, by name; and CUDA events around each call
  queued behind a spin kernel), its launches (torch.profiler's device
  events), its device memory peak above its output, per token, and its
  bytes bound (the tokens read once, the tiles written once);
- the main path's decode of the corpus's members (``engine.decompress``):
  its device events (kernels and copies, torch.profiler) and host-side
  aten ops that launch device work, in all and a wave;
- K3 (``decode_kernels.stage_dc``) on the main path's waves and on the
  first 64 of the continuous member's decode, its inputs captured and
  replayed: its device time a launch (the profiler's ``stage_dc_kernel``
  events; where the tree folds the summary in K3's epilogue, the fold
  included);
- the summary fold on K3's rows of every wave of both decodes: where the
  tree folds in K3 (``stage_dc`` returns the vector), no launch and no
  device time of its own; else replayed (``decode_kernels.wave_summary``
  where the tree has it, else the eager sums and stack the tree's
  ``run_wave`` and ``pack_small`` ran): its device time a wave and its
  launches.

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
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: longer than one call's enqueue
REPS = 5
K3_WAVES = 64  # waves of each decode whose K3 inputs are kept and replayed


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def profiled(calls: list) -> dict:
    """One pass of calls under torch.profiler, after a warm-up pass: the
    device events' time summed (us), their count and the time by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    by_name: dict = collections.defaultdict(float)
    for e in events:
        by_name[e.name[:48]] += e.time_range.elapsed_us()
    return {"us": round(sum(by_name.values()), 3), "events": len(events),
            "by_name": {k: round(v, 3) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}}


def queued_us(fn) -> float:
    """Device us of one call: CUDA events around it, queued behind a spin."""
    import torch

    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1000)
    return statistics.median(times)


def one_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import resolve as rs

    here = os.path.realpath(tree)
    assert os.path.realpath(rs.__file__).startswith(here + os.sep), f"{rs.__file__} is not under {tree}"
    corpus = bench.make_corpus(48)
    gz = native.compress_members_native(corpus)
    big_gz, chunks, _payloads = cs.big_members(corpus)
    cont = engine.compress(corpus, engine="cuda", effort=4)
    out = {"tree": tree, "card": card(), "torch": torch.__version__}

    # The split: every call of a route, captured and replayed.
    split = rs.split_tiles_device

    def split_inputs(stream: bytes, want: bytes) -> list:
        got = []

        def spy(tok, T):
            got.append((tok.clone(), T))
            return split(tok, T)

        rs.split_tiles_device = spy
        try:
            assert engine.decompress(stream, engine="cuda") == want
        finally:
            rs.split_tiles_device = split
        return got

    for label, stream, want in (("split big members", big_gz, b"".join(chunks)),
                                ("split continuous member", cont, corpus)):
        inputs = split_inputs(stream, want)
        calls = [lambda tok=tok, T=T: split(tok, T) for tok, T in inputs]
        peaks, per_token, crc = [], [], 0
        for (tok, T), fn in zip(inputs, calls):
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tiles = fn()
            torch.cuda.synchronize()
            above = torch.cuda.max_memory_allocated() - mem0 - tiles.numel() * 4
            n_tok = int((tok >= 0).sum())
            peaks.append(above)
            per_token.append(round(above / max(n_tok, 1), 4))
            crc = zlib.crc32(tiles.cpu().numpy().tobytes(), crc)
            del tiles
        prof = profiled(calls)
        out[label] = {
            "calls": [[list(tok.shape), T] for tok, T in inputs],
            "device_us": prof["us"], "events": prof["events"], "by_name": prof["by_name"],
            "queued_us": [round(queued_us(fn), 3) for fn in calls],
            "bound_us": [round((tok.numel() * 4 + tok.shape[0] * T * rs.N_POS * 4) / HBM_BYTES_PER_S * 1e6, 3)
                         for tok, T in inputs],
            "peak_above_output": peaks, "peak_above_output_per_token": per_token, "crc": crc,
        }
        del inputs, calls

    # The main path and the continuous member's decode: K3's rows of every
    # wave, its inputs of the first K3_WAVES, and whether K3 returned the
    # folded vector.
    stage_dc = dk.stage_dc
    rec: list = []

    def dc_spy(*a, **kw):
        res = stage_dc(*a, **kw)
        args = (tuple(x.clone() for x in a), dict(kw)) if len(rec) < K3_WAVES else None
        rec.append((args, res[1].clone(), len(res) == 3))
        return res

    captured_waves = {}
    dk.stage_dc = dc_spy
    try:
        for label, stream, want in (("main path", gz, corpus), ("continuous decode", cont, corpus)):
            rec = []
            assert engine.decompress(stream, engine="cuda") == want
            assert len(rec) == pv2.LAST_DECODE_STATS["waves"], (len(rec), pv2.LAST_DECODE_STATS["waves"])
            captured_waves[label] = rec
    finally:
        dk.stage_dc = stage_dc
    waves = len(captured_waves["main path"])
    launches, ops, events = cs.call_record(lambda: engine.decompress(gz, engine="cuda"))
    device_ops = sum(n for op, n in ops.items() if op not in cs.NO_LAUNCH_OPS)
    out["main path"] = {
        "waves": waves, "device_events": len(events), "device_events_a_wave": round(len(events) / waves, 2),
        "aten_device_ops": device_ops, "aten_device_ops_a_wave": round(device_ops / waves, 2),
        "port_launches": sum(launches.values()), "port_launches_a_wave": round(sum(launches.values()) / waves, 2),
    }
    for label, rec in captured_waves.items():
        fused = rec[0][2]
        k3 = [lambda a=a, kw=kw: stage_dc(*a, **kw) for (a, kw), _s, _f in rec[:K3_WAVES]]
        prof = profiled(k3)
        k3_us = sum(us for name, us in prof["by_name"].items() if "stage_dc_kernel" in name)
        out[f"K3 {label}"] = {
            "fused_fold": fused, "launches": len(k3), "device_us": prof["us"],
            "k3_us_a_launch": round(k3_us / len(k3), 3), "by_name": prof["by_name"],
            "queued_us": [round(queued_us(fn), 3) for fn in k3[:5]],
        }
        rows = [summ for _a, summ, _f in rec]
        if fused:  # the fold is K3's epilogue: no launch of its own
            out[f"summary fold {label}"] = {"in_k3": True, "waves": len(rows), "device_us": 0.0,
                                            "device_us_a_wave": 0.0, "events_a_wave": 0.0, "by_name": {},
                                            "queued_us": [], "crc": fold_crc(rows)}
            continue
        if hasattr(dk, "wave_summary"):
            fold = dk.wave_summary
        else:  # the eager fold of the tree's run_wave and pack_small
            def fold(summ):
                sums = dk.wave_sums_plain(summ) if hasattr(dk, "wave_sums_plain") else eager_sums(summ)
                return pv2.pack_small(*sums)
        calls = [lambda s=s: fold(s) for s in rows]
        prof = profiled(calls)
        out[f"summary fold {label}"] = {
            "in_k3": False, "waves": len(rows), "device_us": prof["us"],
            "device_us_a_wave": round(prof["us"] / len(rows), 3),
            "events_a_wave": round(prof["events"] / len(rows), 2), "by_name": prof["by_name"],
            "queued_us": [round(queued_us(fn), 3) for fn in calls[:5]],
            "bound_us": [round((s.numel() * 4 + 7 * s.shape[0] * 4) / HBM_BYTES_PER_S * 1e6, 3) for s in rows[:5]],
            "crc": zlib.crc32(b"".join(fn().cpu().numpy().tobytes() for fn in calls)),
        }
    return out


def fold_crc(rows) -> int:
    """CRC of the plain folds of the rows (the vectors K3 returned equal
    these; chip_smoke.py checks it on every wave)."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    return zlib.crc32(b"".join(dk.wave_summary_plain(s).cpu().numpy().tobytes() for s in rows))


def eager_sums(summ):
    """The sums of the wave body before its summary fold had a kernel (the
    parent's run_wave, from K3's rows on)."""
    import torch

    from tpu_deflate_torch.codec.wave_prep import (ROW_COUNT, ROW_EOB_HIT, ROW_EOB_POS, ROW_EOB_TOK, ROW_ERR_HIT,
                                                   ROW_ERR_TOK, ROW_OVERFLOW, ROW_SIZE_SUM, W_P)

    NT = summ.shape[2]
    counts = summ[:, ROW_COUNT, :].sum(dim=1)
    eob_hit = summ[:, ROW_EOB_HIT, :]
    has_eob = eob_hit.sum(dim=1) > 0
    tile_base = (torch.arange(NT, device=summ.device) * W_P).view(1, NT)
    eob_pos = (summ[:, ROW_EOB_POS, :] + eob_hit * tile_base).sum(dim=1)
    eob_tok = summ[:, ROW_EOB_TOK, :].sum(dim=1)
    eob_exit = torch.where(has_eob, eob_pos + (-eob_tok - 1), 0)
    err_hit = summ[:, ROW_ERR_HIT, :].sum(dim=1) > 0
    err_tok = summ[:, ROW_ERR_TOK, :].sum(dim=1)
    err_code = torch.where(err_hit, -err_tok - 100, 0)
    out_total = summ[:, ROW_SIZE_SUM, :].sum(dim=1)
    overflow = summ[:, ROW_OVERFLOW, :].sum() > 0
    i32 = torch.int32
    return counts.to(i32), has_eob, eob_exit.to(i32), err_code.to(i32), out_total.to(i32), overflow


FIGURES = (
    ("split big members", "device_us"), ("split big members", "events"), ("split big members", "queued_us"),
    ("split big members", "bound_us"), ("split big members", "peak_above_output_per_token"),
    ("split big members", "by_name"),
    ("split continuous member", "device_us"), ("split continuous member", "events"),
    ("split continuous member", "queued_us"), ("split continuous member", "bound_us"),
    ("split continuous member", "peak_above_output_per_token"), ("split continuous member", "by_name"),
    ("main path", "waves"), ("main path", "device_events_a_wave"), ("main path", "aten_device_ops_a_wave"),
    ("main path", "port_launches_a_wave"),
    ("K3 main path", "launches"), ("K3 main path", "k3_us_a_launch"), ("K3 main path", "device_us"),
    ("K3 main path", "queued_us"),
    ("K3 continuous decode", "launches"), ("K3 continuous decode", "k3_us_a_launch"),
    ("K3 continuous decode", "device_us"),
    ("summary fold main path", "in_k3"), ("summary fold main path", "device_us"),
    ("summary fold main path", "device_us_a_wave"), ("summary fold main path", "events_a_wave"),
    ("summary fold main path", "queued_us"), ("summary fold main path", "by_name"),
    ("summary fold continuous decode", "waves"), ("summary fold continuous decode", "device_us"),
    ("summary fold continuous decode", "device_us_a_wave"), ("summary fold continuous decode", "events_a_wave"),
)
SAME = ("split big members", "split continuous member", "summary fold main path",
        "summary fold continuous decode")


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
    print(f"split calls: big members {json.dumps(runs[1]['split big members']['calls'])}, continuous member "
          f"{json.dumps(runs[1]['split continuous member']['calls'])}")
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
