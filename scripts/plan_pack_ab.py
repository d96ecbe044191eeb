"""The encoder's emit with its block routing and header/EOB, the "off"
route's packed token pull and Adler-32 on the card, for one tree or two in
turns.

    python scripts/plan_pack_ab.py --tree DIR [--off-only]          # one tree: one JSON line
    python scripts/plan_pack_ab.py --ab PARENT CHANGE [--off-only]  # PARENT, CHANGE, CHANGE, PARENT
    python scripts/plan_pack_ab.py --emit PARENT [--variants]  # the emit, both trees in one process

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
- the emit step of each of those encodes, every batch's arguments
  captured and replayed: everything the tree runs from the planner's
  upload to the words and total bits (where the tree has
  ``emit.emit_routed``, its one launch; else ``encode.route``, then
  ``emit.emit_device``: the header's length by two eager ops, K10 and the
  header/EOB kernel), its device events a batch, their device time a
  batch (one profiled pass over the batches, summed) by name, the emit
  kernel's device time a launch, CUDA-event time of the first batch's step
  queued behind a spin kernel, and the words' and total bits' CRC;
- the ``"off"`` route, ``engine.decompress`` of the 8 MiB corpus's members
  with ``device_resolve="off"``: the same counts a wave, the decode's wall
  (median of 3) and its device memory peak above what was held before it;
  each wave's compaction and pull, its inputs (K3's tokens and the wave's
  literal planes) captured and replayed: where the tree has
  ``decode_kernels.compact_pack``, its one launch (K4's pull mode, with
  the bitmap's memset), else K4 (``compact_flat``, with its scratch's zero
  fill), then the tree's ``decode_v2.pack_tokens`` and the eager copy of
  nlit into row 6 of the vector; each wave's device µs a call and by
  kernel (20 calls under torch.profiler), its device events a call, its
  CUDA-event time queued behind a spin kernel, the bytes bound of the
  fused function (4 bytes read and 5 1/8 written a token slot, the planes
  and nlit) and its share of the compaction's kernels' device time, and
  the outputs' CRC (bitmap, literals, matches, nlit);
- ``adler32_device`` of 256 MiB on the card (a uint8 buffer uploaded by
  the call): CUDA-event time queued behind a spin kernel, the device
  memory peak above the buffer, the checksum against zlib.

``--emit PARENT`` compares the emit of PARENT (a tree whose encode ran
``encode.route``, then ``emit_body`` and ``header_eob``: ``csrc/route.cu``
and ``csrc/emit.cu``) with this tree's one launch (``emit.emit_routed``) in
one process: both trees' sources built side by side by nvcc, each of the
first effort-2 and effort-4 batches (this tree's ``emit_routed``
arguments) emitted in the order parent, change, change, parent, 20 times
each under torch.profiler: the device µs a call (every device event,
the parent's two eager ops and the zero fills included) and each
kernel's µs a launch, and the outputs (words, total bits, route) held
equal. ``--variants`` adds variants of this tree's ``csrc/emit.cu`` (the
order of its field loads and its routing, and its register cap), built
the same way, routed and with routing off, with ptxas' registers and
spills.

``--off-only`` runs the ``"off"`` route's part alone.

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
WAVE_REPS = 20
HBM_BYTES_PER_S = 3.35e12


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


def emit_steps(encode) -> tuple[list, object]:
    """One call of encode with each batch's emit step captured -> (a
    callable a batch that replays the step, a function that runs them all
    and returns the CRC of their words and total bits)."""
    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe

    steps = []
    if hasattr(em, "emit_routed"):
        routed = em.emit_routed

        def spy(*args):
            steps.append(lambda args=args: routed(*args))
            return routed(*args)

        em.emit_routed = spy
        try:
            encode()
        finally:
            em.emit_routed = routed
    else:
        # The parent's chain: the routing kernel (which rewrites the plan's
        # tensors in place: the same values again on a replay), then the
        # emit (the two eager ops of the header's length, K10, the header/EOB
        # kernel).
        route, device, pending = pe.route, em.emit_device, []

        def route_spy(*args, final=None):
            pending.append((args, final))
            return route(*args, final=final)

        def device_spy(*args):
            (rargs, final), = pending
            pending.clear()
            steps.append(lambda rargs=rargs, final=final, args=args: (route(*rargs, final=final), device(*args))[1])
            return device(*args)

        pe.route, pe.emit_device, pc.emit_device = route_spy, device_spy, device_spy
        try:
            encode()
        finally:
            pe.route, pe.emit_device, pc.emit_device = route, device, device

    def crc() -> int:
        c = 0
        for step in steps:
            words, total = step()[:2]
            c = zlib.crc32(total.cpu().numpy().tobytes(), zlib.crc32(words.cpu().numpy().tobytes(), c))
        return c

    return steps, crc


def profiled_names(calls: list) -> dict:
    """One pass of calls under torch.profiler, after a warm-up pass: the
    device events' count and time (us) summed and by full name (cut at 96
    characters)."""
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
    by_name: dict = {}
    for e in events:
        key = e.name[:96]
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    return {"us": sum(us for _n, us in by_name.values()), "events": len(events), "by_name": by_name}


def one_tree(tree: str, off_only: bool = False) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    here = os.path.realpath(tree)
    assert os.path.realpath(pv2.__file__).startswith(here + os.sep), f"{pv2.__file__} is not under {tree}"
    corpus = b"" if off_only else bench.make_corpus(48)
    batches = -(-len(corpus) // (64 * 64 * 1024))
    out = {"tree": tree, "card": card(), "torch": torch.__version__}

    for effort in (() if off_only else (2, 4)):
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
        steps, crc = emit_steps(encode)
        assert len(steps) == batches, (len(steps), batches)
        prof = profiled_names(steps)
        emit_us = [us / n for name, (n, us) in prof["by_name"].items() if "emit_kernel" in name]
        out[f"emit effort {effort}"] = {
            "batches": len(steps), "device_us_a_batch": round(prof["us"] / batches, 3),
            "events_a_batch": round(prof["events"] / batches, 2),
            "by_name_a_batch": {k: [round(n / batches, 2), round(us / batches, 3)]
                                for k, (n, us) in sorted(prof["by_name"].items(), key=lambda kv: -kv[1][1])},
            "emit_kernel_us_a_launch": [round(u, 3) for u in emit_us],
            "queued_us_first": round(queued_us(steps[0]), 3), "crc": crc()}
        del steps

    small = bench.make_corpus(8)
    gz_small = native.compress_members_native(small)
    off = DecoderConfig(device_resolve="off")
    fused = hasattr(dk, "compact_pack")
    waves_in = []
    if fused:
        pack = pv2.compact_pack

        def spy(tok, planes, vec):
            waves_in.append((tok.clone(), planes.clone()))
            return pack(tok, planes, vec)

        pv2.compact_pack = spy
        try:
            assert engine.decompress(gz_small, engine="cuda", config=off) == small
        finally:
            pv2.compact_pack = pack

        def step(tok, planes, vec):
            return pack(tok, planes, vec)
    else:
        # the parent's wave: K4, then the pull of its output and the eager
        # copy of nlit into the vector
        flat, pull = dk.compact_flat, pv2.pack_tokens

        def spy(tok, planes):
            waves_in.append((tok.clone(), planes.clone()))
            return flat(tok, planes)

        dk.compact_flat = spy
        try:
            assert engine.decompress(gz_small, engine="cuda", config=off) == small
        finally:
            dk.compact_flat = flat

        def step(tok, planes, vec):
            bitmap, lit, match, nlit = pull(flat(tok, planes))
            vec[6] = nlit
            return bitmap, lit, match, vec[6]
    waves = pv2.LAST_DECODE_STATS["waves"]
    assert len(waves_in) == waves, (len(waves_in), waves)
    walls = []
    for _ in range(WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.decompress(gz_small, engine="cuda", config=off)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine.decompress(gz_small, engine="cuda", config=off)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    out["off route"] = {**counts(cs, lambda: engine.decompress(gz_small, engine="cuda", config=off), waves),
                        "wall_s_median": round(statistics.median(walls), 4), "peak_bytes": peak}
    crc, per_wave = 0, []
    for tok, planes in waves_in:
        L, M = tok.shape
        vec = torch.zeros((7, L), dtype=torch.int32, device=tok.device)
        call = lambda tok=tok, planes=planes, vec=vec: step(tok, planes, vec)  # noqa: E731
        for t in call():
            crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
        prof = profiled_names([call] * WAVE_REPS)
        by_name = {k: [round(n / WAVE_REPS, 2), round(us / WAVE_REPS, 3)] for k, (n, us) in prof["by_name"].items()}
        kern_us = sum(us for k, (_n, us) in by_name.items() if "compact" in k or "pack_kernel" in k)
        bound_us = (9 * L * M + 4 * L * -(-M // 32) + 4 * 64 * L + 4 * L) / HBM_BYTES_PER_S * 1e6
        per_wave.append({"tokens": [L, M], "device_us": round(prof["us"] / WAVE_REPS, 3),
                         "events": round(prof["events"] / WAVE_REPS, 2), "by_name": by_name,
                         "compaction_kernels_us": round(kern_us, 3), "bound_us": round(bound_us, 3),
                         "share": round(bound_us / kern_us, 4) if kern_us else None,
                         "queued_us": round(queued_us(call), 3)})
    out["off route pull"] = {
        "fused": fused, "waves": waves, "per_wave": per_wave,
        "device_us": round(sum(w["device_us"] for w in per_wave), 3),
        "compaction_kernels_us": round(sum(w["compaction_kernels_us"] for w in per_wave), 3),
        "bound_us": round(sum(w["bound_us"] for w in per_wave), 3), "crc": crc}
    del waves_in
    if off_only:
        return out

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
    "port_launches_a_unit", "launches", "aten_device_ops_a_unit", "device_events_a_unit", "device_us_a_batch",
    "wall_s_median", "by_name")] + [(f"emit effort {e}", k) for e in (2, 4) for k in (
    "device_us_a_batch", "events_a_batch", "emit_kernel_us_a_launch", "queued_us_first", "by_name_a_batch")] + [
    ("off route", "units"), ("off route", "port_launches_a_unit"), ("off route", "launches"),
    ("off route", "aten_device_ops_a_unit"), ("off route", "device_events_a_unit"), ("off route", "wall_s_median"),
    ("off route", "peak_bytes"), ("off route pull", "fused"), ("off route pull", "device_us"),
    ("off route pull", "compaction_kernels_us"), ("off route pull", "bound_us"), ("off route pull", "per_wave"),
    ("adler32_device", "queued_us"), ("adler32_device", "peak_above_buffer"), ("adler32_device", "equal_zlib"),
]
SAME = ("encode effort 2", "encode effort 4", "emit effort 2", "emit effort 4", "off route pull", "adler32_device")


def ab(parent: str, change: str, off_only: bool = False) -> int:
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree]
                              + (["--off-only"] if off_only else []), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}; torch {runs[0]['torch']}; order: parent, change, change, parent")
    for part, key in FIGURES:
        if part in runs[0]:
            print(f"{part} {key}: " + " / ".join(json.dumps(r[part][key]) for r in runs))
    same = {part: len({r[part]["crc"] for r in runs}) == 1 for part in SAME if part in runs[0]}
    print(f"outputs identical across the four runs: {json.dumps(same)}")
    for r in runs:
        print(json.dumps(r))
    return 0 if all(same.values()) and all(r["adler32_device"]["equal_zlib"] for r in runs if "adler32_device" in r) else 1


# name -> (edit of csrc/emit.cu's text: (old, new) pairs, what it changes)
EMIT_VARIANTS = {
    "fields_first": ([("  load_group(1);\n  if (fixed)", "  if (fixed)"),
                      ("  load_group(0);    // in flight across the barrier and the fold\n",
                       "  load_group(0);\n  load_group(1);\n")],
                     "both halves of the field loads before the barrier, beside the routing's sums"),
    "fields_after": ([("  load_group(0);    // in flight across the barrier and the fold\n", ""),
                      ("  load_group(1);\n  if (fixed)", "  load_group(0);\n  load_group(1);\n  if (fixed)")],
                     "both halves after the barrier"),
    "no_routing": ([("const bool routing = rt.ll_hist != nullptr;", "const bool routing = false;")],
                   "the routing compiled out (routed calls then emit without it)"),
    "no_register_cap": ([("__launch_bounds__(E_THREADS, 2)", "__launch_bounds__(E_THREADS, 1)")],
                        "no cap of 64 registers (one block an SM where more are used)"),
}


def build_libs(sources: dict, out_dir: str, csrc: str) -> dict:
    """{name: [.cu paths]} -> {name: (ctypes library, ptxas' lines of its
    kernels)}: one nvcc a library, all at once."""
    import ctypes

    from tpu_deflate_torch import _build

    nvcc = _build.nvcc_path()
    procs = {}
    for name, cus in sources.items():
        so = os.path.join(out_dir, f"emit_{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so, *cus]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        ptxas = [" ".join(x.split()) for i, line in enumerate(lines) if "_kernel" in line and "Compiling" in line
                 for x in lines[i + 1:i + 3] if "Used" in x or "spill" in x]
        libs[name] = (ctypes.CDLL(so), ptxas)
    return libs


def emit_one_process(parent: str, variants: bool) -> int:
    """The ``--emit`` comparison (module docstring)."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch.codec import emit as em

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(here, "tpu_deflate_torch", "csrc")
    out_dir = os.path.join(here, "chiprun_out", "emit_builds")
    os.makedirs(out_dir, exist_ok=True)
    own = open(os.path.join(csrc, "emit.cu")).read()
    sources = {"parent": [os.path.join(parent, "tpu_deflate_torch", "csrc", f) for f in ("emit.cu", "route.cu")],
               "change": [os.path.join(csrc, "emit.cu")]}
    for name, (edits, _what) in (EMIT_VARIANTS.items() if variants else ()):
        text = own
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: csrc/emit.cu does not hold {old!r} once")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"emit_{name}.cu")
        open(path, "w").write(text)
        sources[name] = [path]
    libs = build_libs(sources, out_dir, csrc)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib_p = libs["parent"][0]
    lib_p.td_route.argtypes = [P] * 19 + [I, I, P]
    lib_p.td_emit_body.argtypes = [P] * 13 + [I, I, P]
    lib_p.td_header_eob.argtypes = [P] * 7 + [I, I, P]
    for name in sources:
        if name != "parent":
            libs[name][0].td_emit.argtypes = [P] * 26 + [I, I, I, P]
    card = cs.gpu_name_power()
    print(f"card: {card}; torch {torch.__version__}")
    for name, (_lib, ptxas) in libs.items():
        print(f"{name}: {EMIT_VARIANTS[name][1] if name in EMIT_VARIANTS else ''} ptxas {ptxas}")
    dev = torch.device("cuda")
    corpus = bench.make_corpus(48)
    batches = {"effort 2": cs.encode_batch(corpus[: 64 * cs.MEMBER], dev)["args"],
               "effort 4": cs.continuous_batch(corpus, dev)["args"]}
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for what, args in batches.items():
        L, S = args[0].shape
        nseg = -(-S // em.EMIT_SEGMENT)
        H = args[15].shape[1]
        plan = [t.clone() if t is not None else None for t in args[7:]]  # the parent's route rewrites these

        def parent_step(args=args, plan=plan, L=L, S=S, nseg=nseg, H=H):
            costs = torch.empty((4, L), dtype=torch.int32, device=dev)
            tensors = plan[:14]
            lib_p.td_route(*(t.data_ptr() for t in tensors), 0 if plan[14] is None else plan[14].data_ptr(),
                           *(c.data_ptr() for c in costs), L, H, stream)
            hdr = plan[9].sum(dim=1).to(torch.int32)  # the parent's body_args: its two eager ops
            words = torch.zeros((L, em.EMIT_WORDS), dtype=torch.int32, device=dev)
            body_end = torch.empty(L, dtype=torch.int32, device=dev)
            scratch = torch.zeros(L * nseg + 1, dtype=torch.int64, device=dev)
            lib_p.td_emit_body(*(t.data_ptr() for t in (*args[:7], plan[6], plan[7], hdr, words, body_end, scratch)),
                               L, S, stream)
            total = torch.empty(L, dtype=torch.int32, device=dev)
            lib_p.td_header_eob(*(t.data_ptr() for t in (plan[8], plan[9], plan[10], plan[11], body_end, words,
                                                         total)), L, H, stream)
            return words, total, costs[0]

        def fused_step(name, routed, args=args, L=L, S=S, nseg=nseg, H=H):
            words = torch.zeros((L, em.EMIT_WORDS), dtype=torch.int32, device=dev)
            total = torch.empty(L, dtype=torch.int32, device=dev)
            costs = torch.empty((4, L), dtype=torch.int32, device=dev)
            scratch = torch.zeros(L * nseg + 1, dtype=torch.int64, device=dev)
            tables = args[13:19] if routed else routed_tables
            route = [args[i].data_ptr() for i in (7, 8, 9, 10, 11, 12, 19, 20)] + [
                0 if args[21] is None else args[21].data_ptr()] if routed else [0] * 9
            libs[name][0].td_emit(*(t.data_ptr() for t in (*args[:7], *tables)), *route, words.data_ptr(),
                                  total.data_ptr(), costs.data_ptr() if routed else 0, scratch.data_ptr(), L, S, H,
                                  stream)
            return words, total, costs[0]

        routed_tables = em.route_plain(*args[7:])[:6]
        want = em.emit_routed_plain(*args)
        calls = {"parent": parent_step, "change": lambda: fused_step("change", True),
                 "change, routing off": lambda: fused_step("change", False)}
        for name in sources:
            if name not in ("parent", "change"):
                calls[name] = lambda name=name: fused_step(name, True)
                calls[f"{name}, routing off"] = lambda name=name: fused_step(name, False)
        for name, fn in calls.items():
            got = fn()
            n = 2 if "routing off" in name else 3
            equal = all(torch.equal(g, w) for g, w in zip(got[:n], want[:n]))
            print(f"{what} {name}: equal to the plain composition {equal}")
            ok &= equal or name.startswith("no_routing")
        order = ["parent", "change", *[k for k in calls if k not in ("parent", "change")], "change", "parent"]
        for name in order:
            fn = calls[name]
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            by: dict = {}
            for e in events:
                short = "fill" if "FillFunctor" in e.name else e.name.replace("(anonymous namespace)::", "")
                by.setdefault(short.split("(")[0].split("<")[0][-40:], []).append(e.time_range.elapsed_us())
            kern = {k: round(statistics.median(v), 2) for k, v in by.items()}
            print(f"{what} [{L} x {S}] {name}: {round(sum(e.time_range.elapsed_us() for e in events) / 20, 2)} "
                  f"device us a call, {len(events) / 20:g} events a call; kernels us a launch (median of 20) "
                  f"{json.dumps(kern)}; queued {queued_us(fn):.2f} us ({card})")
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--tree", metavar="DIR")
    group.add_argument("--ab", nargs=2, metavar=("PARENT", "CHANGE"))
    group.add_argument("--emit", metavar="PARENT")
    ap.add_argument("--variants", action="store_true", help="with --emit: this tree's emit.cu variants too")
    ap.add_argument("--off-only", action="store_true", help="with --tree or --ab: the \"off\" route's part alone")
    args = ap.parse_args(argv)
    if args.emit:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        return emit_one_process(args.emit, args.variants)
    if args.tree:
        print(json.dumps(one_tree(args.tree, args.off_only)))
        return 0
    return ab(*args.ab, off_only=args.off_only)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
