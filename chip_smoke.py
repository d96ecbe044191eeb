#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (tpu_deflate_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which fails the run (non-zero exit) if anything is wrong:

1. environment: torch, CUDA, nvcc and the card; the shared C core must build;
2. build: the CUDA kernels of tpu_deflate_torch/csrc, from source;
3. kernels: every kernel of the decode path against its plain PyTorch
   version on the card, on one real wave (64 members of the synthetic
   corpus at their payload bucket); outputs must be equal (the pipeline is
   integer-only, so the tolerance is exact equality); median times;
4. the slice end to end: ``tpu_deflate_torch.engine.decompress`` of the
   48 MiB corpus, byte-exact, with every kernel launched on that run;
5. interop and errors: a foreign gzip stream, a foreign raw multi-block
   DEFLATE stream through the wave kernels, and a corrupted member raising
   the same Reason as tpu_deflate's host decoder.

The last lines are a JSON record of the kernels, the card's name and
power limit, and the JSON verdict. ``--profile DIR`` adds a torch.profiler
pass (device time per kernel) and a cProfile pass (host time per
function) of the end-to-end decode, written into DIR.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_MB = 48
WAVE_LANES = 64
KERNEL_REPS = 20
PLAIN_REPS = 3
E2E_REPS = 5
REPLACES = {
    "stage_a": "tpu_deflate/codec/decode_pallas.py:110",
    "stage_b": "tpu_deflate/codec/decode_pallas.py:363",
    "stage_dc": "tpu_deflate/codec/decode_pallas.py:413",
    "compact_flat": "tpu_deflate/codec/decode_pallas.py:495",
    "compact_any": "tpu_deflate/codec/decode_pallas.py:605",
}
SOURCES = {
    "stage_a": "tpu_deflate_torch/csrc/stage_a.cu",
    "stage_b": "tpu_deflate_torch/csrc/stage_b.cu",
    "stage_dc": "tpu_deflate_torch/csrc/stage_dc.cu",
    "compact_flat": "tpu_deflate_torch/csrc/compact.cu",
    "compact_any": "tpu_deflate_torch/csrc/compact.cu",
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of fn() in ms, each call between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    require(got.shape == want.shape and got.dtype == want.dtype, "shape/dtype mismatch")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def phase_environment() -> None:
    import torch

    from tpu_deflate_torch import _build, host

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"gpu: {gpu_name_power()}")
    require(torch.cuda.is_available(), "no CUDA device")
    require(host.native.available(), "the shared C core did not build")


def phase_build() -> None:
    from tpu_deflate_torch import _build

    t0 = time.monotonic()
    _build.load()
    log(f"build: {_build.library_path()} in {time.monotonic() - t0:.1f} s")


def huffman_payloads(gz: bytes) -> list[bytes]:
    import numpy as np

    from tpu_deflate_torch import host

    buf = np.frombuffer(gz, np.uint8)
    members = host.split_members(buf)
    require(members is not None, "corpus stream lacks the member index")
    return [
        buf[m.payload_start : m.end - 8].tobytes()
        for m in members
        if (int(buf[m.payload_start]) >> 1) & 3
    ]


def phase_kernels(gz: bytes, device, lanes: int = WAVE_LANES) -> dict:
    """Each kernel against its plain version on one real wave: equality
    and median times. Returns {kernel: record}."""
    import collections

    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import wave_prep as wp

    payloads = huffman_payloads(gz)
    by_bucket = collections.defaultdict(list)
    for p in payloads:
        by_bucket[wp._bucket(len(p), wp.P_BUCKETS_PALLAS)].append(p)
    P, group = max(by_bucket.items(), key=lambda kv: len(kv[1]))
    group = group[:lanes]
    w = wp.wave_to_tensors(wp._prep_wave(group, lanes), device)
    L, _, NTp = w["grid"].shape
    NT = NTp - 1
    k1_wave = wp._lane_k1(w["_min_tok_bits"])
    log(f"wave: {len(group)} members in bucket P={P}: L={L} NT={NT} k1={k1_wave}")
    rec: dict = {}

    def compare(name, kern, plain, shapes):
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, p) for g, p in zip(got, want))
        equal = all(torch.equal(g, p) for g, p in zip(got, want))
        ms = median_ms(kern, KERNEL_REPS)
        plain_ms = median_ms(plain, PLAIN_REPS)
        r = rec.setdefault(name, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if shapes.get("main_path", True):
            r["ms"], r["plain_ms"] = ms, plain_ms
        log(f"{name} {shapes}: equal={equal} max_abs_err={err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        require(equal, f"{name} differs from its plain version at {shapes}")
        return got

    meta = dk.build_meta(w)
    dt, tt = compare(
        "stage_a",
        lambda: dk.stage_a(w["grid"], meta),
        lambda: dk.stage_a_plain(w["grid"], meta),
        {"grid": [L, 64, NTp], "out": [L, 512, NT]},
    )
    (transfers,) = compare(
        "stage_b", lambda: dk.stage_b(dt), lambda: dk.stage_b_plain(dt),
        {"delta": [L, 512, NT], "out": [L, NT, 48]},
    )
    entries, _final = pv2.stage_c_entries(transfers, w["rem"])
    entries = entries.to(torch.int32)
    tokc_main = None
    for k1 in sorted(set(wp.K1_CHOICES) | {wp.W_P}):
        tokc, _summ = compare(
            "stage_dc",
            lambda: dk.stage_dc(dt, tt, entries, k1=k1),
            lambda: dk.stage_dc_plain(dt, tt, entries, k1),
            {"delta": [L, 512, NT], "k1": k1, "main_path": k1 == k1_wave},
        )
        if k1 == k1_wave:
            tokc_main = tokc
    flat = tokc_main.reshape(L, NT * k1_wave)
    (tokens,) = compare(
        "compact_flat",
        lambda: dk.compact_flat(flat, w["lit_planes"]),
        lambda: dk.compact_plain(flat, w["lit_planes"]),
        {"tok": [L, NT * k1_wave]},
    )
    is_lit = (tokens >= 0) & (tokens < 256)
    lit_in = torch.where(is_lit, tokens, -1)
    compare(
        "compact_any",
        lambda: dk.compact_any(lit_in),
        lambda: dk.compact_plain(lit_in, None),
        {"tok": [L, NT * k1_wave]},
    )
    return rec


def phase_end_to_end(corpus: bytes, gz: bytes, n_huff: int) -> tuple[dict, float]:
    import torch

    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2

    dk.reset_launches()
    t0 = time.monotonic()
    out = engine.decompress(gz, engine="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(dk.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == corpus, "end-to-end output differs from the corpus")
    log(f"e2e run 1: {wall:.3f} s, {len(corpus) / wall / 1e9:.4f} GB/s, {len(gz)} compressed bytes")
    log(f"e2e stats: {json.dumps(stats)}")
    log(f"launches in the main-path run: {json.dumps(launches)}")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the main path")
    require(stats["host_resolved"] == n_huff, "host_resolved != Huffman member count")
    walls = []
    for _ in range(E2E_REPS):
        t0 = time.monotonic()
        out = engine.decompress(gz, engine="cuda")
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        require(out == corpus, "end-to-end output differs from the corpus (timed run)")
    med = statistics.median(walls)
    log(f"e2e {E2E_REPS} timed runs: median {med:.4f} s = {len(corpus) / med / 1e9:.4f} GB/s, "
        f"min {min(walls):.4f} s, max {max(walls):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    return launches, med


def phase_profile(gz: bytes, outdir: str, timed_median_s: float) -> None:
    """Device time per kernel (torch.profiler) and host time per function
    (cProfile) of one end-to-end decode each, written into outdir. The
    device's busy share is read off the one profiled decode: the summed
    duration of its device events (kernels and copies, one stream, so
    they do not overlap) over that same decode's wall time; beside it,
    the same busy time over the timed median of the unprofiled decodes."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_deflate_torch import engine

    os.makedirs(outdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.decompress(gz, engine="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(outdir, "profile_device.txt"), "w") as f:
        f.write(table)
    log("profile (device time by op):\n" + "\n".join(table.splitlines()[:22]))
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    log(f"profiled decode: wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle {100 * (1 - busy_us / 1e6 / wall):.2f} % of that wall; "
        f"idle {100 * (1 - busy_us / 1e6 / timed_median_s):.2f} % of the timed median "
        f"{timed_median_s * 1e3:.3f} ms")
    for kernel in ("stage_a_kernel", "stage_b_kernel", "stage_dc_kernel", "compact_kernel"):
        us = [e.time_range.elapsed_us() for e in device_events if kernel in e.name]
        require(bool(us), f"profile shows no {kernel} launch")
        log(f"main-path {kernel}: {len(us)} launches, device {sum(us):.1f} us total, "
            f"per launch min {min(us):.1f} median {statistics.median(us):.1f} max {max(us):.1f} us")
    pr = cProfile.Profile()
    pr.enable()
    engine.decompress(gz, engine="cuda")
    torch.cuda.synchronize()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(40)
    with open(os.path.join(outdir, "profile_host.txt"), "w") as f:
        f.write(s.getvalue())
    log("profile (host cumulative):\n" + "\n".join(s.getvalue().splitlines()[:60]))


def phase_interop(corpus: bytes, gz: bytes, device) -> None:
    import numpy as np

    from tpu_deflate_torch import engine, host
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2

    data = corpus[: 1 << 20]
    foreign = gzip.compress(data, 9)
    require(engine.decompress(foreign, engine="cuda") == data, "foreign gzip stream")
    log(f"foreign gzip (python gzip -9, {len(foreign)} bytes): ok")
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    before = dk.LAUNCHES["stage_a"]
    require(pv2.inflate_raw_v2(raw, device=device) == data, "foreign raw DEFLATE stream")
    log(f"foreign raw DEFLATE (zlib -9, {len(raw)} bytes) through the wave kernels: ok, "
        f"{dk.LAUNCHES['stage_a'] - before} stage-A launches")

    buf = np.frombuffer(gz, np.uint8)
    m = next(m for m in host.split_members(buf) if (int(buf[m.payload_start]) >> 1) & 3)
    bad = bytearray(gz[m.start : m.end])
    bad[m.payload_start - m.start + 100] ^= 0x5A
    reasons = []
    for decode in (host.host_gzip_decompress, lambda b: engine.decompress(b, engine="cuda")):
        try:
            decode(bytes(bad))
            reasons.append(None)
        except host.DataFormatError as e:
            reasons.append(e.reason)
    log(f"corrupted member: host decoder {reasons[0]}, port {reasons[1]}")
    require(reasons[1] is not None and reasons[0] == reasons[1], "corruption Reason differs")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="write device and host profiles into DIR")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "tpu_deflate_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke run needs one GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    phase_environment()
    phase_build()

    import bench
    from tpu_deflate_torch import host

    t0 = time.monotonic()
    corpus = bench.make_corpus(CORPUS_MB)
    gz = host.native.compress_members_native(corpus)
    n_huff = len(huffman_payloads(gz))
    log(f"corpus: {len(corpus)} bytes -> {len(gz)} gzip bytes, {n_huff} Huffman members "
        f"({time.monotonic() - t0:.1f} s)")

    rec = phase_kernels(gz, device)
    launches, timed_median_s = phase_end_to_end(corpus, gz, n_huff)
    if args.profile:
        phase_profile(gz, args.profile, timed_median_s)
    phase_interop(corpus, gz, device)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": rec[name]["max_abs_err"],
            "ms": rec[name]["ms"],
            "plain_ms": rec[name]["plain_ms"],
        }
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
