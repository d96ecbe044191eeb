#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (tpu_deflate_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which fails the run (non-zero exit) if anything is wrong:

1. environment: torch, CUDA, nvcc and the card; the shared C core builds;
2. build: every CUDA kernel of tpu_deflate_torch/csrc, from source (one
   nvcc per source, in parallel);
3. kernels: every kernel against its plain PyTorch version on the card,
   at the main path's shapes: the wave kernels (K1 with its table kernel,
   K2-K4, K7) on one real wave (64 members of the synthetic corpus at
   their payload bucket; the share of its positions that K1 decodes
   through the ladders is printed), K1 and its tables again on waves with
   11-15-bit codes, fixed Huffman codes, a single distance code, an empty
   distance code, a garbage lane and payloads ending inside the last tile,
   K2 again on edge deltas (one lane, one tile, a tile count that is not a
   multiple of its 32-tile strip, all 1, all 48, dense EOB / error
   sentinels, deltas of 0 and 60, hops of 64 and 200, the int32 limits),
   K3 again at every k1 on the main path's own 4-lane waves, on edge
   deltas (0, -5, 60, the int32 limits, dense sentinels; entries 0, 47, 48
   and 255) and on tiles of 512 one-bit deltas, K4 and K7 again on the
   main path's own 4-lane waves (K3's tokens at k1 104 and 512) and on
   edge lanes (every entry valid, none, only the last, only the last 300,
   literal ranks 0 and 255 under random planes, match tokens of 256; M of
   128, 1001, 4099, 5120 and 8228 at 7 and 672 lanes, and a row that is not
   16-byte aligned), the resolve kernels (K5
   expand, K6 sweep) and the lane CRC on the main path's two resolve
   batches (256 and 178 members x 65536 slots) built from the corpus's own
   tokens, the lane CRC also on the encoder's first batch (64 x 64 KiB,
   finished CRCs against zlib) and on random rows of 512 and 524288 bytes,
   crc32_device and adler32_device against zlib at four sizes,
   K5/K6 on lanes at the resolve's edges (errors, an empty lane, regions
   past 32 KiB, output past 64 KiB, random far matches, only 258-runs,
   only literals), K6 on sources written directly (32768 back at every
   step's edges, chains across steps, distance-1 chains, random sources up
   to 32768 back) with a zero and a random tail, and K5/K6 once more with
   32 KiB of history on the tiles
   of a 1 MiB multi-block stream. Outputs must be equal (the pipeline is integer-only, so the tolerance is exact equality; the sweep's round
   count, a diagnostic, is not compared); median times beside each
   kernel's bound;
4. the main path: ``engine.decompress`` of the 48 MiB corpus with the
   defaults (device resolve), byte-exact, every Huffman member resolved on
   the device and every main-path kernel launched, with each kernel's
   bound per launch and summed over the run (with --profile, each K3, K4,
   K6 and lane CRC launch's device time beside its bound); 5 timed runs;
5. the host-resolve route (``device_resolve="off"``) on an 8 MiB corpus,
   byte-exact with the packed token pull (K7) launched (with --profile,
   each K4 and K7 launch's device time beside its bound), and 3 timed runs
   of it on the 48 MiB corpus for comparison;
6. the ``device_resolve="on"`` route: a gzip -9 stream of 1 MiB in one
   member with the member index (multi-block, > 64 KiB), resolved on the
   device in chained tiles; then the big members (the counterpart of the
   reference's ``kernel_only_bench_big``): 16 zlib -9 members of 1 MiB and
   a single-block member of 256 KiB through ``engine.decompress`` with the
   defaults, byte-exact, every member on the device route (tokens kept on
   the card, tile split, chained K5/K6 and lane CRC) with every kernel of
   the route launched and K7 not, each kernel's bound per launch, and each
   kernel against its plain version on the arguments the route gave it
   (its block waves, a first and a chained step of each tile group, the
   CRC at each group's rows); its device memory peak; the split on the
   card equal to ``split_tokens_tiles`` and each chained CRC equal to zlib
   on the same tokens, with the split's memory a token; under a 512 KiB
   batch bound and passes of 8 tiles every member on the device route, the
   1 MiB members in 2 passes each and K7 not launched, on the card and over
   a 4-shard mesh of it, byte-exact with the same stats; 3 timed runs
   against 3 of the "off" route (with
   --profile, the route's device time by kernel beside each launch's
   bound, the split's, and its idle share);
7. interop and errors: a foreign gzip stream without the member index,
   a foreign raw multi-block DEFLATE stream through the wave kernels, and a
   corrupted member raising the same Reason on the "auto" and "off" routes;
8. encode kernels: K8 parse transfers, K9 parse replay and K10 emit body
   against their plain versions (exact equality) on the first batch of
   the encode's main path (64 members x 64 KiB of the corpus), then on
   step fields of all 1, all 250, random 1..250 and one with steps <= 0
   and at the int32 limits (K9 there with entries of -1, 0, 255, 511 and
   512 in the first tiles), a batch with a lane routed FIXED, a
   lane of 15-bit literal codes whose bits overflow the word grid, lanes
   whose segments carry no bits, a width that is not a multiple of K10's
   segment, and slots of more than 31 bits; every lane of the first batch
   has a segment that starts inside a word;
9. the encode's main path: ``engine.compress`` of the 48 MiB corpus at the
   default effort 2, byte-exact through ``gzip.decompress`` and the port's
   ``engine.decompress``, 768 members, every encode kernel and the lane
   CRC launched, its size beside the C core's member encoder, each
   kernel's bound per launch and summed over the run; 3 timed runs;
10. the card against the CPU: five members (text, random, runs, zeros, a
   short tail) encoded on the card and with the plain versions on the CPU
   at efforts 1, 2, 3 and 5 must be byte-identical;
11. continuous-encode kernels: K8, K9 and K10 against their plain
   versions on the first batch of the continuous encode (64 lanes x 98304
   columns: a 32 KiB halo before each 64 KiB block) and on a batch whose
   head lane starts with 50 zero bytes (the reference's F1);
12. the continuous encode's main path: ``engine.compress`` of the 48 MiB
   corpus at effort 4, one member of 768 blocks, byte-exact through
   ``gzip.decompress`` and the port's decode on the card (one member on the
   device route, K7 not launched), K8-K10 and the lane CRC launched (the
   CRC against its plain version on the rows the path gave it), each
   kernel's bound per launch and summed, the device memory peak, the ratio
   beside effort 2's and zlib -9's, timed runs of the encode and one timed
   decode with its waves;
13. the continuous encode on the card against the CPU, byte-identical: 256
   KiB at efforts 4 and 5, 50 zero bytes before text (F1) and 300,000
   7-bit random bytes in blocks of 128 KiB (F2);
14. the mesh (``phase_mesh``): 4 shards of the card. The mesh path is
   ``engine.decompress(corpus's members, mesh=)`` (byte-exact, every
   Huffman member resolved on the device) then ``engine.compress(corpus,
   effort=4, mesh=)`` (byte-identical to phase 12's member), every kernel
   but K7 launched, and each kernel call of that run (captured: the first
   two of each shard shape) held against its plain version, exact
   equality; the decode again over ``make_codec_mesh()``;
   ``sharded_resolve`` on phase 3's first resolve batch and
   ``sharded_analyze_emit`` on phase 8's first encode batch, equal to
   their unsharded outputs; ``sharded_continuous_compress`` of 8 MiB
   through gzip; ``init_distributed`` with one NCCL rank and the four
   collectives over a pod mesh whose host axis is that rank, equal to the
   in-process mesh's; ``dist.dryrun.dryrun_multichip(4)``. Each result's
   wall time is printed beside the card's name and power limit;
15. passes (``phase_passes``): ``engine.compress(bench.make_corpus(96),
   effort=4)`` writes one member of 96 MiB, above the device route's batch
   bound of 64 MiB; ``engine.decompress`` with the defaults, byte-exact,
   resolves it on the device route in 2 passes (device_resolved 1,
   host_resolved 0, K7 not launched, every other kernel of the route
   launched), each wrapper's bytes bound per launch, and every kernel of
   the run (K1 tables, K1-K4 on its one-lane block waves, K5, K6 and the
   lane CRC on its tile steps; the first calls of each shape) held against
   its plain version on the arguments the run gave it; its device memory
   peak beside the member's token bytes; K5,
   K6 and the lane CRC on pass 1's first tile step, with the tail carried
   from pass 0, against their plain versions; pass 1's tile split against
   rows 1024 onward of ``split_tokens_tiles`` of the whole lane; the CRC
   fold's host time; one "auto" and one "off" decode timed, beside the
   card's name and power limit;
16. the kernel-only rows (``phase_kernel_rows``, ``codec.kernel_bench``)
   on phase 4's 48 MiB corpus: ``kernel_only_bench`` (waves staged, K1-K4
   timed), ``kernel_only_bench_full`` (and K5, K6 and the lane CRC on every
   member, stored ones as CRC lanes; every member verified against its
   trailer), ``kernel_only_bench_big`` (16 members of 192 KiB, one dynamic
   block each, split and resolved in chained tiles on the card; every
   member against its input), ``encode_kernel_bench`` (one staged batch of
   64 x 64 KiB) and ``link_probe``. The path's run (each row once at
   reps=1): each row on the kernels ("cuda") with 0 mismatches, every
   kernel but K7 launched over the rows and K7 not, each wrapper's bytes
   bound per launch, and every kernel of the run (K1 tables, K1-K4 on the
   rows' waves, K5, K6 and the lane CRC on the full row's resolve batches
   and the big row's chained steps, K8-K10 on the encode batch; the first
   two calls of each lane count) held against its plain version on the
   arguments the rows gave it. Then the timed run: each row printed with
   one pass's CUDA-event and host enqueue times, its device memory peak
   beside the end-to-end decode's, and each decode row's GB/s over phase
   4's median, beside the card's name and power limit.

The build phase prints each kernel's registers and shared memory (ptxas)
and the resident blocks per SM of K4/K7's and K6's kernels. The last lines
are a JSON record of the kernels, the card's name and power limit, and the
JSON verdict. ``--profile DIR`` adds a torch.profiler
pass (device time per kernel) and a cProfile pass (host time per
function) of the decode's, the encode's and the continuous encode's main
paths, of the big members' route, of the decode of the continuous
encode's member and of the 96 MiB member's decode in passes, written into
DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
OFF_CORPUS_MB = 8
WAVE_LANES = 64
FOREIGN_BYTES = 1 << 20
KERNEL_REPS = 20
PLAIN_REPS = 3
E2E_REPS = 5
OFF_REPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
CSRC = "tpu_deflate_torch/csrc/"
# kernel -> (its source, the TPU kernel it replaces, the path that launches it)
KERNELS = {
    "stage_a_tables": ("stage_a.cu", "tpu_deflate/codec/decode_pallas.py:110", "main"),
    "stage_a": ("stage_a.cu", "tpu_deflate/codec/decode_pallas.py:110", "main"),
    "stage_b": ("stage_b.cu", "tpu_deflate/codec/decode_pallas.py:363", "main"),
    "stage_dc": ("stage_dc.cu", "tpu_deflate/codec/decode_pallas.py:413", "main"),
    "compact_flat": ("compact.cu", "tpu_deflate/codec/decode_pallas.py:495", "main"),
    "compact_any": ("compact.cu", "tpu_deflate/codec/decode_pallas.py:605", "off"),
    "expand": ("expand.cu", "tpu_deflate/codec/resolve_pallas.py:150", "main"),
    "sweep": ("sweep.cu", "tpu_deflate/codec/resolve_pallas.py:353", "main"),
    "crc32_lanes": ("crc32_lanes.cu", "tpu_deflate/kernels/checksum_jax.py:190", "main"),
    "parse_transfers": ("parse.cu", "tpu_deflate/codec/parse_pallas.py:66", "encode"),
    "parse_replay": ("parse.cu", "tpu_deflate/codec/parse_pallas.py:82", "encode"),
    "emit_body": ("emit.cu", "tpu_deflate/codec/emit_pallas.py:67", "encode"),
}
PROFILE_KERNELS = (
    "stage_a_tables_kernel", "stage_a_kernel", "stage_b_kernel", "stage_dc_kernel", "compact_kernel", "expand_kernel",
    "sweep_kernel", "crc32_lanes_kernel",
)
ENCODE_PROFILE_KERNELS = (
    "parse_transfers_kernel", "parse_replay_kernel", "emit_kernel", "crc32_lanes_kernel",
)
ENCODE_REPS = 3
ENCODE_EFFORTS = (1, 2, 3, 5)
MEMBER = 64 * 1024
EDGE_P = 8192  # payload bytes per lane of K1's edge waves


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


def bound(inputs, outputs) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, in ms: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations (one integer operation per
    output element, the least any of these kernels can do) over the CUDA
    cores' rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    ops = sum(t.numel() for t in outputs)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tensor_bytes(x) -> int:
    """Bytes of the tensors in x (a tensor, or a tuple or list of them)."""
    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(t) for t in x)
    return 0


@contextlib.contextmanager
def recorded(*names):
    """Wrap each (module, function name) for the block; yields {name: [the
    bytes each call moves: its tensor arguments read once, its tensor
    results written once]}, {name: [each call's first argument's shape
    and keyword arguments]}, in call order, and the names of all calls in
    call order."""
    calls = {name: [] for _module, name in names}
    shapes = {name: [] for _module, name in names}
    order = []
    saved = [(module, name, getattr(module, name)) for module, name in names]

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append(tensor_bytes(args) + tensor_bytes(out))
            shapes[name].append(f"{list(args[0].shape)}{''.join(f' {k}={v}' for k, v in kwargs.items())}")
            order.append(name)
            return out
        return wrapper

    for module, name, fn in saved:
        setattr(module, name, wrap(name, fn))
    try:
        yield calls, shapes, order
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def captured(*names, per_key: int = 2):
    """Wrap each (module, function name) for the block; yields {name:
    [(args, kwargs)]}: copies of the arguments of the first ``per_key``
    calls for each lane count (the first argument's first dimension) and
    keyword arguments, for replaying them against the plain versions."""
    caps = {name: [] for _module, name in names}
    seen: dict = {}
    saved = [(module, name, getattr(module, name)) for module, name in names]

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            key = (name, args[0].shape[0], tuple(sorted(kwargs.items())))
            if seen.get(key, 0) < per_key:
                seen[key] = seen.get(key, 0) + 1
                caps[name].append((tuple(a.clone() if hasattr(a, "clone") else a for a in args), dict(kwargs)))
            return fn(*args, **kwargs)
        return wrapper

    for module, name, fn in saved:
        setattr(module, name, wrap(name, fn))
    try:
        yield caps
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


# wrapper -> its kernel's name in a profile, for the per-launch bounds
PROFILE_NAMES = {
    "stage_dc": "stage_dc_kernel", "compact_flat": "compact_kernel", "compact_any": "compact_kernel",
    "sweep": "sweep_kernel", "crc32_lanes_raw8": "crc32_lanes_kernel",
}


def launch_bounds(calls: dict, shapes: dict, order: list) -> dict:
    """{profile kernel name: [(bytes bound in us, the wrapper and the call's
    shapes)] per launch, in call order} of the wrappers in PROFILE_NAMES."""
    out: dict = {}
    seen = {name: 0 for name in calls}
    for name in order:
        i = seen[name]
        seen[name] += 1
        if name in PROFILE_NAMES:
            out.setdefault(PROFILE_NAMES[name], []).append(
                (calls[name][i] / HBM_BYTES_PER_S * 1e6, f"{name} {shapes[name][i]}"))
    return out


def path_bounds(label: str, calls: dict) -> None:
    """Print each wrapper's bytes bound per launch (their min, median and
    max past 24 launches) and summed over one run of a path (us at the
    card's memory rate)."""
    for name, nbytes in calls.items():
        us = [b / HBM_BYTES_PER_S * 1e6 for b in nbytes]
        each = ([round(u, 2) for u in us] if len(us) <= 24 else
                f"min {min(us):.2f} median {statistics.median(us):.2f} max {max(us):.2f}")
        log(f"{label} bound of {name}: {len(us)} launches, {sum(nbytes)} bytes, "
            f"per launch {each} us, summed {sum(us):.2f} us (bytes)")


class Kernels:
    """Each kernel against its plain version: equality and times, kept
    per kernel at the main path's shapes."""

    def __init__(self):
        self.rec: dict = {}

    def compare(self, name, kern, plain, inputs, shapes, *, main_path=True, proj=None):
        import torch

        def parts(out):
            out = out if isinstance(out, tuple) else (out,)
            return proj(out) if proj else out

        got_full = kern()
        got, want = parts(got_full), parts(plain())
        err = max(max_abs_err(g, p) for g, p in zip(got, want))
        equal = all(torch.equal(g, p) for g, p in zip(got, want))
        ms = median_ms(kern, KERNEL_REPS)
        plain_ms = median_ms(plain, PLAIN_REPS)
        r = self.rec.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        outs = got_full if isinstance(got_full, tuple) else (got_full,)
        bms, by = bound(inputs, outs)
        if main_path:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, shapes=shapes)
        log(f"{name} {shapes}: equal={equal} max_abs_err={err} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f} % of it)")
        require(equal, f"{name} differs from its plain version at {shapes}")
        return outs


def phase_environment() -> None:
    import torch

    from tpu_deflate_torch import _build, native

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"gpu: {gpu_name_power()}")
    require(torch.cuda.is_available(), "no CUDA device")
    native.load()  # raises with the compiler's output if the C core does not build


def phase_build() -> None:
    from tpu_deflate_torch import _build

    t0 = time.monotonic()
    lib = _build.load()
    log(f"build: {_build.library_path()} in {time.monotonic() - t0:.1f} s")
    for entry, variants in (("td_compact_occupancy", ("compact_kernel<4, map>", "compact_kernel<4, no map>",
                                                      "compact_kernel<16, map>", "compact_kernel<16, no map>")),
                            ("td_sweep_occupancy", ("sweep_kernel",))):
        fn = getattr(lib, entry, None)
        if fn is None:
            log(f"occupancy: {entry} is not in this build")
            continue
        blocks = (ctypes.c_int * len(variants))()
        require(fn(blocks) == 0, f"{entry} failed")
        log("occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
            + ", ".join(f"{v} {b} blocks per SM" for v, b in zip(variants, blocks)))
    log_path = _build.library_path()[:-3] + ".log"
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log("ptxas: " + line.strip())


def huffman_members(gz: bytes):
    """(member index, payload bytes) of every Huffman member, in order."""
    import numpy as np

    from tpu_deflate_torch.codec import decode_np

    buf = np.frombuffer(gz, np.uint8)
    members = decode_np.split_members(buf)
    require(members is not None, "corpus stream lacks the member index")
    return [
        (m, buf[m.payload_start : m.end - 8].tobytes())
        for m in members
        if (int(buf[m.payload_start]) >> 1) & 3
    ]


def phase_wave_kernels(gz: bytes, device, K: Kernels) -> None:
    """K1-K4 and K7 on one real wave."""
    import collections

    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import wave_prep as wp

    by_bucket = collections.defaultdict(list)
    for _m, p in huffman_members(gz):
        by_bucket[wp._bucket(len(p), wp.P_BUCKETS_PALLAS)].append(p)
    P, group = max(by_bucket.items(), key=lambda kv: len(kv[1]))
    group = group[:WAVE_LANES]
    w = wp.wave_to_tensors(wp._prep_wave(group, WAVE_LANES), device)
    L, _, NTp = w["grid"].shape
    NT = NTp - 1
    k1_wave = wp._lane_k1(w["_min_tok_bits"])
    log(f"wave: {len(group)} members in bucket P={P}: L={L} NT={NT} k1={k1_wave}")

    meta = dk.build_meta(w)
    (tables,) = K.compare(
        "stage_a_tables", lambda: dk.stage_a_tables(meta), lambda: dk.stage_a_tables_plain(meta),
        [meta], {"meta": [L, dk.META_W], "out": [L, dk.TAB_W]},
    )
    dt, tt = K.compare(
        "stage_a", lambda: dk.stage_a(w["grid"], meta), lambda: dk.stage_a_plain(w["grid"], meta),
        [w["grid"], meta], {"grid": [L, 64, NTp], "out": [L, 512, NT]},
    )
    n_long, n_pos = long_route(w["grid"], tables)
    log(f"stage_a long route on the corpus wave: {n_long} of {n_pos} positions "
        f"({100 * n_long / n_pos:.4f} %)")
    (transfers,) = K.compare(
        "stage_b", lambda: dk.stage_b(dt), lambda: dk.stage_b_plain(dt), [dt],
        {"delta": [L, 512, NT], "out": [L, NT, 48]},
    )
    entries, _final = pv2.stage_c_entries(transfers, w["rem"])
    entries = entries.to(torch.int32)
    tokc_main = None
    for k1 in sorted(set(wp.K1_CHOICES) | {wp.W_P}):
        tokc, _summ = K.compare(
            "stage_dc",
            lambda: dk.stage_dc(dt, tt, entries, k1=k1),
            lambda: dk.stage_dc_plain(dt, tt, entries, k1),
            [dt, tt, entries],
            {"delta": [L, 512, NT], "k1": k1},
            main_path=k1 == k1_wave,
        )
        if k1 == k1_wave:
            tokc_main = tokc
    flat = tokc_main.reshape(L, NT * k1_wave)
    (tokens,) = K.compare(
        "compact_flat",
        lambda: dk.compact_flat(flat, w["lit_planes"]),
        lambda: dk.compact_plain(flat, w["lit_planes"]),
        [flat, w["lit_planes"]],
        {"tok": [L, NT * k1_wave]},
    )
    is_lit = (tokens >= 0) & (tokens < 256)
    lit_in = torch.where(is_lit, tokens, -1)
    K.compare(
        "compact_any", lambda: dk.compact_any(lit_in), lambda: dk.compact_plain(lit_in, None),
        [lit_in], {"tok": [L, NT * k1_wave]},
    )


def long_route(grid, tables) -> tuple[int, int]:
    """(positions that K1 decodes through the ladders, all positions) of a
    wave: a long litlen entry, or a match whose distance entry is long, read
    from the tables as the kernel reads them (indexed by stream bits)."""
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk

    vR, vR2 = dk.stage_a_windows(grid)

    def rev32(x):
        return sum(dk._rev8((x >> (8 * k)) & 255) << (24 - 8 * k) for k in range(4))

    nat = rev32(vR) | ((rev32(vR2) & 0xFFFF) << 32)  # stream bits pos..pos+47
    L = vR.shape[0]
    tab = tables.to(torch.int64)
    le = tab[:, : dk.TAB_N].gather(1, (nat & (dk.TAB_N - 1)).view(L, -1)).view_as(nat)
    match = ((le >> 4) & 7) == dk.K_MATCH
    d1 = (le & 15) + torch.where(match, (le >> 16) & 7, 0)
    de = tab[:, dk.TAB_N :].gather(1, ((nat >> d1) & (dk.TAB_N - 1)).view(L, -1)).view_as(nat)
    is_long = ((le & dk.E_LONG) != 0) | (match & ((de & dk.E_LONG) != 0))
    return int(is_long.sum()), is_long.numel()


def skewed_lengths(rng, L: int, n_sym: int, width: int, ratio: float):
    """(L, width) complete code lengths with many 11-15-bit codes:
    geometric frequencies over a random symbol order, limited to 15 bits."""
    import numpy as np

    from tpu_deflate_torch.kernels.huffman import huffman_lengths_batch

    freqs = (1e12 * ratio ** np.stack([rng.permutation(n_sym) for _ in range(L)])).astype(np.int64) + 1
    out = np.zeros((L, width), np.int32)
    out[:, :n_sym] = huffman_lengths_batch(freqs, 15)
    return out


def lengths_wave(ll, d, dist_empty, rng, row_bits=None) -> dict:
    """A wave of random payload bytes under the given code lengths (L, 288)
    and (L, 32), built as wave_prep builds it from a header parse."""
    import numpy as np

    from tpu_deflate_torch.codec import decode_np
    from tpu_deflate_torch.codec import wave_prep as wp

    L = ll.shape[0]
    rows = rng.integers(0, 256, (L, EDGE_P), dtype=np.uint8)
    bits = np.full(L, 8 * EDGE_P, np.int64) if row_bits is None else np.asarray(row_bits, np.int64)
    hp = decode_np.HeaderParse(ll.astype(np.int32), d.astype(np.int32), np.asarray(dist_empty, bool),
                               np.zeros(L, np.int64), np.full(L, 2, np.int32), np.ones(L, bool))
    return wp._wave_arrays(rows, bits, hp)[0]


def k1_edge_waves(gz: bytes) -> dict:
    """K1's edge waves (NumPy wave dicts): (a) litlen and distance trees
    with 11-15-bit codes; (b) fixed Huffman, with the reserved litlen
    286/287 and distance 30/31 codes; (c) a single distance code (with the
    header parse's completion at symbol 31) and an empty distance code; (d)
    corpus members and a garbage lane, random bytes behind a valid header;
    (e) payloads that end inside the last tile and the one before it."""
    import numpy as np

    from tpu_deflate_torch.codec import wave_prep as wp
    from tpu_deflate_torch.format.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS

    rng = np.random.default_rng(23)
    ll_one = skewed_lengths(rng, 2, 286, 288, 0.97)
    d_one = np.zeros((2, 32), np.int32)
    d_one[0, 7] = d_one[0, 31] = 1
    payloads = [p for _m, p in huffman_members(gz)[:3]]
    payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    return {
        "long codes": lengths_wave(skewed_lengths(rng, 4, 286, 288, 0.93),
                                   skewed_lengths(rng, 4, 30, 32, 0.55), [False] * 4, rng),
        "fixed Huffman": lengths_wave(np.tile(FIXED_LITLEN_LENGTHS, (2, 1)),
                                      np.tile(FIXED_DIST_LENGTHS, (2, 1)), [False] * 2, rng),
        "one distance code, empty distance code": lengths_wave(ll_one, d_one, [False, True], rng),
        "garbage lane": wp._prep_wave(payloads, 4),
        "ends inside the last tiles": lengths_wave(
            skewed_lengths(rng, 2, 286, 288, 0.9), skewed_lengths(rng, 2, 30, 32, 0.7), [False] * 2,
            rng, row_bits=[8 * EDGE_P - 37, 8 * EDGE_P - 512 - 300]),
    }


def phase_k1_edges(gz: bytes, device, K: Kernels) -> None:
    """K1 and its table kernel against their plain versions on the edge
    waves."""
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import wave_prep as wp

    for what, wave in k1_edge_waves(gz).items():
        w = wp.wave_to_tensors(wave, device)
        meta = dk.build_meta(w)
        L, _, NTp = w["grid"].shape
        (tables,) = K.compare(
            "stage_a_tables", lambda: dk.stage_a_tables(meta), lambda: dk.stage_a_tables_plain(meta),
            [meta], {"edge": what, "meta": [L, dk.META_W]}, main_path=False,
        )
        K.compare(
            "stage_a", lambda: dk.stage_a(w["grid"], meta), lambda: dk.stage_a_plain(w["grid"], meta),
            [w["grid"], meta], {"edge": what, "grid": [L, 64, NTp]}, main_path=False,
        )
        n_long, n_pos = long_route(w["grid"], tables)
        log(f"stage_a edge '{what}': long route {n_long} of {n_pos} positions")


def k2_edge_deltas() -> dict:
    """K2's edge inputs, (L, 512, NT) int32 deltas from a seed: one lane of
    one tile; 45 tiles (a partial 32-tile strip); 3 tiles; all 1 (the
    longest chains); all 48; dense EOB / error sentinels; deltas of 0 (a
    cursor that stops) and 60; hops of 64 and 200, which the kernel walks;
    deltas at the int32 limits."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(29)

    def rnd(shape):
        return torch.randint(1, 49, shape, generator=g, dtype=torch.int32)

    def mixed(shape, shares):
        d, u, lo = rnd(shape), torch.rand(shape, generator=g), 0.0
        for share, value in shares:
            d[(u >= lo) & (u < lo + share)] = value
            lo += share
        return d

    return {
        "one lane, one tile": rnd((1, 512, 1)),
        "45 tiles": rnd((2, 512, 45)),
        "3 tiles": rnd((3, 512, 3)),
        "all 1": torch.ones((2, 512, 64), dtype=torch.int32),
        "all 48": torch.full((2, 512, 64), 48, dtype=torch.int32),
        "dense sentinels": mixed((2, 512, 96), [(0.1, 127), (0.1, 255)]),
        "deltas 0 and 60": mixed((2, 512, 64), [(0.05, 0), (0.05, 60)]),
        "hops of 64 and 200": mixed((2, 512, 64), [(0.02, 64), (0.02, 200)]),
        "int32 limits": mixed((2, 512, 64), [(0.02, 2**31 - 1), (0.02, -(2**31)), (0.02, 9000)]),
    }


def phase_k2_edges(device, K: Kernels) -> None:
    """K2 against its plain version on the edge deltas."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    for what, d in k2_edge_deltas().items():
        d = d.to(device)
        K.compare("stage_b", lambda: dk.stage_b(d), lambda: dk.stage_b_plain(d), [d],
                  {"edge": what, "delta": list(d.shape)}, main_path=False)


def k3_edge_inputs():
    """K3's edge inputs from a seed: (L, 512, NT) int32 deltas of 0 and -5
    (a cursor that stops after its position), 60, 2^31 - 1 and INT_MIN (a
    hop that leaves the tile; a signed sum would overflow), dense EOB /
    error sentinels among deltas of 1..48; random tokens; entries with 0,
    47, 48 (a dead tile) and 255 in the first tiles."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(37)
    L, NT = 2, 64
    delta = torch.randint(1, 49, (L, 512, NT), generator=g, dtype=torch.int32)
    u = torch.rand((L, 512, NT), generator=g)
    for lo, hi, value in ((0.00, 0.03, 0), (0.03, 0.06, -5), (0.06, 0.08, 60), (0.08, 0.10, 2**31 - 1),
                          (0.10, 0.12, -(2**31)), (0.12, 0.20, 127), (0.20, 0.26, 255)):
        delta[(u >= lo) & (u < hi)] = value
    token = torch.randint(0, 1 << 27, (L, 512, NT), generator=g, dtype=torch.int32)
    entries = torch.randint(0, 48, (L, NT), generator=g, dtype=torch.int32)
    entries[:, :4] = torch.tensor([0, 47, 48, 255], dtype=torch.int32)
    return delta, token, entries


def k3_chain_inputs():
    """4 lanes x 128 tiles whose 512 positions are all 1-bit deltas, entered
    at 0: every tile's chain has 512 links."""
    import torch

    delta = torch.ones((4, 512, 128), dtype=torch.int32)
    token = (torch.arange(512, dtype=torch.int32) % 256).view(1, 512, 1).expand(4, 512, 128).contiguous()
    return delta, token, torch.zeros((4, 128), dtype=torch.int32)


def main_path_small_waves(gz: bytes, device) -> list:
    """The main path's waves of at most 4 lanes, taken from a run of its
    wave grouping: (what, K3's inputs delta, token and entries, the wave's
    literal planes) each."""
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2

    small, pending = [], []
    stage_dc, compact_flat = dk.stage_dc, dk.compact_flat

    def capture_dc(d, t, e, *, k1):
        if d.shape[0] <= 4:
            pending.append((f"main-path wave L={d.shape[0]} NT={d.shape[2]} k1={k1}", d.clone(), t.clone(),
                            e.clone()))
        return stage_dc(d, t, e, k1=k1)

    def capture_flat(tok, planes):
        if tok.shape[0] <= 4:  # the wave's stage_dc came just before
            small.append((*pending.pop(), planes.clone()))
        return compact_flat(tok, planes)

    dk.stage_dc, dk.compact_flat = capture_dc, capture_flat
    try:
        pv2.single_block_tokens([p for _m, p in huffman_members(gz)], device)
    finally:
        dk.stage_dc, dk.compact_flat = stage_dc, compact_flat
    require(bool(small) and not pending, "the main path has no wave of at most 4 lanes")
    return small


def phase_k3_edges(small: list, device, K: Kernels) -> None:
    """K3 against its plain version at every k1: on the main path's own
    waves of at most 4 lanes, on the edge deltas and on 512-link chains."""
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import wave_prep as wp

    cases = [w[:4] for w in small] + [
        ("int32 limits, stops, sentinels", *(x.to(device) for x in k3_edge_inputs())),
        ("512 one-bit deltas", *(x.to(device) for x in k3_chain_inputs()))]
    for what, d, tk, e in cases:
        for k1 in sorted(set(wp.K1_CHOICES) | {wp.W_P}):
            K.compare("stage_dc", lambda: dk.stage_dc(d, tk, e, k1=k1), lambda: dk.stage_dc_plain(d, tk, e, k1),
                      [d, tk, e], {"edge": what, "delta": list(d.shape), "k1": k1}, main_path=False)


def compact_edge_lanes(M: int, reps: int, seed: int):
    """(reps * 7, M) int32 entries and (reps * 7, 64) int32 random literal
    planes, the lanes cycling through K4's and K7's edges: every entry
    valid; none; only the last; only the last 300 (the last segment);
    density 0.3; literal ranks 0 and 255 and tokens of 256; density 0.97.
    Valid entries are literal ranks (0 and 255 among them) and match tokens
    (>= 256, passed through unmapped), invalid ones -1, -2 and INT_MIN."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L = 7 * reps
    valid = np.where(rng.random((L, M)) < 0.5, rng.integers(0, 256, (L, M)),
                     rng.integers(256, 1 << 27, (L, M)))
    valid[:, : min(2, M)] = [0, 255][: min(2, M)]
    invalid = rng.choice(np.array([-1, -1, -1, -2, -(2**31)]), (L, M))
    keep = np.zeros((L, M), bool)
    kind = np.arange(L) % 7
    keep[kind == 0] = True
    keep[kind == 2, M - 1] = True
    keep[kind == 3, max(0, M - 300):] = True
    keep[kind == 4] = rng.random((int((kind == 4).sum()), M)) < 0.3
    keep[kind == 6] = rng.random((int((kind == 6).sum()), M)) < 0.97
    r5 = kind == 5
    valid[r5] = np.where(np.arange(M) % 3 == 0, 0, np.where(np.arange(M) % 3 == 1, 255, 256))
    keep[r5] = np.arange(M) % 4 != 3
    tok = np.where(keep, valid, invalid).astype(np.int32)
    planes = rng.integers(-(2**31), 2**31, (L, 64), dtype=np.int64).astype(np.int32)
    return tok, planes


def phase_compact_edges(small: list, device, K: Kernels) -> None:
    """K4 and K7 against their plain version on the main path's own waves of
    at most 4 lanes (K3's tokens at k1 104 and 512, the wave's planes), and
    on the edge lanes of compact_edge_lanes at M = 128, 1001, 4099, 5120 and
    8228 (M not a multiple of 4 takes scalar loads; 7 lanes take 1024-entry
    segments, 672 lanes 4096-entry ones) and once from a row that is not
    16-byte aligned."""
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import wave_prep as wp

    cases = []
    for what, d, tk, e, planes in small:
        L, _, NT = d.shape
        for k1 in (104, wp.W_P):
            tokc, _summ = dk.stage_dc(d, tk, e, k1=k1)
            cases.append((f"{what.rsplit(' k1=', 1)[0]} tokens at k1={k1}", tokc.reshape(L, NT * k1), planes))
    for M in (128, 1001, 4099, 5120, 8228):
        for reps in (1, 96):
            tok, planes = compact_edge_lanes(M, reps, seed=M + reps)
            cases.append((f"edge lanes M={M}", torch.from_numpy(tok).to(device), torch.from_numpy(planes).to(device)))
    tok, planes = compact_edge_lanes(5120, 1, seed=3)
    flat = torch.empty(tok.size + 1, dtype=torch.int32, device=device)
    cases.append(("edge lanes, a row not 16-byte aligned", flat[1:].view(tok.shape).copy_(torch.from_numpy(tok)),
                  torch.from_numpy(planes).to(device)))
    for what, tok, planes in cases:
        K.compare("compact_flat", lambda: dk.compact_flat(tok, planes), lambda: dk.compact_plain(tok, planes),
                  [tok, planes], {"edge": what, "tok": list(tok.shape)}, main_path=False)
        K.compare("compact_any", lambda: dk.compact_any(tok), lambda: dk.compact_plain(tok, None), [tok],
                  {"edge": what, "tok": list(tok.shape)}, main_path=False)


def phase_crc_edges(corpus: bytes, device, K: Kernels) -> None:
    """The lane CRC against its plain version on the encoder's first batch
    (64 members of 64 KiB), whose finished CRCs must equal zlib's, and on
    random rows of the narrowest and widest widths it takes; crc32_device
    and adler32_device against zlib."""
    import numpy as np
    import torch

    from tpu_deflate_torch.kernels import checksum_lanes as cl

    L = 64
    rows = torch.frombuffer(bytearray(corpus[: L * MEMBER]), dtype=torch.uint8).view(L, MEMBER).to(device)
    (raw,) = K.compare("crc32_lanes", lambda: cl.crc32_lanes_raw8(rows), lambda: cl.crc32_lanes_raw8_plain(rows),
                       [rows], {"encode batch": [L, MEMBER]}, main_path=False)
    crcs = cl.crc32_finish_leftaligned(raw.cpu().numpy(), np.full(L, MEMBER), MEMBER)
    want = [zlib.crc32(corpus[i * MEMBER : (i + 1) * MEMBER]) for i in range(L)]
    require([int(c) for c in crcs] == want, "lane CRCs of the encode batch differ from zlib")
    for n in (1, 1000, MEMBER + 7, 3 * FOREIGN_BYTES + 5):
        buf = corpus[n : 2 * n]
        require(cl.crc32_device(buf) == zlib.crc32(buf) and cl.adler32_device(buf) == zlib.adler32(buf),
                f"crc32_device / adler32_device of {n} bytes differ from zlib")
        require(cl.crc32_device(buf[n // 2 :], zlib.crc32(buf[: n // 2])) == zlib.crc32(buf),
                f"crc32_device with an init value ({n} bytes) differs from zlib")
    log("crc32_device and adler32_device on the card equal zlib at 1, 1000, 65543 and 3145733 bytes "
        "(and crc32_device chained across a split)")
    g = torch.Generator(device="cpu").manual_seed(41)
    for shape in ((L, 512), (4, 512 * 1024)):
        r = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(device)
        K.compare("crc32_lanes", lambda: cl.crc32_lanes_raw8(r), lambda: cl.crc32_lanes_raw8_plain(r), [r],
                  {"random rows": list(shape)}, main_path=False)


def chain_depth(y0, src) -> tuple[int, float]:
    """Hops from each match position to a literal along src (max, mean over
    match positions), for positions whose chain stays in the tile."""
    import torch

    pending = y0 < 0
    n_match = int(pending.sum())
    pos = src.clamp(min=0).to(torch.int64)
    depth = pending.to(torch.int64)
    while bool(pending.any()):
        nxt = y0.gather(1, pos) < 0
        pending = pending & nxt
        depth += pending.to(torch.int64)
        pos = torch.where(pending, src.gather(1, pos).clamp(min=0).to(torch.int64), pos)
    return int(depth.max()), float(depth.sum()) / max(n_match, 1)


def phase_resolve_kernels(gz: bytes, corpus: bytes, device, K: Kernels):
    """K5, K6 and the lane CRC on the main path's two resolve batches of the
    corpus's own tokens (hist 0; 256 and 178 lanes), then K5/K6 on edge
    lanes and with 32 KiB of history on tiles 1.. of a 1 MiB multi-block
    stream. Returns the first batch's tokens and its resolve (y, summary
    with the residue in row 3), for the sharded resolve of phase_mesh."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    hm = huffman_members(gz)
    require(len(hm) > pv2.RB, f"the corpus has at most {pv2.RB} Huffman members: one resolve batch")
    order, _small, T_all = pv2.single_block_tokens([p for _m, p in hm], device)
    for base in range(0, T_all.shape[0], pv2.RB):
        T = T_all[base : base + pv2.RB]
        members = [hm[i][0] for i in order[base : base + pv2.RB]]
        main = base == 0
        L, N = T.shape
        log(f"resolve batch at lane {base}: {L} members x {N} token slots, {int((T >= 0).sum())} tokens")
        y0, src, summ = K.compare(
            "expand", lambda: rs.expand(T), lambda: rs.expand_plain(T, 0), [T],
            {"tokens": [L, N], "hist": 0}, main_path=main,
        )
        tail = torch.zeros((L, rs.TAIL), dtype=torch.int32, device=device)
        y, status = K.compare(
            "sweep", lambda: rs.sweep(tail, y0, src), lambda: rs.sweep_plain(tail, y0, src),
            [tail, y0, src], {"y0": [L, N], "tail": [L, rs.TAIL]}, main_path=main,
            proj=lambda out: (out[0], out[1][:, 0]),
        )
        if main:
            first = (T, y, torch.cat([summ[:, :3], status[:, :1], summ[:, 4:]], dim=1))
        dmax, dmean = chain_depth(y0, src)
        log(f"sweep: residue {int(status[:, 0].sum())}, rounds per lane (kernel) max "
            f"{int(status[:, 1].max())}; src chain depth on the corpus: max {dmax}, mean {dmean:.3f} "
            "hops per match position")
        y8 = y.to(torch.uint8)
        (raw,) = K.compare(
            "crc32_lanes", lambda: cl.crc32_lanes_raw8(y8), lambda: cl.crc32_lanes_raw8_plain(y8),
            [y8], {"rows": [L, N]}, main_path=main,
        )
        totals = summ[:, 1].cpu().numpy()
        require((summ[:, 0] == N).all().item(), "an error position in the corpus batch")
        require(list(totals) == [m.isize for m in members], "resolved sizes differ from the trailers")
        crcs = cl.crc32_finish_leftaligned(raw.cpu().numpy(), totals, N)
        require([int(c) for c in crcs] == [m.crc32 for m in members], "lane CRCs differ from the trailers")
        log(f"resolve batch: {L} members byte-exact by size and CRC-32 against their trailers")

    N = rs.N_POS
    edges = torch.from_numpy(edge_tokens(N, rs.TOKEN_MATCH_BIT)).to(device)
    Le = edges.shape[0]
    rng = torch.Generator(device="cpu").manual_seed(5)
    for hist in (0, rs.TAIL):
        e_y0, e_src, _e_summ = K.compare(
            "expand", lambda: rs.expand(edges, hist=hist), lambda: rs.expand_plain(edges, hist),
            [edges], {"edge tokens": [Le, N], "hist": hist}, main_path=False,
        )
        e_tail = torch.randint(0, 256, (Le, rs.TAIL), generator=rng, dtype=torch.int32).to(device)
        e_tail = e_tail if hist else torch.zeros_like(e_tail)
        K.compare(
            "sweep", lambda: rs.sweep(e_tail, e_y0, e_src), lambda: rs.sweep_plain(e_tail, e_y0, e_src),
            [e_tail, e_y0, e_src], {"edge y0": [Le, N], "hist": hist}, main_path=False,
            proj=lambda out: (out[0], out[1][:, 0]),
        )

    s_y0, s_src = (torch.from_numpy(a).to(device) for a in sweep_edge_inputs(N))
    Ls = s_y0.shape[0]
    for hist in (0, rs.TAIL):
        s_tail = torch.randint(0, 256, (Ls, rs.TAIL), generator=rng, dtype=torch.int32).to(device)
        s_tail = s_tail if hist else torch.zeros_like(s_tail)
        K.compare(
            "sweep", lambda: rs.sweep(s_tail, s_y0, s_src), lambda: rs.sweep_plain(s_tail, s_y0, s_src),
            [s_tail, s_y0, s_src], {"edge sources": [Ls, N], "tail": "random" if hist else "zeros"},
            main_path=False, proj=lambda out: (out[0], out[1][:, 0]),
        )

    data = corpus[:FOREIGN_BYTES]
    raw_stream = foreign_raw(data)
    st = pv2.decode_deflate_streams_v2([raw_stream], device)[0]
    require(not st.err, "foreign stream did not decode")
    tiles = torch.from_numpy(rs.split_tokens_tiles(np.concatenate(st.tokens))).to(device)
    ys, _summs = rs.resolve_tokens_tiled(tiles[None])
    require(ys[0].to(torch.uint8).cpu().numpy().tobytes()[: len(data)] == data, "tiled resolve")
    ct = tiles[1:].contiguous()
    tails = ys[0, :-1, N - rs.TAIL :].contiguous()
    Lt = ct.shape[0]
    y0h, srch, _sh = K.compare(
        "expand", lambda: rs.expand(ct, hist=rs.TAIL), lambda: rs.expand_plain(ct, rs.TAIL), [ct],
        {"tokens": [Lt, N], "hist": rs.TAIL}, main_path=False,
    )
    K.compare(
        "sweep", lambda: rs.sweep(tails, y0h, srch), lambda: rs.sweep_plain(tails, y0h, srch),
        [tails, y0h, srch], {"y0": [Lt, N], "tail": [Lt, rs.TAIL]}, main_path=False,
        proj=lambda out: (out[0], out[1][:, 0]),
    )
    return first


def edge_tokens(n_pos: int, match_bit: int):
    """(11, n_pos) int32 token lanes at the resolve's edges: copy before
    start, an oversized distance, an empty lane, constant-distance regions
    past 32 KiB (where the cap on k binds), output past n_pos, random
    tokens that reach far back, a lane of only 258-runs, and literal-only
    lanes (one that fills every slot, one that ends inside the first
    half)."""
    import numpy as np

    rng = np.random.default_rng(17)
    lits = rng.integers(0, 256, 40000).tolist()
    rand = np.where(
        rng.random(30000) < 0.5,
        rng.integers(0, 256, 30000),
        match_bit | rng.integers(3, 259, 30000) << 16 | rng.integers(0, 32768, 30000),
    ).tolist()
    lanes = [
        [65, match_bit | 5 << 16 | 3],
        lits + [match_bit | 5 << 16 | 0x8000, match_bit | 9 << 16 | 3],
        [],
        [65] + [match_bit | 258 << 16 | 0] * 250,
        [1, 2, 3, 4] + [match_bit | 258 << 16 | 3] * 250,
        [7, 8, 9] + [match_bit | 200 << 16 | 2] * 300,
        lits + [match_bit | 258 << 16 | int(d) for d in rng.integers(0, 300, 230)],
        rand,
        [match_bit | 258 << 16 | int(d) for d in rng.integers(0, 32768, 300)],
        rng.integers(0, 256, n_pos).tolist(),
        lits[:20000],
    ]
    out = np.full((len(lanes), n_pos), -1, np.int32)
    for i, toks in enumerate(lanes):
        out[i, : min(len(toks), n_pos)] = toks[:n_pos]
    return out


def sweep_edge_inputs(n_pos: int):
    """(5, n_pos) int32 y0 and src written directly (not by expand): a
    literal lane whose positions at every 1024-position step's start,
    middle and end take a source exactly 32768 back; sources 700 back (chains
    that cross steps and run inside them) among 10 % literals; sources 1
    back (in-step chains of up to 1023 links, a lane of distance-1 runs that
    expand would have collapsed); random sources up to 32768 back among
    half literals; chains that hop 600 back over each step's start, then
    300 back inside the step."""
    import numpy as np

    rng = np.random.default_rng(43)
    p = np.arange(n_pos)
    lits = rng.integers(0, 256, (5, n_pos))
    y0 = np.full((5, n_pos), -1, np.int64)
    src = np.zeros((5, n_pos), np.int64)
    edge = (p % 1024 == 0) | (p % 1024 == 512) | (p % 1024 == 1023)
    y0[0] = np.where(edge, -1, lits[0])
    src[0] = np.where(edge, p - 32768, p)
    y0[1] = np.where((p < 700) | (rng.random(n_pos) < 0.1), lits[1], -1)
    src[1] = p - 700
    y0[2] = np.where(p % 5000 == 0, lits[2], -1)
    src[2] = p - 1
    y0[3] = np.where(rng.random(n_pos) < 0.5, lits[3], -1)
    src[3] = p - rng.integers(1, 32769, n_pos)
    y0[4] = np.where(p % 1024 < 8, lits[4], -1)
    src[4] = np.where(p % 1024 < 600, p - 600, p - 300)
    return y0.astype(np.int32), src.astype(np.int32)


def foreign_raw(data: bytes) -> bytes:
    """The raw DEFLATE payload of a gzip -9 stream of data."""
    gz = gzip.compress(data, 9)
    require(gz[3] == 0, "unexpected gzip header flags")
    return gz[10:-8]


def td_member(payload: bytes, isize: int, crc: int) -> bytes:
    """One gzip member with the 'TD' member index around a raw payload."""
    total = 20 + len(payload) + 8
    head = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x08\x00TD\x04\x00" + total.to_bytes(4, "little")
    return head + payload + crc.to_bytes(4, "little") + isize.to_bytes(4, "little")


def timed_decode(gz: bytes, corpus: bytes, reps: int, config=None) -> list[float]:
    import torch

    from tpu_deflate_torch import engine

    walls = []
    for _ in range(reps):
        t0 = time.monotonic()
        out = engine.decompress(gz, engine="cuda", config=config)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        require(out == corpus, "output differs from the corpus (timed run)")
    return walls


def phase_main_path(corpus: bytes, gz: bytes, n_huff: int) -> tuple[dict, float]:
    import torch

    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2

    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8")]
    with recorded(*kernels) as (calls, shapes, order):
        dk.reset_launches()
        t0 = time.monotonic()
        out = engine.decompress(gz, engine="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(dk.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == corpus, "main-path output differs from the corpus")
    log(f"main path run 1: {wall:.3f} s, {len(corpus) / wall / 1e9:.4f} GB/s, {len(gz)} compressed bytes")
    log(f"main path stats: {json.dumps(stats)}")
    log(f"launches in the main-path run: {json.dumps(launches)}")
    path_bounds("decode main-path", calls)
    bounds = launch_bounds(calls, shapes, order)
    for k, (_src, _tpu, path) in KERNELS.items():
        if path == "main":
            require(launches[k] > 0, f"kernel {k} was not launched on the main path")
    require(stats["device_resolved"] == n_huff, "device_resolved != Huffman member count")
    require(stats["host_resolved"] == 0, "a Huffman member took the host route")
    walls = timed_decode(gz, corpus, E2E_REPS)
    med = statistics.median(walls)
    log(f"main path {E2E_REPS} timed runs: median {med:.4f} s = {len(corpus) / med / 1e9:.4f} GB/s, "
        f"min {min(walls):.4f} s, max {max(walls):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    return launches, med, bounds


def phase_off_route(corpus: bytes, gz: bytes, profile_dir: str | None) -> dict:
    """The host-resolve route: K7 and the wave kernels at a smaller depth
    (with a profile dir: then profiled, each K4 and K7 launch's device time
    beside its bound), then timed at the main path's depth for
    comparison."""
    import bench
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig

    off = DecoderConfig(device_resolve="off")
    small = bench.make_corpus(OFF_CORPUS_MB)
    gz_small = native.compress_members_native(small)
    with recorded((dk, "compact_flat"), (dk, "compact_any")) as (calls, shapes, order):
        dk.reset_launches()
        t0 = time.monotonic()
        out = engine.decompress(gz_small, engine="cuda", config=off)
        wall = time.monotonic() - t0
        launches = dict(dk.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == small, "device_resolve='off' output differs")
    log(f"off route ({OFF_CORPUS_MB} MiB): byte-exact, stats {json.dumps(stats)}, "
        f"launches {json.dumps(launches)}")
    for k in ("stage_a", "stage_b", "stage_dc", "compact_flat", "compact_any"):
        require(launches[k] > 0, f"kernel {k} was not launched on the off route")
    require(stats["device_resolved"] == 0 and launches["expand"] == 0, "off route resolved on device")
    if profile_dir:
        phase_profile(lambda: engine.decompress(gz_small, engine="cuda", config=off), "off route",
                      profile_dir, "profile_off", ("compact_kernel",), wall, launch_bounds(calls, shapes, order))
    walls = timed_decode(gz, corpus, OFF_REPS, config=off)
    med = statistics.median(walls)
    log(f"off route ({CORPUS_MB} MiB) {OFF_REPS} timed runs: median {med:.4f} s = "
        f"{len(corpus) / med / 1e9:.4f} GB/s, min {min(walls):.4f} s, max {max(walls):.4f} s")
    return launches


def phase_on_route(corpus: bytes) -> None:
    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig

    data = corpus[:FOREIGN_BYTES]
    member = td_member(foreign_raw(data), len(data), zlib.crc32(data))
    dk.reset_launches()
    out = engine.decompress(member, engine="cuda", config=DecoderConfig(device_resolve="on"))
    launches = dict(dk.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == data, "device_resolve='on' output differs")
    log(f"on route: gzip -9 member of {len(data)} bytes ({len(member)} compressed) byte-exact, "
        f"stats {json.dumps(stats)}, launches {json.dumps(launches)}")
    require(stats["device_resolved"] > 0, "the 'on' route resolved nothing on the device")
    require(launches["expand"] > 0 and launches["sweep"] > 0, "the 'on' route launched no resolve")


BIG_MEMBER = 1 << 20
BIG_OFFSETS_MIB = tuple(range(8)) + tuple(range(12, 20))  # 8 MiB of the text section, 8 of the records
BIG_SINGLE = (24 << 20, 256 << 10)  # 256 KiB of the runs section: one zlib -9 block
BIG_REPS = 3
SPLIT_REPS = 5


def big_members(corpus: bytes) -> tuple[bytes, list[bytes], list[bytes]]:
    """The big-members stream: 16 TD members, each a zlib -9 raw stream of
    1 MiB of the corpus (several blocks, 16 tiles each), then one
    single-block member of 256 KiB (4 tiles). Returns (stream, each
    member's output, each member's payload)."""
    chunks = [corpus[o << 20 : (o << 20) + BIG_MEMBER] for o in BIG_OFFSETS_MIB]
    chunks.append(corpus[BIG_SINGLE[0] : BIG_SINGLE[0] + BIG_SINGLE[1]])
    payloads = []
    for c in chunks:
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        payloads.append(co.compress(c) + co.flush())
    require(payloads[-1][0] & 1 == 1 and (payloads[-1][0] >> 1) & 3 == 2, "the 256 KiB member is not one block")
    gz = b"".join(td_member(p, len(c), zlib.crc32(c)) for p, c in zip(payloads, chunks))
    return gz, chunks, payloads


BIG_KERNELS = ("stage_a_tables", "stage_a", "stage_b", "stage_dc", "compact_flat", "expand", "sweep", "crc32_lanes")


def phase_big_members(corpus: bytes, device, profile_dir: str | None, K: Kernels) -> dict:
    """Big and multi-block members on the card (the counterpart of the
    reference's kernel_only_bench_big): every member through
    engine.decompress with the defaults, byte-exact, each resolved on the
    device route (the block waves' tokens stay on the card, tile split,
    chained K5/K6 and the lane CRC) and none through K7, with each
    kernel's bound per launch and each kernel held against its plain
    version on the arguments the route gave it; the route's device memory
    peak; then the split on the card against split_tokens_tiles and each
    member's chained CRC against zlib on the same tokens; the batch bound's
    routing; timed against the "off" route in this process. Returns the
    route's launches."""
    import torch

    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    gz, chunks, payloads = big_members(corpus)
    data = b"".join(chunks)
    n_huff = len(payloads)
    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8")]
    with recorded(*kernels) as (calls, shapes, order), captured(*kernels) as caps:
        dk.reset_launches()
        t0 = time.monotonic()
        out = engine.decompress(gz, engine="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(dk.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == data, "big-members output differs")
    log(f"big members: {n_huff} members, {len(data)} bytes ({len(gz)} compressed) byte-exact in {wall:.3f} s; "
        f"{stats.get('chained_tiles')} tiles in {stats.get('chained_groups')} groups, {stats['waves']} waves; "
        f"stats {json.dumps(stats)}")
    log(f"launches in the big-members run: {json.dumps(launches)}")
    require(stats["device_resolved"] == n_huff and stats["host_resolved"] == 0,
            "a big member did not resolve on the device route")
    for k in BIG_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched on the big-members route")
    require(launches["compact_any"] == 0, "the big-members route launched K7")
    path_bounds("big-members route", calls)
    bounds = launch_bounds(calls, shapes, order)
    replay_calls(caps, K, "big members")
    del caps
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    require(engine.decompress(gz, engine="cuda") == data, "big-members output differs (second run)")
    torch.cuda.synchronize()
    log(f"big members: device memory peak {torch.cuda.max_memory_allocated() - mem0} bytes above the {mem0} "
        "held before the run (torch.cuda.max_memory_allocated)")

    # The split and the chained CRC on the route's own tokens.
    N = rs.N_POS
    states = pv2.decode_deflate_streams_v2(payloads, device, device_caps=[len(c) for c in chunks])
    by_t: dict = {}
    for st, chunk in zip(states, chunks):
        require(not st.err and all(isinstance(s, torch.Tensor) for s in st.tokens), "tokens left the card")
        by_t.setdefault(-(-st.out_total // N), []).append((st, chunk))
    for T, pairs in sorted(by_t.items()):
        group = [st for st, _c in pairs]
        segs = [torch.cat(st.tokens) for st in group]
        tok = torch.nn.utils.rnn.pad_sequence(segs, batch_first=True, padding_value=-1)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tiles = rs.split_tiles_device(tok, T)
        torch.cuda.synchronize()
        split_peak = torch.cuda.max_memory_allocated() - mem0
        n_tok = int((tok >= 0).sum())
        for i, seg in enumerate(segs):
            host = torch.from_numpy(rs.split_tokens_tiles(seg.cpu().numpy())).to(device)
            require(host.shape[0] == T and torch.equal(tiles[i], host), "the split on the card differs")
        y8, summs, raws = rs.resolve_tiles_crc(tiles)
        totals = [st.out_total for st in group]
        crcs = cl.crc32_fold_tiles(raws.cpu().numpy(), totals, N)
        y_h = y8.cpu().numpy()
        want = [zlib.crc32(y_h[i, :n].tobytes()) for i, n in enumerate(totals)]
        require([int(c) for c in crcs] == want, "a chained CRC differs from zlib")
        require(all(y_h[i, :n].tobytes() == c for i, (n, (_st, c)) in enumerate(zip(totals, pairs))),
                "the chained bytes differ from the members")
        split_ms = median_ms(lambda: rs.split_tiles_device(tok, T), SPLIT_REPS)
        log(f"big members, T={T}: {len(group)} lanes x {tok.shape[1]} token slots: split on the card equals "
            f"split_tokens_tiles, chained CRCs equal zlib; split {split_ms:.4f} ms (CUDA events, median of "
            f"{SPLIT_REPS}), summary rows 3 (residue) {int(summs[:, :, 3].sum())}; the split's device memory "
            f"peak {split_peak} bytes for {n_tok} tokens ({split_peak / max(n_tok, 1):.1f} bytes a token, "
            f"its output of {tiles.numel() * 4} bytes included)")

    # Under a 512 KiB batch bound and passes of 8 tiles, each 1 MiB member is
    # a device-route batch of its own and resolves in 2 passes, and the 256
    # KiB member resolves in one group; once on the card, once over the
    # 4-shard mesh of phase_mesh.
    from tpu_deflate_torch.dist.mesh import make_codec_mesh

    saved = pv2.BIG_BATCH_POSITIONS
    pv2.BIG_BATCH_POSITIONS = 512 << 10  # passes of 8 tiles
    try:
        dk.reset_launches()
        out = engine.decompress(gz, engine="cuda")
        lowered = dict(pv2.LAST_DECODE_STATS)
        k7 = dk.LAUNCHES["compact_any"]
        require(out == data, "big members under a 512 KiB batch bound differ")
        out = engine.decompress(gz, engine="cuda", mesh=make_codec_mesh(devices=[device] * MESH_SHARDS))
        sharded = dict(pv2.LAST_DECODE_STATS)
        require(out == data, f"big members under a 512 KiB batch bound differ over {MESH_SHARDS} shards")
    finally:
        pv2.BIG_BATCH_POSITIONS = saved
    require((lowered["device_resolved"], lowered["host_resolved"], k7) == (n_huff, 0, 0)
            and lowered.get("passes") == 2 * (n_huff - 1),
            f"members above the batch bound did not resolve in passes on the device route: {lowered}, K7 {k7}")
    require({k: v for k, v in sharded.items() if k != "launches"} == {k: v for k, v in lowered.items() if k != "launches"},
            f"the stats over {MESH_SHARDS} shards differ: {sharded}")
    log(f"big members under a 512 KiB batch bound and passes of 8 tiles: byte-exact, all {n_huff} on the device "
        f"route, {lowered['passes']} passes, K7 launched {k7} times; the same bytes and stats over {MESH_SHARDS} "
        f"shards; stats {json.dumps({k: v for k, v in lowered.items() if k != 'launches'})}")

    # A member of 1- and 2-bit literal codes overflows its wave's k1: the
    # k1 = 512 rerun's tokens stay on the card too.
    runs01 = bytes([0, 1]) * 40000
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    member = td_member(co.compress(runs01) + co.flush(), len(runs01), zlib.crc32(runs01))
    require(engine.decompress(member, engine="cuda") == runs01, "the k1-overflow member differs")
    require(pv2.LAST_DECODE_STATS["device_resolved"] == 1, "the k1-overflow member left the device route")
    log("big members: a k1-overflow member (1- and 2-bit codes, 80000 bytes) byte-exact on the device route")

    off = DecoderConfig(device_resolve="off")
    walls = {"auto": [], "off": []}
    for _ in range(BIG_REPS):
        for mode, cfg in (("auto", None), ("off", off)):
            t0 = time.monotonic()
            out = engine.decompress(gz, engine="cuda", config=cfg)
            torch.cuda.synchronize()
            walls[mode].append(time.monotonic() - t0)
            require(out == data, f"big members on {mode} differ (timed run)")
    for mode, w in walls.items():
        med = statistics.median(w)
        log(f"big members {mode} route {BIG_REPS} timed runs: median {med:.4f} s = {len(data) / med / 1e9:.4f} GB/s, "
            f"min {min(w):.4f} s, max {max(w):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    if profile_dir:
        profile_route(lambda: engine.decompress(gz, engine="cuda"), "big members", profile_dir, "profile_big",
                      statistics.median(walls["auto"]), bounds)
    return launches


def profile_route(run, label: str, profile_dir: str, prefix: str, timed_median_s: float, bounds: dict) -> None:
    """phase_profile of a decode on the device route, with K5, K6 and the
    lane CRC per launch, and the tile split's device time read off a
    profiler annotation around each split_tiles_device call."""
    import torch

    from tpu_deflate_torch.codec import resolve as rs

    split = rs.split_tiles_device

    def annotated(*a, **kw):
        with torch.profiler.record_function("split_tiles_device"):
            return split(*a, **kw)

    rs.split_tiles_device = annotated
    try:
        averages = phase_profile(run, label, profile_dir, prefix, ("expand_kernel", "sweep_kernel", "crc32_lanes_kernel"),
                                 timed_median_s, bounds)
    finally:
        rs.split_tiles_device = split
    for e in averages:
        if e.key == "split_tiles_device":
            dev_us = getattr(e, "device_time_total", None)
            dev_us = e.cuda_time_total if dev_us is None else dev_us
            what = ("its kernels summed" if e.self_cpu_time_total > 0
                    else "the device span of its annotation, idle gaps included")
            log(f"{label} split_tiles_device: {e.count} calls, device {dev_us:.1f} us ({what}; profiler)")


def replay_calls(caps: dict, K: Kernels, label: str) -> None:
    """Each kernel of a path against its plain version, with exact
    equality, on the arguments the path gave it (captured: the first two
    calls of each lane count; on the big-members route the block waves,
    step 0 and a chained step of each tile group, and the CRC at each
    group's rows; on the mesh path each shard shape of the waves, the
    resolve, the CRC and the encode's K8-K10)."""
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    # wrapper -> (its kernel's name in the kernels line, module, plain version, projection)
    plains = {
        "stage_a_tables": ("stage_a_tables", dk, dk.stage_a_tables_plain, None),
        "stage_a": ("stage_a", dk, dk.stage_a_plain, None),
        "stage_b": ("stage_b", dk, dk.stage_b_plain, None),
        "stage_dc": ("stage_dc", dk, lambda d, t, e, *, k1: dk.stage_dc_plain(d, t, e, k1), None),
        "compact_flat": ("compact_flat", dk, dk.compact_plain, None),
        "expand": ("expand", rs, lambda tok, *, hist=0: rs.expand_plain(tok, hist), None),
        "sweep": ("sweep", rs, rs.sweep_plain, lambda out: (out[0], out[1][:, 0])),
        "crc32_lanes_raw8": ("crc32_lanes", cl, cl.crc32_lanes_raw8_plain, None),
        "parse_transfers": ("parse_transfers", pp, pp.parse_transfers_plain, None),
        "parse_replay": ("parse_replay", pp, pp.parse_replay_plain, None),
        "emit_body": ("emit_body", em, em.emit_body_plain, None),
    }
    for wrapper, calls in caps.items():
        kname, module, plain, proj = plains[wrapper]
        fn = getattr(module, wrapper)
        require(bool(calls), f"no {wrapper} call captured on the {label} path")
        log(f"{label}: {wrapper} captured at {[list(args[0].shape) for args, _kw in calls]}")
        for args, kw in calls:
            K.compare(kname, lambda: fn(*args, **kw), lambda: plain(*args, **kw),
                      [a for a in args if hasattr(a, "element_size")],
                      {label: list(args[0].shape), **kw}, main_path=False, proj=proj)
        calls.clear()


def phase_profile(run, label: str, outdir: str, prefix: str, kernels, timed_median_s: float,
                  bounds: dict):
    """Device time per kernel (torch.profiler) and host time per function
    (cProfile) of one call of run() each, written into outdir as
    {prefix}_device.txt and {prefix}_host.txt. The device's busy share is
    read off the one profiled call: the summed duration of its device
    events (kernels and copies, one stream, so they do not overlap) over
    that same call's wall time; beside it, the same busy time over the
    timed median of the unprofiled calls. For the kernels in bounds, each
    launch's device time stands beside its bytes bound (launch_bounds;
    past 24 launches, their sums and the share's min, median and max)."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=30)
    with open(os.path.join(outdir, f"{prefix}_device.txt"), "w") as f:
        f.write(table)
    log(f"profile of one {label} (device time by op):\n" + "\n".join(table.splitlines()[:26]))
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    log(f"profiled {label}: wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
        f"idle {100 * (1 - busy_us / 1e6 / wall):.2f} % of that wall; "
        f"idle {100 * (1 - busy_us / 1e6 / timed_median_s):.2f} % of the timed median "
        f"{timed_median_s * 1e3:.3f} ms")
    for kernel in kernels:
        us = [e.time_range.elapsed_us() for e in device_events if kernel in e.name]
        require(bool(us), f"profile shows no {kernel} launch")
        log(f"{label} {kernel}: {len(us)} launches, device {sum(us):.1f} us total, "
            f"per launch min {min(us):.1f} median {statistics.median(us):.1f} max {max(us):.1f} us"
            + (f", in order {[round(u, 1) for u in us]}" if len(us) <= 16 else ""))
        if len(bounds.get(kernel, ())) == len(us) <= 24:
            for i, (u, (b, sh)) in enumerate(zip(us, bounds[kernel])):
                log(f"{label} {kernel} launch {i} ({sh}): device {u:.1f} us, bound {b:.2f} us "
                    f"({100 * b / u:.1f} % of it)")
        elif len(bounds.get(kernel, ())) == len(us):
            share = [100 * b / u for u, (b, _sh) in zip(us, bounds[kernel])]
            log(f"{label} {kernel}: bound summed {sum(b for b, _sh in bounds[kernel]):.2f} us against device "
                f"{sum(us):.1f} us; bound per launch min {min(share):.2f} median {statistics.median(share):.2f} "
                f"max {max(share):.2f} % of its device time")
    pr = cProfile.Profile()
    pr.enable()
    run()
    torch.cuda.synchronize()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(45)
    with open(os.path.join(outdir, f"{prefix}_host.txt"), "w") as f:
        f.write(s.getvalue())
    log(f"profile of one {label} (host cumulative):\n" + "\n".join(s.getvalue().splitlines()[:70]))
    return averages


def phase_interop(corpus: bytes, gz: bytes, device) -> None:
    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.format.errors import DataFormatError

    data = corpus[:FOREIGN_BYTES]
    foreign = gzip.compress(data, 9)
    require(engine.decompress(foreign, engine="cuda") == data, "foreign gzip stream")
    log(f"foreign gzip without the member index (python gzip -9, {len(foreign)} bytes): ok")
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    before = dk.LAUNCHES["stage_a"]
    require(pv2.inflate_raw_v2(raw, device=device) == data, "foreign raw DEFLATE stream")
    log(f"foreign raw DEFLATE (zlib -9, {len(raw)} bytes) through the wave kernels: ok, "
        f"{dk.LAUNCHES['stage_a'] - before} stage-A launches")

    m, _p = huffman_members(gz)[0]
    bad = bytearray(gz[m.start : m.end])
    bad[m.payload_start - m.start + 100] ^= 0x5A
    reasons = []
    for mode in ("auto", "off"):
        try:
            engine.decompress(bytes(bad), engine="cuda", config=DecoderConfig(device_resolve=mode))
            reasons.append(None)
        except DataFormatError as e:
            reasons.append(e.reason.name)
    log(f"corrupted member: auto route {reasons[0]}, off route {reasons[1]}")
    require(reasons[0] is not None and reasons[0] == reasons[1], "corruption Reason differs")


def encode_members(corpus: bytes) -> bytes:
    """Five members of the corpus for the card-against-CPU check: text,
    random bytes, runs, zeros and a 60-byte text tail (which routes to
    fixed codes). Offsets follow bench.make_corpus: text from 0, records
    from 12 MiB, runs from 24 MiB, random bytes from 30 MiB."""
    mib = 1 << 20
    return (corpus[:MEMBER] + corpus[30 * mib : 30 * mib + MEMBER]
            + corpus[24 * mib : 24 * mib + MEMBER] + bytes(MEMBER) + corpus[12 * mib - 60 : 12 * mib])


def encode_batch(data: bytes, device) -> dict:
    """One lane batch of data as the encoder builds it at effort 2 (lazy
    parse, quality 0): the parse's step tiles, the host entries, K10's
    inputs, the route, the emit's whole arguments and the batch's rows
    and lengths."""
    import numpy as np

    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe

    pend = pe._dispatch_analyze(np.frombuffer(data, np.uint8), True, 0, device)
    args, tiles, entries, choice = pe.emit_inputs(pend)
    return {"tiles": tiles, "entries": entries, "choice": choice, "emit": em.body_args(args),
            "args": args, "rows": pend[0], "lengths": pend[5]}


def phase_encode_kernels(corpus: bytes, device, K: Kernels):
    """K8, K9 and K10 on the first batch of the encode's main path (64
    members), then at the edges: step fields of all 1, all 250 and random
    1..250, K8 and K9 on steps <= 0 and at the int32 limits (K9 with entries
    off the tile), a batch with a lane routed FIXED, and a lane whose bits
    overflow the word grid. Returns the first batch's rows, lengths, emit
    arguments and emitted (words, total_bits), for phase_mesh."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe
    from tpu_deflate_torch.codec import encode_np
    from tpu_deflate_torch.codec import parse as pp

    def parse_pair(tiles, entries, shapes, main_path):
        L, _T, NT = tiles.shape
        steps = tiles.transpose(1, 2)
        (transfers,) = K.compare(
            "parse_transfers", lambda: pp.parse_transfers(tiles), lambda: pp.parse_transfers_plain(tiles),
            [steps], {**shapes, "out": [L, NT, pp.E_P]}, main_path=main_path,
        )
        if entries is None:
            entries = torch.from_numpy(pp.host_entries(transfers.cpu().numpy())).to(device)
        (tok,) = K.compare(
            "parse_replay", lambda: pp.parse_replay(tiles, entries),
            lambda: pp.parse_replay_plain(tiles, entries), [steps, entries],
            {**shapes, "entries": [L, NT]}, main_path=main_path,
        )
        return tok

    b = encode_batch(corpus[: pe.ENC_LANE_BATCH * MEMBER], device)
    L, _T, NT = b["tiles"].shape
    S = NT * pp.T_P
    tok = parse_pair(b["tiles"], b["entries"], {"steps": [L, S]}, True)
    log(f"encode batch: {L} members, {int(tok.sum())} tokens of {L * S} positions")
    args = b["emit"]
    words, body_end = K.compare(
        "emit_body", lambda: em.emit_body(*args), lambda: em.emit_body_plain(*args), list(args),
        {"fields": [L, S], "words": [L, em.EMIT_WORDS]},
    )
    log(f"emit: body bits per lane min {int(body_end.min())} max {int(body_end.max())}, "
        f"routes {np.bincount(b['choice'].cpu().numpy(), minlength=3).tolist()} (dynamic, fixed, stored)")

    for value in (1, pp.PARSE_MAX_STEP):
        tiles = pp.step_tiles(torch.full((L, S), value, dtype=torch.int32, device=device))
        parse_pair(tiles, None, {"steps": [L, S], "all": value}, False)
    g = torch.Generator(device="cpu").manual_seed(31)
    rand = torch.randint(1, pp.PARSE_MAX_STEP + 1, (L, S), generator=g, dtype=torch.int32)
    parse_pair(pp.step_tiles(rand.to(device)), None, {"steps": [L, S], "random": [1, pp.PARSE_MAX_STEP]},
               False)
    # Steps that stop a lock-step cursor (<= 0) or leave the tile at once.
    stop, u = rand.clone(), torch.rand((L, S), generator=g)
    stop[u < 0.5] = 1
    for lo, hi, value in ((0.5, 0.53, 0), (0.53, 0.55, -7), (0.55, 0.56, 600), (0.56, 0.57, 2**31 - 1)):
        stop[(u >= lo) & (u < hi)] = value
    stiles = pp.step_tiles(stop.to(device))
    (stransfers,) = K.compare(
        "parse_transfers", lambda: pp.parse_transfers(stiles), lambda: pp.parse_transfers_plain(stiles),
        [stiles.transpose(1, 2)], {"steps": [L, S], "steps <= 0": True}, main_path=False,
    )
    # K9 on the same field, with entries at and past the tile's edges in
    # the first tiles and the host's entries elsewhere.
    sentries = torch.from_numpy(pp.host_entries(stransfers.cpu().numpy()))
    sentries[:, :5] = torch.tensor([-1, 0, 255, 511, 512], dtype=torch.int32)
    sentries = sentries.to(device)
    K.compare("parse_replay", lambda: pp.parse_replay(stiles, sentries),
              lambda: pp.parse_replay_plain(stiles, sentries), [stiles.transpose(1, 2), sentries],
              {"steps": [L, S], "steps <= 0": True, "entries": [-1, 0, 255, 511, 512]}, main_path=False)

    bf = encode_batch(encode_members(corpus), device)
    choice = bf["choice"].cpu().numpy()
    require(pe.ROUTE_FIXED in choice, f"no lane routed FIXED: {choice.tolist()}")
    fargs = bf["emit"]
    K.compare("emit_body", lambda: em.emit_body(*fargs), lambda: em.emit_body_plain(*fargs), list(fargs),
              {"fields": list(fargs[0].shape), "routes": choice.tolist()}, main_path=False)

    rng = torch.Generator(device="cpu").manual_seed(4)
    sym = torch.randint(0, 256, (1, S), generator=rng, dtype=torch.int32).to(device)
    ones, zeros = torch.ones_like(sym), torch.zeros_like(sym)
    ll = torch.from_numpy(encode_np.pack_codes(np.full((1, 288), 15, np.int64), 15)).to(device)
    dc = torch.zeros((1, 30), dtype=torch.int32, device=device)
    hdr = torch.tensor([77], dtype=torch.int32, device=device)
    oargs = (sym, ones, zeros, zeros, zeros, zeros, zeros, ll, dc, hdr)
    _w, end = K.compare("emit_body", lambda: em.emit_body(*oargs), lambda: em.emit_body_plain(*oargs),
                        list(oargs), {"15-bit literals": [1, S]}, main_path=False)
    require(int(end[0]) == 77 + 15 * S > 32 * em.EMIT_WORDS, "overflow lane's body end")

    # Lanes whose segments carry no bits: all of lane 0, segments 1 and 2 of lane 1.
    seg = em.EMIT_SEGMENT
    eargs = [t[:2].clone() for t in args]
    eargs[1][0] = 0
    eargs[1][1, seg : 3 * seg] = 0
    K.compare("emit_body", lambda: em.emit_body(*eargs), lambda: em.emit_body_plain(*eargs), eargs,
              {"empty segments": [2, S]}, main_path=False)
    # A width that is not a multiple of the segment.
    cut = 2 * seg + em.EMIT_CHUNK
    cargs = [t[:3, :cut].contiguous() for t in args[:7]] + [t[:3] for t in args[7:]]
    K.compare("emit_body", lambda: em.emit_body(*cargs), lambda: em.emit_body_plain(*cargs), cargs,
              {"fields": [3, cut]}, main_path=False)
    # Length slots of more than 31 bits (25 extra bits behind the code),
    # which the kernel places one by one.
    wargs = [t[:2].clone() for t in args]
    wargs[3][:] = torch.randint(0, 1 << 25, wargs[3].shape, generator=rng, dtype=torch.int32).to(device)
    wargs[2][:] = 25
    K.compare("emit_body", lambda: em.emit_body(*wargs), lambda: em.emit_body_plain(*wargs), wargs,
              {"slots over 31 bits": [2, S]}, main_path=False)
    for what, a, every in (("first batch", args, True), ("cut width", cargs, True),
                           ("FIXED batch", fargs, False)):
        starts = segment_starts(a)
        inside = ((starts & 31) != 0).any(dim=1)
        log(f"emit segments, {what}: {int(inside.sum())} of {starts.shape[0]} lanes have a segment "
            "starting inside a word")
        require(bool(inside.all()) or not every, f"emit {what}: a lane whose segments all start on a word")
    return b["rows"], b["lengths"], b["args"], em.emit_device(*b["args"])


def segment_starts(args):
    """(L, segments) first bit of each of K10's segments, from each
    position's bit count as the plain version counts it."""
    import torch

    from tpu_deflate_torch.codec import emit as em

    sym, flags, leb, _lev, dsym, deb, _dev, ll, dc, hdr = args
    i64 = torch.int64
    tok, match = (flags & 1) != 0, (flags & 2) != 0
    b0 = torch.where(tok, ll.to(i64).gather(1, sym.clamp(0, 287).to(i64)) >> 16, 0)
    b2 = dc.to(i64).gather(1, dsym.clamp(0, 29).to(i64)) >> 16
    nb = b0 + torch.where(match, leb.to(i64) + b2 + deb.to(i64), 0)
    ends = hdr.to(i64)[:, None] + torch.cumsum(nb, dim=1)
    bounds = torch.arange(em.EMIT_SEGMENT, nb.shape[1], em.EMIT_SEGMENT, device=nb.device)
    return torch.cat([hdr.to(i64)[:, None], ends[:, bounds - 1]], dim=1)


def member_routes(gz: bytes) -> tuple[int, dict]:
    """(member count, {dynamic, fixed, stored: count}) from each member's BTYPE."""
    import collections

    import numpy as np

    from tpu_deflate_torch.codec import decode_np

    buf = np.frombuffer(gz, np.uint8)
    members = decode_np.split_members(buf)
    require(members is not None, "encoded stream lacks the member index")
    names = {0: "stored", 1: "fixed", 2: "dynamic", 3: "reserved"}
    routes = collections.Counter(names[(int(buf[m.payload_start]) >> 1) & 3] for m in members)
    return len(members), dict(routes)


def phase_encode_main(corpus: bytes) -> tuple[dict, float]:
    """engine.compress of the corpus at the default effort: round trip
    through gzip and the port's decode, every encode kernel launched, then
    timed runs."""
    import torch

    from tpu_deflate_torch import _build, engine, native
    from tpu_deflate_torch.codec import parse as pp

    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    kernels = [(pp, "parse_transfers"), (pp, "parse_replay"), (em, "emit_body"), (cl, "crc32_lanes_raw8")]
    with recorded(*kernels) as (calls, shapes, order):
        _build.reset_launches()
        t0 = time.monotonic()
        gz = engine.compress(corpus, engine="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _build.all_launches()
    log(f"encode run 1: {wall:.3f} s, {len(corpus) / wall / 1e6:.2f} MB/s; launches {json.dumps(launches)}")
    path_bounds("encode main-path", calls)
    bounds = launch_bounds(calls, shapes, order)
    for k in ("parse_transfers", "parse_replay", "emit_body", "crc32_lanes"):
        require(launches[k] > 0, f"kernel {k} was not launched by the encode")
    require(gzip.decompress(gz) == corpus, "gzip.decompress of the encoded corpus differs")
    require(engine.decompress(gz, engine="cuda") == corpus, "the port's decode of the encoded corpus differs")
    n_members, routes = member_routes(gz)
    require(n_members == len(corpus) // MEMBER, f"{n_members} members")
    native_size = len(native.compress_members_native(corpus))
    log(f"encode: {len(corpus)} -> {len(gz)} bytes (ratio {len(gz) / len(corpus):.4f}), {n_members} members "
        f"{json.dumps(routes)}; the C core's member encoder: {native_size} bytes (ratio "
        f"{native_size / len(corpus):.4f}); byte-exact through gzip.decompress and engine.decompress")
    walls = []
    for _ in range(ENCODE_REPS):
        t0 = time.monotonic()
        out = engine.compress(corpus, engine="cuda")
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        require(out == gz, "encode output differs between runs")
    med = statistics.median(walls)
    log(f"encode {ENCODE_REPS} timed runs: median {med:.4f} s = {len(corpus) / med / 1e6:.2f} MB/s, "
        f"min {min(walls):.4f} s, max {max(walls):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    return launches, med, bounds, len(gz)


def phase_encode_cpu(corpus: bytes, device) -> None:
    """Five members encoded on the card and on the CPU (plain versions)
    at each effort, and one full lane batch (the first 64 members) at
    effort 2: the outputs must be byte-identical."""
    import torch

    from tpu_deflate_torch.codec import encode as pe

    five = encode_members(corpus)
    cases = [("five members", five, e) for e in ENCODE_EFFORTS]
    cases.append((f"{pe.ENC_LANE_BATCH} members", corpus[: pe.ENC_LANE_BATCH * MEMBER], 2))
    for what, data, effort in cases:
        t0 = time.monotonic()
        card = pe.compress_members(data, device=device, effort=effort)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        cpu = pe.compress_members(data, device=torch.device("cpu"), effort=effort)
        t2 = time.monotonic()
        require(card == cpu, f"{what}, effort {effort}: card and CPU outputs differ")
        require(gzip.decompress(card) == data, f"{what}, effort {effort}: round trip")
        log(f"{what}, effort {effort}: card and CPU byte-identical, {len(card)} bytes, routes "
            f"{json.dumps(member_routes(card)[1])}; card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")


CONT_FIRST_RUN_LIMIT_S = 30  # the continuous encode's run 1 above this: time 1 more run, not 3
F1_PREFIX = bytes(50)  # leading zeros: the reference's RLE lanes matched its head lane's padding (F1)
F2_BYTES, F2_BLOCK = 300_000, 131072  # 7-bit random blocks that overflow the emit grid (F2)


def continuous_batch(data: bytes, device) -> dict:
    """The first lane batch of data as the continuous encode builds it at
    effort 4 (64 lanes of [32 KiB halo | 64 KiB payload], lazy parse,
    quality 1): the parse's step tiles, the host entries, K10's inputs and
    each lane's first real column."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe

    flat = np.frombuffer(data, np.uint8)
    count = min(pe.ENC_LANE_BATCH, -(-flat.size // MEMBER))
    rows, hstart, pay_lens, final = pc.lane_rows(flat, 0, count, MEMBER)
    dd = torch.from_numpy(rows).to(device)
    pend = pc.dispatch_lanes(dd, torch.from_numpy(hstart).to(device), pay_lens, True, 1)
    args, tiles, entries, _choice = pe.emit_inputs(pend, final)
    return {"tiles": tiles, "entries": entries, "emit": em.body_args(args), "hstart": hstart}


def phase_continuous_kernels(corpus: bytes, device, K: Kernels) -> None:
    """K8, K9 and K10 against their plain versions on the continuous
    encode's first batch (64 x 98304: a third of each row is history), and
    on a batch whose head lane starts with F1's zeros; the parse's chain
    reaches each lane's first payload column."""
    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import parse as pp

    for what, data in (("continuous batch", corpus), ("F1 head lane", F1_PREFIX + corpus)):
        b = continuous_batch(data, device)
        L, _T, NT = b["tiles"].shape
        S = NT * pp.T_P
        steps = b["tiles"].transpose(1, 2)
        K.compare("parse_transfers", lambda: pp.parse_transfers(b["tiles"]),
                  lambda: pp.parse_transfers_plain(b["tiles"]), [steps],
                  {what: [L, S], "out": [L, NT, pp.E_P]}, main_path=False)
        (tok,) = K.compare("parse_replay", lambda: pp.parse_replay(b["tiles"], b["entries"]),
                           lambda: pp.parse_replay_plain(b["tiles"], b["entries"]), [steps, b["entries"]],
                           {what: [L, S], "entries": [L, NT]}, main_path=False)
        args = b["emit"]
        _w, body_end = K.compare("emit_body", lambda: em.emit_body(*args), lambda: em.emit_body_plain(*args),
                                 list(args), {what: [L, S], "words": [L, em.EMIT_WORDS]}, main_path=False)
        require(bool(tok[:, pc.HALO_COLS].all()), f"{what}: the parse chain misses a payload start")
        log(f"{what}: {L} lanes x {S} columns (hstart of lane 0: {int(b['hstart'][0])}), "
            f"{int(tok.sum())} chain positions, body bits per lane min {int(body_end.min())} "
            f"max {int(body_end.max())}")


def phase_continuous_main(corpus: bytes, effort2_bytes: int, profile_dir: str | None, K: Kernels):
    """engine.compress of the corpus at effort 4 (one member of 768 blocks
    of 64 KiB with continuous history): byte-exact through gzip and the
    port's decode on the card, every kernel of the path launched, its
    bounds, memory peak, ratio and times, the lane CRC against its plain
    version on the rows the path gave it; then the decode of its output.
    Returns the encode's and the decode's launches."""
    import numpy as np
    import torch

    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_np
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    def encode():
        return engine.compress(corpus, engine="cuda", effort=4)

    kernels = [(pp, "parse_transfers"), (pp, "parse_replay"), (em, "emit_body"), (cl, "crc32_lanes_raw8")]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with recorded(*kernels) as (calls, shapes, order), captured((cl, "crc32_lanes_raw8"), per_key=1) as caps:
        _build.reset_launches()
        t0 = time.monotonic()
        gz = encode()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _build.all_launches()
    peak = torch.cuda.max_memory_allocated() - mem0
    for (rows,), _kw in caps["crc32_lanes_raw8"]:
        K.compare("crc32_lanes", lambda: cl.crc32_lanes_raw8(rows), lambda: cl.crc32_lanes_raw8_plain(rows),
                  [rows], {"continuous member CRC": list(rows.shape)}, main_path=False)
    log(f"continuous encode run 1: {wall:.3f} s, {len(corpus) / wall / 1e6:.2f} MB/s; launches {json.dumps(launches)}")
    log(f"continuous encode: device memory peak {peak} bytes above the {mem0} held before the run "
        "(torch.cuda.max_memory_allocated)")
    path_bounds("continuous encode", calls)
    bounds = launch_bounds(calls, shapes, order)
    for k in ("parse_transfers", "parse_replay", "emit_body", "crc32_lanes"):
        require(launches[k] > 0, f"kernel {k} was not launched by the continuous encode")
    require(gzip.decompress(gz) == corpus, "gzip.decompress of the continuous encode differs")
    members = decode_np.split_members(np.frombuffer(gz, np.uint8))
    require(members is not None and len(members) == 1, "the continuous encode is not one member")

    dec_kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"),
                   (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8")]
    with recorded(*dec_kernels) as (dec_calls, _shapes, _order):
        _build.reset_launches()
        t0 = time.monotonic()
        out = engine.decompress(gz, engine="cuda")
        torch.cuda.synchronize()
        dec_wall = time.monotonic() - t0
        dec_launches = dict(_build.LAUNCHES)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == corpus, "the port's decode of the continuous encode differs")
    require(stats["device_resolved"] == 1 and stats["host_resolved"] == 0,
            "the continuous member did not resolve on the device route")
    require(dec_launches["compact_any"] == 0, "the continuous member's decode launched K7")
    log(f"continuous decode: {dec_wall:.3f} s ({len(corpus) / dec_wall / 1e9:.4f} GB/s), {stats['waves']} waves, "
        f"stats {json.dumps(stats)}, launches {json.dumps(dec_launches)}")
    path_bounds("continuous decode", dec_calls)

    t0 = time.monotonic()
    z9 = len(zlib.compress(corpus, 9))
    log(f"continuous encode: {len(corpus)} -> {len(gz)} bytes, ratio {len(gz) / len(corpus):.4f}; effort 2's "
        f"members {effort2_bytes / len(corpus):.4f}; zlib.compress(corpus, 9) {z9 / len(corpus):.4f} "
        f"({time.monotonic() - t0:.1f} s on the host); byte-exact through gzip.decompress and engine.decompress")
    reps = 1 if wall > CONT_FIRST_RUN_LIMIT_S else ENCODE_REPS
    walls = []
    for _ in range(reps):
        t0 = time.monotonic()
        again = encode()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        require(again == gz, "continuous encode output differs between runs")
    med = statistics.median(walls)
    log(f"continuous encode timed: median of {reps} run{'s' if reps > 1 else ''} (run 1 took {wall:.1f} s, "
        f"{'above' if wall > CONT_FIRST_RUN_LIMIT_S else 'at most'} {CONT_FIRST_RUN_LIMIT_S} s) {med:.4f} s = "
        f"{len(corpus) / med / 1e6:.2f} MB/s, min {min(walls):.4f} s, max {max(walls):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    if profile_dir:
        phase_profile(encode, "continuous encode", profile_dir, "profile_continuous", ENCODE_PROFILE_KERNELS,
                      med, bounds)
        phase_profile(lambda: engine.decompress(gz, engine="cuda"), "continuous decode", profile_dir,
                      "profile_continuous_decode", PROFILE_KERNELS, dec_wall, {})
    return launches, dec_launches, gz


def phase_continuous_cpu(corpus: bytes, device) -> None:
    """The continuous encode on the card and with the plain versions on
    the CPU, byte-identical: 256 KiB of the corpus (4 blocks) at efforts 4
    and 5, F1's leading zeros before text, and 7-bit random bytes at blocks
    of 128 KiB (F2: lanes whose bits overflow the emit grid are stored)."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import continuous as pc

    rand7 = np.random.default_rng(2).integers(0, 128, F2_BYTES, dtype=np.uint8).tobytes()
    cases = [("256 KiB", corpus[: 4 * MEMBER], 4, MEMBER), ("256 KiB", corpus[: 4 * MEMBER], 5, MEMBER),
             ("F1 zeros + text", F1_PREFIX + corpus[:17000], 4, MEMBER),
             ("F2 7-bit random", rand7, 4, F2_BLOCK)]
    for what, data, effort, block in cases:
        t0 = time.monotonic()
        card = pc.compress_continuous(data, device=device, effort=effort, block_data=block)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        cpu = pc.compress_continuous(data, device=torch.device("cpu"), effort=effort, block_data=block)
        t2 = time.monotonic()
        require(card == cpu, f"continuous {what}, effort {effort}: card and CPU outputs differ")
        require(gzip.decompress(card) == data, f"continuous {what}, effort {effort}: round trip")
        log(f"continuous {what}, effort {effort}, blocks of {block}: card and CPU byte-identical, "
            f"{len(card)} bytes; card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")


MESH_SHARDS = 4  # shards of the mesh on the one card
MESH_DECODE_REPS = 3
MESH_CONT_BYTES = 8 << 20  # sharded_continuous_compress's input: the corpus's first 8 MiB
MESH_PATH_KERNELS = tuple(k for k, (_src, _tpu, path) in KERNELS.items() if path != "off")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh(corpus: bytes, gz: bytes, n_huff: int, resolve_first, encode_first, cont_gz: bytes, device,
               K: Kernels) -> dict:
    """The distribution over a mesh of MESH_SHARDS shards of the card
    (``make_codec_mesh(devices=[cuda] * 4)``): the mesh path (the corpus
    decoded with ``mesh=``, then ``engine.compress(corpus, effort=4,
    mesh=)``, the launch counts read around both) against the earlier
    phases' single-device results, and each kernel call of that run held
    against its plain version on the shard's own arguments (captured, the
    first two calls of each shard shape); the decode over ``make_codec_mesh()``
    (the real devices); the sharded resolve and the sharded analysis and
    emit on the main path's first batches; the sharded C-core encode
    through gzip; ``init_distributed`` with one NCCL rank and the four
    collectives over it; ``dryrun_multichip``. Returns the mesh path's
    launches."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.dist import dryrun
    from tpu_deflate_torch.dist import sharded as ds
    from tpu_deflate_torch.dist.mesh import init_distributed, make_codec_mesh, make_pod_mesh

    card = gpu_name_power()
    cuda = device
    mesh = make_codec_mesh(devices=[cuda] * MESH_SHARDS)
    real = make_codec_mesh()
    log(f"mesh: {MESH_SHARDS} shards of {cuda}; make_codec_mesh(): {real.size} device(s) "
        f"{[str(d) for d in real.devices.reshape(-1)]}")

    def timed(what: str, fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        log(f"mesh {what}: {time.monotonic() - t0:.4f} s wall ({card})")
        return out

    from tpu_deflate_torch.kernels import checksum_lanes as cl

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"), (dk, "compact_flat"),
               (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8"), (pp, "parse_transfers"),
               (pp, "parse_replay"), (em, "emit_body")]
    with captured(*kernels) as caps:
        _build.reset_launches()
        out = timed(f"decode of the corpus over {MESH_SHARDS} shards (argument copies for the replay included)",
                    lambda: engine.decompress(gz, engine="cuda", mesh=mesh))
        stats = dict(pv2.LAST_DECODE_STATS)
        member = timed(f"engine.compress(corpus, effort=4) over {MESH_SHARDS} shards (argument copies for the "
                       "replay included)", lambda: engine.compress(corpus, engine="cuda", effort=4, mesh=mesh))
        launches = _build.all_launches()
    replay_calls(caps, K, "mesh")
    del caps
    require(out == corpus, "the sharded decode differs from the corpus")
    require(stats["device_resolved"] == n_huff and stats["host_resolved"] == 0,
            f"device_resolved {stats['device_resolved']} != {n_huff} Huffman members over the mesh")
    require(member == cont_gz, "the sharded continuous encode differs from the one-device member")
    log(f"mesh decode stats {json.dumps(stats)}")
    log(f"launches on the mesh path (decode, then the effort-4 encode): {json.dumps(launches)}")
    for k in MESH_PATH_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched on the mesh path")

    walls = []
    for _ in range(MESH_DECODE_REPS):
        t0 = time.monotonic()
        require(engine.decompress(gz, engine="cuda", mesh=mesh) == corpus, "the sharded decode differs (timed)")
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    log(f"mesh decode {MESH_DECODE_REPS} timed runs: median {statistics.median(walls):.4f} s, min {min(walls):.4f} s, "
        f"max {max(walls):.4f} s ({card})")
    again = timed(f"engine.compress(corpus, effort=4) over {MESH_SHARDS} shards, timed",
                  lambda: engine.compress(corpus, engine="cuda", effort=4, mesh=mesh))
    require(again == cont_gz, "the sharded continuous encode differs from the one-device member (timed)")
    again = timed("decode of the corpus over make_codec_mesh()", lambda: engine.decompress(gz, engine="cuda", mesh=real))
    require(again == corpus, "the decode over the real devices' mesh differs from the corpus")

    T, y1, summ1 = resolve_first
    ys, summs = timed(f"sharded_resolve of the first resolve batch {list(T.shape)}",
                      lambda: ds.sharded_resolve(mesh)(T))
    require(torch.equal(ys, y1) and torch.equal(summs, summ1), "sharded resolve differs from K5/K6 unsharded")
    log(f"resolve of the first resolve batch, CUDA-event median of {KERNEL_REPS}: sharded over {MESH_SHARDS} "
        f"{median_ms(lambda: ds.sharded_resolve(mesh)(T), KERNEL_REPS):.4f} ms, unsharded "
        f"{median_ms(lambda: rs.resolve_tokens_device(T), KERNEL_REPS):.4f} ms ({card})")

    rows, lengths, args, (w1, b1) = encode_first
    w, b = timed(f"sharded_analyze_emit of the first encode batch {list(rows.shape)}",
                 lambda: ds.sharded_analyze_emit(mesh)(rows, lengths, *args[7:]))
    require(torch.equal(w, w1) and torch.equal(b, b1), "sharded analyze+emit differs from the unsharded batch")

    part = corpus[:MESH_CONT_BYTES]
    sgz = timed(f"sharded_continuous_compress of {len(part)} bytes", lambda: ds.sharded_continuous_compress(part, mesh))
    require(gzip.decompress(sgz) == part, "sharded_continuous_compress does not round-trip through gzip")
    log(f"sharded_continuous_compress: {len(part)} -> {len(sgz)} bytes (ratio {len(sgz) / len(part):.4f})")

    backend = "nccl" if cuda.type == "cuda" else "gloo"
    ok = timed(f"init_distributed (one {backend} rank)", lambda: init_distributed(
        coordinator_address=f"tcp://localhost:{free_port()}", num_processes=1, process_id=0, device=cuda.type))
    require(ok and tdist.get_backend() == backend, f"init_distributed did not bring up {backend}")
    try:
        pod = make_pod_mesh(1, MESH_SHARDS, devices=[cuda] * MESH_SHARDS)
        require(pod.rank_axis == "host", "the pod mesh's host axis is not the ranks")
        axes = ("host", "data")
        rng = np.random.default_rng(12)
        shards = rng.integers(0, 256, (2 * MESH_SHARDS, 40000), dtype=np.uint8)
        word = b"dictionary" * 500
        pd = timed(f"broadcast_preset_dict over {backend}", lambda: ds.broadcast_preset_dict(word, pod))
        require(torch.equal(pd[cuda], ds.broadcast_preset_dict(word, mesh)[cuda]), "broadcast differs")
        h = timed(f"halo_exchange over {backend}", lambda: ds.halo_exchange(shards, pod, axes, preset_dict=pd))
        require(torch.equal(h, ds.halo_exchange(shards, mesh, preset_dict=pd)), "halo exchange differs")
        vals = rng.integers(-1000, 1000, (3 * MESH_SHARDS, 5)).astype(np.int32)
        p = timed(f"psum_stats over {backend}", lambda: ds.psum_stats(vals, pod, axes))
        require(torch.equal(p, ds.psum_stats(vals, mesh)), "psum differs")
        payload = rng.integers(0, 256, (MESH_SHARDS, 300), dtype=np.uint8)
        lens = rng.integers(0, 300, MESH_SHARDS).astype(np.int32)
        g = timed(f"ordered_ragged_gather over {backend}", lambda: ds.ordered_ragged_gather(payload, lens, pod, axes))
        want = ds.ordered_ragged_gather(payload, lens, mesh)
        require(all(np.array_equal(a, b) for a, b in zip(g, want)), "ordered ragged gather differs")
    finally:
        tdist.destroy_process_group()

    timed(f"dryrun_multichip({MESH_SHARDS})", lambda: dryrun.dryrun_multichip(MESH_SHARDS, devices=[cuda] * MESH_SHARDS))
    log(f"gpu: {card}")
    return launches


PASS_CORPUS_MB = 96  # one effort-4 member of more than BIG_BATCH_POSITIONS bytes: 2 passes


def phase_passes(device, profile_dir: str | None, K: Kernels) -> dict:
    """A member above the device route's batch bound, resolved in passes:
    ``engine.compress(bench.make_corpus(96), effort=4)`` writes one member
    of 96 MiB, and ``engine.decompress`` with the defaults must give it back
    byte-exact on the device route (device_resolved 1, host_resolved 0) in
    2 passes, with K7 not launched. Then each wrapper's bytes bound per
    launch, every kernel of that run held against its plain version on the
    arguments the run gave it (captured: the first calls of each shape),
    its device memory peak beside the member's token bytes, K5, K6 and the
    lane CRC on the first tile step of pass 1 (with the tail carried from
    pass 0) against their plain versions, pass 1's tile split against rows
    1024 (a pass's tiles) onward of ``split_tokens_tiles`` of the whole
    lane, the CRC fold's host time, and one "auto" and one "off" decode
    timed in this process (with --profile, the "auto" decode's device time
    by kernel beside each launch's bound, the split's, its idle share and
    its host profile). Returns the pass route's launches."""
    import numpy as np
    import torch

    import bench
    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_np
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.config import DecoderConfig
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    pass_tiles = pv2.BIG_BATCH_POSITIONS // rs.N_POS
    t0 = time.monotonic()
    corpus = bench.make_corpus(PASS_CORPUS_MB)
    made = time.monotonic() - t0
    t0 = time.monotonic()
    gz = engine.compress(corpus, engine="cuda", effort=4)
    torch.cuda.synchronize()
    enc_wall = time.monotonic() - t0
    members = decode_np.split_members(np.frombuffer(gz, np.uint8))
    require(members is not None and len(members) == 1 and members[0].isize == len(corpus) > pv2.BIG_BATCH_POSITIONS,
            "the 96 MiB effort-4 encode is not one member above the batch bound")
    log(f"passes: corpus of {len(corpus)} bytes ({made:.1f} s) -> one effort-4 member of {len(gz)} bytes in "
        f"{enc_wall:.3f} s; batch bound {pv2.BIG_BATCH_POSITIONS}, passes of {pass_tiles} tiles")

    # The path's run: the lane's segments, pass 1's split and the first
    # step of each pass are kept for the checks below.
    seen: dict = {"splits": [], "steps": [], "fold_s": []}
    passes, split, chain, fold = pv2._resolve_passes, rs.split_tiles_device, rs.resolve_tiles_crc, cl.crc32_fold_tiles

    def passes_spy(st, *a):
        seen["segments"] = list(st.tokens)
        return passes(st, *a)

    def split_spy(tokens, T):
        out = split(tokens, T)
        seen["splits"].append(out if len(seen["splits"]) == 1 else None)
        return out

    def chain_spy(tiles, *, tail=None):
        seen["steps"].append((tiles[:, 0].clone(), None if tail is None else tail.clone()))
        return chain(tiles, tail=tail)

    def fold_spy(*a):
        t = time.monotonic()
        out = fold(*a)
        seen["fold_s"].append((a[0].shape, time.monotonic() - t))
        return out

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8")]
    pv2._resolve_passes, rs.split_tiles_device, rs.resolve_tiles_crc, cl.crc32_fold_tiles = (
        passes_spy, split_spy, chain_spy, fold_spy)
    try:
        with recorded(*kernels) as (calls, shapes, order), captured(*kernels) as caps:
            _build.reset_launches()
            t0 = time.monotonic()
            out = engine.decompress(gz, engine="cuda")
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = dict(_build.LAUNCHES)
    finally:
        pv2._resolve_passes, rs.split_tiles_device, rs.resolve_tiles_crc, cl.crc32_fold_tiles = (
            passes, split, chain, fold)
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == corpus, "the 96 MiB member's decode differs")
    log(f"passes: decode in {wall:.3f} s, stats {json.dumps(stats)}, launches {json.dumps(launches)}")
    require((stats["device_resolved"], stats["host_resolved"], stats.get("passes")) == (1, 0, 2),
            "the 96 MiB member did not resolve on the device route in 2 passes")
    require(launches["compact_any"] == 0, "the pass route launched K7")
    for k in BIG_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched on the pass route")
    (shape, fold_s), = seen["fold_s"]
    log(f"passes: CRC fold over {shape[1]} tile registers on the host {fold_s * 1e3:.3f} ms")
    path_bounds("pass route", calls)
    bounds = launch_bounds(calls, shapes, order)
    del calls, shapes, order
    replay_calls(caps, K, "passes")
    del caps

    # K5, K6 and the lane CRC on pass 1's first step, with its carried tail.
    tile0, tail = seen["steps"][1]
    require(tail is not None and seen["steps"][0][1] is None, "pass 1 did not start from pass 0's tail")
    y0, src, _summ = K.compare("expand", lambda: rs.expand(tile0, hist=rs.TAIL), lambda: rs.expand_plain(tile0, rs.TAIL),
                               [tile0], {"pass 1, step 0": list(tile0.shape), "hist": rs.TAIL}, main_path=False)
    y, _status = K.compare("sweep", lambda: rs.sweep(tail, y0, src), lambda: rs.sweep_plain(tail, y0, src),
                           [tail, y0, src], {"pass 1, step 0": list(y0.shape)}, main_path=False,
                           proj=lambda o: (o[0], o[1][:, 0]))
    y8 = y.to(torch.uint8)
    K.compare("crc32_lanes", lambda: cl.crc32_lanes_raw8(y8), lambda: cl.crc32_lanes_raw8_plain(y8), [y8],
              {"pass 1, step 0": list(y8.shape)}, main_path=False)
    want = np.frombuffer(corpus, np.uint8)[pass_tiles * rs.N_POS :][: rs.N_POS]
    require(np.array_equal(y8[0].cpu().numpy(), want), "pass 1's first tile differs from the corpus")

    # Pass 1's split against the whole lane's split on the host.
    segs = seen.pop("segments")
    tok_bytes = sum(s.numel() * s.element_size() if isinstance(s, torch.Tensor) else s.nbytes for s in segs)
    whole = np.concatenate([s.cpu().numpy() if isinstance(s, torch.Tensor) else s for s in segs])
    n_dev, n_segs = sum(isinstance(s, torch.Tensor) for s in segs), len(segs)
    del segs
    t0 = time.monotonic()
    host = rs.split_tokens_tiles(whole)
    pass1 = seen["splits"][1]
    require(pass1 is not None and host.shape[0] == -(-len(corpus) // rs.N_POS), "unexpected tile counts")
    require(np.array_equal(pass1[0].cpu().numpy(), host[pass_tiles :]),
            f"pass 1's split differs from rows {pass_tiles} onward of split_tokens_tiles of the whole lane")
    log(f"passes: pass 1's split ({list(pass1.shape)}) equals rows {pass_tiles}.. of split_tokens_tiles of the "
        f"whole lane ({whole.size} tokens in {len(seen['steps'])} passes; {n_dev} of its {n_segs} segments on the card, "
        f"the others stored blocks; host split {time.monotonic() - t0:.1f} s)")
    del seen, host, whole, pass1, tile0, tail, y0, src, y, y8

    card = gpu_name_power()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = engine.decompress(gz, engine="cuda")
    torch.cuda.synchronize()
    auto_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    require(out == corpus, "the 96 MiB member's decode differs (timed run)")
    log(f"passes: device memory peak {peak} bytes above the {mem0} held before the run "
        f"(torch.cuda.max_memory_allocated), for {tok_bytes} bytes of the member's tokens "
        f"({peak / tok_bytes:.2f}x)")
    log(f"passes: \"auto\" decode of the 96 MiB member {auto_s:.4f} s = {len(corpus) / auto_s / 1e9:.4f} GB/s ({card})")
    t0 = time.monotonic()
    out = engine.decompress(gz, engine="cuda", config=DecoderConfig(device_resolve="off"))
    torch.cuda.synchronize()
    off_s = time.monotonic() - t0
    require(out == corpus, "the 96 MiB member's decode on \"off\" differs")
    log(f"passes: \"off\" decode of the 96 MiB member {off_s:.4f} s = {len(corpus) / off_s / 1e9:.4f} GB/s "
        f"({gpu_name_power()}); \"auto\" / \"off\" = {auto_s / off_s:.3f}")
    if profile_dir:
        profile_route(lambda: engine.decompress(gz, engine="cuda"), "passes", profile_dir, "profile_passes", auto_s,
                      bounds)
    return launches


BIG_ROW_KB = 192  # bench.py's arguments of the big-member row
BIG_ROW_MEMBERS = 16


def phase_kernel_rows(corpus: bytes, gz: bytes, e2e_median_s: float, K: Kernels) -> dict:
    """The kernel-only rows (``codec.kernel_bench``) on phase 4's 48 MiB
    corpus: the decode's Huffman/token stages, the full-member decode with
    its Huffman and stored sub-rows, the big members (16 of 192 KiB, one
    dynamic block each), one staged encode batch and the link probe.

    The path's run: each row once at ``reps=1``, with its launches counted,
    each wrapper's bytes bound per launch, and every kernel call held
    against its plain version on the arguments the rows gave it (captured:
    the first two calls of each lane count, among them ``_big``'s 16-lane
    wave and chained steps at hist 0 and 32768 and ``_full``'s second,
    padded resolve batch). Each row must run the kernels ("cuda") and
    verify every member; every kernel but K7 must launch and K7 must not.
    Then the timed run, unwrapped at the reference's reps: each row, one
    pass's host enqueue time and CUDA-event time, the device memory peak
    beside the end-to-end decode's, and each decode row's GB/s over phase
    4's median end-to-end "auto" decode. Returns the path run's launches."""
    import torch

    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import kernel_bench as kb
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    card = gpu_name_power()
    rows = (
        ("kernel_only_bench", lambda **kw: kb.kernel_only_bench(corpus, **kw)),
        ("kernel_only_bench_full", lambda **kw: kb.kernel_only_bench_full(corpus, **kw)),
        ("kernel_only_bench_big",
         lambda **kw: kb.kernel_only_bench_big(corpus, member_kb=BIG_ROW_KB, n_members=BIG_ROW_MEMBERS, **kw)),
        ("encode_kernel_bench", lambda **kw: kb.encode_kernel_bench(corpus, **kw)),
    )

    def verified(results: dict) -> None:
        kob, full, big = (results[k] for k in ("kernel_only_bench", "kernel_only_bench_full",
                                                "kernel_only_bench_big"))
        require(kob["runner"] == "cuda", "kernel_only_bench did not run the kernels")
        require(full["verified_members"] == full["members"] and full["crc_or_size_mismatches"] == 0,
                "the full-member row did not verify every member")
        require(big["members"] == BIG_ROW_MEMBERS and big["verified_members"] == big["members"]
                and big["byte_mismatches"] == 0, "the big-member row did not verify every member")

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8"),
               (pp, "parse_transfers"), (pp, "parse_replay"), (em, "emit_body")]
    with recorded(*kernels) as (calls, _shapes, _order), captured(*kernels) as caps:
        _build.reset_launches()
        results = {name: run(reps=1) for name, run in rows}
        launches = _build.all_launches()
    log(f"launches over the kernel rows (reps=1): {json.dumps(launches)}")
    verified(results)
    for k in KERNELS:
        if k == "compact_any":
            require(launches[k] == 0, "K7 launched in the kernel rows")
        else:
            require(launches[k] > 0, f"kernel {k} was not launched in the kernel rows")
    path_bounds("kernel rows", calls)
    del calls
    replay_calls(caps, K, "kernel rows")
    del caps

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.decompress(gz, engine="cuda")
    torch.cuda.synchronize()
    require(out == corpus, "the end-to-end decode differs")
    e2e_peak = torch.cuda.max_memory_allocated() - mem0
    e2e_gbps = len(corpus) / e2e_median_s / 1e9
    log(f"kernel rows: end-to-end \"auto\" decode (phase 4) median {e2e_median_s:.4f} s = {e2e_gbps:.4f} GB/s, "
        f"device memory peak {e2e_peak} bytes ({card})")
    huff_bytes = sum(m.isize for m, _p in huffman_members(gz))
    row_bytes = {"kernel_only_bench": huff_bytes, "kernel_only_bench_full": len(corpus),
                 "kernel_only_bench_full_huff": huff_bytes, "kernel_only_bench_full_stored": len(corpus) - huff_bytes,
                 "kernel_only_bench_big": BIG_ROW_KB * 1024 * BIG_ROW_MEMBERS,
                 "encode_kernel_bench": min(len(corpus), 64 * MEMBER)}
    results = {}
    for name, run in rows:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        r = run()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        results[name] = r
        log(f"kernel rows: {name} {json.dumps(r)}")
        for row, t in kb.LAST_PASS_TIMES.items():
            log(f"kernel rows: {row} one pass: CUDA events {t['event_ms']:.3f} ms, host enqueue "
                f"{t['enqueue_ms']:.3f} ms; queued behind a spin kernel {t['device_ms']:.3f} ms of device time "
                f"(whole pass queued before the spin ended: {t['queued']}) = "
                f"{row_bytes[row] / t['device_ms'] / 1e6:.4f} GB/s of device time")
        log(f"kernel rows: {name} call {wall:.2f} s with its prep, device memory peak {peak} bytes "
            f"(end-to-end decode {e2e_peak}) ({card})")
        if "decode_gbps" in r:
            log(f"kernel rows: {name} decode_gbps {r['decode_gbps']} = {r['decode_gbps'] / e2e_gbps:.3f}x the "
                f"end-to-end {e2e_gbps:.4f} GB/s; guard {r['marginal_guard']}")
    verified(results)
    log(f"kernel rows: link probe {json.dumps(kb.link_probe())} (one 256 KiB pull less one scalar round trip, "
        f"a single sample) ({card})")
    return launches


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
    from tpu_deflate_torch import engine, native

    t0 = time.monotonic()
    corpus = bench.make_corpus(CORPUS_MB)
    gz = native.compress_members_native(corpus)
    n_huff = len(huffman_members(gz))
    log(f"corpus: {len(corpus)} bytes -> {len(gz)} gzip bytes, {n_huff} Huffman members "
        f"({time.monotonic() - t0:.1f} s)")

    K = Kernels()
    phase_wave_kernels(gz, device, K)
    phase_k1_edges(gz, device, K)
    phase_k2_edges(device, K)
    small = main_path_small_waves(gz, device)
    phase_k3_edges(small, device, K)
    phase_compact_edges(small, device, K)
    resolve_first = phase_resolve_kernels(gz, corpus, device, K)
    phase_crc_edges(corpus, device, K)
    launches, timed_median_s, bounds = phase_main_path(corpus, gz, n_huff)
    if args.profile:
        phase_profile(lambda: engine.decompress(gz, engine="cuda"), "decode", args.profile, "profile",
                      PROFILE_KERNELS, timed_median_s, bounds)
    off_launches = phase_off_route(corpus, gz, args.profile)
    phase_on_route(corpus)
    big_launches = phase_big_members(corpus, device, args.profile, K)
    phase_interop(corpus, gz, device)

    encode_first = phase_encode_kernels(corpus, device, K)
    enc_launches, enc_median_s, enc_bounds, effort2_bytes = phase_encode_main(corpus)
    if args.profile:
        phase_profile(lambda: engine.compress(corpus, engine="cuda"), "encode", args.profile,
                      "profile_encode", ENCODE_PROFILE_KERNELS, enc_median_s, enc_bounds)
    phase_encode_cpu(corpus, device)

    phase_continuous_kernels(corpus, device, K)
    cont_launches, cont_dec_launches, cont_gz = phase_continuous_main(corpus, effort2_bytes, args.profile, K)
    phase_continuous_cpu(corpus, device)
    mesh_launches = phase_mesh(corpus, gz, n_huff, resolve_first, encode_first, cont_gz, device, K)
    del corpus, gz, cont_gz, resolve_first, encode_first
    pass_launches = phase_passes(device, args.profile, K)
    corpus = bench.make_corpus(CORPUS_MB)
    row_launches = phase_kernel_rows(corpus, native.compress_members_native(corpus), timed_median_s, K)
    path_launches = {"main": launches, "off": off_launches, "big": big_launches, "encode": enc_launches,
                     "continuous": cont_launches, "continuous_decode": cont_dec_launches, "mesh": mesh_launches,
                     "passes": pass_launches, "kernel_rows": row_launches}

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": CSRC + src,
            "replaces": tpu,
            "path": path,
            "launches": path_launches[path][name],
            "launches_by_path": {p: n[name] for p, n in path_launches.items() if name in n},
            "max_abs_err": K.rec[name]["max_abs_err"],
            "ms": K.rec[name]["ms"],
            "plain_ms": K.rec[name]["plain_ms"],
            "bound_ms": K.rec[name]["bound_ms"],
            "bound_by": K.rec[name]["bound_by"],
            "library_ms": None,
        }
        for name, (src, tpu, path) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
