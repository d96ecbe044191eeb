#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (tpu_deflate_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which fails the run (non-zero exit) if anything is wrong:

1. environment: torch, CUDA, nvcc and the card; the shared C core builds;
2. build: every CUDA kernel of tpu_deflate_torch/csrc, from source (one
   nvcc per source, in parallel);
3. kernels: every kernel against its plain PyTorch version on the card,
   at the main path's shapes: the wave kernels (K1 with its table kernel,
   K2, stage C, K3, K4, K7) on one real wave (64 members of the synthetic corpus at
   their payload bucket; the share of its positions that K1 decodes
   through the ladders is printed), K1 and its tables again on waves with
   11-15-bit codes, fixed Huffman codes, a single distance code, an empty
   distance code, a garbage lane and payloads ending inside the last tile,
   K2 again on edge deltas (one lane, one tile, a tile count that is not a
   multiple of its 32-tile strip, all 1, all 48, dense EOB / error
   sentinels, deltas of 0 and 60, hops of 64 and 200, the int32 limits),
   stage C again on edge maps (NT of 1, 3, 128, 384 and 4224, entry0 over
   every byte value and -1 and 1000, maps mixing [0, 48), 48..126, 127,
   128..254 and 255, maps mostly outside the domain, one-lane waves of NT
   1, 2, 15, 17, 511, 513, 4224 and every payload bucket's, with
   states that turn 127 or 255 inside a segment and a first segment that
   ends in 48..126, maps not 16-byte aligned) and with one call's launches
   counted (one launch and the zero fill of its look-back scratch, no
   other device work), the wave summary (the fold of K3's summary rows
   into the (7, L) vector, K3's epilogue, run alone on given rows by
   ``wave_summary``) on that wave, with one call's launches counted (one
   launch and no zero fill; and K3 with the fold, one launch), and on
   edge rows (a 1-lane
   wave of 1 and of 4224 tiles, 256 x 1152 waves with and without nlit,
   overflow in one lane only and in the last lane only, rows over the whole
   int32 range), the tile split on edge streams (one lane of 1024 tiles of
   258-byte runs, straddlers as the last and the first token of a place
   pass segment, a run ending on a seam at a segment's edge, -1 runs over
   segment edges, T = 1, tokens past tile T - 1, K = 0), K3
   again at every k1 on the main path's own 4-lane waves, on edge
   deltas (0, -5, 60, the int32 limits, dense sentinels; entries 0, 47, 48
   and 255) and on tiles of 512 one-bit deltas, K4 and K7 again on the
   main path's own 4-lane waves (K3's tokens at k1 104 and 512) and on
   edge lanes (every entry valid, none, only the last, only the last 300,
   literal ranks 0 and 255 under random planes, match tokens of 256; M of
   128, 1001, 4099, 5120 and 8228 at 7 and 672 lanes, and a row that is not
   16-byte aligned), K4's pull mode with the map (the host route's
   compaction and packed token pull in one launch, ``compact_pack``) on
   the same waves and lanes and on seam lanes (segments that start off a
   bitmap word and runs of empty segments between two shared words; 7 and
   672 lanes), the pull mode without the map (the pull alone,
   ``pack_tokens``) on the same lanes and on its own (all literals, all
   matches, all below 0, a literal at bit 31 of every bitmap word; M of 31,
   1001, 4099 and 8228 at 11 and 704 lanes, one lane, a row not 16-byte
   aligned), the resolve kernels (K5
   expand, K6 sweep) and the lane CRC on the main path's two resolve
   batches (256 and 178 members x 65536 slots) built from the corpus's own
   tokens, the lane CRC also on the encoder's first batch (64 x 64 KiB,
   finished CRCs against zlib) and on random rows of 512 and 524288 bytes,
   crc32_device against zlib at four sizes, Adler-32's sums
   (``adler_sums``) against their plain version at those sizes, at 15, 16,
   17, 5552 and 5553 bytes and from an address off 16 bytes, then
   ``adler32_device`` against zlib at the four sizes and on 2**31 + 4099
   bytes on the card (whole and from its second byte), with its launches
   counted (one a call) and the big buffer's sums timed beside their bound,
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
   the device and every main-path kernel launched, stage C and K3's
   summary fold (its (7, L) vector against ``wave_summary_plain`` of its
   rows) held against their plain versions on every wave of the run (one
   K3 a wave, the fold launched alone never), one decode's launches, aten
   ops and device events a wave, with each kernel's
   bound per launch and summed over the run (with --profile, each K3, K4,
   K6 and lane CRC launch's device time beside its bound); 5
   timed runs;
5. the host-resolve route (``device_resolve="off"``) on an 8 MiB corpus,
   byte-exact with one compaction launch a wave, K4's pull mode
   (``compact_pack``: the compaction, the literal map, the packed pull and
   nlit into row 6 of K3's vector), and K4 alone, K7 and the pull alone
   never outside a k1 = 512 rerun, the fused launch on every wave held
   against ``compact_pack_plain`` of the same K3 tokens and planes, K3's
   fold on every wave and each pulled vector (K3's, with nlit in row 6)
   against ``wave_summary_plain`` with that nlit, each wave's fused launch
   alone with its launches counted (one, no zero fill), one decode's
   launches, aten ops and device events a wave with the plain chain and
   with the kernel (with --profile, each fused launch's device time beside
   its bound), and 3 timed runs of it on the 48 MiB corpus for comparison;
6. the ``device_resolve="on"`` route: a gzip -9 stream of 1 MiB in one
   member with the member index (multi-block, > 64 KiB), resolved on the
   device in chained tiles; then the big members (the counterpart of the
   reference's ``kernel_only_bench_big``): 16 zlib -9 members of 1 MiB and
   a single-block member of 256 KiB through ``engine.decompress`` with the
   defaults, byte-exact, every member on the device route (tokens kept on
   the card, tile split, chained K5/K6 and lane CRC) with every kernel of
   the route launched and K7 and the pull not, each kernel's bound per launch, and each
   kernel against its plain version on the arguments the route gave it
   (its block waves and K3's folds of them, each group's split, a first and
   a chained step of each tile group, the CRC at each group's rows); its
   device memory peak; the split on the card equal to
   ``split_tokens_tiles`` and to its plain version, with one call's
   launches counted (the split's one kernel, no zero fill and no other
   device work), its kernel's device time and its memory a token above its
   output, and each chained CRC equal to zlib on the same tokens; under a 512 KiB
   batch bound and passes of 8 tiles every member on the device route, the
   1 MiB members in 2 passes each and K7 and the pull not launched, on the card and over
   a 4-shard mesh of it, byte-exact with the same stats; 3 timed runs
   against 3 of the "off" route (with
   --profile, the route's device time by kernel beside each launch's
   bound, the split's, and its idle share);
7. interop and errors: a foreign gzip stream without the member index,
   a foreign raw multi-block DEFLATE stream through the wave kernels, and a
   corrupted member raising the same Reason on the "auto" and "off" routes;
   then the host codec (``phase_host_codec``): the one-shot API's gzip
   streams (256 KiB at efforts 0, 1 and 2 and with ``FULL_STATIC``, 64 KiB
   at effort 5) decoded by ``engine.decompress`` on the card as written (no
   member index: the C core) and with their DEFLATE payload under the TD
   member index (each Huffman stream taking K1 launches), raw DEFLATE
   through ``inflate_raw_v2``, ``profile_compress_host`` of 4 MiB on the
   main path, ``engine.compress`` of 2 MiB read back by ``GzipReader``,
   three ``MemberCatalog.read_range`` calls (inside a member, across a
   seam, to the end) and ``resume_point``, ``decode_all(on_error="skip")``
   reporting exactly the one corrupted member, and ``zlib_compress`` of 1
   MiB through ``zlib_decompress`` and Python's zlib, its trailer equal to
   ``adler32_device`` on the card; each step's seconds beside the card's
   name and power limit;
8. encode kernels: the match finder's four kernels (``match_keys``,
   ``match_chain``, the same-hash links, ``match_bucket``, the compare
   along them, ``match_select``; every hash family in one launch of each),
   K8 parse transfers, K9 parse
   replay, the symbols and histograms (``_finish_analysis``) and the
   emit's one launch (``emit_routed``: the block routing, K10's body, the
   header and the EOB; its counters ``route`` and ``header_eob`` are
   ``emit_body``'s) against their plain versions (exact equality) on the
   first batch of the encode's main path (64 members x 64 KiB of the
   corpus; there ``_finish_analysis`` also with one call's launches
   counted, one launch and the histograms' zero fill, and
   ``torch.bincount``'s time on the plain version's keys; the emit with
   one call's launches counted, one launch and the words' and scratch's
   zero fills, and with routing off on the routed tables, equal to it);
   the emit also on the routing's edge lanes (dynamic == fixed, stored ==
   dynamic below fixed, lengths 0, 1, 65535 and 65536, every strategy;
   final None, all 0 and mixed) and on the header/EOB's (32- and 1-bit
   slots, 0-bit slots and EOBs, an empty body, an EOB straddling the
   grid's end, one past it), each on a short token row, on the FIXED
   batch and on the lane whose bits overflow the grid;
   ``_finish_analysis`` also on edge batches (4 and 16 lanes: every run of
   3..258 against every distance-symbol boundary, clamped runs and
   distances, a lane with no token, a lane of one literal; rows of 4099
   columns; inputs off their alignment); the match finder's kernels also on edge rows (zeros,
   random bytes, a lone repeat at distance 32768 that must be found and
   one at 32769 that must not, lengths of 1000, 0, 1 and 40000 with the
   row's own bytes past them, runs, records) at qualities 0, 1 and 2,
   lazy on and off, without and with the history masks, on long rows of
   98304 columns (4-byte patterns recurring 65536, 65537, 32768 and 32769
   columns apart, where only the 32768 one has a link; records whose
   matches stop short of the cap; zeros; lanes of length 0, 1 and 3;
   random bytes; hstart 12345 and 32768), on 64 rows of zeros of 98304
   columns at quality 2 (one hash group, every compare matching the cap),
   64 rows of those records at quality 1 (every position taking all K4 =
   32 hops) and 64 rows of random bytes, ``match_keys`` also on rows not
   4-byte aligned, S of 65535, 4112, 4100, 4097 and 23 and F = 1 and 3,
   with and without hstart; K8-K10 then on
   step fields of all 1, all 250, random 1..250 and one with steps <= 0
   and at the int32 limits (K9 there with entries of -1, 0, 255, 511 and
   512 in the first tiles), and the emit on a batch with a lane routed
   FIXED, a lane of 15-bit literal codes whose bits overflow the word
   grid, lanes whose segments carry no bits, a width that is not a
   multiple of K10's segment, and slots of more than 31 bits; every lane
   of the first batch has a segment that starts inside a word;
9. the encode's main path: ``engine.compress`` of the 48 MiB corpus at the
   default effort 2, byte-exact through ``gzip.decompress`` and the port's
   ``engine.decompress``, 768 members, every encode kernel and the lane
   CRC launched (the match finder's four kernels once a batch, the emit
   once a batch with no routing or header/EOB launch of its own, held
   against its plain composition on every call), one encode's launches,
   aten ops and device events a batch, its size
   beside the C core's member encoder, each kernel's bound per launch and
   summed over the run; 3 timed runs; then one batch of the match finder:
   its launches (exactly its four kernels) and device time under
   torch.profiler, its chain kernel's time alone, its memory peak, and the
   plain eager version's launches and time on the card;
10. the card against the CPU: five members (text, random, runs, zeros, a
   short tail) encoded on the card and with the plain versions on the CPU
   at efforts 1, 2, 3 and 5 must be byte-identical;
11. continuous-encode kernels: the match finder's kernels (quality 1, with
   the history masks), K8, K9, ``_finish_analysis`` and the emit's one
   launch (its final per lane) against their plain versions on the
   first batch of the continuous encode (64 lanes x 98304 columns: a 32 KiB
   halo before each 64 KiB block) and on a batch whose head lane starts
   with 50 zero bytes (the reference's F1);
12. the continuous encode's main path: ``engine.compress`` of the 48 MiB
   corpus at effort 4, one member of 768 blocks, byte-exact through
   ``gzip.decompress`` and the port's decode on the card (one member on the
   device route, K7 and the pull not launched, one tile split, K3's summary fold every wave,
   both held against their plain versions), the match finder's kernels (three
   families a batch), the emit (once a batch, against its plain
   composition on every call, non-final lanes among them; one encode's
   launches, aten ops and device events a batch), K8-K10 and the lane CRC
   launched (the CRC against
   its plain version on the rows the path gave it), each kernel's bound
   per launch and summed, the device memory peak, the ratio beside effort
   2's and zlib -9's, timed runs of the encode, phase 9's profile of one
   batch of the match finder on phase 11's first batch, and one timed
   decode with its waves;
13. the continuous encode on the card against the CPU, byte-identical: 256
   KiB at efforts 4 and 5, 50 zero bytes before text (F1) and 300,000
   7-bit random bytes in blocks of 128 KiB (F2);
14. the mesh (``phase_mesh``): 4 shards of the card. The mesh path is
   ``engine.decompress(corpus's members, mesh=)`` (byte-exact, every
   Huffman member resolved on the device), the big members of phase 6
   decoded over the mesh (the tile split on each shard), then ``engine.compress(corpus,
   effort=4, mesh=)`` (byte-identical to phase 12's member), every kernel
   but K7, K4's pull mode and the pull alone, and Adler-32's sums launched (the match
   finder's among them; the emit held against its plain composition on
   every call), and each kernel call of
   that run (captured: the first
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
   host_resolved 0, K7 and the pull not launched, every other kernel of the route
   launched), each wrapper's bytes bound per launch, and every kernel of
   the run (K1 tables, K1-K4 and K3's summary fold on its one-lane block
   waves, the tile split of each pass, K5, K6 and the lane CRC on its tile
   steps; the first calls of each shape) held against
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
   kernel but K7, K4's pull mode, the pull alone and Adler-32's sums launched over the
   rows and those not (the emit held against its plain composition on
   every call), each wrapper's bytes
   bound per launch, and every kernel of the run (K1 tables, K1-K4 and the
   K3's summary fold on the rows' waves, the big row's tile split, K5, K6 and
   the lane CRC on the full row's resolve batches and the big row's
   chained steps, the match finder's kernels and K8-K10
   on the encode batch; the first
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
    "stage_c": ("stage_c.cu", "tpu_deflate/codec/decode_jax_v2.py:654", "main"),
    "stage_dc": ("stage_dc.cu", "tpu_deflate/codec/decode_pallas.py:413", "main"),
    "compact_flat": ("compact.cu", "tpu_deflate/codec/decode_pallas.py:495", "main"),
    "compact_any": ("compact.cu", "tpu_deflate/codec/decode_pallas.py:605", "off"),
    "pack_tokens": ("compact.cu", "tpu_deflate/codec/decode_jax_v2.py:1385", "off"),
    "compact_pack": ("compact.cu", "tpu_deflate/codec/decode_jax_v2.py:1385", "off"),
    "expand": ("expand.cu", "tpu_deflate/codec/resolve_pallas.py:150", "main"),
    "sweep": ("sweep.cu", "tpu_deflate/codec/resolve_pallas.py:353", "main"),
    "crc32_lanes": ("crc32_lanes.cu", "tpu_deflate/kernels/checksum_jax.py:190", "main"),
    "parse_transfers": ("parse.cu", "tpu_deflate/codec/parse_pallas.py:66", "encode"),
    "parse_replay": ("parse.cu", "tpu_deflate/codec/parse_pallas.py:82", "encode"),
    "emit_body": ("emit.cu", "tpu_deflate/codec/emit_pallas.py:67", "encode"),
    "match_keys": ("match.cu", "tpu_deflate/codec/encode_jax.py:144", "encode"),
    "match_chain": ("match.cu", "tpu_deflate/codec/encode_jax.py:214", "encode"),
    "match_bucket": ("match.cu", "tpu_deflate/codec/encode_jax.py:144", "encode"),
    "match_select": ("match.cu", "tpu_deflate/codec/encode_jax.py:144", "encode"),
    "finish_analysis": ("finish.cu", "tpu_deflate/codec/encode_jax.py:372", "encode"),
    "tile_split": ("tile_split.cu", "tpu_deflate/codec/resolve_pallas.py:620", "big"),
    "wave_summary": ("stage_dc.cu", "tpu_deflate/codec/decode_jax_v2.py:1331", "main"),
    "route": ("emit.cu", "tpu_deflate/codec/encode_jax.py:575", "encode"),
    "header_eob": ("emit.cu", "tpu_deflate/codec/emit_pallas.py:271", "encode"),
    "adler_sums": ("adler32.cu", "tpu_deflate/kernels/checksum_jax.py:282", "adler"),
}
# kernel -> the kernel whose launch runs it, where that is another: the
# routing (K10's prologue) and the header/EOB (K10's epilogue) have no
# launch of their own, so their counts and their numbers are the emit's
FOLDED = {"route": "emit_body", "header_eob": "emit_body"}
# kernel -> the counter of its launches where another kernel runs it: the
# summary fold is K3's epilogue, launched with K3 (the wave_summary counter
# counts only its launches alone, on given rows); K7's compaction and the
# packed pull run on the "off" route inside K4's pull mode, one launch a
# wave (the compact_any and pack_tokens counters count their launches
# alone, which no route makes); and FOLDED
COUNTERS = {"wave_summary": "stage_dc", "compact_any": "compact_pack", "pack_tokens": "compact_pack", **FOLDED}
# paths that only the "off" route or the Adler-32 phase drive
SIDE_PATHS = ("off", "adler")
PROFILE_KERNELS = (
    "stage_a_tables_kernel", "stage_a_kernel", "stage_b_kernel", "stage_c_kernel", "stage_dc_kernel",
    "compact_kernel", "expand_kernel", "sweep_kernel", "crc32_lanes_kernel",
)
OFF_PROFILE_KERNELS = ("compact_pull_kernel",)
ENCODE_PROFILE_KERNELS = (
    "match_keys_kernel", "match_chain_kernel", "match_bucket_kernel", "match_select_kernel",
    "parse_transfers_kernel", "parse_replay_kernel", "finish_analysis_kernel", "emit_kernel", "crc32_lanes_kernel",
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


def tensors_of(x) -> list:
    """The tensors in x: a tensor, or a tuple, list or dict of them (nested)."""
    if hasattr(x, "element_size"):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors_of(item)]
    return []


def tensor_bytes(x) -> int:
    """Bytes of the tensors in x (a tensor, or a tuple, list or dict of them)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


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
    "stage_c": "stage_c_kernel", "stage_dc": "stage_dc_kernel", "compact_flat": "compact_kernel",
    "compact_any": "compact_kernel", "sweep": "sweep_kernel", "crc32_lanes_raw8": "crc32_lanes_kernel",
    "_finish_analysis": "finish_analysis_kernel", "pack_tokens": "compact_pull_kernel",
    "compact_pack": "compact_pull_kernel",
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
        """kern() and plain() equal (exact), both timed; the bound from
        ``inputs`` and the kernel's results."""
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
        bms, by = bound(inputs, tensors_of(outs))
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
                                                      "compact_kernel<16, map>", "compact_kernel<16, no map>",
                                                      "compact_pull_kernel<4, map>",
                                                      "compact_pull_kernel<4, no map>",
                                                      "compact_pull_kernel<16, map>",
                                                      "compact_pull_kernel<16, no map>")),
                            ("td_sweep_occupancy", ("sweep_kernel",)),
                            ("td_match_occupancy", ("match_chain_kernel", "match_bucket_kernel"))):
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


def stage_c_plain3(transfers, entry0):
    """``decode_kernels.stage_c``'s three results from its plain version."""
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk

    entries, final = dk.stage_c_plain(transfers, entry0)
    return entries, final, entries.to(torch.int32)


def stage_dc_plain3(delta, token, entries, k1):
    """``decode_kernels.stage_dc``'s three results from the plain versions:
    K3's tokens and rows, and the summary fold of the rows."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    tokens, summ = dk.stage_dc_plain(delta, token, entries, k1)
    return tokens, summ, dk.wave_summary_plain(summ)


@contextlib.contextmanager
def folds_checked(K, label: str, keep: bool = False):
    """Wrap ``decode_kernels.stage_dc`` for the block: each call's (7, L)
    vector, K3's summary fold, held equal to ``wave_summary_plain`` of the
    call's own rows as it returns (exact; its max_abs_err kept under
    ``wave_summary``). Yields a list with an entry a call: (a copy of the
    rows, the vector the path goes on with) with ``keep``, else None."""
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk

    seen = []
    stage_dc = dk.stage_dc

    def wrapper(*args, **kwargs):
        tok, summ, vec = stage_dc(*args, **kwargs)
        want = dk.wave_summary_plain(summ)
        err = max_abs_err(vec, want)
        r = K.rec.setdefault("wave_summary", {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        require(torch.equal(vec, want), f"{label}: K3's summary fold differs from its plain version at "
                                        f"{list(summ.shape)}")
        seen.append((summ.clone(), vec) if keep else None)
        return tok, summ, vec

    dk.stage_dc = wrapper
    try:
        yield seen
    finally:
        dk.stage_dc = stage_dc
    log(f"{label}: K3's summary fold equal to wave_summary_plain on all {len(seen)} waves")


FINISH_KEYS = ("is_token", "is_match", "litlen_sym", "len_eb", "len_ev", "dist_sym", "dist_eb", "dist_ev",
               "litlen_hist", "dist_hist")


def finish_plain(data, use, dist, replay, valid):
    """``encode._finish_analysis``'s (analysis, flags) from its plain version."""
    from tpu_deflate_torch.codec import encode as pe

    a = pe._finish_analysis_plain(data, use, dist, replay & valid)
    return a, pe._flags_plain(a)


def finish_parts(out: tuple) -> tuple:
    """``_finish_analysis``'s (analysis dict, flags) as a flat tuple, for the
    comparisons; the dict must hold exactly the reference's keys."""
    a, flags = out
    require(tuple(a) == FINISH_KEYS, f"analysis keys {tuple(a)}")
    return (*(a[k] for k in FINISH_KEYS), flags)


PROFILE_TRIES = 3
# aten ops that launch no device work: allocations, views, a `to` that keeps the dtype
NO_LAUNCH_OPS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like", "aten::view", "aten::_unsafe_view", "aten::slice",
    "aten::select", "aten::as_strided", "aten::to", "aten::lift_fresh", "aten::detach", "aten::alias",
    "aten::expand", "aten::unsqueeze", "aten::squeeze", "aten::reshape", "aten::_reshape_alias",
    "aten::transpose", "aten::permute", "aten::t", "aten::unbind", "aten::resolve_conj", "aten::resolve_neg",
})


def call_record(fn) -> tuple:
    """One call of fn after a warm-up call: (the port's kernel launches it
    made, by ``_build``'s counters; the aten ops it dispatched, from
    torch.profiler's host-side record; its device events). The first two
    are exact and count every launch: a kernel of ours moves its counter,
    and any other device work is an aten op. The device events (CUPTI)
    give the device time only: on the card a session that followed a
    session of thousands of events, or a scheduled session that followed
    another profiler, recorded no device event at all, so a session is
    retried, at most PROFILE_TRIES times, until it records one."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_deflate_torch import _build

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        before = _build.all_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        after = _build.all_launches()
        events = [e for e in prof.events() if e.device_type == cuda]
        if events:
            break
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    ops = collections.Counter(e.name for e in prof.events() if e.device_type != cuda and e.name.startswith("aten::"))
    return launches, ops, events


def launch_profile(label: str, fn, kernels: dict, allowed: tuple = ()) -> list:
    """One call of fn (``call_record``): exactly ``kernels`` ({counter:
    launches}) of the port's kernels and no aten op that launches device
    work but those in ``allowed`` (the zero fill of an output). Returns its
    device events."""
    import collections

    launches, ops, events = call_record(fn)
    names = collections.Counter(e.name for e in events)
    log(f"{label}: one call launched {json.dumps(launches)} of the port's kernels; aten ops {json.dumps(dict(ops))}; "
        f"device events {json.dumps(dict(names)) if events else 'not recorded'}")
    require(launches == kernels, f"{label}: the port's kernel launches {launches}, expected {kernels}")
    device_ops = {op: n for op, n in ops.items() if op not in NO_LAUNCH_OPS and op not in allowed}
    require(not device_ops, f"{label}: aten ops that launch device work {device_ops}")
    return events


def one_launch(label: str, fn, counter: str, allowed: tuple = ()) -> None:
    """One call of fn (``launch_profile``): exactly one launch of the
    port's ``counter`` kernel and no other device work but the aten ops in
    ``allowed`` (none: no zero fill); prints its device time where the
    profiler recorded it."""
    events = launch_profile(label, fn, {counter: 1}, allowed)
    if events:
        log(f"{label}: device time {sum(e.time_range.elapsed_us() for e in events):.2f} us "
            f"({', '.join(f'{e.name[:40]} {e.time_range.elapsed_us():.2f}' for e in events)}) ({gpu_name_power()})")


def wave_launches(fn, label: str) -> None:
    """One decode (``call_record``): the port's kernel launches, the aten
    ops that launch device work and the device events, in all and a wave
    (``LAST_DECODE_STATS["waves"]``)."""
    import collections

    from tpu_deflate_torch.codec import decode_v2 as pv2

    launches, ops, events = call_record(fn)
    waves = pv2.LAST_DECODE_STATS["waves"]
    device_ops = collections.Counter({op: n for op, n in ops.items() if op not in NO_LAUNCH_OPS})
    kernels = [e for e in events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    n_ports, n_ops = sum(launches.values()), sum(device_ops.values())
    log(f"{label}: one decode of {waves} waves: {n_ports} launches of the port's kernels "
        f"({n_ports / waves:.1f} a wave), {n_ops} aten ops that launch device work ({n_ops / waves:.1f} a wave; "
        f"most {json.dumps(dict(device_ops.most_common(8)))}), "
        + (f"{len(kernels)} device kernel events ({len(kernels) / waves:.1f} a wave)" if events
           else "device events not recorded"))


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
    entries8, _final, entries = K.compare(
        "stage_c", lambda: dk.stage_c(transfers, w["rem"]), lambda: stage_c_plain3(transfers, w["rem"]),
        [transfers, w["rem"]], {"maps": [L, NT, 48], "out": [L, NT]},
    )
    require(torch.equal(pv2.stage_c_entries(transfers, w["rem"])[0], entries8),
            "stage_c_entries differs from stage_c")
    launch_profile("stage_c_entries on the corpus wave", lambda: pv2.stage_c_entries(transfers, w["rem"]),
                   {"stage_c": 1}, ("aten::zeros", "aten::zero_", "aten::fill_"))
    tokc_main = summ_main = None
    for k1 in sorted(set(wp.K1_CHOICES) | {wp.W_P}):
        tokc, summ, _vec = K.compare(
            "stage_dc",
            lambda: dk.stage_dc(dt, tt, entries, k1=k1),
            lambda: stage_dc_plain3(dt, tt, entries, k1),
            [dt, tt, entries],
            {"delta": [L, 512, NT], "k1": k1},
            main_path=k1 == k1_wave,
        )
        if k1 == k1_wave:
            tokc_main, summ_main = tokc, summ
    K.compare("wave_summary", lambda: dk.wave_summary(summ_main), lambda: dk.wave_summary_plain(summ_main),
              [summ_main], {"summ": [L, 8, NT]})
    launch_profile("wave_summary on the corpus wave", lambda: dk.wave_summary(summ_main), {"wave_summary": 1})
    launch_profile("stage_dc (the summary fold in its epilogue) on the corpus wave",
                   lambda: dk.stage_dc(dt, tt, entries, k1=k1_wave), {"stage_dc": 1})
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


def stage_c_edge_maps(device) -> list:
    """Stage C's edge inputs: (label, maps (L, NT, 48) uint8, entry0 (L,)
    int32) at NT of 1, 3, 128, 384 and 4224 (P 270336: 9 segments of 512
    at 8 lanes), entry0 over every byte value (and -1, 1000) where the wave
    has 258 lanes, maps mixing [0, 48), 48..126, 127, 128..254 and 255,
    maps mostly outside the domain, one-lane waves (NT of 1, 2, 15, 17,
    511, 513, 4224 and every payload bucket's; states that turn
    127 or 255 inside a segment, a first segment that ends in 48..126), and
    maps not 16-byte aligned (the kernel's byte loads)."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import wave_prep as wp

    rng = np.random.default_rng(16)

    def maps_of(L, NT, out_share=0.02):
        m = rng.integers(0, 48, (L, NT, 48)).astype(np.uint8)
        u = rng.random(m.shape)
        m[u < 0.004] = 127
        m[(u >= 0.004) & (u < 0.007)] = 255
        lo = (u >= 0.007) & (u < 0.007 + out_share / 2)
        m[lo] = rng.integers(48, 127, int(lo.sum()))
        hi = (u >= 0.007 + out_share / 2) & (u < 0.007 + out_share)
        m[hi] = rng.integers(128, 255, int(hi.sum()))
        return m

    every = np.concatenate([np.arange(256), [-1, 1000]]).astype(np.int32)
    cases = [(f"NT={NT}, entry0 every byte", maps_of(258, NT), every) for NT in (1, 3, 128, 384)]
    cases.append(("NT=4224", maps_of(8, 4224), np.array([0, 1, 5, 47, 48, 127, 255, 7], np.int32)))
    dense = rng.choice(np.array([0, 1, 47, 48, 100, 126, 127, 128, 200, 254, 255], np.uint8), (16, 700, 48))
    cases.append(("dense sentinels and values outside the domain", dense, every[:16]))
    # One lane: NT of 1 and 2, the smallest segment length (16) - 1 and + 1,
    # 511 and 513 (32 segments of 16; 17 of 32, the last of one tile), 4224
    # and every payload bucket's NT (the continuous member's decode runs
    # waves of its blocks' bucket, 1152 tiles); each with a lane whose
    # state turns EOB and one whose state turns error inside a segment, and
    # one whose first segment ends in a state of 48..126 (every entry of
    # its last map 100).
    low = dk.STAGE_C_MIN_SEGMENT
    nts = sorted({1, 2, low - 1, low + 1, 511, 513, 4224, *(P // 64 for P in wp.P_BUCKETS_PALLAS)})
    for NT in nts:
        seg = dk.stage_c_segment(1, NT)
        m = np.concatenate([maps_of(1, NT), rng.integers(0, 48, (3, NT, 48)).astype(np.uint8)])
        inside = min(NT - 1, seg // 2 + 1)
        m[1, inside], m[2, inside], m[3, min(NT, seg) - 1] = 127, 255, 100
        for lane in range(4):
            cases.append((f"L=1 NT={NT} ({-(-NT // seg)} segments of {seg}), lane {lane}", m[lane : lane + 1],
                          np.array([5], np.int32)))
    out = [(label, torch.from_numpy(m).to(device), torch.from_numpy(e).to(device)) for label, m, e in cases]
    L, NT = 64, 384
    flat = torch.from_numpy(maps_of(L, NT).reshape(-1)).to(device)
    buf = torch.zeros(flat.numel() + 1, dtype=torch.uint8, device=device)
    buf[1:] = flat
    out.append(("maps not 16-byte aligned", buf[1:].view(L, NT, 48), torch.from_numpy(every[:L]).to(device)))
    return out


def phase_stage_c_edges(device, K: Kernels) -> None:
    """Stage C against its plain version on the edge maps."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    for label, maps, entry0 in stage_c_edge_maps(device):
        L, NT, _E = maps.shape
        K.compare("stage_c", lambda: dk.stage_c(maps, entry0), lambda: stage_c_plain3(maps, entry0), [maps, entry0],
                  {label: [L, NT]}, main_path=False)


def wave_summary_edge_rows(device) -> list:
    """(label, K3-like summary rows (L, 8, NT) int32, nlit or None) from a
    seed: a 1-lane wave of one tile and of 4224, the main path's widest
    wave (256 x 1152) with EOB and error hits, overflow in one lane only and
    in the last (a padding) lane only, rows over the whole int32 range (sums
    past int32, negative hit and overflow sums), nlit given."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import wave_prep as wp

    rng = np.random.default_rng(18)

    def rows(L, NT, *, eob=(), err=(), overflow=()):
        s = np.zeros((L, 8, NT), np.int32)
        s[:, wp.ROW_COUNT] = rng.integers(0, 177, (L, NT))
        s[:, wp.ROW_SIZE_SUM] = rng.integers(0, 60000, (L, NT))
        for lane in eob:
            t = int(rng.integers(0, NT))
            s[lane, wp.ROW_EOB_HIT, t], s[lane, wp.ROW_EOB_POS, t] = 1, rng.integers(0, wp.W_P)
            s[lane, wp.ROW_EOB_TOK, t] = -int(rng.integers(1, 16))
        for lane in err:
            t = int(rng.integers(0, NT))
            s[lane, wp.ROW_ERR_HIT, t], s[lane, wp.ROW_ERR_TOK, t] = 1, -(100 + int(rng.integers(0, 19)))
        for lane in overflow:
            s[lane, wp.ROW_OVERFLOW, int(rng.integers(0, NT))] = 1
        return torch.from_numpy(s).to(device)

    wild = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (7, 8, 300)).astype(np.int32)).to(device)
    wild[0] = (1 << 31) - 1
    wild[1, wp.ROW_EOB_HIT] = -1
    wild[2, wp.ROW_OVERFLOW] = -3
    nlit = torch.from_numpy(rng.integers(0, 1 << 20, 256).astype(np.int32)).to(device)
    return [
        ("1 lane x 1 tile", rows(1, 1, eob=(0,)), None),
        ("1 lane x 4224 tiles", rows(1, 4224, eob=(0,), err=(0,)), None),
        ("256 x 1152", rows(256, 1152, eob=range(0, 256, 2), err=range(1, 256, 3)), None),
        ("256 x 1152, nlit", rows(256, 1152, eob=range(256)), nlit),
        ("overflow in lane 3 only", rows(8, 37, eob=range(8), overflow=(3,)), None),
        ("overflow in the padding lane only", rows(8, 37, eob=range(7), overflow=(7,)), None),
        ("int32 range", wild, None),
        ("int32 range, nlit", wild, nlit[:7].contiguous()),
    ]


def phase_wave_summary_edges(device, K: Kernels) -> None:
    """The summary fold (K3's epilogue, run alone on given rows) against
    its plain version on the edge rows."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    for label, summ, nlit in wave_summary_edge_rows(device):
        K.compare("wave_summary", lambda: dk.wave_summary(summ, nlit), lambda: dk.wave_summary_plain(summ, nlit),
                  [summ] + ([] if nlit is None else [nlit]), {label: list(summ.shape)}, main_path=False)


def split_edge_streams(device) -> list:
    """(label, (L, K) int32 tokens, T) for the tile split's edges: one lane
    of 1024 tiles of 258-byte runs (every seam straddled, the last 32 bytes
    past tile 1023); straddlers as the last token of a scan segment and as
    the first of the next, a run ending on a seam at a segment's edge, -1
    runs over segment edges and other negative values mid-stream; T = 1 on
    streams of several tiles; tokens past T - 1; K = 0."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import resolve as rs

    M, N, SEG = rs.TOKEN_MATCH_BIT, rs.N_POS, rs.TILE_SPLIT_SEGMENT
    rng = np.random.default_rng(20)

    def m(run, d=0):
        return M | run << 16 | d

    def tail(n):  # random matches and literals
        return [m(int(r), int(d)) if r >= 3 else int(d) & 0xFF
                for r, d in zip(rng.integers(0, 259, n), rng.integers(0, 32768, n))]

    def batch(lanes, pad=0):
        K = max(len(x) for x in lanes) + pad
        out = np.full((len(lanes), K), -1, np.int64)
        for i, x in enumerate(lanes):
            out[i, : len(x)] = x
        return torch.from_numpy(out.astype(np.int32)).to(device)

    runs258 = [m(258, i & 0x7FFF) for i in range(N * 1024 // 258 + 1)]
    at_end = [m(16, 1)] * (SEG - 2) + [7, m(258, 2)] + tail(9000)  # straddler = token 4095
    at_start = [m(16, 1)] * (SEG - 1) + [7, m(258, 3)] + tail(9000)  # straddler = token 4096
    on_seam = [m(16, 1)] * (SEG - 2) + [m(32, 4)] + tail(9000)  # token 4094 ends on the seam
    holes = tail(12000)
    holes[8000:8000] = [-1] * 300 + [-5, -(1 << 31)]  # over the edge at 8192
    holes[SEG - 3 : SEG - 3] = [-1] * 7
    return [
        ("1 lane x 1024 tiles of 258-runs", batch([runs258]), 1024),
        ("straddlers and -1 runs on segment edges", batch([at_end, at_start, on_seam, holes], pad=100), 16),
        ("T = 1", batch([at_end, tail(3000), [5]]), 1),
        ("tokens past T - 1", batch([runs258[: 300000 // 258], tail(20000)]), 3),
        ("K = 0", torch.zeros((2, 0), dtype=torch.int32, device=device), 2),
    ]


def phase_split_edges(device, K: Kernels) -> None:
    """The tile split against its plain version on the edge streams."""
    from tpu_deflate_torch.codec import resolve as rs

    for label, tok, T in split_edge_streams(device):
        K.compare("tile_split", lambda: rs.split_tiles_device(tok, T), lambda: rs.split_tiles_plain(tok, T), [tok],
                  {label: list(tok.shape), "T": T}, main_path=False)


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
            K.compare("stage_dc", lambda: dk.stage_dc(d, tk, e, k1=k1), lambda: stage_dc_plain3(d, tk, e, k1),
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
    """K4, K7, K4's pull mode with the map (``compact_pack``) and without
    it (``pack_tokens``) against their plain versions on the main path's
    own waves of at most 4 lanes (K3's tokens at k1 104 and 512, the wave's
    planes), and on the edge lanes of compact_edge_lanes at M = 128, 1001,
    4099, 5120 and 8228 (M not a multiple of 4 takes scalar loads; 7 lanes
    take 1024-entry segments, 672 lanes 4096-entry ones) and once from a
    row that is not 16-byte aligned; ``compact_pack`` also on seam_lanes at
    M = 1001, 4099 and 9216 (7 and 672 lanes) and from a row not 16-byte
    aligned; ``pack_tokens`` also on pack_edge_lanes at M = 31, 1001, 4099
    and 8228 (11 and 704 lanes), one lane alone and a row not 16-byte
    aligned."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import wave_prep as wp

    def fused(what, tok, planes):
        vec = torch.zeros((7, tok.shape[0]), dtype=torch.int32, device=device)
        K.compare("compact_pack", lambda: dk.compact_pack(tok, planes, vec), lambda: dk.compact_pack_plain(tok, planes),
                  [tok, planes], {"edge": what, "tok": list(tok.shape)}, main_path=False)
        require(not vec[:6].any(), f"compact_pack wrote outside row 6 of the vector ({what})")

    cases = []
    for what, d, tk, e, planes in small:
        L, _, NT = d.shape
        for k1 in (104, wp.W_P):
            tokc, _summ, _vec = dk.stage_dc(d, tk, e, k1=k1)
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
        fused(what, tok, planes)
        K.compare("pack_tokens", lambda: dk.pack_tokens(tok), lambda: dk.pack_tokens_plain(tok), [tok],
                  {"edge": what, "tok": list(tok.shape)}, main_path=False)
    # The fused mode's bitmap seams: segments whose first slot is off a
    # word and runs of segments with no valid entry between two shared
    # words, in both segment sizes, and from a row not 16-byte aligned.
    for M in (1001, 4099, 9216):
        for L in (7, 672):
            tok, planes = seam_lanes(M, L, seed=M + L)
            fused(f"seam lanes M={M}", torch.from_numpy(tok).to(device), torch.from_numpy(planes).to(device))
    tok, planes = seam_lanes(9216, 7, seed=5)
    flat = torch.empty(tok.size + 1, dtype=torch.int32, device=device)
    fused("seam lanes, a row not 16-byte aligned", flat[1:].view(tok.shape).copy_(torch.from_numpy(tok)),
          torch.from_numpy(planes).to(device))
    # The pull alone on its own edge lanes (all literals, all matches, all
    # below 0, bit 31 of every bitmap word), M % 32 != 0, in both segment
    # sizes, one lane alone and a row that is not 16-byte aligned.
    for M in (31, 1001, 4099, 8228):
        lanes = pack_edge_lanes(M, seed=M)
        for reps in (1, 64):
            tok = torch.from_numpy(np.tile(lanes, (reps, 1))).to(device)
            K.compare("pack_tokens", lambda: dk.pack_tokens(tok), lambda: dk.pack_tokens_plain(tok), [tok],
                      {"pack edge lanes": list(tok.shape)}, main_path=False)
    lanes = pack_edge_lanes(5120, seed=9)
    flat = torch.empty(lanes.size + 1, dtype=torch.int32, device=device)
    for what, tok in (("one lane", torch.from_numpy(lanes[3:4].copy()).to(device)),
                      ("a row not 16-byte aligned", flat[1:].view(lanes.shape).copy_(torch.from_numpy(lanes)))):
        K.compare("pack_tokens", lambda: dk.pack_tokens(tok), lambda: dk.pack_tokens_plain(tok), [tok],
                  {"pack edge lanes": what, "tok": list(tok.shape)}, main_path=False)


def pack_edge_lanes(M: int, seed: int):
    """(L, M) int32 tokens for the pull alone (``pack_tokens``):
    compact_edge_lanes' lanes (literal ranks 0 and 255, match tokens of 256
    and more, -1, -2 and INT_MIN among them) and four more: every token a literal, every token
    a match, every token below 0, and literals at every 32nd token (bit 31
    of each bitmap word set)."""
    import numpy as np

    tok, _planes = compact_edge_lanes(M, 1, seed)
    rng = np.random.default_rng(seed + 1)
    extra = np.stack([rng.integers(0, 256, M), rng.integers(256, 1 << 27, M), np.full(M, -1),
                      np.where(np.arange(M) % 32 == 31, rng.integers(0, 256, M), rng.integers(256, 1 << 20, M))])
    return np.concatenate([tok, extra.astype(np.int32)])


def seam_lanes(M: int, L: int, seed: int):
    """(L, M) int32 tokens and (L, 64) int32 random literal planes for K4's
    pull mode, whose bitmap words at a segment's two ends are shared: every
    1024-entry block of a lane holds 0, 1, 5, 31, 33 or 37 valid entries
    (half of the blocks none) at random places among -1, -2 and INT_MIN,
    literal ranks and match tokens at random, so segments of 1024 and 4096
    entries start at slots that are not a multiple of 32, one word takes the
    bits of several segments, and runs of segments with no valid entry lie
    between two seam words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = rng.choice(np.array([-1, -1, -1, -2, -(2**31)]), (L, M))
    valid = np.where(rng.random((L, M)) < 0.5, rng.integers(0, 256, (L, M)), rng.integers(256, 1 << 27, (L, M)))
    counts = rng.choice(np.array([0, 0, 0, 0, 0, 1, 5, 31, 33, 37]), (L, -(-M // 1024)))
    for lane, b in zip(*np.nonzero(counts)):
        lo, hi = b * 1024, min(M, (b + 1) * 1024)
        pos = lo + rng.choice(hi - lo, min(int(counts[lane, b]), hi - lo), replace=False)
        tok[lane, pos] = valid[lane, pos]
    planes = rng.integers(-(2**31), 2**31, (L, 64), dtype=np.int64).astype(np.int32)
    return tok.astype(np.int32), planes


def route_edge_inputs(L: int, seed: int, final_kind: str = "none"):
    """NumPy arguments of ``encode.route`` for L lanes cycling through its
    edges: dynamic == fixed (a tie: DYNAMIC), stored == dynamic < fixed (a
    tie: not STORED), member lengths 0, 1 and 65535, lanes cheapest as
    FIXED, as DYNAMIC and as STORED; random codes and headers (uint32
    values, 0-16 bits a slot). Returns (the 14 arrays, final): ``final_kind``
    "none" (None), "zeros" (no lane final) or "mixed"."""
    import numpy as np

    from tpu_deflate_torch.codec import encode as pe

    rng = np.random.default_rng(seed)
    ll_hist = np.where(rng.random((L, 288)) < 0.4, 0, rng.integers(0, 400, (L, 288)))
    d_hist = rng.integers(0, 200, (L, 30))
    ll_len = rng.integers(1, 16, (L, 288))
    d_len = rng.integers(0, 16, (L, 30))
    sym, dsym = np.arange(288), np.arange(30)
    extras = ll_hist @ np.where((sym >= 265) & (sym <= 284), (sym - 261) >> 2, 0) + d_hist @ np.maximum(
        (dsym >> 1) - 1, 0)
    fix = np.where(sym < 144, 8, np.where(sym < 256, 9, np.where(sym < 280, 7, 8)))
    dyn0 = (ll_hist * ll_len).sum(1) + (d_hist * d_len).sum(1) + extras + ll_len[:, 256]
    fixed = 3 + ll_hist @ fix + 5 * d_hist.sum(1) + extras + 7
    kind = np.arange(L) % 8
    lengths = np.choose(kind, [65536, 100, 0, 1, 65535, 65536, 65536, 1000])
    stored = 8 * (lengths + 5 * (-(-lengths // 65535)) + 1)
    hdr = rng.integers(100, 4000, L)
    hdr = np.where(kind == 0, fixed - dyn0, hdr)  # dynamic == fixed
    hdr = np.where(kind == 1, stored - dyn0, hdr)  # dynamic == stored, below fixed
    hdr = np.where(kind == 5, fixed - dyn0 + 1000, hdr)  # FIXED
    hdr = np.where(kind == 6, fixed - dyn0 - 1000, hdr)  # DYNAMIC
    fl, fd = pe._fixed_code_tables()
    i32 = np.int32
    arrays = (ll_hist.astype(i32), d_hist.astype(i32), ll_len.astype(i32), d_len.astype(i32), hdr.astype(i32),
              lengths.astype(i32), rng.integers(-(2**31), 2**31, (L, 288)).astype(i32),
              rng.integers(-(2**31), 2**31, (L, 30)).astype(i32), rng.integers(0, 2**32, (L, 384)),
              rng.integers(0, 17, (L, 384)).astype(i32), rng.integers(0, 2**32, L), rng.integers(1, 16, L).astype(i32),
              fl, fd)
    final = {"none": None, "zeros": np.zeros(L, np.int64), "mixed": (np.arange(L) % 3 == 0).astype(np.int64)}
    return arrays, final[final_kind]


def header_eob_edge_inputs(L: int, seed: int):
    """NumPy arguments of ``emit.header_eob`` for L lanes: random body words
    (L, EMIT_WORDS); header slots of 0-32 bits (a fifth of them 0 bits with
    a value that must not be placed), every slot 32 bits and on a word in
    lanes 0, 6, 12, ..., every slot 1 bit in lanes 1, 7, ...; the EOB at the
    header's end, past it, straddling the grid's last word, at a random
    bit with 0 EOB bits (not placed), at the grid's last bit and past the
    grid (dropped)."""
    import numpy as np

    from tpu_deflate_torch.codec import emit as em

    rng = np.random.default_rng(seed)
    grid = 32 * em.EMIT_WORDS
    kind = np.arange(L) % 6
    hb = np.where(rng.random((L, 384)) < 0.2, 0, rng.integers(1, 33, (L, 384)))
    hb[kind == 0], hb[kind == 1] = 32, 1
    hv = rng.integers(0, 2**32, (L, 384))
    hv = np.where(hb > 0, hv & ((1 << hb) - 1), hv)
    eb = np.where(kind == 3, 0, rng.integers(4, 16, L))
    ev = rng.integers(0, 2**32, L) & ((1 << eb) - 1)
    total = hb.sum(1)
    body_end = np.choose(kind, [total, total + rng.integers(0, 500000, L), grid - 3, rng.integers(total, grid),
                                grid - 1, grid + 77])
    words = rng.integers(-(2**31), 2**31, (L, em.EMIT_WORDS)).astype(np.int32)
    return words, hv, hb.astype(np.int32), ev, eb.astype(np.int32), body_end.astype(np.int32)


EDGE_ROW = 4096 + 1024  # a short token row: K10's segment 0 and a last segment of one chunk


def random_tokens(rng, L: int, S: int) -> list:
    """Seven (L, S) int32 token fields of random literals and matches with
    their extra bits (a tenth of the positions no token)."""
    import numpy as np

    from tpu_deflate_torch.format.tables import LENGTH_EXTRA

    kind = rng.random((L, S))
    flags = np.where(kind < 0.1, 0, np.where(kind < 0.6, 1, 3))
    match = flags == 3
    msym = rng.integers(0, 29, (L, S))
    sym = np.where(match, 257 + msym, rng.integers(0, 256, (L, S)))
    leb = np.where(match, LENGTH_EXTRA[msym], 0)
    dsym = np.where(match, rng.integers(0, 30, (L, S)), 0)
    deb = np.where(match, np.maximum(dsym // 2 - 1, 0), 0)
    lev = rng.integers(0, 1 << 13, (L, S)) & ((1 << leb) - 1)
    dev = rng.integers(0, 1 << 13, (L, S)) & ((1 << deb) - 1)
    return [x.astype(np.int32) for x in (sym, flags, leb, lev, dsym, deb, dev)]


def routed_edge_lanes(L: int, seed: int, final_kind: str = "none") -> tuple:
    """NumPy arguments of ``emit.emit_routed`` for L lanes: the routing edges
    of :func:`route_edge_inputs` (ties, every strategy, member lengths 0, 1,
    65535 and 65536) on a short token row (:data:`EDGE_ROW` positions of
    random literals and matches), with code tables the emit can place
    (lengths 1-15, each code below its length) and the header's and EOB's
    values masked to their bits. The planned header's bits (``hdr_bits``,
    the costs' input) differ from the sum of its slots' bits (the header's
    length in the words), as they may in any call."""
    import numpy as np

    arrays, final = route_edge_inputs(L, seed, final_kind)
    ll_hist, d_hist, ll_len, d_len, hdr, lengths, _llc, _dc, hv, hb, ev, eb, fl, fd = arrays
    rng = np.random.default_rng(seed + 100)

    def codes(shape):
        n = rng.integers(1, 16, shape)
        return ((n << 16) | (rng.integers(0, 1 << 15, shape) & ((1 << n) - 1))).astype(np.int32)

    hv = hv & ((1 << hb) - 1)
    ev = ev & ((1 << eb) - 1)
    args = (*random_tokens(rng, L, EDGE_ROW), ll_hist, d_hist, ll_len, d_len, hdr, lengths, codes((L, 288)),
            codes((L, 30)), hv, hb, ev, eb, fl, fd)
    return args, final


def header_eob_edge_lanes(L: int, seed: int) -> tuple:
    """NumPy arguments of ``emit.emit_device`` for L lanes: the header and EOB
    edges of :func:`header_eob_edge_inputs` (32- and 1-bit slots, 0-bit
    slots whose values must not land, a 0-bit EOB) with each lane's body on
    a short token row (:data:`EDGE_ROW` positions) that ends where that
    function puts the EOB: at the header's end (an empty body), past it,
    straddling the grid's last word, at its last bit and past the grid.
    Every code is 1 bit; a body of n bits is the row's last min(n, S - 1)
    positions as literals and, for the rest, position 0 as a match whose
    length extra bits make up the difference (a slot of more than 31 bits:
    segment 0 on the direct path)."""
    import numpy as np

    _words, hv, hb, ev, eb, body_end = header_eob_edge_inputs(L, seed)
    rng = np.random.default_rng(seed + 200)
    S = EDGE_ROW
    need = body_end.astype(np.int64) - hb.sum(axis=1)
    require(bool((need >= 0).all()), "header/EOB edge lanes: a body end before the header's end")
    sym, flags, leb, lev, dsym, deb, dev = (np.zeros((L, S), np.int64) for _ in range(7))
    for lane in range(L):
        n_lit = int(min(need[lane], S - 1))
        rest = int(need[lane]) - n_lit
        flags[lane, S - n_lit :] = 1
        sym[lane, S - n_lit :] = rng.integers(0, 256, n_lit)
        if rest:
            flags[lane, 0], sym[lane, 0], leb[lane, 0] = 3, 257, rest - 1
            lev[lane, 0] = rng.integers(0, 1 << min(rest - 1, 31))
    ll = ((1 << 16) | (np.arange(288) & 1))[None, :].repeat(L, axis=0)
    fields = [x.astype(np.int32) for x in (sym, flags, leb, lev, dsym, deb, dev)]
    return (*fields, ll.astype(np.int32), np.zeros((L, 30), np.int32), hv, hb, ev, eb)


def emit_compare(K: Kernels, args: tuple, shapes: dict, main_path: bool = False) -> tuple:
    """The emit's one launch against its plain composition on the same
    arguments: ``emit_routed`` (22 arguments: the routing, K10's body,
    header and EOB) or ``emit_device`` (13: no routing). Nothing is
    written into the arguments, so both run on them as they are."""
    from tpu_deflate_torch.codec import emit as em

    kern, plain = (em.emit_routed, em.emit_routed_plain) if len(args) == 22 else (em.emit_device,
                                                                                  em.emit_device_plain)
    return K.compare("emit_body", lambda: kern(*args), lambda: plain(*args), tensors_of(args), shapes,
                     main_path=main_path)


def phase_plan_edges(device, K: Kernels) -> None:
    """The emit's one launch on the routing's edge lanes (ties, every
    strategy, lengths 0/1/65535/65536; final None, all 0 and mixed) and on
    the header/EOB's edge lanes (32- and 1-bit slots, 0-bit slots and
    EOBs, an EOB straddling the grid's end and one past it, an empty body,
    segment 0 on the direct path), each on a short token row."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import emit as em

    def on_card(arrays):
        return tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    for final_kind in ("none", "zeros", "mixed"):
        arrays, final = routed_edge_lanes(96, seed=len(final_kind), final_kind=final_kind)
        out = emit_compare(K, on_card((*arrays, final)), {"routing edge lanes": [96, EDGE_ROW], "final": final_kind})
        routes = np.bincount(out[2].cpu().numpy(), minlength=3).tolist()
        require(all(routes), f"routing edge lanes: routes {routes} (dynamic, fixed, stored), expected each")
    args = on_card(header_eob_edge_lanes(48, seed=5))
    _words, total = emit_compare(K, args, {"header/EOB edge lanes": [48, EDGE_ROW]})
    grid = 32 * em.EMIT_WORDS
    require(bool((total > grid).any()) and bool((total.to(torch.int64) - args[12] == args[10].sum(dim=1)).any()),
            "header/EOB edge lanes: no EOB past the grid or no empty body")
    log("the emit's one launch equal to its plain composition on the routing's and the header/EOB's edge lanes")


def phase_crc_edges(corpus: bytes, device, K: Kernels) -> None:
    """The lane CRC against its plain version on the encoder's first batch
    (64 members of 64 KiB), whose finished CRCs must equal zlib's, and on
    random rows of the narrowest and widest widths it takes; crc32_device
    against zlib."""
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
        require(cl.crc32_device(buf) == zlib.crc32(buf), f"crc32_device of {n} bytes differs from zlib")
        require(cl.crc32_device(buf[n // 2 :], zlib.crc32(buf[: n // 2])) == zlib.crc32(buf),
                f"crc32_device with an init value ({n} bytes) differs from zlib")
    log("crc32_device on the card equals zlib at 1, 1000, 65543 and 3145733 bytes (and chained across a "
        "split)")
    g = torch.Generator(device="cpu").manual_seed(41)
    for shape in ((L, 512), (4, 512 * 1024)):
        r = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(device)
        K.compare("crc32_lanes", lambda: cl.crc32_lanes_raw8(r), lambda: cl.crc32_lanes_raw8_plain(r), [r],
                  {"random rows": list(shape)}, main_path=False)


ADLER_SIZES = (1, 1000, MEMBER + 7, 3 * FOREIGN_BYTES + 5)
ADLER_BIG = (1 << 31) + 4099  # above 2**31 bytes: 64-bit indices and sums


def phase_adler(corpus: bytes, device, K: Kernels) -> dict:
    """Adler-32's sums (``checksum_lanes.adler_sums``) against their plain
    version at the four sizes of the CRC phase, at 15, 16, 17, 5552 and
    5553 bytes and from an address off 16 bytes; then the path: counts set
    to 0, ``adler32_device`` at the four sizes and on a buffer of more than
    2**31 bytes on the card (whole and from its second byte), each against
    zlib.adler32 alone (the plain version's int64 temporaries would not
    fit), one launch a call; the big buffer's sums timed beside their
    bound. Returns the path's launches."""
    import torch

    from tpu_deflate_torch import _build
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    bufs = [corpus[n : 2 * n] for n in ADLER_SIZES]
    for n, buf in zip(ADLER_SIZES, bufs):
        d = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(device)
        K.compare("adler_sums", lambda: cl.adler_sums(d), lambda: cl.adler_sums_plain(d), [d], {"bytes": n},
                  main_path=n == ADLER_SIZES[-1])
    for n in (15, 16, 17, 5552, 5553):
        d = torch.frombuffer(bytearray(corpus[:n + 3]), dtype=torch.uint8).to(device)
        for what, x in (("aligned", d[:n]), ("from byte 3", d[3:])):
            K.compare("adler_sums", lambda: cl.adler_sums(x), lambda: cl.adler_sums_plain(x), [x],
                      {"bytes": x.numel(), "start": what}, main_path=False)
    g = torch.Generator(device=device).manual_seed(20)
    big = torch.randint(0, 256, (ADLER_BIG,), generator=g, dtype=torch.uint8, device=device)
    host = big.cpu().numpy()
    torch.cuda.synchronize()
    _build.reset_launches()
    got = [cl.adler32_device(buf) for buf in bufs] + [cl.adler32_device(big), cl.adler32_device(big[1:])]
    launches = _build.all_launches()
    want = [zlib.adler32(buf) for buf in bufs] + [zlib.adler32(host), zlib.adler32(host[1:])]
    require(got == want, f"adler32_device differs from zlib: {got} against {want}")
    require(launches["adler_sums"] == len(want), f"adler32_device: {launches['adler_sums']} launches for {len(want)} "
            "calls")
    one_launch(f"adler_sums of {ADLER_BIG} bytes", lambda: cl.adler_sums(big), "adler_sums")
    ms = median_ms(lambda: cl.adler_sums(big), 5)
    bound_ms = ADLER_BIG / HBM_BYTES_PER_S * 1e3
    log(f"adler32_device equal to zlib at {list(ADLER_SIZES)} bytes and at {ADLER_BIG} bytes on the card (whole and "
        f"from its second byte), one launch a call; adler_sums of {ADLER_BIG} bytes {ms:.4f} ms "
        f"({ADLER_BIG / ms / 1e6:.1f} GB/s), bound {bound_ms:.4f} ms (bytes, {100 * bound_ms / ms:.1f} % of it) "
        f"({gpu_name_power()})")
    del big, host
    return launches


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


def phase_main_path(corpus: bytes, gz: bytes, n_huff: int, K: Kernels) -> tuple[dict, float]:
    """The decode's main path: launches, bounds, stage C held against its
    plain version on every wave of the run, timed runs."""
    import torch

    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2

    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "expand"), (rs, "sweep"), (cl, "crc32_lanes_raw8")]
    with recorded(*kernels) as (calls, shapes, order), captured((dk, "stage_c"), per_key=64) as caps, \
            folds_checked(K, "main path") as folds:
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
            require(launches[COUNTERS.get(k, k)] > 0, f"kernel {k} was not launched on the main path")
    require(stats["device_resolved"] == n_huff, "device_resolved != Huffman member count")
    require(stats["host_resolved"] == 0, "a Huffman member took the host route")
    require(len(caps["stage_c"]) == launches["stage_c"] == launches["stage_b"],
            f"stage C: {len(caps['stage_c'])} calls captured, {launches['stage_c']} launches, "
            f"{launches['stage_b']} of K2")
    require(len(folds) == launches["stage_dc"] == stats["waves"] and launches["wave_summary"] == 0,
            f"the summary fold: {len(folds)} K3 vectors checked, {launches['stage_dc']} launches of K3, "
            f"{launches['wave_summary']} of the fold alone, {stats['waves']} waves: expected K3's one a wave")
    replay_calls(caps, K, "main path")
    wave_launches(lambda: engine.decompress(gz, engine="cuda"), "main path")
    walls = timed_decode(gz, corpus, E2E_REPS)
    med = statistics.median(walls)
    log(f"main path {E2E_REPS} timed runs: median {med:.4f} s = {len(corpus) / med / 1e9:.4f} GB/s, "
        f"min {min(walls):.4f} s, max {max(walls):.4f} s")
    log(f"gpu: {gpu_name_power()}")
    return launches, med, bounds


def compact_pack_chain(tok, planes, small):
    """``decode_kernels.compact_pack`` by its plain chain on the card (K4's
    compaction and the pull as eager ops and two K7 launches, then the
    nlit copy into the vector): what a wave of the "off" route ran before
    the fused launch, for its launch counts."""
    from tpu_deflate_torch.codec import decode_kernels as dk

    bitmap, lit, match, nlit = dk.compact_pack_plain(tok, planes)
    small[6] = nlit
    return bitmap, lit, match, small[6]


def phase_off_route(corpus: bytes, gz: bytes, profile_dir: str | None, K: Kernels) -> dict:
    """The host-resolve route: the wave kernels with K4's pull mode as the
    wave's one compaction launch (``compact_pack``) at a smaller depth, the
    fused launch held against its plain version on every wave and the
    pulled vector against the plain fold with its nlit, its launches (one a
    wave; K4 alone only in a k1 = 512 rerun, K7 and the pull alone none),
    a decode's launches a wave with the plain chain and with the kernel
    (with a profile dir: then profiled, each fused launch's device time
    beside its bound), then timed at the main path's depth for
    comparison."""
    import torch

    import bench
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import wave_prep as wp
    from tpu_deflate_torch.config import DecoderConfig

    off = DecoderConfig(device_resolve="off")
    small = bench.make_corpus(OFF_CORPUS_MB)
    gz_small = native.compress_members_native(small)
    pack, wave_stages = pv2.compact_pack, pv2.wave_stages
    pulls, reruns = [], []

    def pack_spy(tok, planes, vec):
        out = pack(tok, planes, vec)
        # after the wave's K3 (the last vector checked); the inputs kept for
        # the plain version, which runs K7 and so after the counted run
        pulls.append((len(folds), tok.clone(), planes.clone(), out))
        calls["compact_pack"].append(tensor_bytes((tok, planes)) + tensor_bytes(out))
        shapes["compact_pack"].append(f"{list(tok.shape)}")
        order.append("compact_pack")
        return out

    def stages_spy(w, **kw):
        reruns.append(kw.get("k1") == wp.W_P)
        return wave_stages(w, **kw)

    pv2.compact_pack, pv2.wave_stages = pack_spy, stages_spy
    try:
        with recorded((dk, "compact_flat"), (dk, "compact_any")) as (calls, shapes, order), \
                folds_checked(K, "off route", keep=True) as folds:
            calls["compact_pack"], shapes["compact_pack"] = [], []
            dk.reset_launches()
            t0 = time.monotonic()
            out = engine.decompress(gz_small, engine="cuda", config=off)
            wall = time.monotonic() - t0
            launches = dict(dk.LAUNCHES)
    finally:
        pv2.compact_pack, pv2.wave_stages = pack, wave_stages
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == small, "device_resolve='off' output differs")
    log(f"off route ({OFF_CORPUS_MB} MiB): byte-exact, stats {json.dumps(stats)}, "
        f"launches {json.dumps(launches)}")
    for k in ("stage_a", "stage_b", "stage_c", "stage_dc", "compact_pack"):
        require(launches[k] > 0, f"kernel {k} was not launched on the off route")
    n_reruns = sum(reruns)
    require(len(pulls) == stats["waves"] == launches["compact_pack"] == launches["stage_dc"] - n_reruns
            and launches["compact_flat"] == n_reruns and launches["compact_any"] == launches["pack_tokens"] == 0,
            f"the off route: {len(pulls)} fused launches captured, {launches['compact_pack']} counted, "
            f"{launches['compact_flat']} of K4 alone ({n_reruns} k1 = 512 reruns), {launches['compact_any']} of K7 "
            f"and {launches['pack_tokens']} of the pull alone for {stats['waves']} waves: expected one compaction "
            f"launch a wave")
    for i, (n, tok, planes, got) in enumerate(pulls):
        want = dk.compact_pack_plain(tok, planes)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        r = K.rec.setdefault("compact_pack", {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"the off route's fused launch {i} {list(tok.shape)} differs from compact_pack_plain")
        summ, vec = folds[n - 1]  # the vector the route pulled: K3's, with nlit in row 6
        require(got[3].data_ptr() == vec[6].data_ptr() and torch.equal(vec, dk.wave_summary_plain(summ, want[3])),
                "the off route's vector differs from wave_summary_plain with nlit")
    log(f"off route: every wave's fused launch equal to compact_pack_plain and its pulled vector to "
        f"wave_summary_plain with its nlit ({len(pulls)} waves, tokens "
        f"{sorted({str(list(t.shape)) for _n, t, _p, _o in pulls})}; {n_reruns} k1 = 512 reruns)")
    _n, tok, planes, _o = pulls[0]
    vec = torch.zeros((7, tok.shape[0]), dtype=torch.int32, device=tok.device)
    K.compare("compact_pack", lambda: dk.compact_pack(tok, planes, vec), lambda: dk.compact_pack_plain(tok, planes),
              [tok, planes], {"off route wave": list(tok.shape)})
    flat = dk.compact_plain(tok, planes)  # what the pull alone took before the fold
    K.compare("pack_tokens", lambda: dk.pack_tokens(flat), lambda: dk.pack_tokens_plain(flat), [flat],
              {"off route wave, compacted": list(flat.shape)})
    for _n, t, p, _o in pulls:
        v = torch.zeros((7, t.shape[0]), dtype=torch.int32, device=t.device)
        one_launch(f"compact_pack, off route wave {list(t.shape)}", lambda: dk.compact_pack(t, p, v), "compact_pack")
    del folds, pulls, flat
    require(stats["device_resolved"] == 0 and launches["expand"] == 0, "off route resolved on device")
    for what, fn in (("plain chain", compact_pack_chain), ("fused launch", dk.compact_pack)):
        pv2.compact_pack = fn
        try:
            wave_launches(lambda: engine.decompress(gz_small, engine="cuda", config=off), f"off route, {what}")
        finally:
            pv2.compact_pack = pack
    if profile_dir:
        phase_profile(lambda: engine.decompress(gz_small, engine="cuda", config=off), "off route",
                      profile_dir, "profile_off", OFF_PROFILE_KERNELS, wall, launch_bounds(calls, shapes, order))
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


BIG_KERNELS = ("stage_a_tables", "stage_a", "stage_b", "stage_c", "stage_dc", "compact_flat", "tile_split",
               "expand", "sweep", "crc32_lanes")


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
    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "split_tiles_device"), (rs, "expand"), (rs, "sweep"),
               (cl, "crc32_lanes_raw8")]
    with recorded(*kernels) as (calls, shapes, order), captured(*kernels) as caps, \
            folds_checked(K, "big members") as folds:
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
    require(launches["compact_any"] == launches["pack_tokens"] == launches["compact_pack"] == 0,
            "the big-members route launched K7 or the pull")
    require(len(folds) == launches["stage_dc"] == stats["waves"], "the big members: not one K3 fold a wave")
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
        above = split_peak - tiles.numel() * 4
        log(f"big members, T={T}: {len(group)} lanes x {tok.shape[1]} token slots: split on the card equals "
            f"split_tokens_tiles, chained CRCs equal zlib; split {split_ms:.4f} ms (CUDA events, median of "
            f"{SPLIT_REPS}), summary rows 3 (residue) {int(summs[:, :, 3].sum())}; the split's device memory "
            f"peak {split_peak} bytes for {n_tok} tokens ({split_peak / max(n_tok, 1):.1f} bytes a token, "
            f"its output of {tiles.numel() * 4} bytes included; {above} bytes above its output, "
            f"{above / max(n_tok, 1):.4f} bytes a token)")
        K.compare("tile_split", lambda: rs.split_tiles_device(tok, T), lambda: rs.split_tiles_plain(tok, T), [tok],
                  {"big members": list(tok.shape), "T": T}, main_path=T == 16)
        events = launch_profile(f"split_tiles_device, big members T={T}", lambda: rs.split_tiles_device(tok, T),
                                {"tile_split": 1})
        us = {e.name: e.time_range.elapsed_us() for e in events if "split_" in e.name}
        log(f"big members, T={T}: the split's kernels' device time in one call {json.dumps(us)} us "
            f"(profiler; {sum(us.values()):.1f} us in all)")

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
        k7 = dk.LAUNCHES["compact_any"] + dk.LAUNCHES["pack_tokens"] + dk.LAUNCHES["compact_pack"]
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
        averages = phase_profile(run, label, profile_dir, prefix, ("split_kernel", "expand_kernel", "sweep_kernel",
                                                                   "crc32_lanes_kernel"), timed_median_s, bounds)
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
    from tpu_deflate_torch.codec import encode as pe
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    # wrapper -> (its kernel's name in the kernels line, module, plain version, projection)
    plains = {
        "stage_a_tables": ("stage_a_tables", dk, dk.stage_a_tables_plain, None),
        "stage_a": ("stage_a", dk, dk.stage_a_plain, None),
        "stage_b": ("stage_b", dk, dk.stage_b_plain, None),
        "stage_c": ("stage_c", dk, stage_c_plain3, None),
        "stage_dc": ("stage_dc", dk, lambda d, t, e, *, k1: stage_dc_plain3(d, t, e, k1), None),
        "compact_flat": ("compact_flat", dk, dk.compact_plain, None),
        "expand": ("expand", rs, lambda tok, *, hist=0: rs.expand_plain(tok, hist), None),
        "sweep": ("sweep", rs, rs.sweep_plain, lambda out: (out[0], out[1][:, 0])),
        "crc32_lanes_raw8": ("crc32_lanes", cl, cl.crc32_lanes_raw8_plain, None),
        "parse_transfers": ("parse_transfers", pp, pp.parse_transfers_plain, None),
        "parse_replay": ("parse_replay", pp, pp.parse_replay_plain, None),
        "emit_routed": ("emit_body", em, em.emit_routed_plain, None),
        "match_keys": ("match_keys", pe, pe._match_keys_plain, None),
        "match_chain": ("match_chain", pe, pe._match_chain_plain, int32_parts),
        "match_bucket": ("match_bucket", pe, pe._bucket_best_plain, None),
        "match_select": ("match_select", pe, pe._match_select_plain, None),
        "_finish_analysis": ("finish_analysis", pe, finish_plain, finish_parts),
        "split_tiles_device": ("tile_split", rs, rs.split_tiles_plain, None),
        "wave_summary": ("wave_summary", dk, dk.wave_summary_plain, None),
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


HOST_BYTES = 256 << 10  # the host encoder's streams at efforts 0-2 and FULL_STATIC
HOST_E5_BYTES = 64 << 10  # effort 5 (about 0.2 MB/s on the host)
HOST_PROFILE_BYTES = 4 << 20
HOST_CATALOG_BYTES = 2 << 20
HOST_ZLIB_BYTES = 1 << 20
HOST_BAD_MEMBER = 5


def phase_host_codec(corpus: bytes, device) -> dict:
    """The host codec (the one-shot API's host engine, the streams) with the
    card's front doors: the host encoder's gzip streams decoded on the card
    as written (no member index: the C core) and with their DEFLATE payload
    under the TD member index (the wave kernels; each Huffman stream must
    take K1 launches), raw DEFLATE through ``inflate_raw_v2``, the profile
    encoder's members on the main path, the card's encode read back by
    ``GzipReader`` and by the member catalog on the card (``read_range``,
    ``resume_point``, ``decode_all(on_error="skip")`` on a copy with one
    member corrupted), a host zlib stream through ``zlib_decompress`` on the
    card, Python's zlib and ``adler32_device``, and the one-shot API on its
    default engine, the card (:func:`oneshot_on_card`). Each step's seconds
    are printed. Returns the phase's launches."""
    import io

    import tpu_deflate_torch as td
    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.catalog import MemberCatalog
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec.profile import profile_compress_host
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    card = gpu_name_power()

    def timed(fn):
        t0 = time.monotonic()
        out = fn()
        return out, time.monotonic() - t0

    _build.reset_launches()
    data = corpus[:HOST_BYTES]
    streams = [(f"effort {e}", data, {"effort": e}) for e in (0, 1, 2)]
    streams += [("effort 5", corpus[:HOST_E5_BYTES], {"effort": 5}), ("FULL_STATIC", data, {"strategy": td.FULL_STATIC})]
    raws = {}
    for label, src, kw in streams:
        gz, t_enc = timed(lambda: td.gzip_compress(src, engine="host", **kw))
        out, t_dec = timed(lambda: engine.decompress(gz, engine="cuda"))
        require(out == src, f"host encoder, {label}: the card's decode of the stream differs")
        raws[label] = gz[10:-8]  # the default header is 10 bytes
        member = td_member(raws[label], len(src), zlib.crc32(src))
        before = dk.LAUNCHES["stage_a"]
        out, t_td = timed(lambda: engine.decompress(member, engine="cuda"))
        stage_a = dk.LAUNCHES["stage_a"] - before
        stats = dict(pv2.LAST_DECODE_STATS)
        require(out == src, f"host encoder, {label}: the card's decode under the TD index differs")
        huffman = stats["stored"] == 0
        require(stage_a > 0 if huffman else stage_a == 0,
                f"host encoder, {label}: {stage_a} stage_a launches for a {'Huffman' if huffman else 'stored'} member")
        log(f"host codec: gzip_compress({len(src)} bytes, {label}) {len(gz)} bytes in {t_enc:.3f} s; the card's "
            f"decode {t_dec:.3f} s as written (no index: the C core), {t_td:.3f} s under the TD index "
            f"(stage_a launches {stage_a}, device_resolved {stats['device_resolved']}, stored {stats['stored']}, "
            f"waves {stats['waves']}); byte-exact ({card})")

    raw, t_enc = timed(lambda: td.deflate(data, effort=1, engine="host"))
    for label, r, src in (("deflate effort 1", raw, data), ("effort 5's payload", raws["effort 5"],
                                                            corpus[:HOST_E5_BYTES])):
        before = dk.LAUNCHES["stage_a"]
        out, t_dec = timed(lambda: pv2.inflate_raw_v2(r, device=device))
        require(out == src and dk.LAUNCHES["stage_a"] > before, f"raw DEFLATE ({label}) through inflate_raw_v2")
        log(f"host codec: raw DEFLATE ({label}, {len(r)} bytes) through inflate_raw_v2 on the card in {t_dec:.3f} s, "
            f"{dk.LAUNCHES['stage_a'] - before} stage_a launches; byte-exact (deflate {t_enc:.3f} s) ({card})")

    src = corpus[:HOST_PROFILE_BYTES]
    pm, t_enc = timed(lambda: profile_compress_host(src))
    before = dk.LAUNCHES["stage_a"]
    out, t_dec = timed(lambda: engine.decompress(pm, engine="cuda"))
    stats = dict(pv2.LAST_DECODE_STATS)
    require(out == src, "profile_compress_host's members: the card's decode differs")
    require(stats["members"] == len(src) // MEMBER and stats["device_resolved"] == stats["members"] - stats["stored"]
            and dk.LAUNCHES["stage_a"] > before, f"profile_compress_host's members off the main path: {stats}")
    log(f"host codec: profile_compress_host({len(src)} bytes) {len(pm)} bytes in {t_enc:.3f} s; the card's decode "
        f"{t_dec:.3f} s, {stats['members']} members, device_resolved {stats['device_resolved']}, stored "
        f"{stats['stored']}, {dk.LAUNCHES['stage_a'] - before} stage_a launches; byte-exact ({card})")

    src = corpus[:HOST_CATALOG_BYTES]
    gz, t_enc = timed(lambda: engine.compress(src, engine="cuda"))
    out, t_read = timed(lambda: td.GzipReader(io.BytesIO(gz), multi_member=True).read())
    require(out == src, "GzipReader of the card's encode differs")
    cat, t_cat = timed(lambda: MemberCatalog(gz))
    require(len(cat.entries) == len(src) // MEMBER and cat.total_uncompressed == len(src), "catalog of the card's encode")
    ranges = ((1000, 5000), (3 * MEMBER - 100, 4 * MEMBER + 100), (len(src) - 12345, 1 << 40))
    for a, b in ranges:
        got, t = timed(lambda: cat.read_range(a, b))
        require(got == src[a:b], f"MemberCatalog.read_range({a}, {b}) differs")
        log(f"host codec: MemberCatalog.read_range({a}, {b}) of the card's encode: {len(got)} bytes in {t:.4f} s; "
            f"byte-exact ({card})")
    done = 7 * MEMBER + 17
    start, out_start = cat.resume_point(done)
    out, t_res = timed(lambda: engine.decompress(gz[start:], engine="cuda"))
    require(out_start == 7 * MEMBER and start == cat.entries[7].index.start and out == src[out_start:],
            f"resume_point({done}) = ({start}, {out_start})")
    bad = bytearray(gz)
    bad[cat.entries[HOST_BAD_MEMBER].index.payload_start + 100] ^= 0x5A
    (out, bad_members), t_skip = timed(lambda: MemberCatalog(bytes(bad)).decode_all(on_error="skip"))
    lo, hi = HOST_BAD_MEMBER * MEMBER, (HOST_BAD_MEMBER + 1) * MEMBER
    require(bad_members == [HOST_BAD_MEMBER] and out == src[:lo] + src[hi:],
            f"decode_all(on_error='skip') reported {bad_members}, expected [{HOST_BAD_MEMBER}]")
    log(f"host codec: engine.compress({len(src)} bytes) on the card in {t_enc:.3f} s; GzipReader read it back in "
        f"{t_read:.3f} s, the catalog of {len(cat.entries)} members in {t_cat:.4f} s (its decodes on the card), resume_point({done}) = "
        f"({start}, {out_start}) and the card's decode from there in {t_res:.3f} s; decode_all(on_error='skip') "
        f"with member {HOST_BAD_MEMBER} corrupted reported {bad_members} in {t_skip:.3f} s; byte-exact ({card})")

    src = corpus[:HOST_ZLIB_BYTES]
    z, t_enc = timed(lambda: td.zlib_compress(src, effort=1, engine="host"))
    before = dict(dk.LAUNCHES)
    out, t_dec = timed(lambda: td.zlib_decompress(z))
    require(out == src and zlib.decompress(z) == src, "zlib_compress's stream does not round-trip")
    require(dk.LAUNCHES["stage_a"] > before["stage_a"] and dk.LAUNCHES["adler_sums"] == before["adler_sums"] + 1,
            "zlib_decompress did not decode on the card")
    before = dk.LAUNCHES["adler_sums"]
    ad, t_ad = timed(lambda: cl.adler32_device(src, device=device))
    trailer = int.from_bytes(z[-4:], "big")
    require(ad == trailer == zlib.adler32(src) and dk.LAUNCHES["adler_sums"] == before + 1,
            f"zlib trailer {trailer:#010x}, adler32_device {ad:#010x}")
    log(f"host codec: zlib_compress({len(src)} bytes, effort 1, the host engine) {len(z)} bytes in {t_enc:.3f} s, "
        f"zlib_decompress on the card {t_dec:.3f} s, Python's zlib reads it; its trailer {trailer:#010x} equals "
        f"adler32_device's on the card ({t_ad:.4f} s, one launch) ({card})")
    oneshot_on_card(corpus[:HOST_BYTES], card)
    return _build.all_launches()


def oneshot_on_card(src: bytes, card: str) -> None:
    """The one-shot API on its default engine, the card: each encode read by
    Python's gzip or zlib and by the card's one-shot decode, the first member
    alone with ``multi_member=False``; each step's seconds printed."""
    import tpu_deflate_torch as td
    from tpu_deflate_torch import _build
    from tpu_deflate_torch.codec import decode_kernels as dk

    enc = dict(_build.ENCODE_LAUNCHES)
    t0 = time.monotonic()
    gz, raw, z = td.gzip_compress(src), td.deflate(src, effort=4), td.zlib_compress(src, effort=4)
    t_enc = time.monotonic() - t0
    require(all(_build.ENCODE_LAUNCHES[k] > enc[k] for k in ("emit_body", "match_select")),
            "the one-shot encodes did not run on the card")
    require(gzip.decompress(gz) == zlib.decompress(raw, -15) == zlib.decompress(z) == src,
            "the one-shot encodes on the card: Python's gzip/zlib read other bytes")
    before = dk.LAUNCHES["stage_a"]
    t0 = time.monotonic()
    outs = (td.gzip_decompress(gz), td.gzip_decompress(gz, multi_member=False), td.zlib_decompress(z))
    t_dec = time.monotonic() - t0
    require(outs == (src, src[:MEMBER], src) and dk.LAUNCHES["stage_a"] > before,
            "the one-shot decodes on the card differ")
    log(f"host codec: the one-shot API on the card, {len(src)} bytes: gzip_compress (effort 2) {len(gz)}, deflate "
        f"and zlib_compress (effort 4) {len(raw)} and {len(z)} bytes, {t_enc:.3f} s for the three; gzip_decompress "
        f"(all members, the first member alone) and zlib_decompress {t_dec:.3f} s for the three; byte-exact ({card})")


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
    parse, quality 0): the parse's step tiles, the host entries, the
    emit's arguments (``emit.emit_routed``'s) and the batch's rows and
    lengths."""
    import numpy as np

    from tpu_deflate_torch.codec import encode as pe

    pend = pe._dispatch_analyze(np.frombuffer(data, np.uint8), True, 0, device)
    args, tiles, entries = pe.emit_inputs(pend)
    return {"tiles": tiles, "entries": entries, "args": args, "rows": pend[0], "lengths": pend[5]}


def unrouted(args: tuple) -> tuple:
    """``emit.emit_routed``'s arguments -> ``emit.emit_device``'s: the token
    fields and the tables, header and EOB that the routing gives each lane
    (``route_plain``)."""
    from tpu_deflate_torch.codec import emit as em

    return (*args[:7], *em.route_plain(*args[7:])[:6])


@contextlib.contextmanager
def emits_checked(K: Kernels, label: str):
    """Wrap ``emit.emit_routed`` and ``emit.emit_device`` for the block: each
    call held equal to its plain composition on the same arguments as it
    returns (exact), its max_abs_err kept under ``emit_body``. Yields
    {wrapper: calls checked}."""
    import torch

    from tpu_deflate_torch.codec import emit as em

    saved = {"emit_routed": (em.emit_routed, em.emit_routed_plain),
             "emit_device": (em.emit_device, em.emit_device_plain)}
    seen = {name: 0 for name in saved}

    def wrap(name, kern, plain):
        def wrapper(*args):
            got = kern(*args)
            want = plain(*args)
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            r = K.rec.setdefault("emit_body", {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{label}: {name} differs from its plain composition at {list(args[0].shape)}")
            seen[name] += 1
            return got
        return wrapper

    for name, (kern, plain) in saved.items():
        setattr(em, name, wrap(name, kern, plain))
    try:
        yield seen
    finally:
        for name, (kern, _plain) in saved.items():
            setattr(em, name, kern)
    log(f"{label}: the emit's one launch equal to its plain composition on all {seen['emit_routed']} routed and "
        f"{seen['emit_device']} unrouted calls")


def emit_launches(launches: dict, batches: int, label: str) -> None:
    """One emit launch a batch, the routing and the header/EOB inside it:
    no launch of a kernel of their own."""
    require(launches["emit_body"] == batches and not set(FOLDED) & {k for k, n in launches.items() if n},
            f"{label}: {launches['emit_body']} emit launches for {batches} batches, "
            f"{ {k: launches.get(k, 0) for k in FOLDED} } of the routing and the header/EOB alone")


def plan_launches(fn, label: str, batches: int) -> None:
    """One call of fn (an encode of ``batches`` lane batches, ``call_record``):
    the port's kernel launches (one emit launch a batch, no routing or
    header/EOB launch of its own), the aten ops that launch device work and
    the device events, in all and a batch."""
    import collections

    launches, ops, events = call_record(fn)
    emit_launches(collections.defaultdict(int, launches), batches, label)
    device_ops = collections.Counter({op: n for op, n in ops.items() if op not in NO_LAUNCH_OPS})
    n_ports, n_ops = sum(launches.values()), sum(device_ops.values())
    a_batch = {k: round(n / batches, 2) for k, n in launches.items()}
    log(f"{label}: {n_ports} launches of the port's kernels ({n_ports / batches:.2f} a batch: "
        f"{json.dumps(a_batch)}; {json.dumps({k: 0 for k in FOLDED})}), "
        f"{n_ops} aten ops that launch device work ({n_ops / batches:.2f} a batch; most "
        f"{json.dumps(dict(device_ops.most_common(8)))}), "
        + (f"{len(events)} device events ({len(events) / batches:.2f} a batch)" if events
           else "device events not recorded") + f" ({gpu_name_power()})")


def int32_parts(out: tuple) -> tuple:
    """uint16 outputs as int32, for the comparisons (``torch.equal`` and the
    error take every dtype of the other kernels)."""
    import torch

    return tuple(t.to(torch.int32) for t in out)


def match_kernels(K: Kernels, what: str, data, lengths, quality: int, lazy: bool, hist=None, hstart=None,
                  main_path: bool = False):
    """The match finder's kernels against their plain versions on one
    batch, exact equality: the hash families' keys, their same-hash links,
    every family's candidate compare along the links, then the selection.
    Returns (use, dist, step, valid) and the links."""
    from tpu_deflate_torch.codec import encode as pe

    q = pe._QUALITY[quality]
    L, S = data.shape
    shapes = {what: [L, S], "quality": quality, "lazy": lazy, "history": hist is not None}
    fams = [(family, q[k], q[w]) for family, k, w in pe._FAMILIES if k in q]
    families = tuple(f for f, _k, _w in fams)
    masks = [t for t in (hstart,) if t is not None]
    (keys,) = K.compare("match_keys", lambda: pe.match_keys(data, lengths, families, hstart),
                        lambda: pe._match_keys_plain(data, lengths, families, hstart), [data, lengths, *masks],
                        {**shapes, "families": families}, main_path=main_path)
    (prev,) = K.compare("match_chain", lambda: pe.match_chain(keys), lambda: pe._match_chain_plain(keys), [keys],
                        {**shapes, "families": families}, main_path=main_path, proj=int32_parts)
    del keys
    args = (prev, data, tuple(k for _f, k, _w in fams), tuple(w for _f, _k, w in fams))
    (packs,) = K.compare("match_bucket", lambda: pe.match_bucket(*args), lambda: pe._bucket_best_plain(*args),
                         [prev, data], {**shapes, "K": args[2], "words": args[3]}, main_path=main_path)
    args = (data, lengths, lazy, packs[0], packs[1], packs[2] if len(fams) == 3 else None, hist, hstart)
    out = K.compare("match_select", lambda: pe.match_select(*args), lambda: pe._match_select_plain(*args),
                    [a for a in args if hasattr(a, "element_size")], shapes, main_path=main_path)
    return out, prev


MATCH_REPEATS = ((100, 32768), (5000, 32769))  # (source column, distance): the lone repeats of edge lane 2


def match_edge_rows(corpus: bytes, device) -> tuple:
    """The match finder's edge rows (8 x 65536, from a seed and the corpus):
    zeros, random bytes, random bytes with a lone 16-byte repeat at distance
    32768 and one at 32769, text of length 1000, 0 and 1 (the rest of the
    row is the lane's own padding), runs of length 40000 and records. Returns
    (data, lengths, hist, hstart): the history masks of a continuous batch
    (hist 32768; hstart 0, 12345 or 32768) for the same rows."""
    import numpy as np
    import torch

    mib = 1 << 20
    flat = np.frombuffer(corpus, np.uint8)
    rng = np.random.default_rng(41)
    rows = np.zeros((8, MEMBER), np.uint8)
    rows[1] = rng.integers(0, 256, MEMBER, dtype=np.uint8)
    rows[2] = rng.integers(0, 256, MEMBER, dtype=np.uint8)
    for src, dist in MATCH_REPEATS:
        rows[2, src + dist : src + dist + 16] = rows[2, src : src + 16]
    for lane in (3, 4, 5):
        rows[lane] = flat[lane * MEMBER :][:MEMBER]
    rows[6] = flat[24 * mib :][:MEMBER]
    rows[7] = flat[12 * mib :][:MEMBER]
    lengths = np.array([MEMBER, MEMBER, MEMBER, 1000, 0, 1, 40000, MEMBER], np.int32)
    hstart = np.array([0, 0, 0, 12345, 32768, 32768, 0, 32768], np.int32)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(rows), put(lengths), put(np.full(8, 32768, np.int32)), put(hstart)


RECUR = ((1000, 65536), (3000, 65537), (5000, 32768), (7000, 32769))  # (column, apart) of lane 0's patterns
RECORD = 48  # bytes of a record of lane 1: a fixed 40-byte head, then 8 random bytes


def match_long_rows(device) -> tuple:
    """The match finder's long edge rows (8 x 98304, from a seed): lane 0
    zeros but for four 4-byte patterns, each twice, 65536, 65537, 32768
    and 32769 columns apart (their windows' hashes recur with nothing in
    between); lane 1 records whose 40-byte heads repeat every 48 bytes
    (same-hash groups of ~680 within reach, every match 40-47 bytes, short
    of the 64-byte cap at K4 = 32, W4 = 16, so no early exit); lane 2
    zeros; lanes 3-5 text of length 0, 1 and 3; lane 6 random bytes; lane
    7 records. Returns (data, lengths, hist, hstart), the history masks
    with hstart 0, 12345 or 32768."""
    import numpy as np
    import torch

    rng = np.random.default_rng(45)
    S = 98304
    rows = np.zeros((8, S), np.uint8)
    for (col, apart), pattern in zip(RECUR, rng.integers(1, 256, (len(RECUR), 4), dtype=np.uint8)):
        rows[0, col : col + 4] = rows[0, col + apart : col + apart + 4] = pattern
    head = rng.integers(0, 256, RECORD - 8, dtype=np.uint8)
    for lane in (1, 7):
        rec = np.tile(np.concatenate([head, np.zeros(8, np.uint8)]), S // RECORD).reshape(-1, RECORD)
        rec[:, RECORD - 8 :] = rng.integers(0, 256, (rec.shape[0], 8), dtype=np.uint8)
        rows[lane] = rec.reshape(-1)
    rows[3:6] = rng.integers(32, 127, (3, S), dtype=np.uint8)
    rows[6] = rng.integers(0, 256, S, dtype=np.uint8)
    lengths = np.array([S, S, S, 0, 1, 3, S, S - 1000], np.int32)
    hstart = np.array([0, 0, 32768, 32768, 12345, 0, 12345, 32768], np.int32)
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return put(rows), put(lengths), put(np.full(8, 32768, np.int32)), put(hstart)


def phase_match_edges(corpus: bytes, device, K: Kernels) -> None:
    """The match finder's kernels on the edge rows at qualities 0, 1 and 2,
    lazy on and off, without and with the history masks; the repeat at
    distance 32768 found and the one at 32769 not; the long rows (lanes of
    98304 columns; patterns recurring 65536 and 65537 apart must have no
    link, 32768 apart a link of 32768); then the worst cases of the
    candidate compare: 64 rows of zeros at quality 2 with history (64 x
    98304, one hash group throughout: every candidate matches the cap) and
    64 rows of records at quality 1 with history (long groups whose
    matches stop short of the cap: every position takes all K4 = 32 hops),
    and 64 rows of random bytes at quality 0."""
    import torch

    from tpu_deflate_torch.codec import encode as pe

    data, lengths, hist, hstart = match_edge_rows(corpus, device)
    for quality, lazy in ((0, False), (0, True), (1, True), (2, True), (2, False)):
        (use, dist, _step, _valid), _prev = match_kernels(K, "edge rows", data, lengths, quality, lazy)
        for src, d in MATCH_REPEATS:
            found = int(dist[2, src + d]) == d and int(use[2, src + d]) >= 16
            require(found == (d <= 32768), f"edge rows, quality {quality}: the repeat at distance {d}")
        match_kernels(K, "edge rows", data, lengths, quality, lazy, hist, hstart)
    data, lengths, hist, hstart = match_long_rows(device)
    for quality, lazy in ((0, True), (1, False), (2, True)):
        _out, prev = match_kernels(K, "long rows", data, lengths, quality, lazy)
        links = {apart: int(prev[0, 0, col + apart]) for col, apart in RECUR}
        require(links == {65536: 0, 65537: 0, 32768: 32768, 32769: 0},
                f"long rows, quality {quality}: the 4-byte links of the recurring patterns {links}")
        match_kernels(K, "long rows", data, lengths, quality, lazy, hist, hstart)
    L = pe.ENC_LANE_BATCH
    zeros = torch.zeros((L, 98304), dtype=torch.uint8, device=device)
    full = torch.full((L,), 98304, dtype=torch.int32, device=device)
    half = torch.full((L,), 32768, dtype=torch.int32, device=device)
    match_kernels(K, "zeros", zeros, full, 2, True, half, torch.zeros_like(half))
    records = data[1].expand(L, -1).contiguous()
    match_kernels(K, "records", records, full, 1, True, half, torch.zeros_like(half))
    g = torch.Generator(device="cpu").manual_seed(43)
    rand = torch.randint(0, 256, (L, MEMBER), generator=g, dtype=torch.uint8).to(device)
    match_kernels(K, "random", rand, full.clamp(max=MEMBER), 0, True)
    log("match finder: edge rows equal to their plain versions at qualities 0-2; the repeat at distance 32768 "
        "found, the one at 32769 not; no link across 65536 or 65537 columns")
    match_keys_edges(corpus, device, K)


def match_keys_edges(corpus: bytes, device, K: Kernels) -> None:
    """``match_keys`` at the edges of its vector path: rows sliced one byte
    into a buffer (not 4-byte aligned: the byte path), S of 65535, 4097
    and 23 (not a multiple of 4 or 16: the byte path), S of 4100 and 4112
    (a multiple of 4 and 16 ending inside a warp's runs: the vector path,
    its last words from past S); F = 1 (each family alone) and 3, with and
    without hstart."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import encode as pe

    flat = np.frombuffer(corpus, np.uint8)
    rng = np.random.default_rng(17)
    L = 8
    for S in (65536, 65535, 4112, 4100, 4097, 23):
        rows = flat[: L * S].reshape(L, S).copy()
        rows[1] = rng.integers(0, 256, S, dtype=np.uint8)
        rows[2] = 0
        lengths = torch.from_numpy(np.array([S, S, S, 0, 1, S - 1, S // 2, S], np.int32)).to(device)
        hstart = torch.from_numpy(np.array([0, 0, 5, 0, 0, 3, S // 3, S], np.int32)).to(device)
        buf = torch.zeros(L * S + 1, dtype=torch.uint8, device=device)
        buf[1:] = torch.from_numpy(rows.reshape(-1)).to(device)
        for layout, data in (("aligned", buf[1:].clone().view(L, S)), ("1 byte into a buffer", buf[1:].view(L, S))):
            for families in ((pe.FAMILY_4,), (pe.FAMILY_3,), (pe.FAMILY_6,), (pe.FAMILY_4, pe.FAMILY_3, pe.FAMILY_6)):
                for hs in (None, hstart):
                    K.compare("match_keys", lambda: pe.match_keys(data, lengths, families, hs),
                              lambda: pe._match_keys_plain(data, lengths, families, hs),
                              [data, lengths, *([] if hs is None else [hs])],
                              {"edge": layout, "keys": [L, S], "families": families, "hstart": hs is not None},
                              main_path=False)
    log("match_keys: rows not 4-byte aligned, S not a multiple of 16 and F = 1 and 3 equal to the plain version")


def match_finder_profile(label: str, data, lengths, lazy: bool, quality: int, hist=None, hstart=None) -> None:
    """One batch of the match finder (``encode._match_find``) on the card:
    its launches (``launch_profile``: exactly one of each of its four
    kernels and no other device work) and their device time, CUDA-event
    median of the call and of its chain kernel alone, and its device memory
    peak; then the plain eager version's (the plain pieces on the card, as
    the port ran before its kernels) launches and time, equal outputs."""
    import torch

    from tpu_deflate_torch.codec import encode as pe

    q = pe._QUALITY[quality]
    families = [(family, q[k], q[w]) for family, k, w in pe._FAMILIES if k in q]
    ks, ws = tuple(k for _f, k, _w in families), tuple(w for _f, _k, w in families)

    def kernels():
        return pe._match_find(data, lengths, lazy, quality, hist, hstart)

    def plain():
        keys = pe._match_keys_plain(data, lengths, tuple(f for f, _k, _w in families), hstart)
        packs = pe._bucket_best_plain(pe._match_chain_plain(keys), data, ks, ws)
        return pe._match_select_plain(data, lengths, lazy, packs[0], packs[1], packs[2] if len(packs) > 2 else None,
                                      hist, hstart)

    require(all(torch.equal(a, b) for a, b in zip(kernels(), plain())),
            f"{label}: the match finder differs from its plain eager version")
    card = gpu_name_power()
    events = launch_profile(f"{label} match finder", kernels, {k: 1 for k in MATCH_WRAPPERS})
    _launches, _ops, plain_events = call_record(plain)
    for what, fn, reps, ev in (("kernels", kernels, KERNEL_REPS, events),
                               ("plain eager", plain, PLAIN_REPS, plain_events)):
        busy = f"{sum(e.time_range.elapsed_us() for e in ev):.1f} us" if ev else "not recorded"
        log(f"{label} match finder ({what}, quality {quality}, {list(data.shape)}): {len(ev)} device events a "
            f"batch, device time {busy}; CUDA-event median {median_ms(fn, reps):.4f} ms ({card})")
    keys = pe.match_keys(data, lengths, tuple(f for f, _k, _w in families), hstart)
    log(f"{label} match finder: its chain kernel on every family's keys {list(keys.shape)} alone, CUDA-event median "
        f"{median_ms(lambda: pe.match_chain(keys), KERNEL_REPS):.4f} ms ({card})")
    del keys
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = kernels()
    torch.cuda.synchronize()
    log(f"{label} match finder: device memory peak {torch.cuda.max_memory_allocated() - mem0} bytes above the "
        f"{mem0} held before the call, {sum(t.numel() * t.element_size() for t in out)} bytes of its outputs")


def finish_kernels(K: Kernels, what: str, rows, use, dist, replay, valid, *, main_path: bool = False,
                   flags=None) -> None:
    """``_finish_analysis`` against its plain version on one batch (exact
    equality; the flags also against ``flags``, the ones the batch's emit
    took); on the main path's batch also one call's device events (one
    launch, the histograms' zero fill beside it), and ``torch.bincount``'s
    time on the plain version's histogram keys, the one PyTorch call that
    computes the histogram half."""
    import torch

    from tpu_deflate_torch.codec import encode as pe

    L, S = rows.shape
    args = (rows, use, dist, replay, valid)
    out = K.compare("finish_analysis", lambda: pe._finish_analysis(*args), lambda: finish_plain(*args), list(args),
                    {what: [L, S]}, main_path=main_path, proj=finish_parts)
    a, got_flags = out
    if flags is not None:
        require(torch.equal(got_flags, flags), f"{what}: the emit's flags differ from the kernel's")
    log(f"{what}: {int(a['is_token'].sum())} tokens, {int(a['is_match'].sum())} matches; histogram sums "
        f"{int(a['litlen_hist'].sum())} / {int(a['dist_hist'].sum())}")
    if not main_path:
        return
    launch_profile(f"{what} _finish_analysis", lambda: pe._finish_analysis(*args), {"finish_analysis": 1},
                   ("aten::zeros", "aten::zero_", "aten::fill_"))
    lanes = torch.arange(L, device=rows.device)[:, None]
    plain = pe._finish_analysis_plain(rows, use, dist, replay & valid)
    keys = ((torch.where(plain["is_token"], plain["litlen_sym"], 288).to(torch.int64) + lanes * 289).view(-1),
            (torch.where(plain["is_match"], plain["dist_sym"], 30).to(torch.int64) + lanes * 31).view(-1))
    card = gpu_name_power()
    for k, nbins in zip(keys, (289, 31)):
        ms = median_ms(lambda: torch.bincount(k, minlength=L * nbins), KERNEL_REPS)
        log(f"{what}: torch.bincount of {k.numel()} int64 keys into {L} x {nbins} bins, CUDA-event median "
            f"{ms:.4f} ms ({card})")


def finish_edge_rows(device) -> list:
    """``_finish_analysis``'s edge batches: (label, rows, use, dist, replay,
    valid). 4 and 16 lanes of 65536: lane 0 sweeps every run of 3..258
    against every distance-symbol base, the value before it and 32768, then
    out-of-range runs and distances (clamped); lane 1 has no token; lane 2
    every position a token (a literal of one byte value: one bin takes the
    whole lane); the rest random. 3 lanes of 4099 columns (the kernel's
    scalar loads and its partial last block), and inputs one element off
    their alignment (the scalar loads again)."""
    import numpy as np
    import torch

    bases = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513, 769, 1025, 1537, 2049,
             3073, 4097, 6145, 8193, 12289, 16385, 24577)
    dists = np.array(sorted({*bases, *(b - 1 for b in bases[1:]), 32767, 32768}), np.int32)
    rng = np.random.default_rng(17)

    def batch(L, S):
        data = rng.integers(0, 256, (L, S), dtype=np.uint8)
        use = np.where(rng.random((L, S)) < 0.45, 0, rng.integers(3, 259, (L, S))).astype(np.int32)
        dist = rng.integers(1, 32769, (L, S)).astype(np.int32)
        replay = rng.random((L, S)) < 0.6
        valid = np.ones((L, S), bool)
        n = 2 * 256
        use[0, :n] = np.tile(np.arange(3, 259), 2)
        dist[0, :n] = np.resize(dists, n)
        replay[0, :n] = True
        use[0, n : n + 8] = [259, 300, 1000, 2**31 - 1, -5, 0, 7, 258]
        dist[0, n : n + 8] = [40000, 0, -3, 2**31 - 1, 5, 1, 32769, 32768]
        replay[0, n : n + 8] = True
        replay[1] = False
        data[2], use[2], replay[2] = 101, 0, True
        return data, use, dist, replay, valid

    out = []
    for label, (L, S) in (("4 lanes", (4, 65536)), ("16 lanes", (16, 65536)), ("4099 columns", (3, 4099))):
        out.append((label, *(torch.from_numpy(a).to(device) for a in batch(L, S))))
    L, S = 4, 8192
    parts = []
    for a in batch(L, S):
        t = torch.from_numpy(a.reshape(-1)).to(device)
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=device)
        buf[1:] = t
        parts.append(buf[1:].view(L, S))
    out.append(("inputs off alignment", *parts))
    return out


def finish_edges(device, K: Kernels) -> None:
    for label, *args in finish_edge_rows(device):
        finish_kernels(K, label, *args)


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
    lengths = torch.from_numpy(b["lengths"]).to(device)
    (use, dist, step, valid), _prev = match_kernels(K, "encode batch", b["rows"], lengths, 0, True,
                                                    main_path=True)
    require(torch.equal(step, b["tiles"].transpose(1, 2).reshape(step.shape)), "the batch's steps differ from the "
            "match finder's")
    log(f"encode batch: {int((use > 0).sum())} match starts of {use.numel()} positions")
    phase_match_edges(corpus, device, K)
    L, _T, NT = b["tiles"].shape
    S = NT * pp.T_P
    tok = parse_pair(b["tiles"], b["entries"], {"steps": [L, S]}, True)
    log(f"encode batch: {L} members, {int(tok.sum())} tokens of {L * S} positions")
    finish_kernels(K, "encode batch", b["rows"], use, dist, tok, valid, main_path=True, flags=b["args"][1])
    finish_edges(device, K)
    args = b["args"]
    words, total, choice, *_costs = emit_compare(
        K, args, {"fields": [L, S], "words": [L, em.EMIT_WORDS], "routed": True}, main_path=True)
    body = total - torch.where(choice == pe.ROUTE_FIXED, 7, args[18]) - torch.where(
        choice == pe.ROUTE_FIXED, 3, args[16].sum(dim=1, dtype=torch.int32))
    log(f"emit: body bits per lane min {int(body.min())} max {int(body.max())}, "
        f"routes {np.bincount(choice.cpu().numpy(), minlength=3).tolist()} (dynamic, fixed, stored)")
    # The same launch with routing off, given the routed tables, header and EOB.
    dargs = unrouted(args)
    dw, dt = emit_compare(K, dargs, {"fields": [L, S], "routing": "off, the routed tables"})
    require(torch.equal(dw, words) and torch.equal(dt, total), "the emit with routing off differs from routing on")
    one_launch("emit_routed, first encode batch", lambda: em.emit_routed(*args), "emit_body",
               ("aten::zeros", "aten::zero_", "aten::fill_"))
    phase_plan_edges(device, K)

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
    fargs = bf["args"]
    fchoice = emit_compare(K, fargs, {"fields": list(fargs[0].shape), "routed": True})[2].cpu().numpy()
    require(pe.ROUTE_FIXED in fchoice, f"no lane routed FIXED: {fchoice.tolist()}")
    log(f"FIXED batch: routes {fchoice.tolist()}")

    rng = torch.Generator(device="cpu").manual_seed(4)
    sym = torch.randint(0, 256, (1, S), generator=rng, dtype=torch.int32).to(device)
    ones, zeros = torch.ones_like(sym), torch.zeros_like(sym)
    ll = torch.from_numpy(encode_np.pack_codes(np.full((1, 288), 15, np.int64), 15)).to(device)
    dc = torch.zeros((1, 30), dtype=torch.int32, device=device)
    oargs = (sym, ones, zeros, zeros, zeros, zeros, zeros, ll, dc, *(t[:1] for t in dargs[9:13]))
    _w, end = emit_compare(K, oargs, {"15-bit literals, EOB past the grid": [1, S]})
    require(int(end[0]) == int(dargs[10][0].sum()) + 15 * S + int(dargs[12][0]) > 32 * em.EMIT_WORDS,
            "overflow lane's total bits")

    # Lanes whose segments carry no bits: all of lane 0, segments 1 and 2 of lane 1.
    seg = em.EMIT_SEGMENT
    eargs = [t[:2].clone() for t in dargs]
    eargs[1][0] = 0
    eargs[1][1, seg : 3 * seg] = 0
    emit_compare(K, eargs, {"empty segments": [2, S]})
    # A width that is not a multiple of the segment.
    cut = 2 * seg + em.EMIT_CHUNK
    cargs = [t[:3, :cut].contiguous() for t in dargs[:7]] + [t[:3] for t in dargs[7:]]
    emit_compare(K, cargs, {"fields": [3, cut]})
    # Length slots of more than 31 bits (25 extra bits behind the code),
    # which the kernel places one by one.
    wargs = [t[:2].clone() for t in dargs]
    wargs[3][:] = torch.randint(0, 1 << 25, wargs[3].shape, generator=rng, dtype=torch.int32).to(device)
    wargs[2][:] = 25
    emit_compare(K, wargs, {"slots over 31 bits": [2, S]})
    for what, a, every in (("first batch", dargs, True), ("cut width", cargs, True),
                           ("FIXED batch", unrouted(fargs), False)):
        starts = segment_starts(a)
        inside = ((starts & 31) != 0).any(dim=1)
        log(f"emit segments, {what}: {int(inside.sum())} of {starts.shape[0]} lanes have a segment "
            "starting inside a word")
        require(bool(inside.all()) or not every, f"emit {what}: a lane whose segments all start on a word")
    return b["rows"], b["lengths"], dargs, (words, total)


def segment_starts(args):
    """(L, segments) first bit of each of K10's segments, from each
    position's bit count as the plain version counts it; ``args`` are
    ``emit.emit_device``'s."""
    import torch

    from tpu_deflate_torch.codec import emit as em

    sym, flags, leb, _lev, dsym, deb, _dev, ll, dc, _hv, hb = args[:11]
    hdr = hb.sum(dim=1, dtype=torch.int32)
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


MATCH_WRAPPERS = ("match_keys", "match_chain", "match_bucket", "match_select")


def batch_launches(launches: dict, kernel: str, batches: int, label: str) -> None:
    """The kernel launched once a batch."""
    require(launches[kernel] == batches, f"{label}: {launches[kernel]} launches of {kernel} for {batches} batches")


def match_launches(launches: dict, batches: int, label: str) -> None:
    """Each batch launched each of the match finder's kernels once (every
    hash family in the same launch)."""
    want = {k: batches for k in MATCH_WRAPPERS}
    got = {k: launches[k] for k in want}
    require(got == want, f"{label}: match finder launches {got}, expected {want}")


def phase_encode_main(corpus: bytes, first, K: Kernels) -> tuple[dict, float]:
    """engine.compress of the corpus at the default effort: round trip
    through gzip and the port's decode, every encode kernel launched (the
    match finder's on every batch), then timed runs and one batch of the
    match finder profiled (``first``: phase 8's first batch)."""
    import torch

    from tpu_deflate_torch import _build, engine, native
    from tpu_deflate_torch.codec import encode as pe
    from tpu_deflate_torch.codec import parse as pp

    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    kernels = [(pe, k) for k in MATCH_WRAPPERS] + [
        (pp, "parse_transfers"), (pp, "parse_replay"), (pe, "_finish_analysis"), (em, "emit_routed"),
        (cl, "crc32_lanes_raw8")]
    batches = -(-len(corpus) // (pe.ENC_LANE_BATCH * MEMBER))
    with recorded(*kernels) as (calls, shapes, order), emits_checked(K, "encode") as checked:
        _build.reset_launches()
        t0 = time.monotonic()
        gz = engine.compress(corpus, engine="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _build.all_launches()
    log(f"encode run 1 (the emit checked against its plain composition): {wall:.3f} s, "
        f"{len(corpus) / wall / 1e6:.2f} MB/s; launches {json.dumps(launches)}")
    path_bounds("encode main-path", calls)
    bounds = launch_bounds(calls, shapes, order)
    for k in ("parse_transfers", "parse_replay", "crc32_lanes"):
        require(launches[k] > 0, f"kernel {k} was not launched by the encode")
    match_launches(launches, batches, "encode")
    batch_launches(launches, "finish_analysis", batches, "encode")
    emit_launches(launches, batches, "encode")
    require(checked == {"emit_routed": batches, "emit_device": 0}, f"encode: {checked} calls checked")
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
    plan_launches(lambda: engine.compress(corpus, engine="cuda"), "encode", batches)
    rows, lengths = first[0], torch.from_numpy(first[1]).to(first[0].device)
    match_finder_profile("encode", rows, lengths, True, 0)
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
    quality 1): the parse's step tiles, the host entries, the emit's
    arguments (``emit.emit_routed``'s, each lane's final among them) and
    each lane's first real column."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import encode as pe

    flat = np.frombuffer(data, np.uint8)
    count = min(pe.ENC_LANE_BATCH, -(-flat.size // MEMBER))
    rows, hstart, pay_lens, final = pc.lane_rows(flat, 0, count, MEMBER)
    dd = torch.from_numpy(rows).to(device)
    hs = torch.from_numpy(hstart).to(device)
    pend = pc.dispatch_lanes(dd, hs, pay_lens, True, 1)
    args, tiles, entries = pe.emit_inputs(pend, final)
    lengths = torch.from_numpy((pc.HALO_COLS + pay_lens).astype(np.int32)).to(device)
    hist = torch.full((count,), pc.HALO_COLS, dtype=torch.int32, device=device)
    return {"tiles": tiles, "entries": entries, "args": args, "hstart": hstart,
            "match": (dd, lengths, hist, hs)}


def phase_continuous_kernels(corpus: bytes, device, K: Kernels):
    """The match finder's kernels (quality 1, with the history masks), K8,
    K9 and K10 against their plain versions on the continuous encode's
    first batch (64 x 98304: a third of each row is history), and on a
    batch whose head lane starts with F1's zeros; the parse's chain
    reaches each lane's first payload column. Returns the first batch's
    match finder arguments (rows, lengths, hist, hstart)."""
    import numpy as np
    import torch

    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import parse as pp

    first = None
    for what, data in (("continuous batch", corpus), ("F1 head lane", F1_PREFIX + corpus)):
        b = continuous_batch(data, device)
        rows, lengths, hist, hstart = b["match"]
        (use, dist, step, valid), _prev = match_kernels(K, what, rows, lengths, 1, True, hist, hstart)
        require(torch.equal(step, b["tiles"].transpose(1, 2).reshape(step.shape)),
                f"{what}: the batch's steps differ from the match finder's")
        require(int(use[:, : pc.HALO_COLS].count_nonzero()) == 0, f"{what}: a match starts in the history")
        if first is None:
            first = b["match"]
        L, _T, NT = b["tiles"].shape
        S = NT * pp.T_P
        steps = b["tiles"].transpose(1, 2)
        K.compare("parse_transfers", lambda: pp.parse_transfers(b["tiles"]),
                  lambda: pp.parse_transfers_plain(b["tiles"]), [steps],
                  {what: [L, S], "out": [L, NT, pp.E_P]}, main_path=False)
        (tok,) = K.compare("parse_replay", lambda: pp.parse_replay(b["tiles"], b["entries"]),
                           lambda: pp.parse_replay_plain(b["tiles"], b["entries"]), [steps, b["entries"]],
                           {what: [L, S], "entries": [L, NT]}, main_path=False)
        finish_kernels(K, what, rows, use, dist, tok, valid, flags=b["args"][1])
        args = b["args"]
        _words, total, choice, *_costs = emit_compare(
            K, args, {what: [L, S], "words": [L, em.EMIT_WORDS], "final lanes": int(args[21].sum())})
        require(bool(tok[:, pc.HALO_COLS].all()), f"{what}: the parse chain misses a payload start")
        log(f"{what}: {L} lanes x {S} columns (hstart of lane 0: {int(b['hstart'][0])}), "
            f"{int(tok.sum())} chain positions, total bits per lane min {int(total.min())} "
            f"max {int(total.max())}, routes {np.bincount(choice.cpu().numpy(), minlength=3).tolist()} (dynamic, "
            "fixed, stored)")
    return first


def phase_continuous_main(corpus: bytes, effort2_bytes: int, profile_dir: str | None, K: Kernels, first):
    """engine.compress of the corpus at effort 4 (one member of 768 blocks
    of 64 KiB with continuous history): byte-exact through gzip and the
    port's decode on the card, every kernel of the path launched (the
    match finder's on every batch), its bounds, memory peak, ratio and
    times, the lane CRC against its plain version on the rows the path
    gave it, one batch of the match finder profiled (``first``: phase
    11's first batch); then the decode of its output. Returns the
    encode's and the decode's launches."""
    import numpy as np
    import torch

    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_np
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe
    from tpu_deflate_torch.codec import parse as pp
    from tpu_deflate_torch.codec import resolve as rs
    from tpu_deflate_torch.kernels import checksum_lanes as cl

    def encode():
        return engine.compress(corpus, engine="cuda", effort=4)

    kernels = [(pe, k) for k in MATCH_WRAPPERS] + [
        (pp, "parse_transfers"), (pp, "parse_replay"), (pe, "_finish_analysis"), (em, "emit_routed"),
        (cl, "crc32_lanes_raw8")]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batches = -(-len(corpus) // (pe.ENC_LANE_BATCH * MEMBER))
    with recorded(*kernels) as (calls, shapes, order), captured((cl, "crc32_lanes_raw8"), per_key=1) as caps, \
            emits_checked(K, "continuous encode") as checked:
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
    for k in ("parse_transfers", "parse_replay", "crc32_lanes"):
        require(launches[k] > 0, f"kernel {k} was not launched by the continuous encode")
    match_launches(launches, batches, "continuous encode")
    batch_launches(launches, "finish_analysis", batches, "continuous encode")
    emit_launches(launches, batches, "continuous encode")
    require(checked == {"emit_routed": batches, "emit_device": 0}, f"continuous encode: {checked} calls checked")
    require(gzip.decompress(gz) == corpus, "gzip.decompress of the continuous encode differs")
    members = decode_np.split_members(np.frombuffer(gz, np.uint8))
    require(members is not None and len(members) == 1, "the continuous encode is not one member")

    dec_kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
                   (dk, "compact_flat"), (rs, "split_tiles_device"), (rs, "expand"), (rs, "sweep"),
                   (cl, "crc32_lanes_raw8")]
    with recorded(*dec_kernels) as (dec_calls, _shapes, _order), \
            captured((rs, "split_tiles_device"), per_key=1) as dec_caps, \
            folds_checked(K, "continuous decode") as folds:
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
    require(dec_launches["compact_any"] == dec_launches["pack_tokens"] == dec_launches["compact_pack"] == 0,
            "the continuous member's decode launched K7 or the pull")
    require(dec_launches["tile_split"] == 1 and len(folds) == dec_launches["stage_dc"] == stats["waves"],
            f"the continuous member's decode: {dec_launches['tile_split']} splits (1 expected), "
            f"{len(folds)} K3 folds checked for {stats['waves']} waves")
    log(f"continuous decode: {dec_wall:.3f} s ({len(corpus) / dec_wall / 1e9:.4f} GB/s), {stats['waves']} waves, "
        f"stats {json.dumps(stats)}, launches {json.dumps(dec_launches)}")
    path_bounds("continuous decode", dec_calls)
    replay_calls(dec_caps, K, "continuous decode")
    del dec_caps

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
    plan_launches(encode, "continuous encode", batches)
    match_finder_profile("continuous encode", *first[:2], True, 1, *first[2:])
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
MESH_PATH_KERNELS = tuple(k for k, (_src, _tpu, path) in KERNELS.items() if path not in SIDE_PATHS)


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
    from tpu_deflate_torch.codec import encode as pe
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

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "split_tiles_device"), (rs, "expand"), (rs, "sweep"),
               (cl, "crc32_lanes_raw8"), (pp, "parse_transfers"), (pp, "parse_replay"), (pe, "_finish_analysis"),
               (em, "emit_routed")] + [(pe, k) for k in MATCH_WRAPPERS]
    big_gz, big_chunks, _payloads = big_members(corpus)
    with captured(*kernels) as caps, folds_checked(K, "mesh") as folds, emits_checked(K, "mesh") as checked:
        _build.reset_launches()
        out = timed(f"decode of the corpus over {MESH_SHARDS} shards (argument copies for the replay included)",
                    lambda: engine.decompress(gz, engine="cuda", mesh=mesh))
        stats = dict(pv2.LAST_DECODE_STATS)
        big_out = timed(f"decode of the big members over {MESH_SHARDS} shards (argument copies included)",
                        lambda: engine.decompress(big_gz, engine="cuda", mesh=mesh))
        big_stats = dict(pv2.LAST_DECODE_STATS)
        member = timed(f"engine.compress(corpus, effort=4) over {MESH_SHARDS} shards (argument copies for the "
                       "replay included)", lambda: engine.compress(corpus, engine="cuda", effort=4, mesh=mesh))
        launches = _build.all_launches()
    replay_calls(caps, K, "mesh")
    del caps
    require(out == corpus, "the sharded decode differs from the corpus")
    require(stats["device_resolved"] == n_huff and stats["host_resolved"] == 0,
            f"device_resolved {stats['device_resolved']} != {n_huff} Huffman members over the mesh")
    require(member == cont_gz, "the sharded continuous encode differs from the one-device member")
    require(big_out == b"".join(big_chunks), "the big members' sharded decode differs")
    require(big_stats["device_resolved"] == len(big_chunks) and big_stats["host_resolved"] == 0,
            f"a big member left the device route over the mesh: {big_stats}")
    log(f"mesh decode stats {json.dumps(stats)}; big members {json.dumps(big_stats)}")
    log(f"launches on the mesh path (decode, the big members' decode, then the effort-4 encode): "
        f"{json.dumps(launches)}")
    for k in MESH_PATH_KERNELS:
        require(launches[COUNTERS.get(k, k)] > 0, f"kernel {k} was not launched on the mesh path")
    require(len(folds) == launches["stage_dc"], "the mesh path: a K3 fold not checked")
    require(checked == {"emit_routed": launches["emit_body"], "emit_device": 0},
            f"the mesh path: {checked} emit calls checked for {launches['emit_body']} launches")

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
    2 passes, with K7 and the pull not launched. Then each wrapper's bytes bound per
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

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "split_tiles_device"), (rs, "expand"), (rs, "sweep"),
               (cl, "crc32_lanes_raw8")]
    pv2._resolve_passes, rs.split_tiles_device, rs.resolve_tiles_crc, cl.crc32_fold_tiles = (
        passes_spy, split_spy, chain_spy, fold_spy)
    try:
        with recorded(*kernels) as (calls, shapes, order), captured(*kernels) as caps, \
                folds_checked(K, "passes") as folds:
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
    require(launches["compact_any"] == launches["pack_tokens"] == launches["compact_pack"] == 0,
            "the pass route launched K7 or the pull")
    for k in BIG_KERNELS:
        require(launches[k] > 0, f"kernel {k} was not launched on the pass route")
    require(len(folds) == launches["stage_dc"], "the pass route: a K3 fold not checked")
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
    verify every member; every kernel but K7, K4's pull mode, the pull
    alone and Adler-32's sums must launch and those must not.
    Then the timed run, unwrapped at the reference's reps: each row, one
    pass's host enqueue time and CUDA-event time, the device memory peak
    beside the end-to-end decode's, and each decode row's GB/s over phase
    4's median end-to-end "auto" decode. Returns the path run's launches."""
    import torch

    from tpu_deflate_torch import _build, engine
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import emit as em
    from tpu_deflate_torch.codec import encode as pe
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

    kernels = [(dk, "stage_a_tables"), (dk, "stage_a"), (dk, "stage_b"), (dk, "stage_c"), (dk, "stage_dc"),
               (dk, "compact_flat"), (rs, "split_tiles_device"), (rs, "expand"), (rs, "sweep"),
               (cl, "crc32_lanes_raw8"), (pp, "parse_transfers"), (pp, "parse_replay"), (pe, "_finish_analysis"),
               (em, "emit_routed")] + [(pe, k) for k in MATCH_WRAPPERS]
    with recorded(*kernels) as (calls, _shapes, _order), captured(*kernels) as caps, \
            folds_checked(K, "kernel rows") as folds, emits_checked(K, "kernel rows") as checked:
        _build.reset_launches()
        results = {name: run(reps=1) for name, run in rows}
        launches = _build.all_launches()
    log(f"launches over the kernel rows (reps=1): {json.dumps(launches)}")
    verified(results)
    for k in KERNELS:
        if KERNELS[k][2] in SIDE_PATHS:
            require(launches[COUNTERS.get(k, k)] == 0, f"kernel {k} launched in the kernel rows")
        else:
            require(launches[COUNTERS.get(k, k)] > 0, f"kernel {k} was not launched in the kernel rows")
    require(len(folds) == launches["stage_dc"], "the kernel rows: a K3 fold not checked")
    require(checked == {"emit_routed": launches["emit_body"], "emit_device": 0},
            f"the kernel rows: {checked} emit calls checked for {launches['emit_body']} launches")
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
    phase_stage_c_edges(device, K)
    phase_wave_summary_edges(device, K)
    phase_split_edges(device, K)
    small = main_path_small_waves(gz, device)
    phase_k3_edges(small, device, K)
    phase_compact_edges(small, device, K)
    resolve_first = phase_resolve_kernels(gz, corpus, device, K)
    phase_crc_edges(corpus, device, K)
    adler_launches = phase_adler(corpus, device, K)
    launches, timed_median_s, bounds = phase_main_path(corpus, gz, n_huff, K)
    if args.profile:
        phase_profile(lambda: engine.decompress(gz, engine="cuda"), "decode", args.profile, "profile",
                      PROFILE_KERNELS, timed_median_s, bounds)
    off_launches = phase_off_route(corpus, gz, args.profile, K)
    phase_on_route(corpus)
    big_launches = phase_big_members(corpus, device, args.profile, K)
    phase_interop(corpus, gz, device)
    host_launches = phase_host_codec(corpus, device)

    encode_first = phase_encode_kernels(corpus, device, K)
    enc_launches, enc_median_s, enc_bounds, effort2_bytes = phase_encode_main(corpus, encode_first, K)
    if args.profile:
        phase_profile(lambda: engine.compress(corpus, engine="cuda"), "encode", args.profile,
                      "profile_encode", ENCODE_PROFILE_KERNELS, enc_median_s, enc_bounds)
    phase_encode_cpu(corpus, device)

    cont_first = phase_continuous_kernels(corpus, device, K)
    cont_launches, cont_dec_launches, cont_gz = phase_continuous_main(corpus, effort2_bytes, args.profile, K,
                                                                       cont_first)
    del cont_first
    phase_continuous_cpu(corpus, device)
    mesh_launches = phase_mesh(corpus, gz, n_huff, resolve_first, encode_first, cont_gz, device, K)
    del corpus, gz, cont_gz, resolve_first, encode_first
    pass_launches = phase_passes(device, args.profile, K)
    corpus = bench.make_corpus(CORPUS_MB)
    row_launches = phase_kernel_rows(corpus, native.compress_members_native(corpus), timed_median_s, K)
    path_launches = {"main": launches, "off": off_launches, "big": big_launches, "encode": enc_launches,
                     "continuous": cont_launches, "continuous_decode": cont_dec_launches, "mesh": mesh_launches,
                     "passes": pass_launches, "kernel_rows": row_launches, "adler": adler_launches,
                     "host_codec": host_launches}

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": CSRC + src,
            "replaces": tpu,
            "path": path,
            "launches": path_launches[path][COUNTERS.get(name, name)],
            "launches_by_path": {p: n[COUNTERS.get(name, name)] for p, n in path_launches.items()
                                 if COUNTERS.get(name, name) in n},
            "max_abs_err": K.rec[FOLDED.get(name, name)]["max_abs_err"],
            "ms": K.rec[FOLDED.get(name, name)]["ms"],
            "plain_ms": K.rec[FOLDED.get(name, name)]["plain_ms"],
            "bound_ms": K.rec[FOLDED.get(name, name)]["bound_ms"],
            "bound_by": K.rec[FOLDED.get(name, name)]["bound_by"],
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
