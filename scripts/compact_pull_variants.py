"""Variants of K4's pull mode (``compact_pull_kernel`` in
tpu_deflate_torch/csrc/compact.cu) on the ``"off"`` route's waves, in one
process on the card.

    python scripts/compact_pull_variants.py

Each variant is this tree's ``csrc/compact.cu`` with a few edits of its
text (``VARIANTS``), built by nvcc into a library of its own (all at once)
and called through its ``td_compact_pull`` on the same inputs: K3's tokens
and the literal planes of each of the four waves of an ``"off"`` decode of
the 8 MiB corpus (``bench.make_corpus(8)``, ``native.
compress_members_native``), captured from ``decode_v2.compact_pack``. Each
variant's outputs must equal ``compact_pack_plain``'s. The variants run in
the order of ``VARIANTS`` and then back, 20 calls a wave each under
torch.profiler: the kernel's device µs a call (median), the memset's, and
the bytes bound's share (4 bytes read and 5 1/8 written a token slot, the
planes and nlit, at 3.35 TB/s). ptxas' registers and spills of each
variant's pull kernels are printed, and every figure stands beside the
card's name and power limit (``nvidia-smi``)."""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "tpu_deflate_torch", "csrc")
OUT = os.path.join(HERE, "chiprun_out", "compact_pull_variants")
REPS = 20
HBM_BYTES_PER_S = 3.35e12

SCALAR_FILL = ("  fill_ones(yl + (M - (seg0 - start_l) - out_l), out_l, tid);\n"
               "  fill_ones(reinterpret_cast<uint8_t*>(ym + (M - (seg0 - start_m) - out_m)), 4 * out_m, tid);\n",
               "  for (int i = tid; i < out_l; i += THREADS) yl[M - (seg0 - start_l) - out_l + i] = 255;\n"
               "  for (int i = tid; i < out_m; i += THREADS) ym[M - (seg0 - start_m) - out_m + i] = -1;\n")

VECTOR_STORES = ("  for (int i = tid; i < agg_l; i += THREADS) yl[start_l + i] = stage_l[i];\n"
                 "  for (int i = tid; i < agg_m; i += THREADS) ym[start_m + i] = stage_m[i];\n", '''  {
    uint8_t* d = yl + start_l;
    const int head = min(agg_l, (int)((4 - (reinterpret_cast<uintptr_t>(d) & 3)) & 3));
    if (tid < head) d[tid] = stage_l[tid];
    const int nw = (agg_l - head) >> 2;
    uint32_t* dw = reinterpret_cast<uint32_t*>(d + head);
    for (int i = tid; i < nw; i += THREADS) {
      const int k = head + 4 * i;
      dw[i] = stage_l[k] | (uint32_t)stage_l[k + 1] << 8 | (uint32_t)stage_l[k + 2] << 16 |
              (uint32_t)stage_l[k + 3] << 24;
    }
    if (tid < agg_l - head - 4 * nw) d[head + 4 * nw + tid] = stage_l[head + 4 * nw + tid];
  }
  {
    int* d = ym + start_m;
    const int head = min(agg_m, (int)(((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15) >> 2));
    if (tid < head) d[tid] = stage_m[tid];
    const int nv = (agg_m - head) >> 2;
    int4* dv = reinterpret_cast<int4*>(d + head);
    for (int i = tid; i < nv; i += THREADS) {
      const int k = head + 4 * i;
      dv[i] = make_int4(stage_m[k], stage_m[k + 1], stage_m[k + 2], stage_m[k + 3]);
    }
    if (tid < agg_m - head - 4 * nv) d[head + 4 * nv + tid] = stage_m[head + 4 * nv + tid];
  }
''')

THRESHOLD = "constexpr int PULL_SMALL_WAVE_BLOCKS = 2 * 132;"

# name -> ([(old, new)] edits of csrc/compact.cu, what it changes)
VARIANTS = {
    "base": ([], "the tree's kernel: 4096-entry segments from 264 of them a wave, padding by 16-byte stores"),
    "per16_from_528": ([(THRESHOLD, THRESHOLD.replace("2 * 132", "4 * 132"))],
                       "4096-entry segments from 528 of them a wave, K4's rule (the first version's)"),
    "per16_from_132": ([(THRESHOLD, THRESHOLD.replace("2 * 132", "132"))],
                       "4096-entry segments from 132 of them a wave"),
    "scalar_fill": ([SCALAR_FILL], "both streams' padding by single stores (the first version's)"),
    "vector_stores": ([VECTOR_STORES],
                      "the literals by 4-byte and the matches by 16-byte stores between single heads and tails"),
}
VARIANTS["first_version"] = (VARIANTS["per16_from_528"][0] + VARIANTS["scalar_fill"][0],
                             "per16_from_528 and scalar_fill: the kernel as first written")


def build(names) -> dict:
    """{variant: (ctypes library, ptxas' lines of its pull kernels)}."""
    from tpu_deflate_torch import _build

    os.makedirs(OUT, exist_ok=True)
    own = open(os.path.join(CSRC, "compact.cu")).read()
    nvcc = _build.nvcc_path()
    procs = {}
    for name in names:
        text = own
        for old, new in VARIANTS[name][0]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: csrc/compact.cu does not hold {old!r} once")
            text = text.replace(old, new)
        src = os.path.join(OUT, f"compact_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"compact_{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", CSRC, "-o", so, src]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        ptxas = [" ".join(x.split()) for i, line in enumerate(lines) if "compact_pull_kernel" in line
                 and "Compiling" in line for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]
        lib = ctypes.CDLL(so)
        lib.td_compact_pull.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                                ctypes.c_void_p]
        libs[name] = (lib, ptxas)
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk
    from tpu_deflate_torch.codec import decode_v2 as pv2
    from tpu_deflate_torch.config import DecoderConfig

    card = cs.gpu_name_power()
    libs = build(VARIANTS)
    print(f"card: {card}; torch {torch.__version__}")
    for name, (_lib, ptxas) in libs.items():
        print(f"{name}: {VARIANTS[name][1]}; ptxas {ptxas}")
    small = bench.make_corpus(8)
    gz = native.compress_members_native(small)
    waves, pack = [], pv2.compact_pack

    def spy(tok, planes, vec):
        waves.append((tok.clone(), planes.clone()))
        return pack(tok, planes, vec)

    pv2.compact_pack = spy
    try:
        assert engine.decompress(gz, engine="cuda", config=DecoderConfig(device_resolve="off")) == small
    finally:
        pv2.compact_pack = pack
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for tok, planes in waves:
        L, M = tok.shape
        dev = tok.device
        words = L * -(-M // 1024) + 1
        halves = torch.zeros((2, words), dtype=torch.int64, device=dev)
        turn = [0, 0]  # the half to use next, the words of the other half to put back to 0
        bitmap = torch.empty((L, -(-M // 32)), dtype=torch.int32, device=dev)
        lit = torch.empty((L, M), dtype=torch.uint8, device=dev)
        match = torch.empty((L, M), dtype=torch.int32, device=dev)
        nlit = torch.empty(L, dtype=torch.int32, device=dev)

        def call(lib):
            half, dirty = turn
            err = lib.td_compact_pull(tok.data_ptr(), planes.data_ptr(), bitmap.data_ptr(), lit.data_ptr(),
                                      match.data_ptr(), nlit.data_ptr(), halves[half].data_ptr(),
                                      halves[1 - half].data_ptr(), dirty, L, M, stream)
            assert err == 0, err
            turn[0], turn[1] = 1 - half, words

        want = dk.compact_pack_plain(tok, planes)
        bound_us = (9 * L * M + 4 * L * -(-M // 32) + 4 * 64 * L + 4 * L) / HBM_BYTES_PER_S * 1e6
        times: dict = {name: [] for name in libs}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            lib = libs[name][0]
            call(lib)
            torch.cuda.synchronize()
            equal = all(torch.equal(g, w) for g, w in zip((bitmap, lit, match, nlit), want))
            ok &= equal
            if not equal:
                print(f"[{L}, {M}] {name}: differs from compact_pack_plain")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    call(lib)
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            kern = [e.time_range.elapsed_us() for e in events if "compact_pull_kernel" in e.name]
            mset = [e.time_range.elapsed_us() for e in events if "memset" in e.name.lower()]
            times[name].append((statistics.median(kern) if kern else None, statistics.median(mset) if mset else None))
        for name in libs:
            ks = [k for k, _m in times[name]]
            ms = [m for _k, m in times[name]]
            best = min(k for k in ks if k is not None) if any(k is not None for k in ks) else None
            print(f"[{L}, {M}] {name}: kernel {ks} us a call (median of {REPS}, first and second pass), memset "
                  f"{ms} us; bound {bound_us:.3f} us" + (f" ({100 * bound_us / best:.1f} % of the faster pass)"
                                                           if best else "") + f" ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
