"""Time the variants of the tile split's place pass on the card, with a
probe of its phases.

    python scripts/split_variants.py

Builds ``scripts/split_variants.cu`` (which includes ``tpu_deflate_torch/
csrc/tile_split.cu`` whole) with ``nvcc`` and the port's flags into
``tpu_deflate_torch/_kernels_build/``. Captures the split's calls of the
big members' route (``chip_smoke.big_members`` of ``bench.make_corpus(48)``
through ``engine.decompress``: 2 groups) and of the continuous member's
decode (``engine.compress(corpus, effort=4)``: one lane), then for each
call and variant: the output held equal to ``resolve.split_tiles_device``'s,
the device time of one call (CUDA events around it, queued behind a spin
kernel; the least of 5) beside its bytes bound, and one probed call: each
block's phases of the place pass (load and scan, look-back, seams and the
wait for its first tile, placing, stores) from ``%globaltimer`` stamps,
their medians, the most placing blocks that ran at once and their span. Every figure
stands beside the card's name and power limit."""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    0: "256 threads x 16 tokens (segments of 4096), registers for 4 blocks an SM (the kernel)",
    1: "512 threads x 16 tokens (segments of 8192), registers for 2 blocks an SM",
    2: "512 threads x 8 tokens (segments of 4096), registers for 3 blocks an SM",
    3: "256 threads x 8 tokens (segments of 2048), registers for 6 blocks an SM",
    4: "the kernel's shape, look-back rounds of 256 segments",
    5: "the kernel's shape, look-back rounds of 512 segments",
}
PHASES = ("load and scan", "look-back", "seams and wait", "place", "stores")
RUNS = 5
SPIN_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def build() -> ctypes.CDLL:
    from tpu_deflate_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "libsplit_variants.so")
    src = os.path.join(HERE, "scripts", "split_variants.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(so)
    lib.split_variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p] * 2)
    lib.split_variant.restype = ctypes.c_int
    lib.split_variant_segment.argtypes = [ctypes.c_int]
    lib.split_variant_segment.restype = ctypes.c_int
    return lib


def split(lib, v: int, tok, T: int, stamps=None):
    import torch

    from tpu_deflate_torch import _build
    from tpu_deflate_torch.codec import resolve as rs

    L, K = tok.shape
    dev = tok.device
    out = torch.empty((L, T, rs.N_POS), dtype=torch.int32, device=dev)
    seg = lib.split_variant_segment(v)
    scratch, other, dirty = _build.alternating_halves(f"split_variant_{v}", dev, L * -(-K // seg) + 2 * L * T + 1)
    err = lib.split_variant(v, tok.data_ptr(), out.data_ptr(), scratch.data_ptr(), other.data_ptr(), dirty, L, K, T,
                            None if stamps is None else stamps.data_ptr(), _build.stream(dev))
    _build.check(err, f"split_variant {v}")
    return out


def call_us(fn) -> float:
    """Device us of one call: CUDA events around it, queued behind a spin;
    the least of RUNS."""
    import torch

    fn()
    best = float("inf")
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) * 1000)
    return best


def probe(lib, v: int, tok, T: int) -> dict:
    """One call with stamps: the phases' medians (us), the most blocks at
    once, the place pass's span (us)."""
    import torch

    L, K = tok.shape
    n = L * -(-K // lib.split_variant_segment(v))
    stamps = torch.zeros((n, 8), dtype=torch.int64, device=tok.device)  # the placing blocks' tickets
    split(lib, v, tok, T, stamps)
    torch.cuda.synchronize()
    st = stamps[:, :6].cpu().numpy().astype("float64") / 1000.0  # ns -> us
    d = st[:, 1:] - st[:, :-1]
    events = sorted([(a, 1) for a in st[:, 0]] + [(b, -1) for b in st[:, 5]])
    live = most = 0
    for _t, step in events:
        live += step
        most = max(most, live)
    return {"phases_median_us": {p: round(float(statistics.median(d[:, i])), 3) for i, p in enumerate(PHASES)},
            "block_median_us": round(float(statistics.median(st[:, 5] - st[:, 0])), 3),
            "blocks": n, "most_at_once": most, "span_us": round(float(st[:, 5].max() - st[:, 0].min()), 3)}


def captured() -> dict:
    """{label: [(tokens, T)]} of the split's calls on two routes."""
    sys.path.insert(0, HERE)
    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import engine
    from tpu_deflate_torch.codec import resolve as rs

    corpus = bench.make_corpus(48)
    big_gz, chunks, _payloads = cs.big_members(corpus)
    cont = engine.compress(corpus, engine="cuda", effort=4)
    out = {}
    real = rs.split_tiles_device
    for label, stream, want in (("big members", big_gz, b"".join(chunks)), ("continuous member", cont, corpus)):
        got = out[label] = []

        def spy(tok, T):
            got.append((tok.clone(), T))
            return real(tok, T)

        rs.split_tiles_device = spy
        try:
            assert engine.decompress(stream, engine="cuda") == want
        finally:
            rs.split_tiles_device = real
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    from tpu_deflate_torch.codec import resolve as rs

    lib = build()
    print(f"card: {card()}; torch {torch.__version__}")
    results = []
    for label, calls in captured().items():
        for tok, T in calls:
            want = rs.split_tiles_device(tok, T)
            bound = (tok.numel() * 4 + want.numel() * 4) / HBM_BYTES_PER_S * 1e6
            base = call_us(lambda: rs.split_tiles_device(tok, T))
            print(f"{label} {list(tok.shape)} T={T}: split_tiles_device {base:.2f} us, bound {bound:.2f} us")
            for v, what in VARIANTS.items():
                equal = torch.equal(split(lib, v, tok, T), want)
                us = call_us(lambda: split(lib, v, tok, T))
                p = probe(lib, v, tok, T)
                row = {"call": label, "shape": list(tok.shape), "T": T, "variant": v, "equal": equal,
                       "us": round(us, 2), "bound_us": round(bound, 2), **p}
                results.append(row)
                print(f"  variant {v} ({what}): equal={equal} {us:.2f} us ({100 * bound / us:.1f} % of bound); "
                      f"probe {json.dumps(p)}")
                if not equal:
                    return 1
    print(f"card: {card()}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
