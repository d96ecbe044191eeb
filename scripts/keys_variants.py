"""Time the variants of the match finder's key kernel on the card.

    python scripts/keys_variants.py

Builds ``scripts/keys_variants.cu`` with ``nvcc`` (the port's flags) into
``tpu_deflate_torch/_kernels_build/``, then, on the encode's first batch at
effort 2 (64 rows of 65536 bytes of ``bench.make_corpus(48)``, the 4- and
3-byte families) and the continuous encode's first batch at effort 4 (64 x
98304 halo rows, three families, hstart), runs each variant, holds its keys
equal to ``encode.match_keys``'s (the kernel of ``csrc/match.cu``) and
prints its device time per launch: 20 launches queued behind a spin kernel
between two CUDA events, the least of 5 such runs. Beside them the same for
``match_keys`` itself and, as the card's ceilings for the keys' bytes, a
``fill_`` of a tensor of the keys' size and a ``copy_`` of one, each beside
the bytes bound at 3.35 TB/s and the card's name and power limit."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (
    "a thread a position, grid (S / 256, L, F), six byte loads (the kernel before the redesign)",
    "a run of 16 a thread: a 16-byte and an 8-byte load, four 16-byte stores a family",
    "variant 1 with streaming stores (__stcs)",
    "four runs of 4 a thread, lanes 4 positions apart: word loads, shuffles, one coalesced 16-byte store a run",
    "variant 1 with the keys staged in shared memory, stored 512 contiguous bytes a warp instruction",
    "variant 3 with streaming stores",
)
REPS, RUNS = 20, 5
SPIN_CYCLES = 2_000_000
HBM_BYTES_PER_S = 3.35e12


def build(lib_dir: str) -> ctypes.CDLL:
    from tpu_deflate_torch import _build

    os.makedirs(lib_dir, exist_ok=True)
    so = os.path.join(lib_dir, "libkeys_variants.so")
    src = os.path.join(HERE, "scripts", "keys_variants.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(so)
    lib.keys_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.keys_variant.restype = ctypes.c_int
    return lib


def per_launch_us(fn) -> float:
    """Device us per call: REPS calls queued behind a spin, between two
    CUDA events; the least of RUNS."""
    import torch

    fn()
    best = float("inf")
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) * 1000 / REPS)
    return best


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import bench
    from keys_stage_c_ab import card
    from tpu_deflate_torch import _build
    from tpu_deflate_torch.codec import continuous as pc
    from tpu_deflate_torch.codec import encode as pe

    lib = build(_build.BUILD_DIR)
    dev = torch.device("cuda")
    flat = np.frombuffer(bench.make_corpus(48), np.uint8)
    L, S2 = pe.ENC_LANE_BATCH, 65536
    rows4, hstart4, pay_lens, _final = pc.lane_rows(flat, 0, L, S2)
    batches = {
        "effort 2": (torch.from_numpy(flat[: L * S2].reshape(L, S2).copy()).to(dev),
                     torch.full((L,), S2, dtype=torch.int32, device=dev), (pe.FAMILY_4, pe.FAMILY_3), None),
        "effort 4": (torch.from_numpy(rows4).to(dev),
                     torch.from_numpy((pc.HALO_COLS + pay_lens).astype(np.int32)).to(dev),
                     (pe.FAMILY_4, pe.FAMILY_3, pe.FAMILY_6), torch.from_numpy(hstart4).to(dev)),
    }
    print(f"card: {card()}; torch {torch.__version__}")
    stream = torch.cuda.current_stream().cuda_stream
    for label, (data, lengths, families, hstart) in batches.items():
        Lb, S = data.shape
        F = len(families)
        codes = sum(f << (2 * i) for i, f in enumerate(families))
        want = pe.match_keys(data, lengths, families, hstart)
        nbytes = Lb * S + 4 * Lb * (1 + (hstart is not None)) + 4 * F * Lb * S
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        print(f"{label}: {Lb} x {S}, F = {F}, bound {bound:.3f} us ({nbytes} bytes)")
        out = torch.empty_like(want)
        hs = 0 if hstart is None else hstart.data_ptr()
        for v, what in enumerate(VARIANTS):
            def run(v=v):
                _build.check(lib.keys_variant(v, data.data_ptr(), lengths.data_ptr(), hs, out.data_ptr(), Lb, S, F,
                                              codes, stream), f"keys_variant {v}")
            out.fill_(0)
            run()
            assert torch.equal(out, want), f"{label}: variant {v} differs"
            us = per_launch_us(run)
            print(f"{label} variant {v} ({what}): {us:.3f} us, {100 * bound / us:.1f} % of the bound")
        us = per_launch_us(lambda: pe.match_keys(data, lengths, families, hstart))
        print(f"{label} match_keys (csrc/match.cu): {us:.3f} us, {100 * bound / us:.1f} % of the bound")
        other = torch.empty_like(want)
        wbytes = 4 * F * Lb * S
        us = per_launch_us(lambda: out.fill_(-1))
        print(f"{label} fill_ of the keys' {wbytes} bytes: {us:.3f} us, "
              f"{wbytes / us / 1e6:.3f} TB/s ({100 * wbytes / HBM_BYTES_PER_S * 1e6 / us:.1f} % of 3.35)")
        us = per_launch_us(lambda: out.copy_(other))
        print(f"{label} copy_ of the keys' {wbytes} bytes: {us:.3f} us, "
              f"{2 * wbytes / us / 1e6:.3f} TB/s read and written ({100 * 2 * wbytes / HBM_BYTES_PER_S * 1e6 / us:.1f} % of 3.35)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
