"""Time the variants of the match finder's chain kernel on the card.

    python scripts/chain_variants.py

Builds ``scripts/chain_variants.cu`` with ``nvcc`` (the port's flags) into
``tpu_deflate_torch/_kernels_build/``, then, on the keys of the encode's
first batch at effort 2 (64 x 65536, two hash families), of the continuous
encode's first batch at effort 4 (64 x 98304, three families) and of 64
rows of zeros and of random bytes of 98304 columns (three families), runs
each variant, holds its links equal to ``encode.match_chain``'s (the
kernel of ``csrc/match.cu``) and prints its CUDA-event median of 20
launches beside the card's name and power limit."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (
    "first design: 4 parts a block each, uint16 heads, 128 threads, keys loaded 8 steps at a time",
    "+ the next 8 steps' keys prefetched",
    "+ the 8 steps' match_any hoisted",
    "+ one warp a block",
    "8 parts, int32 heads, no epochs",
    "one warp, peers by 62 shuffles",
    "8 parts, uint16 heads, one warp",
    "16 parts, uint16 heads, one warp",
    "variant 3 + links stored after the 8 steps",
    "variant 8 without __syncwarp (volatile heads, no branch)",
    "variant 8 at 8 parts",
    "variant 3 without __syncwarp",
    "dense: 8 parts, chunks of 2048 gathered by 4 warps, warp 0 walks the part's positions only",
    "dense: 16 parts, chunks of 2048",
    "dense: 8 parts, chunks of 4096",
    "dense: 4 parts, chunks of 2048",
    "variant 3 with the peers from 15 ballots (radix match) in place of match_any",
    "dense, radix match: 8 parts, chunks of 2048",
    "dense, radix match: 4 parts, chunks of 2048",
    "dense, radix match: 8 parts, chunks of 1024",
    "dense, radix match: 16 parts, chunks of 2048",
    "split: a block a row, 8 walkers, chunks of 2048",
    "split: 16 walkers, chunks of 2048",
    "split: 16 walkers, chunks of 4096",
    "split: 8 walkers, chunks of 1024",
    "split + tags (match_any only in steps with a shared hash): 16 walkers, chunks of 4096",
    "split + tags: 16 walkers, chunks of 2048",
    "split + tags: 8 walkers, chunks of 2048",
    "split + links staged, stored coalesced a chunk at a time: 16 walkers, chunks of 4096",
    "split + tags + staged links: 16 walkers, chunks of 4096",
    "split + staged links: 16 walkers, chunks of 2048",
    "split + staged links: 8 walkers, chunks of 4096",
    "variant 28 with 2 steps' peers and predecessors ahead of their head reads",
    "variant 28 with 4 steps ahead",
)


def build(lib_dir: str) -> ctypes.CDLL:
    from tpu_deflate_torch import _build

    os.makedirs(lib_dir, exist_ok=True)
    so = os.path.join(lib_dir, "libchain_variants.so")
    src = os.path.join(HERE, "scripts", "chain_variants.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(so)
    lib.chain_variant.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.chain_variant.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import bench
    import chip_smoke as cs
    from tpu_deflate_torch import _build
    from tpu_deflate_torch.codec import encode as pe

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = build(_build.BUILD_DIR)
    device = torch.device("cuda")
    corpus = bench.make_corpus(48)
    first = cs.encode_batch(corpus[: pe.ENC_LANE_BATCH * cs.MEMBER], device)
    lengths = torch.from_numpy(first["lengths"]).to(device)
    cont = cs.continuous_batch(corpus, device)["match"]
    g = torch.Generator(device="cpu").manual_seed(47)
    full = torch.full((64,), 98304, dtype=torch.int32, device=device)
    three = (pe.FAMILY_4, pe.FAMILY_3, pe.FAMILY_6)
    inputs = {
        "effort 2 batch": pe.match_keys(first["rows"], lengths, (pe.FAMILY_4, pe.FAMILY_3)),
        "effort 4 batch": pe.match_keys(cont[0], cont[1], three, cont[3]),
        "zeros": pe.match_keys(torch.zeros((64, 98304), dtype=torch.uint8, device=device), full, three),
        "random": pe.match_keys(torch.randint(0, 256, (64, 98304), generator=g, dtype=torch.uint8).to(device), full,
                                three),
    }
    card = cs.gpu_name_power()
    ok = True
    for what, keys in inputs.items():
        F, L, S = keys.shape
        want = pe.match_chain(keys)
        ref_ms = cs.median_ms(lambda: pe.match_chain(keys), 20)
        print(f"{what} {[F, L, S]}: match.cu's match_chain {ref_ms:.4f} ms ({card})")
        for v, name in enumerate(VARIANTS):
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = lib.chain_variant(v, keys.data_ptr(), out.data_ptr(), L, S, F, stream)
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            equal = torch.equal(out.to(torch.int32), want.to(torch.int32))
            ok &= equal
            print(f"{what} variant {v} ({name}): equal={equal} {cs.median_ms(run, 20):.4f} ms ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
