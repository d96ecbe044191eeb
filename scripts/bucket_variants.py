"""Time the variants of the match finder's candidate compare on the card.

    python scripts/bucket_variants.py

Builds ``scripts/bucket_variants.cu`` with ``nvcc`` (the port's flags) into
``tpu_deflate_torch/_kernels_build/``, then, on the links and rows of the
encode's first batch at effort 2 (64 x 65536, quality 0), of the continuous
encode's first batch at effort 4 (64 x 98304, quality 1, with history), of
64 rows of 48-byte records (a 40-byte head and 8 random bytes: long
same-hash groups whose matches stop short of the cap, quality 1) and of 64
rows of zeros (quality 2), runs each variant, holds its output equal to
``encode.match_bucket``'s (the kernel of ``csrc/match.cu``) and prints its
CUDA-event median of 20 launches beside the card's name and power
limit."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (
    "first design: 512 threads, tiles of 4096, bytes and links staged",
    "+ the position's first word read once",
    "links read from global memory, bytes staged",
    "links from global memory + the position's first word once",
    "1024 threads (2 blocks an SM)",
    "1024 threads + the position's first word once",
    "256 threads, links from global memory, first word once (4 blocks an SM)",
    "1024 threads, tiles of 8192, first word once",
    "1024 threads, links from global memory, first word once",
    "512 threads (4 blocks an SM), links from global memory, first word once",
    "512 threads (2 blocks an SM), links staged, first word once",
    "512 threads (4 blocks an SM), tiles of 2048, links from global memory, first word once",
)


def build(lib_dir: str) -> ctypes.CDLL:
    from tpu_deflate_torch import _build

    os.makedirs(lib_dir, exist_ok=True)
    so = os.path.join(lib_dir, "libbucket_variants.so")
    src = os.path.join(HERE, "scripts", "bucket_variants.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(so)
    lib.bucket_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.bucket_variant.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
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
    cont = cs.continuous_batch(corpus, device)["match"]
    rng = np.random.default_rng(46)
    rec = np.tile(np.concatenate([rng.integers(0, 256, 40, dtype=np.uint8), np.zeros(8, np.uint8)]), 2048)
    rec = rec.reshape(-1, 48)
    rec[:, 40:] = rng.integers(0, 256, (2048, 8), dtype=np.uint8)
    records = torch.from_numpy(np.tile(rec.reshape(1, -1), (64, 1))).to(device)
    full = torch.full((64,), 98304, dtype=torch.int32, device=device)
    inputs = {
        "effort 2 batch": (first["rows"], torch.from_numpy(first["lengths"]).to(device), None, 0),
        "effort 4 batch": (cont[0], cont[1], cont[3], 1),
        "records": (records, full, None, 1),
        "zeros": (torch.zeros((64, 98304), dtype=torch.uint8, device=device), full, None, 2),
    }
    card = cs.gpu_name_power()
    ok = True
    for what, (data, lengths, hstart, quality) in inputs.items():
        q = pe._QUALITY[quality]
        fams = [(f, q[k], q[w]) for f, k, w in pe._FAMILIES if k in q]
        prev = pe.match_chain(pe.match_keys(data, lengths, tuple(f for f, _k, _w in fams), hstart))
        ks, ws = tuple(k for _f, k, _w in fams), tuple(w for _f, _k, w in fams)
        want = pe.match_bucket(prev, data, ks, ws)
        L, S = data.shape
        ref_ms = cs.median_ms(lambda: pe.match_bucket(prev, data, ks, ws), 20)
        print(f"{what} {list(prev.shape)} K {ks} words {ws}: match.cu's match_bucket {ref_ms:.4f} ms ({card})")
        for v, name in enumerate(VARIANTS):
            out = torch.empty_like(want)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = lib.bucket_variant(v, prev.data_ptr(), data.data_ptr(), out.data_ptr(), L, S, len(fams),
                                         pe._pack_bytes(ks), pe._pack_bytes(ws), stream)
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            equal = torch.equal(out, want)
            ok &= equal
            print(f"{what} variant {v} ({name}): equal={equal} {cs.median_ms(run, 20):.4f} ms ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
