"""Where a launch of stage C's kernel spends its time, from timestamps.

    python scripts/stage_c_probe.py

Builds ``scripts/stage_c_probe.cu`` (the production kernel of ``csrc/
stage_c.cu`` with ``%globaltimer`` stamps at its phase boundaries) with
``nvcc`` into ``tpu_deflate_torch/_kernels_build/``, captures the inputs of
the decode main path's stage C calls and of the continuous member's decode
(``stage_c_segments.captured_inputs``), and runs the probe on each main-path
wave and on the first continuous wave at the wrapper's segment length and
at 16, 64 and 128 tiles. Per launch it holds the outputs equal to
``decode_kernels.stage_c``'s and prints the span from the first block's
start to the last block's stores (ns), the spread of the blocks' starts,
and for each phase (ticket, maps staged, chunk maps, scan, look-back with
the map's publication beside it, replay, stores) the median and largest time over the blocks,
beside the card's name and power limit, the SM clock the blocks ran at
(clock64 over globaltimer), nvidia-smi's clocks and the kernel's SASS
instruction count (cuobjdump)."""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# phase: (stamp before, stamp after); stamp 5 is unused (warp 1 publishes a segment's map beside the look-back)
PHASES = {"ticket": (0, 1), "maps staged": (1, 2), "chunk maps": (2, 3), "scan": (3, 4), "look-back": (4, 6),
          "replay": (6, 7), "stores": (7, 8)}


def build(lib_dir: str) -> ctypes.CDLL:
    from tpu_deflate_torch import _build

    os.makedirs(lib_dir, exist_ok=True)
    so = os.path.join(lib_dir, "libstage_c_probe.so")
    src = os.path.join(HERE, "scripts", "stage_c_probe.cu")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    lib.stage_c_probe.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.stage_c_probe.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    from keys_stage_c_ab import card
    from stage_c_segments import captured_inputs
    from tpu_deflate_torch import _build
    from tpu_deflate_torch.codec import decode_kernels as dk

    lib = build(_build.BUILD_DIR)
    print(f"card: {card()}; torch {torch.__version__}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv"],
                         capture_output=True, text=True).stdout.strip())
    sass = subprocess.run([os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"), "-sass",
                           os.path.join(_build.BUILD_DIR, "libstage_c_probe.so")],
                          capture_output=True, text=True).stdout.split("Function : ")
    body = next((f for f in sass if "stage_c_kernel" in f.splitlines()[0]), "")
    print(f"stage_c_kernel (probe): {sum(1 for x in body.splitlines() if x.strip().startswith('/*0'))} SASS "
          "instructions")
    inputs = captured_inputs()
    runs = [("main path", t, e) for t, e in inputs["main path"]] + [("continuous", *inputs["continuous member"][0])]
    for label, t, e in runs:
        L, NT, _E = t.shape
        for seg in sorted({dk.stage_c_segment(L, NT), *(min(s, NT) for s in (16, 64, 128))}):
            nseg = -(-NT // seg)
            want = dk.stage_c(t, e)
            for _ in range(3):
                entries = torch.empty((L, NT), dtype=torch.uint8, device=t.device)
                entries32 = torch.empty((L, NT), dtype=torch.int32, device=t.device)
                final = torch.empty(L, dtype=torch.uint8, device=t.device)
                scratch = torch.zeros(L * nseg * 7 + 1, dtype=torch.int64, device=t.device)
                stamps = torch.zeros((L * nseg, 12), dtype=torch.int64, device=t.device)
                _build.check(lib.stage_c_probe(t.data_ptr(), e.data_ptr(), entries.data_ptr(), entries32.data_ptr(),
                                               final.data_ptr(), scratch.data_ptr(), stamps.data_ptr(), L, NT, seg,
                                               _build.stream(t.device)), "stage_c_probe")
                torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip((entries, final, entries32), want)), f"{label} seg {seg}"
            s = stamps.cpu().tolist()
            t0 = min(r[0] for r in s)
            phases = {}
            for name, (a, b) in PHASES.items():
                d = [r[b] - r[a] for r in s]
                phases[name] = [statistics.median(d), max(d)]
            ghz = statistics.median((r[11] - r[10]) / (r[8] - r[0]) for r in s if r[8] > r[0])
            print(f"{label} {L}x{NT} seg {seg} ({L * nseg} blocks): span {max(r[8] for r in s) - t0} ns, starts "
                  f"spread {max(r[0] for r in s) - t0} ns, SM clock {ghz:.3f} GHz (clock64 over globaltimer); "
                  f"phase [median, max] ns: {json.dumps(phases)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
