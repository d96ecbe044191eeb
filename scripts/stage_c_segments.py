"""Time stage C's kernel at each segment length on the card.

    python scripts/stage_c_segments.py

Captures the inputs of every stage C call of the decode's main path
(``engine.decompress`` of the members of ``bench.make_corpus(48)``: 5
waves) and of the continuous member's decode (``engine.compress(corpus,
effort=4)``, then its decode), then launches ``td_stage_c`` (``csrc/
stage_c.cu``) on them at segment lengths of 16 to 512 tiles and at the one
``decode_kernels.stage_c_segment`` picks, holds every output equal to
``decode_kernels.stage_c``'s and prints, per segment length, the kernel's
device time per wave shape and summed over each path (torch.profiler, or
CUDA events a call where it records none; ``keys_stage_c_ab.device_times``)
beside the card's name and power limit."""

from __future__ import annotations

import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = (16, 32, 64, 128, 256, 512)


def launch(transfers, entry0, seg: int):
    """``decode_kernels.stage_c`` at a given segment length."""
    import torch

    from tpu_deflate_torch import _build

    L, NT, _E = transfers.shape
    dev = transfers.device
    entries = torch.empty((L, NT), dtype=torch.uint8, device=dev)
    entries32 = torch.empty((L, NT), dtype=torch.int32, device=dev)
    final = torch.empty(L, dtype=torch.uint8, device=dev)
    scratch = torch.zeros(L * -(-NT // seg) * 7 + 1, dtype=torch.int64, device=dev)
    err = _build.load().td_stage_c(transfers.data_ptr(), entry0.data_ptr(), entries.data_ptr(), entries32.data_ptr(),
                                   final.data_ptr(), scratch.data_ptr(), L, NT, seg, _build.stream(dev))
    _build.check(err, "td_stage_c")
    return entries, final, entries32


def captured_inputs() -> dict:
    """{path: [(maps, entry0) of each stage C call]} of the decode's main
    path and of the continuous member's decode on the card."""
    sys.path.insert(0, HERE)
    import bench
    from tpu_deflate_torch import engine, native
    from tpu_deflate_torch.codec import decode_kernels as dk

    corpus = bench.make_corpus(48)
    streams = {"main path": native.compress_members_native(corpus),
               "continuous member": engine.compress(corpus, engine="cuda", effort=4)}
    stage_c = dk.stage_c
    out = {}
    for label, stream in streams.items():
        inputs = out[label] = []

        def spy(t, e, inputs=inputs):
            inputs.append((t.clone(), e.clone()))
            return stage_c(t, e)

        dk.stage_c = spy
        try:
            assert engine.decompress(stream, engine="cuda") == corpus
        finally:
            dk.stage_c = stage_c
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    from keys_stage_c_ab import card, device_times
    from tpu_deflate_torch.codec import decode_kernels as dk

    print(f"card: {card()}; torch {torch.__version__}")
    for label, inputs in captured_inputs().items():
        want = [dk.stage_c(t, e) for t, e in inputs]
        for seg in (*SEGMENTS, "policy"):
            segs = [dk.stage_c_segment(*t.shape[:2]) if seg == "policy" else min(seg, t.shape[1]) for t, _e in inputs]
            calls = [lambda t=t, e=e, s=s: launch(t, e, s) for (t, e), s in zip(inputs, segs)]
            for fn, w in zip(calls, want):
                assert all(torch.equal(g, x) for g, x in zip(fn(), w)), f"{label}: segment {seg} differs"
            times = device_times(calls, "stage_c_kernel")
            by_shape: dict = {}
            for (t, _e), s, us in zip(inputs, segs, times["us"]):
                by_shape.setdefault(f"{t.shape[0]}x{t.shape[1]} seg {s}", []).append(us)
            print(f"{label} segment {seg}: {len(calls)} launches, {sum(times['us']):.3f} us summed ({times['source']}); "
                  + json.dumps({k: round(statistics.median(v), 3) for k, v in by_shape.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
