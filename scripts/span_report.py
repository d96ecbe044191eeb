"""A cell's calls layer by layer, from the port's own spans
(``tpu_deflate_torch.spans``) in one ``torch.profiler`` session on the card
beside the device's events, and what the spans cost.

    python3 scripts/span_report.py --workload <cell> --seed <n> [--seconds 20] [--off-seconds 20] [--out FILE]

Run from the root of a checkout that holds the program and ``portbench/``,
on a machine with a CUDA device. It builds the cell's inputs from the seed
as ``portbench/run.py`` does and makes one warm call, then:

- calls the program for ``--off-seconds`` with no profiler (the spans off);
- calls it for ``--seconds`` under ``torch.profiler`` (CPU and CUDA), each
  call in a ``portbench.call`` range, and reduces the session as a traced
  run reduces its device half (``devtrace.from_profiler``), with the spans
  (``spantrace.program_spans``) on the same clock;
- times ``spans.span`` off, and ``record_function`` inside an active
  session, per span.

It prints one JSON line (also written to ``--out``): calls a second in
both windows, the device's idle share, every reading of ``spantrace.
READINGS`` for the cell's op, each span's calls, self and whole ms per MiB,
the spans a call, the roots' self share, the emit layer's device µs per MiB
(``parse_transfers_kernel``, ``parse_replay_kernel``,
``finish_analysis_kernel``, ``emit_kernel``), the device events and
breakdown entries that carry a ``td.`` name (none should), and the card's
name and power limit. On a checkout without the spans module the span
fields are null and the rest is measured the same way.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.getcwd()
sys.path[:0] = [os.path.join(ROOT, "portbench"), ROOT]

import devtrace  # noqa: E402
import harness  # noqa: E402
import spantrace  # noqa: E402

EMIT_KERNELS = ("parse_transfers_kernel", "parse_replay_kernel", "finish_analysis_kernel", "emit_kernel")


def card_name() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"


def profiled_window(call, seconds: float, mix: dict, seed: int):
    """(Window, devtrace.Trace without MiB, spans, the session) of calls in
    ``portbench.call`` ranges under a CPU and CUDA profiler session; a
    session with no device event is tried again, at most twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(3):
        starts = []

        def ranged(i):
            starts.append(time.perf_counter_ns())
            with record_function(devtrace.CALL_RANGE):
                out = call(i)
                torch.cuda.synchronize()
            return out

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w = harness.run_window(ranged, seconds, mix, seed + attempt)
        device, window, _samples = devtrace.from_profiler(prof, sorted(starts), [])
        if device:
            break
    return w, devtrace.Trace(device=device, window=window), spantrace.program_spans(prof), prof


def span_costs(n_off: int = 200_000, n_on: int = 20_000) -> dict | None:
    """Microseconds a span costs: off (the flag check and the shared no-op)
    and on (``record_function`` inside an active CPU and CUDA session)."""
    try:
        from tpu_deflate_torch.spans import span
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    def loop(n: int, spanned: bool) -> float:
        t0 = time.perf_counter()
        if spanned:
            for _ in range(n):
                with span("td.decode.prep"):
                    pass
        else:
            for _ in range(n):
                pass
        return time.perf_counter() - t0

    off = (loop(n_off, True) - loop(n_off, False)) / n_off * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = (loop(n_on, True) - loop(n_on, False)) / n_on * 1e6
    return {"off_us_per_span": off, "on_us_per_span": on}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--off-seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    cell = harness.load_cell(args.workload)
    op = "decode" if "decode_GBps" in {m["name"] for m in cell.end_to_end} else "encode"
    inputs = cell.op.make_inputs(cell.config, cell.mix, args.seed)
    call = cell.op.program_call(cell.mix, inputs)
    call(0)
    torch.cuda.synchronize()

    off = harness.run_window(call, args.off_seconds, cell.mix, args.seed + 1)
    w, t, spans, prof = profiled_window(call, args.seconds, cell.mix, args.seed + 2)
    n = len(w.done)
    t.device_mib = n * inputs.work_bytes / 2**20
    mib = t.device_mib

    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s[0]].append(s)
    roots = [f"td.{op}"]
    root_total = spantrace.total_us(spans, roots)
    emit_us = t.kernel_us(EMIT_KERNELS)
    cuda = torch.autograd.DeviceType.CUDA
    annotations = sum(1 for e in prof.events() if e.device_type == cuda and e.name.startswith(spantrace.PREFIX))
    result = {
        "workload": args.workload, "seed": args.seed, "card": card_name(), "torch": torch.__version__,
        "calls_off": len(off.done), "calls_per_s_off": len(off.done) / off.seconds,
        "calls_profiled": n, "calls_per_s_profiled": n / (t.window_us / 1e6) if t.window_us > 0 else None,
        "window_s": t.window_us / 1e6, "busy_s": t.busy_us / 1e6,
        "device_idle_pct": 100.0 * (1 - t.busy_us / t.window_us) if t.window_us > 0 else None,
        "readings": {k: spantrace.reading(k, t, spans) for k in spantrace.READINGS if k.endswith(op)},
        "emit_us_per_MiB": None if emit_us is None or op != "encode" else emit_us / mib,
        "spans_per_call": len(spans) / n if n else None,
        "spans": {name: {"per_call": len(v) / n,
                         "self_ms_per_MiB": spantrace.self_us(spans, name) / 1e3 / mib,
                         "total_ms_per_MiB": spantrace.total_us(spans, name) / 1e3 / mib}
                  for name, v in sorted(by_name.items())},
        "root_self_share_pct": (None if root_total is None
                                else 100.0 * spantrace.self_us(spans, roots) / root_total),
        "idle_unspanned_us": spantrace.idle_outside_layers_us(t, spans),
        "td_device_events": sum(n_.startswith(spantrace.PREFIX) for n_, _s, _e in t.device),
        "td_breakdown_ops": sum(o.startswith(spantrace.PREFIX)
                                for o, _v in t.breakdown(top=10**6)["device_ops"]),
        "td_cuda_annotations": annotations,
        "device_ops": t.breakdown(top=12)["device_ops"],
        "span_costs": span_costs(),
        "failed": off.failed + w.failed,
    }
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
