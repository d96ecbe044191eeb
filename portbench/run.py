"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``tpu_deflate_torch``), on a machine with the CUDA
devices the cell asks for; without them it exits with a nonzero code and
prints no result. The cell's op (``ops/<op>.py``, named by its mix) makes
its inputs from ``--seed`` and gives the one call into the program; the
run makes one warm call (set-up, timed from the start of this script as
``setup_s``), then calls the program for ``--seconds`` as the mix's loop
says (``harness.run_window``). With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` it traces the window
(``harness.traced_window``) and reports the per-layer metrics that
``metrics/<name>.py`` read from it, with ``busy_s``, ``window_s`` and a
``breakdown``. After the window, and after the device's memory peak is
read, the op's probes hold the program to the guarantees the window's
inputs cannot show, and the plain reference (``refcheck``, through the
op's ``judge``) judges every call's output; the numbers compared and their
limits are the last lines on standard error and the result's last key.
The last line on standard output is the result.

Build and kernel caches stay inside the checkout at fixed paths: the
program's own (``tpu_deflate_torch/_kernels_build/``), the frozen C core's
(``portbench/_build/``), and Triton's and PyTorch's extension caches
(``portbench/_cache/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(HERE, "_cache", sub)
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402
import peaks  # noqa: E402


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else "not read"


def launches() -> dict:
    from tpu_deflate_torch import _build

    return _build.all_launches()


def main(argv=None, card=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    op = cell.op
    card = harness.Card() if card is None else card
    missing = card.missing(cell.chips)
    if missing:
        say(f"portbench: {args.workload} {missing}")
        return 3
    kind = card.kind()

    inputs = op.make_inputs(cell.config, cell.mix, args.seed)
    call = op.program_call(cell.mix, inputs)
    try:  # builds the kernels in a fresh checkout, and warms every shape the window uses
        warm, warm_failed = call(0), 0
    except Exception as e:  # counted with the window's failures; the window shows the rest
        say(f"portbench: the warm call failed: {type(e).__name__}: {e}")
        warm, warm_failed = None, 1
    card.synchronize()
    setup_s = time.perf_counter() - T_START

    before = launches()
    trace = None
    if args.trace:
        w, trace = harness.traced_window(card, call, args.seconds, cell.mix, args.seed, inputs.work_bytes,
                                         lambda o: op.moved_bytes(inputs, o))
    else:
        w = harness.run_window(call, args.seconds, cell.mix, args.seed)
        print(f"call seconds: {json.dumps(w.latency_s)}")
    failed = w.failed + warm_failed
    attempted = len(w.done) + failed
    calls_launches = {k: v - before[k] for k, v in launches().items() if v != before[k]}
    memory_peak = card.peak_bytes()
    if trace is not None and trace.peak_bytes is not None:
        memory_peak = max(memory_peak, trace.peak_bytes)

    # The window is closed and the peak read: the untimed probes, what the
    # process loaded, then the program's state freed.
    probed, probe_lines = op.probe(cell.config, cell.mix, inputs, args.seed)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        say(f"portbench: the run loaded {bad}; none of {list(harness.FORBIDDEN)} may be loaded")
        return 4
    del call
    card.free()
    for line in [*op.notes(), *probe_lines]:
        print(line)
    print(f"launches over {attempted} calls: {json.dumps(calls_launches, sort_keys=True)}")
    for e in w.errors:
        say(f"portbench: a call failed: {e}")

    limit = power_limit()
    device = {"platform": "gpu", "kind": kind, "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if trace is None:
        metrics = end_to_end(cell, op.end_to_end(inputs, w) if w.done else {}, setup_s)
    else:
        trace.peak_bw = peaks.hbm_bytes_per_s(kind)
        for note in trace.notes:
            print(f"trace: {note}")
        metrics = per_layer(cell, trace)
        device.update(busy_s=trace.busy_us / 1e6, window_s=trace.window_us / 1e6)
    say(f"portbench: {args.workload} seed {args.seed}: {attempted} calls, {failed} failed; card {limit}")

    t_ref = time.perf_counter()
    compared = w.done if warm is None else [(0, warm), *w.done]
    checks = {**op.judge(cell.config, cell.mix, inputs, compared), **probed}
    say(f"portbench: reference {time.perf_counter() - t_ref:.3f} s over {len(compared)} outputs")
    correct = failed == 0 and attempted > 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        say(f"check {k}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


def end_to_end(cell, values: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics, from its op's values over all the
    work and time of the window, and the set-up time."""
    values = {**values, "setup_s": setup_s}
    out = {}
    for m in cell.end_to_end:
        if values.get(m["name"]) is None:
            say(f"portbench: no value for {m['name']} in this window")
        else:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(cell, trace) -> dict:
    """Each per-layer metric the cell reports, read by its own file; a
    reader that finds nothing to read leaves its metric out of the line."""
    out = {}
    for m in cell.per_layer:
        reader = harness.load_metric(m["name"])
        value = reader.read(trace)
        if value is None:
            print(f"metric {m['name']}: null (its sources did not appear in this trace)")
        else:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


if __name__ == "__main__":
    sys.exit(main())
