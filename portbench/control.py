"""The controls of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, held to the same
comparison as a run. Each has to come out not correct. A cell's control
is its op's (``ops/<op>.py``'s ``control``): for a decode, the reference
inflater with a 16 KiB window where the streams need 32 KiB; for an
encode, zlib's gzip members without the ``TD`` size subfield.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

makes each seed's inputs at the cell's own size, runs the control once,
compares as a run does, and prints one JSON line a seed. The benchmark's
runs never call this; ``tests/test_portbench_runs.py`` runs it at a test
size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seed:
        t0 = time.perf_counter()
        inputs = cell.op.make_inputs(cell.config, cell.mix, seed)
        out = cell.op.control(cell.config, cell.mix, inputs)
        checks = cell.op.judge(cell.config, cell.mix, inputs, [(0, out)])
        correct = all(v <= lim for v, lim in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
