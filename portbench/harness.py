"""The benchmark's harness: it finds a cell's parts by name, runs its window
and reduces what the window left. It knows no operation, layout or metric
of its own: each is a file, found by the name that data gives it.

- ``configs/<config>.json`` (the manifest's ``file``): the deployment, its
  data set (sizes and corpus parts) and ``layout``, the format its streams
  are written in, whose ``kind`` names ``layouts/<kind>.py``;
- ``mixes/<traffic>.json``: ``op``, which names ``ops/<op>.py``, the keys
  that op reads (its ``MIX_KEYS``), and how calls come, read by the one
  loop here (:func:`run_window`): ``loop`` ``closed`` (each of ``callers``
  calls back to back, ``think_s`` apart) or ``open`` (requests arrive at
  ``rate_per_s``, Poisson times drawn from the seed, and ``callers``
  serve them in turn; a request's latency counts its wait). A key that
  neither reads is refused;
- ``ops/<op>.py``: the op's inputs from the seed, its one call into the
  program, its end-to-end values, its probes of the program's guarantees
  after the window, its judge and its control (see ``ops/decode.py``);
- ``layouts/<kind>.py``: ``write(data, layout)``, the stream a decode
  reads, written by the benchmark's own writers;
- ``metrics/<metric>.py``: a per-layer metric's layer, unit, the
  end-to-end metric it moves, its sources and its reader.

The program under test is only ever reached through an op's
``program_call`` and ``probe``.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_deflate")  # top-level module names the run may not load
LOOP_KEYS = {"op", "loop", "callers", "think_s", "rate_per_s", "what"}  # the mix keys the loop reads


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_part(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """The module ``portbench/<kind>/<name>.py`` (names may hold dots)."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind} file {os.path.relpath(path, root)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: str = ROOT) -> ModuleType:
    return load_part("metrics", name, root)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    op: ModuleType  # ops/<mix["op"]>.py
    end_to_end: list  # the manifest's end-to-end entries this cell reports
    per_layer: list  # the manifest's per-layer entries this cell reports


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """An entry with ``workloads`` is reported in the cells it lists; a
    per-layer one without, in every cell that reports what it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def check_mix(name: str, mix: dict, op: ModuleType) -> None:
    """Refuses a mix whose loop the harness cannot run as written, or that
    holds a key neither the loop nor its op reads."""
    unknown = set(mix) - LOOP_KEYS - set(op.MIX_KEYS)
    if unknown:
        raise SystemExit(f"mix {name}: no part reads {sorted(unknown)}")
    loop, callers = mix.get("loop"), mix.get("callers")
    if loop not in ("closed", "open") or not isinstance(callers, int) or callers < 1:
        raise SystemExit(f"mix {name}: 'loop' is 'closed' or 'open', 'callers' a whole number >= 1")
    if (loop == "open") != ("rate_per_s" in mix) or float(mix.get("rate_per_s", 1)) <= 0:
        raise SystemExit(f"mix {name}: an open loop, and only it, has a 'rate_per_s' above 0")
    if float(mix.get("think_s", 0)) < 0 or (loop == "open" and "think_s" in mix):
        raise SystemExit(f"mix {name}: 'think_s' is a closed loop's, at least 0")


def load_cell(name: str, root: str = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, mix, op and metrics."""
    manifest = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, cfg_entry["file"]))
    mix = _json(os.path.join(root, "portbench", "mixes", f"{w['traffic']}.json"))
    op = load_part("ops", mix.get("op", ""), root)
    check_mix(w["traffic"], mix, op)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, mix, op, e2e, per_layer)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


@dataclass
class Window:
    done: list = field(default_factory=list)  # (request index, output) of each call that returned
    failed: int = 0
    errors: list = field(default_factory=list)
    seconds: float = 0.0  # from the window's start to its last call's end
    latency_s: list = field(default_factory=list)  # each call's seconds, from its arrival in an open loop

    @property
    def outputs(self) -> list:
        return [o for _i, o in self.done]


def arrivals(rate_per_s: float, seconds: float, seed: int) -> list:
    """Poisson arrival times in [0, seconds) at ``rate_per_s``, from the seed."""
    import numpy as np

    rng = np.random.default_rng([seed & (2**63 - 1), 0xA221])
    n = int(rate_per_s * seconds * 1.5) + 16
    t = np.cumsum(rng.exponential(1.0 / rate_per_s, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / rate_per_s, n))])
    return t[t < seconds].tolist()


def run_window(call, seconds: float, mix: dict, seed: int, idents: set | None = None) -> Window:
    """Calls ``call(i)`` for requests i = 0, 1, ... as the mix's loop says
    (module docstring). A closed loop starts calls until ``seconds`` have
    passed since the window began; an open loop serves every request that
    arrives in the first ``seconds``. The window ends when its last call
    ends. A call that raises counts as failed, and the loop goes on. The
    threads that call add their ident to ``idents``. One caller calls from
    the calling thread."""
    w = Window()
    lock = threading.Lock()
    counter = itertools.count()
    times = arrivals(float(mix["rate_per_s"]), seconds, seed) if mix["loop"] == "open" else None
    think = float(mix.get("think_s", 0))
    t0 = time.perf_counter()
    ends = [t0]

    def serve() -> None:
        if idents is not None:
            idents.add(threading.get_ident())
        while True:
            with lock:  # an index goes only to a call that will start, so the indices called run 0, 1, ...
                i = next(counter)
                if times is None and i > 0 and time.perf_counter() - t0 >= seconds:
                    return
            if times is None:
                start = time.perf_counter()
            else:
                if i >= len(times):
                    return
                start = t0 + times[i]
                time.sleep(max(0.0, start - time.perf_counter()))
            try:
                out, err = call(i), None
            except Exception as e:  # counted as failed and reported; the window goes on
                out, err = None, f"{type(e).__name__}: {e}"
            end = time.perf_counter()
            with lock:
                w.latency_s.append(end - start)
                ends.append(end)
                if err is None:
                    w.done.append((i, out))
                else:
                    w.failed += 1
                    if len(w.errors) < 3:
                        w.errors.append(err)
            if times is None and think:
                time.sleep(think)

    if int(mix["callers"]) == 1:
        serve()
    else:
        threads = [threading.Thread(target=serve, name=f"portbench-caller-{k}") for k in range(int(mix["callers"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    w.seconds = max(ends) - t0
    w.done.sort(key=lambda d: d[0])
    return w


class Card:
    """The CUDA devices a run uses, behind the few calls the harness makes
    of them (a test drives a run with a stand-in of the same shape)."""

    def __init__(self):
        import torch

        self.torch = torch

    def missing(self, chips: int) -> str | None:
        """Why the run cannot go on with ``chips`` devices, or None."""
        cuda = self.torch.cuda
        if not cuda.is_available() or cuda.device_count() < chips:
            return f"needs {chips} CUDA device(s); available: {cuda.is_available()}, count {cuda.device_count()}"
        return None

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(0)

    def synchronize(self) -> None:
        self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def free(self) -> None:
        self.torch.cuda.empty_cache()


def traced_window(card: Card, call, seconds: float, mix: dict, seed: int, work_bytes: int, moved_out) -> tuple:
    """The traced run's window: its first half under torch.profiler with the
    stack sampler, its second under cProfile, each through
    :func:`run_window`. Returns (Window of both halves, devtrace.Trace).
    A call's bytes moved come from ``moved_out(output)``."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace

    starts: list = []

    def ranged(i):
        starts.append(time.perf_counter_ns())
        with record_function(devtrace.CALL_RANGE):
            out = call(i)
            card.synchronize()
        return out

    card.synchronize()
    card.reset_peak()
    notes = []
    both = Window()
    # A profiler session on the card can record no device event at all; a
    # later session is tried, over a shorter stretch, at most twice.
    for attempt, share in enumerate((0.5, 0.125, 0.125)):
        starts.clear()
        idents: set = set()
        with devtrace.StackSampler(idents) as sampler, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first = run_window(ranged, seconds * share, mix, seed + attempt, idents)
        both.done += first.done
        both.failed += first.failed
        both.errors += first.errors
        device, window, samples = devtrace.from_profiler(prof, sorted(starts), sampler.samples)
        if device:
            break
        notes.append(f"profiler session {attempt + 1} recorded no device event")
    peak = card.peak_bytes()
    profs: dict = {}  # a cProfile per calling thread, on only inside calls

    def profiled(i):
        pr = profs.setdefault(threading.get_ident(), cProfile.Profile())
        pr.enable()
        try:
            return call(i)
        finally:
            pr.disable()

    second = run_window(profiled, seconds / 2, mix, seed + 3)
    t = devtrace.Trace(
        device=device, window=window, samples=samples,
        device_mib=len(first.done) * work_bytes / 2**20,
        device_bytes_moved=sum(moved_out(o) for o in first.outputs),
        host_mib=len(second.done) * work_bytes / 2**20,
        host_stats=pstats.Stats(*profs.values()).stats if profs else {},
        peak_bytes=peak,
        notes=notes,
    )
    both.done += second.done
    both.failed += second.failed
    both.errors += second.errors
    return both, t


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
