"""The reduction from a traced run to the numbers the per-layer metrics read.

A traced run measures in two halves (``harness.traced_window``): the first
under ``torch.profiler`` (device events by CUPTI, one ``portbench.call``
range a call) with a sampler of the host's stack beside it, the second
under ``cProfile``. :class:`Trace` holds what both left, and offers the
readers in ``metrics/`` the few questions they ask:

- :meth:`Trace.kernel_us`: device microseconds of the kernels whose names
  match, None where none ran;
- :meth:`Trace.host_s`: cProfile seconds of a set of the program's
  functions, a call counted once where one listed function calls another,
  None where none was called;
- ``busy_us``, ``window_us``: the union of device intervals (kernels,
  copies, fills) inside the traced window, and the window, from the first
  call's start to the last call's end.

The profiler's events carry its own clock; the sampler's carry the host's.
The ``portbench.call`` ranges, stamped on both, give the offset.
"""

from __future__ import annotations

import bisect
import collections
import os
import re
import statistics
import sys
import threading
import time
from dataclasses import dataclass, field

CALL_RANGE = "portbench.call"
SAMPLE_S = 0.001
PROGRAM = "tpu_deflate_torch"


def _ident(name: str) -> re.Pattern:
    """A kernel's name as a whole identifier inside a demangled signature."""
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")


def short_name(name: str) -> str:
    """A device event's name without its argument list, its ``void`` and
    its anonymous namespace (the port's kernels live in one)."""
    n = name.strip()
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    n = n.removeprefix("void ").replace("(anonymous namespace)::", "").strip()
    return n or name


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union_us(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def gaps(intervals: list, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for s, e in sorted(intervals):
        if s > reach:
            out.append((reach, min(s, hi)))
        reach = max(reach, e)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(s, e) for s, e in out if e > s]


class StackSampler:
    """Samples, every SAMPLE_S, which of the program's functions each
    calling thread is in: the innermost frame in the program's package,
    named ``module.function``, or the innermost frame's ``file:function``
    outside it. The calling threads are the idents in ``idents`` (filled
    by the loop as its callers start), or the main thread while it is
    empty. Runs on a thread of its own while the profiler half runs."""

    def __init__(self, idents: set | None = None):
        self.samples: list = []  # (perf_counter_ns, label)
        self._stop = threading.Event()
        self._idents = set() if idents is None else idents
        self._main = threading.main_thread().ident
        self._thread = threading.Thread(target=self._run, name="portbench-sampler", daemon=True)

    @staticmethod
    def label(frame) -> str:
        inner = frame
        while frame is not None:
            path = frame.f_code.co_filename
            at = path.rfind(os.sep + PROGRAM + os.sep)
            if at >= 0:
                mod = path[at + len(PROGRAM) + 2 :].removesuffix(".py").replace(os.sep, ".")
                return f"{mod}.{frame.f_code.co_name}"
            frame = frame.f_back
        return f"{os.path.basename(inner.f_code.co_filename)}:{inner.f_code.co_name}"

    def _run(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            frames = sys._current_frames()
            now = time.perf_counter_ns()
            for ident in list(self._idents) or [self._main]:
                frame = frames.get(ident)
                if frame is not None:
                    self.samples.append((now, self.label(frame)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


@dataclass
class Trace:
    """What a traced run left (see the module docstring). Times in µs on
    the profiler's clock; MiB is the cell's unit of work (decompressed bytes
    for a decode, input bytes for an encode) of the calls in each half."""

    device: list = field(default_factory=list)  # (name, start_us, end_us)
    window: tuple = (0.0, 0.0)
    samples: list = field(default_factory=list)  # (us on the profiler's clock, label)
    device_mib: float = 0.0
    device_bytes_moved: int = 0  # compressed + uncompressed bytes of the profiled calls
    host_mib: float = 0.0
    host_stats: dict = field(default_factory=dict)  # pstats' stats: key -> (cc, nc, tt, ct, callers)
    peak_bytes: int | None = None
    peak_bw: float | None = None  # the card's published bytes/s
    notes: list = field(default_factory=list)  # what the run says about its trace on earlier lines

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for _n, s, e in self.device], *self.window)

    def kernel_us(self, names) -> float | None:
        pats = [_ident(n) for n in names]
        us = [e - s for n, s, e in self.device if any(p.search(n) for p in pats)]
        return sum(us) if us else None

    def all_kernels_us(self) -> float | None:
        us = [e - s for n, s, e in self.device if is_kernel(n)]
        return sum(us) if us else None

    def host_s(self, functions) -> float | None:
        """cProfile's cumulative seconds of ``functions`` ((path under the
        program's package, function name) pairs), less the time one listed
        function spends in a call to another, so nothing counts twice."""
        keys = {k for k in self.host_stats
                if any(k[0].endswith(os.sep.join((PROGRAM, *p.split("/")))) and k[2] == f for p, f in functions)}
        if not keys:
            return None
        total = sum(self.host_stats[k][3] for k in keys)
        nested = sum(ct[3] for k in keys for caller, ct in self.host_stats[k][4].items() if caller in keys)
        return total - nested

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps'
        time by what the host was doing in them, each [name, seconds]."""
        ops = collections.Counter()
        for n, s, e in self.device:
            ops[short_name(n)] += (e - s) / 1e6
        idle = collections.Counter()
        times = [t for t, _l in self.samples]
        for s, e in gaps([(s, e) for _n, s, e in self.device], *self.window):
            i, j = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
            if j > i:
                for _t, lab in self.samples[i:j]:
                    idle[lab] += (e - s) / 1e6 / (j - i)
            else:
                idle[self.samples[i - 1][1] if i > 0 else "unsampled"] += (e - s) / 1e6
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}


def from_profiler(prof, host_starts_ns: list, samples: list) -> tuple[list, tuple, list]:
    """(device events, traced window, samples on the profiler's clock) from
    a finished ``torch.profiler.profile`` whose calls ran in
    ``portbench.call`` ranges, entered at ``host_starts_ns``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, calls = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if e.name == CALL_RANGE or getattr(e, "is_user_annotation", False):
                continue
            device.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        elif e.name == CALL_RANGE:
            calls.append((float(e.time_range.start), float(e.time_range.end)))
    calls.sort()
    if calls and len(calls) == len(host_starts_ns):
        offset = statistics.median(h / 1e3 - s for h, (s, _e) in zip(host_starts_ns, calls))
        window = (calls[0][0], calls[-1][1])
    else:  # no ranges to align by: the device's own extent, the samples unplaced
        offset, window = None, (min((s for _n, s, _e in device), default=0.0),
                                max((e for _n, _s, e in device), default=0.0))
    placed = [] if offset is None else [(t / 1e3 - offset, lab) for t, lab in samples]
    return device, window, placed
