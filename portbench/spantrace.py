"""The program's own spans in a traced run, and the readings a per-layer
metric takes from them.

The program names its layer boundaries with ``torch.profiler`` ranges whose
names start with ``td.``: ``td.<op>`` is a call's root, ``td.<op>.<layer>`` a
layer inside it. They are CPU events of the same profiler session as the
device events that ``devtrace.from_profiler`` keeps, so their times are on
the clock of ``Trace.device`` and ``Trace.window``, with no offset to
estimate. Spans are matched by that prefix, as the metrics match kernels by
name: nothing of the program is imported here.

- :func:`program_spans`: a finished session's spans, with their parents;
- :func:`self_us`: the time spans of some names spent outside their child
  spans;
- :func:`idle_outside_layers_us`: the device-idle time of the traced window
  during which no thread was inside a layer span;
- :data:`READINGS` and :func:`reading`: the per-layer readings of the spans,
  by metric name.
"""

from __future__ import annotations

import collections

from devtrace import union_us

PREFIX = "td."


def is_layer(name: str) -> bool:
    """A layer span, ``td.<op>.<layer>``, as against a call's root."""
    return name.startswith(PREFIX) and name.count(".") == 2


def program_spans(prof) -> list:
    """The ``td.`` CPU ranges of a finished ``torch.profiler.profile``, in
    order of start, as (name, start_us, end_us, thread, parent): ``parent``
    is the index among them of the innermost span on the same thread that
    holds this one, or -1. Nothing is clipped."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    found = [(e.name, float(e.time_range.start), float(e.time_range.end), e.thread)
             for e in prof.events() if e.device_type == cpu and e.name.startswith(PREFIX)]
    return with_parents(found)


def with_parents(found: list) -> list:
    """(name, start, end, thread) ranges -> :func:`program_spans`' tuples.
    Ranges of one thread nest (they are context managers), so a range's
    parent is the innermost earlier one on its thread that has not ended."""
    found = sorted(found, key=lambda s: (s[1], -s[2]))
    out, open_by_thread = [], collections.defaultdict(list)
    for i, (name, start, end, thread) in enumerate(found):
        stack = open_by_thread[thread]
        while stack and found[stack[-1]][2] < end:
            stack.pop()
        out.append((name, start, end, thread, stack[-1] if stack else -1))
        stack.append(i)
    return out


def self_us(spans: list, names) -> float | None:
    """Summed time of the spans named ``names`` (a name or several) less
    the part their child spans cover; None where none of them ran."""
    names = {names} if isinstance(names, str) else set(names)
    picked = [i for i, s in enumerate(spans) if s[0] in names]
    if not picked:
        return None
    children = collections.defaultdict(list)
    for _n, start, end, _t, parent in spans:
        if parent >= 0:
            children[parent].append((start, end))
    return sum(spans[i][2] - spans[i][1] - union_us(children[i], spans[i][1], spans[i][2]) for i in picked)


def total_us(spans: list, names) -> float | None:
    """Summed time of the spans named ``names``, children included."""
    names = {names} if isinstance(names, str) else set(names)
    us = [e - s for n, s, e, _t, _p in spans if n in names]
    return sum(us) if us else None


def idle_outside_layers_us(trace, spans: list) -> float | None:
    """Time of the traced window in which no device interval ran and no
    thread was inside a layer span; None where no layer span ran."""
    layers = [(s, e) for n, s, e, _t, _p in spans if is_layer(n)]
    if not layers:
        return None
    lo, hi = trace.window
    return (hi - lo) - union_us([(s, e) for _n, s, e in trace.device] + layers, lo, hi)


# Per-layer readings by metric name: (kind, span names). ``self``: the
# spans' time outside their child spans, ms per MiB of the profiled calls;
# ``total``: their whole time, ms per MiB; ``unspanned``: the share of the
# device's idle time in which no thread was inside a layer span, %.
READINGS = {
    "prep_self_ms_per_MiB.decode": ("self", ("td.decode.prep",)),
    "enqueue_self_ms_per_MiB.decode": ("self", ("td.decode.enqueue",)),
    "pull_ms_per_MiB.decode": ("total", ("td.decode.pull",)),
    "assemble_self_ms_per_MiB.decode": ("self", ("td.decode.assemble",)),
    "idle_unspanned_pct.decode": ("unspanned", ("td.decode",)),
    "prep_self_ms_per_MiB.encode": ("self", ("td.encode.prep",)),
    "plan_self_ms_per_MiB.encode": ("self", ("td.encode.plan",)),
    "enqueue_self_ms_per_MiB.encode": ("self", ("td.encode.enqueue",)),
    "pull_ms_per_MiB.encode": ("total", ("td.encode.pull",)),
    "assemble_self_ms_per_MiB.encode": ("self", ("td.encode.assemble",)),
    "idle_unspanned_pct.encode": ("unspanned", ("td.encode",)),
}


def reading(name: str, trace, spans: list) -> float | None:
    """The reading ``name`` of READINGS from a trace (``device``, ``window``,
    ``device_mib``) and its spans; None where its spans did not run."""
    kind, names = READINGS[name]
    if kind == "unspanned":
        if not any(s[0] in names for s in spans):
            return None
        idle = trace.window_us - trace.busy_us
        out = idle_outside_layers_us(trace, spans)
        return None if out is None or idle <= 0 else 100.0 * out / idle
    us = (self_us if kind == "self" else total_us)(spans, names)
    return None if us is None or trace.device_mib <= 0 else us / 1e3 / trace.device_mib
