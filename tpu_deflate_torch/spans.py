"""Named spans at the port's layer boundaries, recorded by ``torch.profiler``.

Run any call of the port under a ``torch.profiler.profile`` session and each
span below appears as a CPU range of that name, on the profiler's own clock
beside the CUDA kernels and copies it launched (``export_chrome_trace``
shows them above their kernels). Outside a session :func:`span` returns one
shared ``contextlib.nullcontext()`` after a single flag check, so the spans
cost next to nothing when nobody records them.

A call's root span is ``td.decode`` (``decode_v2.gzip_decompress_v2``) or
``td.encode`` (``encode.compress_members``, ``continuous.compress_continuous``);
its own time, outside the layer spans, is the member split and the route
choice. The layer spans ``td.<op>.<layer>`` sit inside it, one a call,
wave, batch or stage (never one a member, block or token):

- ``prep``: host work that builds a wave's or a batch's inputs (the decode's
  k1 groups, wave prep, block walk, row build and header parse; the
  encoder's padded rows or halo rows and the parse's host entries);
- ``plan`` (encode only): the host's code planning, ``encode._plan_codes``;
- ``enqueue``: uploads and kernel launches;
- ``pull``: blocking reads of the card's results (and, where a call both
  launches and reads back at once, as the CRC helpers do, that call);
- ``assemble``: the output built on the host (stored members, the size and
  CRC-32 checks, member framing, the bit splice, the final join).

A span's cause is its enclosing span: the profiler keeps the parent links
and thread ids. No environment variable or setting turns them on or off.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

NAMES = (
    "td.decode",
    "td.decode.prep",
    "td.decode.enqueue",
    "td.decode.pull",
    "td.decode.assemble",
    "td.encode",
    "td.encode.prep",
    "td.encode.plan",
    "td.encode.enqueue",
    "td.encode.pull",
    "td.encode.assemble",
)

_OFF = contextlib.nullcontext()

if isinstance(getattr(_profiler, "_is_profiler_enabled", None), bool):

    def recording() -> bool:
        """True while a profiler session records (the module flag the
        session sets on entry and clears on exit)."""
        return _profiler._is_profiler_enabled

else:  # a torch without the flag: ask the profiler itself
    recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler session
    records, else the shared no-op context. ``name`` is one of NAMES."""
    return _profiler.record_function(name) if recording() else _OFF
