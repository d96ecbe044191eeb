"""The port's layer spans (``tpu_deflate_torch.spans``): off, they are one
shared no-op and never reach ``record_function``; under a CPU profiler
session a decode and both encodes record only the listed names, each layer
span inside its call's root, and give the same bytes as without it."""

from __future__ import annotations

import ast
import gzip
import os

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import tpu_deflate_torch
from tpu_deflate_torch import spans
from tpu_deflate_torch.codec import continuous, decode_v2, encode

CPU = torch.device("cpu")
PACKAGE = os.path.dirname(tpu_deflate_torch.__file__)


def text_of(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(100)]
    return np.concatenate([words[i] for i in rng.integers(0, 100, n // 2)])[:n].tobytes()


def three_members() -> bytes:
    """Three 64 KiB members' worth of input, the middle one random (the
    encoder stores it) and a short last one."""
    rng = np.random.default_rng(7)
    return text_of(65536, 1) + rng.integers(0, 256, 65536, dtype=np.uint8).tobytes() + text_of(3000, 2)


def calls() -> dict:
    """Each call's output: the member-profile encode, its decode (main path
    and a stored member), the continuous encode and its decode (the block
    chain on the device route)."""
    data = three_members()
    members = encode.compress_members(data, device=CPU, effort=1)
    out = {"compress_members": members,
           "gzip_decompress_v2": decode_v2.gzip_decompress_v2(members, device=CPU, device_resolve="on")}
    assert decode_v2.LAST_DECODE_STATS["stored"] == 1
    one = continuous.compress_continuous(text_of(20000, 3), device=CPU, effort=4, block_data=16384)
    out["compress_continuous"] = one
    out["chained decode"] = decode_v2.gzip_decompress_v2(one, device=CPU, device_resolve="on")
    assert decode_v2.LAST_DECODE_STATS["chained_groups"] == 1
    return out


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unprofiled(one_thread):
    """The calls with no profiler running and ``record_function`` made to
    raise: a span that is off never reaches it."""
    mp = pytest.MonkeyPatch()

    def refuse(*_a, **_k):
        raise AssertionError("record_function reached with no profiler running")

    mp.setattr(autograd_profiler, "record_function", refuse)
    try:
        return calls()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def profiled(unprofiled):
    """The calls under a CPU profiler session, and its ``td.`` ranges as
    (name, start ns, end ns, thread), read from the session's raw results
    (building its full event list would take seconds here)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = calls()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("td.")]
    return out, events


def test_off_span_is_the_shared_no_op():
    assert not spans.recording()
    assert spans.span("td.decode") is spans.span("td.encode.plan")
    with spans.span("td.decode.prep"):
        pass


def test_off_calls_run_and_are_sound(unprofiled):
    assert gzip.decompress(unprofiled["compress_members"]) == three_members()
    assert unprofiled["gzip_decompress_v2"] == three_members()
    assert unprofiled["chained decode"] == text_of(20000, 3)


def test_profiled_calls_give_the_same_bytes(unprofiled, profiled):
    out, _events = profiled
    assert out.keys() == unprofiled.keys()
    for name in out:
        assert out[name] == unprofiled[name], name


def test_profiled_calls_record_only_listed_names(profiled):
    _out, events = profiled
    names = {n for n, _s, _e, _t in events}
    assert names <= set(spans.NAMES), names - set(spans.NAMES)
    assert names == set(spans.NAMES), set(spans.NAMES) - names


def test_every_layer_span_lies_inside_its_root(profiled):
    """Each root is a call's outermost span, and each layer span lies inside
    the root of its own op on the same thread."""
    _out, events = profiled
    roots = [e for e in events if e[0] in ("td.decode", "td.encode")]
    assert [n for n, _s, _e, _t in sorted(roots, key=lambda e: e[1])] == ["td.encode", "td.decode"] * 2
    for name, start, end, thread in events:
        around = [r for r in roots if r[3] == thread and r[1] <= start and end <= r[2]]
        if (name, start, end, thread) in roots:
            assert around == [(name, start, end, thread)], name
        else:
            assert len(around) == 1 and name.startswith(around[0][0] + "."), (name, around)


def span_literals() -> list:
    """(file, name) of every ``span("...")`` call in the package."""
    found = []
    for folder, _dirs, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(folder, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) == "span":
                    arg = node.args[0] if node.args else None
                    assert isinstance(arg, ast.Constant), f"{path}:{node.lineno}: a span's name is a literal"
                    found.append((os.path.relpath(path, PACKAGE), arg.value))
    return found


def test_every_span_literal_is_listed():
    found = span_literals()
    assert found
    assert {n for _f, n in found} == set(spans.NAMES)
    for path, name in found:
        assert name in spans.NAMES, (path, name)
    assert all(n.startswith("td.") for n in spans.NAMES) and len(set(spans.NAMES)) == len(spans.NAMES)
