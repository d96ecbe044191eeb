"""The reduction of the program's spans (``spantrace.py``): parents by
nesting on each thread, self time with nested and concurrent spans, the
device-idle time outside every layer span on one clock with the device's
events, readings that are null without spans, and, on the CPU, a profiled
call of each cell's op whose spans give every reading of its op."""

from __future__ import annotations

import pytest
from conftest import ROOT

import devtrace
import harness
import spantrace


def test_parents_nest_per_thread():
    spans = spantrace.with_parents([
        ("td.decode", 0.0, 100.0, 1), ("td.decode.prep", 10.0, 20.0, 1), ("td.decode.enqueue", 20.0, 50.0, 1),
        ("td.decode.pull", 60.0, 100.0, 1), ("td.encode", 5.0, 90.0, 2), ("td.encode.plan", 30.0, 80.0, 2),
        ("td.encode.pull", 30.0, 40.0, 2)])
    by_name = {s[0]: s for s in spans}
    parent = {s[0]: (spans[s[4]][0] if s[4] >= 0 else None) for s in spans}
    assert parent == {"td.decode": None, "td.decode.prep": "td.decode", "td.decode.enqueue": "td.decode",
                      "td.decode.pull": "td.decode", "td.encode": None, "td.encode.plan": "td.encode",
                      "td.encode.pull": "td.encode.plan"}
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)
    assert by_name["td.encode.pull"][3] == 2


def test_self_time_with_nesting_and_two_threads():
    spans = spantrace.with_parents([
        ("td.encode", 0.0, 100.0, 1), ("td.encode.plan", 10.0, 60.0, 1), ("td.encode.pull", 10.0, 25.0, 1),
        ("td.encode.enqueue", 50.0, 60.0, 1), ("td.encode.plan", 70.0, 90.0, 1),
        # a second calling thread, inside the first's spans in time but not a child of them
        ("td.encode", 5.0, 95.0, 2), ("td.encode.plan", 20.0, 40.0, 2), ("td.encode.plan", 20.0, 30.0, 2)])
    assert spantrace.self_us(spans, "td.encode.plan") == (50 - 15 - 10) + 20 + (20 - 10) + 10
    assert spantrace.self_us(spans, ["td.encode"]) == (100 - 50 - 20) + (90 - 20)
    assert spantrace.total_us(spans, "td.encode.plan") == 50 + 20 + 20 + 10
    assert spantrace.self_us(spans, "td.decode.prep") is None and spantrace.total_us(spans, "td.decode") is None


def test_idle_outside_layers_on_the_device_clock():
    """Window 0-100; device busy 10-20 and 50-55; layer spans 15-30 (thread
    1) and 25-40 (thread 2), and the root 0-100, which is no layer."""
    t = devtrace.Trace(device=[("k", 10.0, 20.0), ("Memcpy DtoH", 50.0, 55.0)], window=(0.0, 100.0), device_mib=2.0)
    spans = spantrace.with_parents([("td.decode", 0.0, 100.0, 1), ("td.decode.prep", 15.0, 30.0, 1),
                                    ("td.decode.pull", 25.0, 40.0, 2)])
    assert spantrace.idle_outside_layers_us(t, spans) == 100 - (10 + 20 + 5)
    assert spantrace.reading("idle_unspanned_pct.decode", t, spans) == pytest.approx(100 * 65 / 85)
    assert spantrace.reading("pull_ms_per_MiB.decode", t, spans) == pytest.approx(15 / 1e3 / 2)
    assert spantrace.reading("idle_unspanned_pct.encode", t, spans) is None


@pytest.mark.parametrize("name", sorted(spantrace.READINGS))
def test_each_reading_is_null_without_spans(name):
    t = devtrace.Trace(device=[("k", 10.0, 20.0)], window=(0.0, 100.0), device_mib=2.0)
    assert spantrace.reading(name, t, []) is None
    assert spantrace.reading(name, t, spantrace.with_parents([("portbench.call", 0.0, 100.0, 1)])) is None


def test_every_span_read_is_one_the_program_names():
    from tpu_deflate_torch import spans

    read = {n for _kind, names in spantrace.READINGS.values() for n in names}
    assert read <= set(spans.NAMES), read - set(spans.NAMES)
    assert {n for n in spans.NAMES if spantrace.is_layer(n)} <= read


TEST_BYTES = {"data_bytes": 196_608, "read_member_bytes": 131_072}


@pytest.mark.parametrize("cell", ["profile.decode", "archive.decode", "profile.encode", "archive.encode"])
def test_a_profiled_call_gives_every_reading_of_its_op(cell, monkeypatch):
    """The cell's op at a test size on the CPU (the program's plain versions
    in place of its kernels), two calls in ``portbench.call`` ranges under a
    CPU profiler session, reduced as a traced run reduces its device half."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_deflate_torch import engine

    monkeypatch.setattr(engine, "_cuda", lambda _engine: torch.device("cpu"))
    c = harness.load_cell(cell, ROOT)
    config = {**c.config, **{k: v for k, v in TEST_BYTES.items() if k in c.config}}
    inputs = c.op.make_inputs(config, c.mix, 2**34 + 7)
    call = c.op.program_call(c.mix, inputs)
    starts, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(2):
                starts.append(time.perf_counter_ns())
                with record_function(devtrace.CALL_RANGE):
                    call(i)
    finally:
        torch.set_num_threads(threads)
    device, window, _samples = devtrace.from_profiler(prof, starts, [])
    t = devtrace.Trace(device=device, window=window, device_mib=2 * inputs.work_bytes / 2**20)
    spans = spantrace.program_spans(prof)
    op = "decode" if cell.endswith("decode") else "encode"
    assert {s[0] for s in spans if s[4] < 0} == {f"td.{op}"}
    assert sum(s[0] == f"td.{op}" for s in spans) == 2
    for name in spantrace.READINGS:
        value = spantrace.reading(name, t, spans)
        if name.endswith(op):
            assert value is not None and value >= 0, name
        else:
            assert value is None, name
