"""The per-layer readers and the trace reduction: a metric whose sources are
absent reads null, never 0; kernels match by whole identifier; the busy
union, the gaps and the nested host time count nothing twice."""

from __future__ import annotations

import json
import os

import pytest
from conftest import ROOT

import devtrace
import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    NAMES = [m["name"] for m in json.load(f)["per_layer"]]
PKG = os.sep + os.path.join("x", "tpu_deflate_torch") + os.sep


def _key(path: str, func: str) -> tuple:
    return (PKG + path.replace("/", os.sep), 1, func)


@pytest.mark.parametrize("name", NAMES)
def test_absent_sources_read_null(name):
    """No device event, no profiled function, no peak: every reader gives
    None (the harness then leaves the metric out of the line)."""
    t = devtrace.Trace(window=(0.0, 1e6), device_mib=100.0, host_mib=100.0, peak_bw=3.35e12)
    assert harness.load_metric(name).read(t) is None


@pytest.mark.parametrize("name", NAMES)
def test_renamed_sources_read_null(name):
    """Sources under other names (a kernel or function renamed later) read
    null too, so a rename shows as something to re-point, not as a gain."""
    t = devtrace.Trace(device=[("void renamed_kernel<4>(int const*)", 10.0, 20.0)], window=(0.0, 1e6),
                       device_mib=100.0, host_mib=100.0,
                       host_stats={_key("codec/other.py", "renamed"): (1, 1, 0.1, 0.2, {})}, peak_bw=3.35e12)
    mod = harness.load_metric(name)
    if hasattr(mod, "KERNELS") or hasattr(mod, "FUNCTIONS"):
        assert mod.read(t) is None


def test_kernels_match_by_whole_identifier():
    t = devtrace.Trace(device=[("void stage_a_tables_kernel(int const*, int*)", 0.0, 5.0),
                               ("void compact_pull_kernel<4, true>(int const*)", 5.0, 7.0)], window=(0.0, 10.0))
    assert t.kernel_us(["stage_a_kernel"]) is None
    assert t.kernel_us(["compact_kernel"]) is None
    assert t.kernel_us(["stage_a_tables_kernel", "compact_pull_kernel"]) == 7.0


def test_busy_is_a_union_clipped_to_the_window():
    t = devtrace.Trace(device=[("k", -5.0, 10.0), ("Memcpy HtoD (Pageable -> Device)", 5.0, 15.0),
                               ("k", 30.0, 40.0), ("k", 95.0, 120.0)], window=(0.0, 100.0))
    assert t.busy_us == 10.0 + 5.0 + 10.0 + 5.0
    assert devtrace.gaps([(s, e) for _n, s, e in t.device], *t.window) == [(15.0, 30.0), (40.0, 95.0)]
    assert t.all_kernels_us() == 15.0 + 10.0 + 25.0


def test_idle_share_and_breakdown():
    t = devtrace.Trace(device=[("void a(int)", 0.0, 10.0), ("void b(int)", 50.0, 100.0)], window=(0.0, 100.0),
                       samples=[(20.0, "codec.decode_np.parse_headers_batch"), (30.0, "codec.wave_prep._k1_groups")])
    assert harness.load_metric("device_idle_pct.decode").read(t) == pytest.approx(40.0)
    b = t.breakdown()
    assert b["device_ops"] == [["b", 50e-6], ["a", 10e-6]]
    assert sorted(b["idle_gaps"]) == [["codec.decode_np.parse_headers_batch", 20e-6],
                                      ["codec.wave_prep._k1_groups", 20e-6]]


def test_nested_host_time_counts_once():
    """_k1_groups (0.5 s) calls parse_headers_batch (0.3 s of it); a
    wave's own parse_headers_batch call takes 0.2 s more."""
    k1 = _key("codec/wave_prep.py", "_k1_groups")
    parse = _key("codec/decode_np.py", "parse_headers_batch")
    other = _key("codec/decode_v2.py", "run_wave")
    stats = {k1: (1, 1, 0.2, 0.5, {other: (1, 1, 0.2, 0.5)}),
             parse: (2, 2, 0.5, 0.5, {k1: (1, 1, 0.3, 0.3), other: (1, 1, 0.2, 0.2)})}
    t = devtrace.Trace(host_stats=stats, host_mib=2.0)
    assert t.host_s([("codec/wave_prep.py", "_k1_groups"), ("codec/decode_np.py", "parse_headers_batch")]) \
        == pytest.approx(0.7)
    assert harness.load_metric("header_parse_ms_per_MiB.decode").read(t) == pytest.approx(350.0)


def test_roofline_counts_bytes_from_the_data():
    t = devtrace.Trace(device=[("void k(int)", 0.0, 1000.0), ("Memcpy DtoH (Device -> Pinned)", 0.0, 5e5)],
                       window=(0.0, 1e6), device_bytes_moved=335_000_000, peak_bw=3.35e12)
    # 335 MB at 3.35 TB/s is 100 us; one kernel ran 1000 us; the copy is no kernel.
    assert harness.load_metric("kernels_roofline.decode").read(t) == pytest.approx(10.0)
    t.peak_bw = None
    assert harness.load_metric("kernels_roofline.decode").read(t) is None


def test_sampler_names_the_programs_innermost_function():
    import sys

    frame = sys._getframe()
    assert devtrace.StackSampler.label(frame).startswith("test_portbench_metrics.py:")


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::stage_a_kernel<4>(int const*, int*)", "stage_a_kernel<4>"),
    ("(anonymous namespace)::compact_kernel(int const*, int)", "compact_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
    ("void at::native::f<at::native::g(at::TensorIteratorBase&)::{lambda()#1}>(int, int)",
     "at::native::f<at::native::g(at::TensorIteratorBase&)::{lambda()#1}>"),
])
def test_short_names(name, short):
    assert devtrace.short_name(name) == short
