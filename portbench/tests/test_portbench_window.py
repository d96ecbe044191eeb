"""The one window loop (``harness.run_window``): many callers lose no call
and serve no request twice; an open loop's arrivals come from the seed
and every one is served, its latency counting its wait; a raising call
counts as failed and the loop goes on."""

from __future__ import annotations

import sys
import threading
import time

import pytest

import harness


def test_many_callers_lose_no_call():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seen, lock = [], threading.Lock()

        def call(i):
            with lock:
                seen.append(i)
            return i * 2

        idents: set = set()
        w = harness.run_window(call, 0.3, {"loop": "closed", "callers": 24}, seed=1, idents=idents)
    finally:
        sys.setswitchinterval(switch)
    assert len(idents) == 24 and threading.get_ident() not in idents
    assert [i for i, _o in w.done] == sorted(seen) == list(range(len(seen)))
    assert all(o == 2 * i for i, o in w.done) and len(w.latency_s) == len(seen) and w.failed == 0
    assert 0.2 < w.seconds < 2  # the last call ends near the 0.3 s mark; no caller starts one past it


def test_open_loop_serves_every_arrival_from_the_seed():
    mix = {"loop": "open", "rate_per_s": 200, "callers": 2}
    times = harness.arrivals(200, 0.5, seed=2**40 + 3)
    assert times == harness.arrivals(200, 0.5, seed=2**40 + 3) != harness.arrivals(200, 0.5, seed=2**40 + 4)
    assert 50 < len(times) < 150 and all(0 <= t < 0.5 for t in times)
    w = harness.run_window(lambda i: time.sleep(0.004) or i, 0.5, mix, seed=2**40 + 3)
    assert [i for i, _o in w.done] == list(range(len(times)))
    assert min(w.latency_s) >= 0.004 and w.seconds >= times[-1]


@pytest.mark.parametrize("callers", [1, 3])
def test_a_raising_call_counts_as_failed_and_the_loop_goes_on(callers):
    def call(i):
        if i % 2:
            raise ValueError(f"odd {i}")
        return i

    w = harness.run_window(call, 0.05, {"loop": "closed", "callers": callers, "think_s": 0.001}, seed=0)
    assert w.failed >= 1 and len(w.done) >= 1 and all(i % 2 == 0 for i, _o in w.done)
    assert w.errors[0].startswith("ValueError: odd") and len(w.errors) <= 3
