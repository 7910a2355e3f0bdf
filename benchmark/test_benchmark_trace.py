"""The reduction of a profiler capture, on made-up events."""

from __future__ import annotations

import pytest
import torch

from benchmark import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._v = (name, dev, start, end, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def capture():
    """A call [0, 100) holding a gram span [10, 40) and a solve span
    [40, 60); the gram launches k1 at 12 (runs 20-35), the solve launches
    k2 at 45 (runs 50-90) and a copy at 47 (runs 92-95); the span's own
    device range is not a device operation."""
    return trace.reduce_events([
        Ev("bench.call", CPU, 0, 100),
        Ev("bench.gram_rhs", CPU, 10, 40),
        Ev("bench.solve", CPU, 40, 60),
        Ev("aten::bmm", CPU, 11, 13),
        Ev("cudaLaunchKernel", CPU, 12, 13, corr=7),
        Ev("cuLaunchKernel", CPU, 45, 46, corr=8),
        Ev("cudaMemcpyAsync", CPU, 47, 48, corr=9),
        Ev("k1", CUDA, 20, 35, corr=7),
        Ev("k2", CUDA, 50, 90, corr=8),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 92, 95, corr=9),
        Ev("bench.gram_rhs", CUDA, 20, 35),
    ])


def test_reduce_links_launches_and_drops_span_ranges():
    cap = capture()
    assert [(n, s, e, t) for n, s, e, t in cap.device_ops] == [
        ("k1", 20, 35, 12), ("k2", 50, 90, 45),
        ("Memcpy DtoH (Device -> Pageable)", 92, 95, 47)]
    assert cap.spans["call"] == [(0, 100)]


def test_busy_is_a_union_inside_the_windows():
    cap = capture()
    win = trace.call_windows(cap)
    assert trace.busy_ns(cap, win) == 15 + 40 + 3
    assert trace.busy_ns(cap, win, kernels_only=True) == 55
    assert trace.busy_ns(cap, [(30, 60)]) == 5 + 10
    # overlapping operations count once
    assert trace.merged([(0, 10), (5, 12), (20, 30)]) == [(0, 12), (20, 30)]


def test_device_time_goes_to_the_span_that_launched_it():
    cap = capture()
    assert trace.span_device_ns(cap, "gram_rhs") == 15
    assert trace.span_device_ns(cap, "solve") == 40 + 3
    assert trace.span_device_ns(cap, "solve", trace.is_kernel) == 40
    assert trace.span_device_ns(cap, "absent") == 0


def test_kernels_and_idle_gaps():
    cap = capture()
    win = trace.call_windows(cap)
    assert [op[0] for op in trace.ops_in(cap, win)] == ["k1", "k2"]
    gaps = dict((n, s) for n, s in trace.idle_gaps(cap, win))
    # idle: [0, 20), [35, 50), [90, 92) and [95, 100), each given to the
    # host's activity at its middle (10: the gram's span; 42: the solve's)
    assert sum(gaps.values()) == pytest.approx((20 + 15 + 2 + 5) / 1e9)
    assert gaps == pytest.approx({"gram_rhs/python": 20e-9,
                                  "solve/python": 15e-9,
                                  "call/python": 7e-9})
    # sampled finer, a gap is shared by the activities it spans
    fine = dict(trace.idle_gaps(cap, win, step_ns=1))
    assert fine["call/python"] == pytest.approx(17e-9)
    assert fine["gram_rhs/aten::bmm"] == pytest.approx(3e-9)
    s = trace.summary(cap)
    assert s["busy_s"] == pytest.approx(58 / 1e9)
    assert s["window_s"] == pytest.approx(100 / 1e9)
    assert s["breakdown"]["device_ops"][0] == ["k2", 40 / 1e9]


def test_spans_wrap_and_restore():
    import benchmark.work as w
    orig = w.mfu
    with trace.spans([("benchmark.work", "mfu", "mfu")]):
        assert w.mfu is not orig and w.mfu.__wrapped__ is orig
        assert w.mfu(w.PEAK_FLOPS, 1.0) == pytest.approx(100.0)
    assert w.mfu is orig
