"""The traced run: spans from the benchmark's own files around the port's
functions, one ``torch.profiler`` capture, and its reduction.

``spans(...)`` wraps module attributes of the port in
``torch.profiler.record_function`` ranges named ``bench.<span>`` while it
is open, and puts them back after; the port is not edited, and the window
never runs under it.

``capture(fn)`` profiles one call of ``fn`` and reduces the profiler's raw
events (``kineto_results.events()``) to

- ``device_ops``: every operation that ran on the device (kernels, copies,
  fills) as ``(name, start_ns, end_ns, launch_ns)``; ``launch_ns`` is the
  host time of the CUDA API call that launched it (matched by
  the CUPTI correlation id), or None;
- ``spans``: the host intervals of each ``bench.*`` span, by span name;
- ``host_ops``: the host's other operator intervals (for the idle gaps).

The reductions (``busy_ns``, ``span_device_ns``, ``idle_gaps``) work on
these lists only, so the CPU tests drive them with made-up events.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict
from typing import NamedTuple

import torch

PREFIX = "bench."
# profiled runs before a capture that recorded no device operation gives up
TRIES = 3
# names of device operations that are copies and fills, not kernels
_COPIES = ("Memcpy", "Memset", "memcpy", "memset")
# host events that launch device work (the CUDA API's cuda* and cu* calls)
_LAUNCHES = ("cuda", "cu")


class Capture(NamedTuple):
    device_ops: list          # [(name, start_ns, end_ns, launch_ns)]
    spans: dict               # {span: [(start_ns, end_ns)] sorted}
    host_ops: list            # [(start_ns, end_ns, name)] sorted


def is_kernel(name: str) -> bool:
    return not name.startswith(_COPIES)


@contextlib.contextmanager
def spans(wraps):
    """Wrap ``(module name, attribute, span)`` triples in
    ``record_function(PREFIX + span)`` while the block runs."""
    saved = []
    try:
        for mod_name, attr, span in wraps:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _wrapped(fn, PREFIX + span))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _wrapped(fn, name):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    call.__wrapped__ = fn
    return call


def reduce_events(events) -> Capture:
    """A Capture from the profiler's raw events (objects with ``name()``,
    ``device_type()``, ``start_ns()``, ``end_ns()``,
    ``correlation_id()``)."""
    cpu = torch.autograd.DeviceType.CPU
    launch_at = {}
    devs = []
    span_iv = defaultdict(list)
    host = []
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cpu:
            if name.startswith(PREFIX):
                span_iv[name[len(PREFIX):]].append((start, end))
            elif name.startswith(_LAUNCHES) and "::" not in name:
                launch_at[ev.correlation_id()] = start
            else:
                host.append((start, end, name))
        elif not name.startswith(PREFIX):     # not a span's device range
            devs.append((name, start, end, ev.correlation_id()))
    ops = [(n, s, e, launch_at.get(c)) for n, s, e, c in devs]
    ops.sort(key=lambda o: o[1])
    for iv in span_iv.values():
        iv.sort()
    host.sort()
    return Capture(ops, dict(span_iv), host)


def capture(fn, cuda: bool) -> Capture:
    """Profile one call of ``fn`` (CPU and, on a card, CUDA activity) and
    reduce it; a capture with no device operation on a card is taken again,
    up to ``TRIES`` times."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    cap = None
    for _ in range(TRIES):
        with profile(activities=acts) as prof:
            fn()
            if cuda:
                torch.cuda.synchronize()
        cap = reduce_events(prof.profiler.kineto_results.events())
        if cap.device_ops or not cuda:
            return cap
    return cap


def merged(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped(intervals, windows):
    """Parts of ``intervals`` that lie inside ``windows`` (both sorted
    unions)."""
    out = []
    for ws, we in windows:
        for s, e in intervals:
            if e <= ws or s >= we:
                continue
            out.append((max(s, ws), min(e, we)))
    return out


def busy_ns(cap: Capture, windows, kernels_only: bool = False) -> int:
    """Nanoseconds inside ``windows`` in which a device operation (or a
    kernel) ran: the union of their intervals, not a sum."""
    iv = [(s, e) for n, s, e, _ in cap.device_ops
          if not kernels_only or is_kernel(n)]
    return sum(e - s for s, e in clipped(merged(iv), merged(windows)))


def ops_in(cap: Capture, windows, kernels_only: bool = True):
    """Device operations that start inside ``windows``."""
    win = merged(windows)
    starts = [w[0] for w in win]
    out = []
    for op in cap.device_ops:
        if kernels_only and not is_kernel(op[0]):
            continue
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[1] < win[i][1]:
            out.append(op)
    return out


def _inside(iv, t) -> bool:
    """Whether t lies in one of the sorted, disjoint intervals ``iv``."""
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t <= iv[i][1]


def span_device_ns(cap: Capture, span: str, name_filter=None) -> int:
    """Device nanoseconds of the operations launched inside span ``span``
    (optionally only those whose name passes ``name_filter``)."""
    iv = merged(cap.spans.get(span, []))
    total = 0
    for name, s, e, t in cap.device_ops:
        if t is None or (name_filter and not name_filter(name)):
            continue
        if _inside(iv, t):
            total += e - s
    return total


def _host_activity(cap: Capture, t) -> str:
    """What the host was doing at time t: the innermost ``bench`` span
    open then, and the innermost host operator running then, if any."""
    best_span, best_start = "outside spans", None
    for span, iv in cap.spans.items():
        # spans of one name never nest: the last that began by t
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        if i >= 0 and iv[i][0] <= t <= iv[i][1]:
            if best_start is None or iv[i][0] > best_start:
                best_span, best_start = span, iv[i][0]
    name = best_span
    j = bisect.bisect_right(cap.host_ops, (t, float("inf"), "")) - 1
    op = None
    # the host operators nest: walk back over those that ended before t
    for back in range(j, max(j - 64, -1), -1):
        s, e, n = cap.host_ops[back]
        if s <= t <= e:
            op = n
            break
    return f"{name}/{op}" if op else f"{name}/python"


def idle_gaps(cap: Capture, windows, top: int = 10,
              step_ns: int = 50_000):
    """The device's idle time inside ``windows`` by what the host was doing
    meanwhile: [[activity, seconds]], longest total first. Each idle gap is
    sampled every ``step_ns`` (at least once) and each sample's share of
    the gap goes to the host's activity at that instant."""
    win = merged(windows)
    busy = clipped(merged([(s, e) for _, s, e, _ in cap.device_ops]), win)
    gaps = []
    for ws, we in win:
        t = ws
        for s, e in busy:
            if e <= ws or s >= we:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if we > t:
            gaps.append((t, we))
    by = defaultdict(float)
    for s, e in gaps:
        n = max(1, (e - s) // step_ns)
        for j in range(n):
            t = s + (e - s) * (2 * j + 1) // (2 * n)
            by[_host_activity(cap, t)] += (e - s) / n
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in rows]


def top_device_ops(cap: Capture, windows, top: int = 10,
                   width: int = 120):
    """The device operations inside ``windows`` that took most time, by
    name (cut at ``width`` characters): [[name, seconds]]."""
    by = defaultdict(int)
    for name, s, e, _ in ops_in(cap, windows, kernels_only=False):
        by[name[:width]] += e - s
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in rows]


def call_windows(cap: Capture, span: str = "call"):
    """The host intervals of the traced calls."""
    return merged(cap.spans.get(span, []))


def summary(cap: Capture) -> dict:
    """busy_s and window_s of the traced calls, and the breakdown."""
    win = call_windows(cap)
    window_ns = sum(e - s for s, e in win)
    return {"busy_s": busy_ns(cap, win) / 1e9, "window_s": window_ns / 1e9,
            "breakdown": {"device_ops": top_device_ops(cap, win),
                          "idle_gaps": idle_gaps(cap, win)}}


__all__ = ["Capture", "PREFIX", "spans", "capture", "reduce_events",
           "merged", "clipped", "busy_ns", "ops_in", "span_device_ns",
           "idle_gaps", "top_device_ops", "call_windows",
           "summary", "is_kernel"]
