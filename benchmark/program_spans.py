"""The port's own spans and counters (its ``utils.profiling``), as the
per-layer metrics read them.

The port keeps its spans in a ring in memory, each on two clocks: the
profiler's (the clock of a ``trace.Capture``'s events) and
``time.perf_counter_ns`` (the clock of the runners' windows). A metric reads
them after the run:

- ``in_window``: the records of a span inside the window's calls (no
  profiler runs there);
- ``launched_ns``: the device time of the traced call's operations launched
  inside the records of a span or mark, clipped to the capture's
  ``bench.call`` windows;
- ``totals``: the process's span totals and counters.

Each returns None, never a partial number, where the ring no longer holds
the start of what it reads (it overflowed), and where the port has no
recorder (a program from before it): the metric then reads nothing, and
does not raise.
"""

from __future__ import annotations

import bisect

from benchmark import trace


def profiling():
    """The port's ``utils.profiling`` module if it has the recorder, else
    None."""
    try:
        from recommendation_models_tpu_torch.utils import profiling as p
    except ImportError:
        return None
    return p if hasattr(p, "recent") and hasattr(p, "summary") else None


def _ring(since: int, clock: str):
    """The ring's records, or None without a recorder or when its oldest
    record closed after ``since`` on ``clock`` ("pc_end_ns" or
    "end_ns"): the ring may have dropped records from after ``since``."""
    p = profiling()
    if p is None:
        return None
    ring = p.recent()
    if not ring or getattr(ring[0], clock) > since:
        return None
    return ring


def in_window(run, name: str):
    """The records of span ``name`` that lie inside one of the window's
    calls (perf-counter clock), or None."""
    calls = [(int(c[0] * 1e9), int(c[1] * 1e9))
             for c in run.window.get("calls", [])]
    if not calls:
        return None
    ring = _ring(calls[0][0], "pc_end_ns")
    if ring is None:
        return None
    starts = [c[0] for c in calls]
    out = []
    for r in ring:
        if r.name != name:
            continue
        i = bisect.bisect_right(starts, r.pc_start_ns) - 1
        if i >= 0 and r.pc_end_ns <= calls[i][1]:
            out.append(r)
    return out


def per_call_ms(run, name: str, call: str):
    """Host ms of span ``name`` in the window over the number of ``call``
    spans there, or None."""
    recs, calls = in_window(run, name), in_window(run, call)
    if recs is None or not calls:
        return None
    return sum(r.pc_end_ns - r.pc_start_ns for r in recs) / 1e6 / len(calls)


def launched_ns(run, name: str):
    """Device ns of the traced call's operations launched inside a record
    of span or mark ``name`` (the records clipped to the capture's call
    windows), or None when there is no capture or no such record."""
    cap = run.capture
    if cap is None:
        return None
    win = trace.call_windows(cap)
    if not win:
        return None
    ring = _ring(win[0][0], "end_ns")
    if ring is None:
        return None
    iv = trace.clipped(trace.merged([(r.start_ns, r.end_ns) for r in ring
                                     if r.name == name]), win)
    if not iv:
        return None
    return trace.span_device_ns(cap._replace(spans={name: iv}), name)


def totals():
    """The port's ``summary()`` (span totals and counters of the process),
    or None."""
    p = profiling()
    return None if p is None else p.summary()


__all__ = ["profiling", "in_window", "per_call_ms", "launched_ns", "totals"]
