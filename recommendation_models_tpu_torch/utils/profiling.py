"""Tracing/profiling hooks (SURVEY.md §5).

``trace_sweeps`` wraps a training region in ``torch.profiler.profile`` (the
CPU, plus CUDA when a card is present) and writes a Chrome trace
(``*.pt.trace.json``, viewable in TensorBoard's profiler plugin, Perfetto or
``chrome://tracing``) into its logdir, with the port's own spans of the
block beside it (``*.spans.json``, on the trace's clock); ``Timer`` provides
the wall-clock and rows-solved/sec/chip counters of the headline metric.

The port's spans and counters live in one ``Recorder`` (``RECORDER``; the
module's ``span``, ``mark``, ``count``, ``summary``, ``recent`` and
``reset`` are its methods):

- ``span(name)`` times a block on the host. On close it adds one to the
  name's count and its nanoseconds to the name's total, and appends a
  ``SpanRecord`` to a ring of the last ``RING_SIZE`` spans. A span never
  synchronises the device, creates no tensor and calls nothing of the
  profiler, so it costs host time alone (about a microsecond);
- ``mark(name)`` is a span written only while a ``torch.profiler`` is
  active, and a flag read otherwise: for sites that run hundreds of times a
  sweep;
- ``count(name, n)`` adds to an integer counter.

A record holds both clocks: ``start_ns`` / ``end_ns`` on the profiler's
(``time.time_ns``, the clock of the profiler's event times) and
``pc_start_ns`` / ``pc_end_ns`` on ``time.perf_counter_ns`` (the clock of
``Timer``). ``call`` is the id of the enclosing call span (one
``ALS.fit`` or ``recommend`` call: ``span(name, call=True)``), 0 outside
any. Span names never start with ``bench.``, ``cu`` or ``cuda``: a
profiler reader takes such names for its own ranges and for CUDA calls.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch

RING_SIZE = 65_536
_profiler_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    start_ns: int            # the profiler's clock (epoch ns)
    end_ns: int
    pc_start_ns: int         # time.perf_counter_ns
    pc_end_ns: int
    id: int
    parent: int              # id of the enclosing span, 0 = none
    call: int                # id of the enclosing call span, 0 = none


class _Open:
    """One open span, on its thread's stack."""

    __slots__ = ("rec", "name", "is_call", "local", "id", "parent", "call",
                 "t0", "p0", "child")

    def __init__(self, rec: "Recorder", name: str, is_call: bool):
        self.rec, self.name, self.is_call = rec, name, is_call

    def __enter__(self):
        self.local = local = self.rec._local
        stack = local.stack
        up = stack[-1] if stack else None
        self.id = sid = next(self.rec._ids)
        if up is None:
            self.parent, self.call = 0, sid if self.is_call else 0
        else:
            self.parent, self.call = up.id, sid if self.is_call else up.call
        self.child = 0
        stack.append(self)
        self.p0 = time.perf_counter_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        p1 = time.perf_counter_ns()
        local = self.local
        stack = local.stack
        stack.pop()
        dur = p1 - self.p0
        if stack:
            stack[-1].child += dur
        tot = local.totals.get(self.name)
        if tot is None:
            tot = local.totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child
        # a deque's append is atomic: threads share the ring unlocked
        self.rec._ring.append((self.name, self.t0, t1, self.p0, p1, self.id,
                               self.parent, self.call))
        return False


class _Thread(threading.local):
    """A thread's open spans and span totals; the totals of every thread
    that opened a span stay listed in ``threads``."""

    def __init__(self, threads: list, lock: threading.Lock):
        self.stack, self.totals = [], {}
        with lock:
            threads.append(self.totals)


_OFF = contextlib.nullcontext()


class Recorder:
    """Per-name span totals, counters and a ring of the last ``ring_size``
    span records, for every thread of the process. Each thread nests its
    own spans and keeps its own totals (no lock on a span's path);
    ``summary`` adds them up."""

    def __init__(self, ring_size: int = RING_SIZE):
        self._lock = threading.Lock()
        self._threads = []          # each thread's span totals
        self._local = _Thread(self._threads, self._lock)
        self._ring = collections.deque(maxlen=ring_size)
        self._counters = {}
        self._ids = itertools.count(1)

    def span(self, name: str, call: bool = False) -> _Open:
        """A context manager timing its block as span ``name``; ``call``
        makes it the call span of the spans inside it."""
        return _Open(self, name, call)

    def mark(self, name: str):
        """``span(name)`` while a ``torch.profiler`` is active, else a
        context manager that records nothing."""
        if not _profiler_enabled():
            return _OFF
        return _Open(self, name, False)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def recent(self, name: Optional[str] = None) -> list:
        """The ring's records, oldest first (records go in as their spans
        close): those of span ``name``, or all of them."""
        return [SpanRecord._make(r) for r in list(self._ring)
                if name is None or r[0] == name]

    def summary(self) -> dict:
        """``{"spans": {name: {"count", "total_ns", "self_ns"}},
        "counters": {name: n}}``; self time is a span's time less the part
        its child spans cover. The counters include the kernel launch
        counts of ``ops.cholesky`` and ``ops.gather``, read in place, as
        ``ops.<module>.<COUNTS>.<kernel>``."""
        from recommendation_models_tpu_torch.ops import cholesky, gather
        spans = {}
        with self._lock:
            for totals in self._threads:
                for name, (c, t, s) in list(totals.items()):
                    acc = spans.setdefault(
                        name, {"count": 0, "total_ns": 0, "self_ns": 0})
                    acc["count"] += c
                    acc["total_ns"] += t
                    acc["self_ns"] += s
            counters = dict(self._counters)
        for mod, label, names in (
                (cholesky, "ops.cholesky",
                 ("LAUNCHES", "ROUTED", "LATENCY_LAUNCHES", "PANEL_LAUNCHES",
                  "LARGE_LAUNCHES")),
                (gather, "ops.gather", ("LAUNCHES",))):
            for attr in names:
                for kernel, n in getattr(mod, attr).items():
                    counters[f"{label}.{attr}.{kernel}"] = int(n)
        return {"spans": spans, "counters": counters}

    def reset(self) -> None:
        """Forget every total, counter and record (the kernel launch
        counts stay: ``ops.*.reset_counts`` clears them)."""
        with self._lock:
            self._ring.clear()
            for totals in self._threads:
                totals.clear()
            self._counters.clear()


RECORDER = Recorder()
span = RECORDER.span
mark = RECORDER.mark
count = RECORDER.count
recent = RECORDER.recent
summary = RECORDER.summary
reset = RECORDER.reset


def summary_record() -> dict:
    """``summary()`` for a metrics record: per span its count and total and
    self milliseconds, and the counters."""
    s = summary()
    return {"spans": {n: {"count": v["count"],
                          "total_ms": v["total_ns"] / 1e6,
                          "self_ms": v["self_ns"] / 1e6}
                      for n, v in sorted(s["spans"].items())},
            "counters": dict(sorted(s["counters"].items()))}


def _write_spans(records, path, base_ns: int = 0) -> None:
    """Write span records as a Chrome trace (``ph: X`` events, µs after
    ``base_ns`` on the profiler's clock), to lay beside a profiler trace
    whose ``baseTimeNanoseconds`` is ``base_ns``."""
    pid = os.getpid()
    events = [{"name": r.name, "ph": "X", "cat": "port_span", "pid": pid,
               "tid": "port spans", "ts": (r.start_ns - base_ns) / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3,
               "args": {"id": r.id, "parent": r.parent, "call": r.call}}
              for r in records]
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "traceEvents": events}, f)


@contextlib.contextmanager
def trace_sweeps(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed sweeps into `logdir` (no-op when logdir is None),
    and write the port's spans of the block beside the Chrome trace."""
    if not logdir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = set(Path(logdir).glob("*.pt.trace.json"))
    t0 = time.perf_counter_ns()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
    records = [r for r in recent() if r.pc_start_ns >= t0]
    for trace in set(Path(logdir).glob("*.pt.trace.json")) - before:
        with open(trace) as f:
            base = int(json.load(f).get("baseTimeNanoseconds", 0))
        _write_spans(records, str(trace)[:-len(".pt.trace.json")]
                     + ".spans.json", base)


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    def rows_per_sec(self, n_rows: int, n_chips: int = 1) -> float:
        return n_rows / self.elapsed / max(n_chips, 1)


__all__ = ["trace_sweeps", "Timer", "Recorder", "RECORDER", "SpanRecord",
           "RING_SIZE", "span", "mark", "count", "recent", "summary",
           "summary_record", "reset"]
