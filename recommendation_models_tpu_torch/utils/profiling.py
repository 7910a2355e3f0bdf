"""Tracing/profiling hooks (SURVEY.md §5).

``trace_sweeps`` wraps a training region in ``torch.profiler.profile`` (the
CPU, plus CUDA when a card is present) and writes a Chrome trace
(``*.pt.trace.json``, viewable in TensorBoard's profiler plugin, Perfetto or
``chrome://tracing``) into its logdir; ``Timer`` provides the wall-clock and
rows-solved/sec/chip counters of the headline metric.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_sweeps(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed sweeps into `logdir` (no-op when logdir is None)."""
    if not logdir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    def rows_per_sec(self, n_rows: int, n_chips: int = 1) -> float:
        return n_rows / self.elapsed / max(n_chips, 1)


__all__ = ["trace_sweeps", "Timer"]
