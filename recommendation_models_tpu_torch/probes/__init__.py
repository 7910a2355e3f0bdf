"""Measurement probes of the port, run as modules
(``python -m recommendation_models_tpu_torch.probes.<name>``), and what
they share: the synthetic data scales and the device and host timers."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional

import torch

# n_users, n_items, n_obs of the synthetic data at each scale (bench.py's
# SCALES, copied)
SCALES = {
    "synth100m": (500_000, 200_000, 100_000_000),
    "ml25m": (162_541, 62_423, 25_000_000),
    "ml1m": (6_040, 3_706, 1_000_209),
    "ml100k": (943, 1_682, 100_000),
    "tiny": (2_000, 1_500, 120_000),
}

# default directory of the probes' layout cache files (ignored by git)
LAYOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "layout_cache"


def time_ms(fn: Callable, iters: int, warm: int = 0) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls between CUDA
    events, after ``warm`` untimed calls. The events are on the stream, so
    the time includes the device's idle gaps while the host enqueues."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(fn: Callable, reps: int = 1, warm: int = 1):
    """The device activity of ``reps`` calls of ``fn`` under
    ``torch.profiler`` (CUDA activity only: kernels and copies, not runtime
    calls), after ``warm`` untimed calls: [(device µs, calls, name)],
    longest first. Host gaps between the calls do not count. Raises if the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, ev.count, ev.key[:70]))
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    return sorted(rows, reverse=True)


def profiled_ms(fn: Callable, reps: int) -> float:
    """Device ms per call of ``fn`` (``device_rows`` summed, over ``reps``
    calls after one warm-up call)."""
    return sum(r[0] for r in device_rows(fn, reps)) / 1e3 / reps


def host_us(fn: Callable, calls: int = 200) -> float:
    """Host wall time per call of ``fn`` in µs over ``calls`` calls (at
    least 200) with no synchronisation inside the window, after one warm-up
    call: the wrapper, its checks and the launch."""
    calls = max(calls, 200)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def timed(fn: Callable, iters: int, device: torch.device, label: str,
          rows: Optional[int] = None, width: int = 42) -> Optional[float]:
    """One line of a probe: on the card, ``fn``'s mean device time over
    ``iters`` calls after one warm-up call (and the gather rate when
    ``rows`` is given), printed and returned; on the CPU ``fn`` runs once,
    untimed, and None is returned."""
    if device.type != "cuda":
        fn()
        print(f"{label:{width}s} (cpu, untimed)", flush=True)
        return None
    ms = time_ms(fn, iters, warm=1)
    rate = "" if rows is None else f"  {rows / ms / 1e3:8.1f} M rows/s"
    print(f"{label:{width}s} {ms:9.4f} ms{rate}", flush=True)
    return ms


__all__ = ["SCALES", "LAYOUT_CACHE_DIR", "time_ms", "device_rows",
           "profiled_ms", "host_us", "timed"]
