"""Measurement probes of the port, run as modules
(``python -m recommendation_models_tpu_torch.probes.<name>``), and what
they share: the synthetic data scales and the device timer."""

from __future__ import annotations

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


__all__ = ["SCALES", "LAYOUT_CACHE_DIR", "time_ms", "timed"]
