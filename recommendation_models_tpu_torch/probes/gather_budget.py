"""Whole half-sweep time against ``SolveConfig.gather_budget_mb``: the port
of the reference's ``scripts/ablate_gather_budget.py``.

    python -m recommendation_models_tpu_torch.probes.gather_budget \
        [--platform cpu]

The gather budget caps the rows of one gathered (rows, P, k) block, so it
sets how many row blocks, and so how many host-enqueued launches, a
half-sweep takes (the auto budget at rank 64 is the reference's TPU value,
2 MB). Each line is one budget's half-sweep, the mean device time of
``ABL_ITERS`` calls between CUDA events after one warm-up call, on the
opposite table 0.01 N(0, 1) from ``default_rng(0)``.

Env (the reference's): ABL_SIDE (item), ABL_SCALE (ml25m), ABL_RANK (64),
ABL_ITERS (5), ABL_CACHE_DIR (``build/layout_cache`` at the checkout's
root), ABL_BUDGETS (256,64,24,8). The layout is the default
``DataConfig``'s, as the reference builds it, cached by
``data/layout_cache.py`` as ``<scale>_<side>.npz``. ``run(layout, rank,
budgets, n_iters)`` times a layout the caller has built.

Runs on the CUDA card, and raises when there is none, unless
``--platform cpu`` is given; on the CPU every line runs once, untimed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from recommendation_models_tpu_torch.config import SolveConfig
from recommendation_models_tpu_torch.data.layout import layout_from_coo
from recommendation_models_tpu_torch.data.layout_cache import cached_layout
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops.cholesky import block_batch
from recommendation_models_tpu_torch.probes import (
    LAYOUT_CACHE_DIR, SCALES, timed)
from recommendation_models_tpu_torch.solver.als_sweep import (
    device_buckets, half_sweep)

BUDGETS = (256, 64, 24, 8)      # MB, the reference's default


def run(layout, rank: int, budgets, n_iters: int, side: str = "item",
        device=None) -> dict:
    """One timed half-sweep of ``layout`` per budget (MB); returns budget ->
    ms (None on the CPU)."""
    dev = resolve_device(device)
    bs = device_buckets(layout, block_batch(rank), dev)
    rng = np.random.default_rng(0)
    T = torch.from_numpy((0.01 * rng.standard_normal(
        (layout.n_cols, rank))).astype(np.float32)).to(dev)
    out = {}
    for mb in budgets:
        cfg = SolveConfig(rank=rank, reg=0.1, solver="auto",
                          compute_dtype="auto", gather_budget_mb=mb)
        out[mb] = timed(lambda: half_sweep(T, bs, layout.n_rows, cfg),
                        n_iters, dev, f"{side} half, gather_budget={mb}MB")
    return out


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    side = env.get("ABL_SIDE", "item")
    if side not in ("user", "item"):
        raise SystemExit(f"ABL_SIDE must be user or item, got {side!r}")
    scale = env.get("ABL_SCALE", "ml25m")
    rank = int(env.get("ABL_RANK", "64"))
    iters = int(env.get("ABL_ITERS", "5"))
    cache = env.get("ABL_CACHE_DIR", str(LAYOUT_CACHE_DIR))
    budgets = [int(b) for b in env.get(
        "ABL_BUDGETS", ",".join(map(str, BUDGETS))).split(",")]
    device = resolve_device(args.platform)
    n_users, n_items, n_obs = SCALES[scale]
    os.makedirs(cache, exist_ok=True)

    def build():
        users, items, ratings = synthetic_ratings(n_users, n_items, n_obs,
                                                  rank=16, seed=0)
        return layout_from_coo(users, items, ratings, n_users, n_items,
                               transpose=(side == "item"))

    layout = cached_layout(os.path.join(cache, f"{scale}_{side}.npz"), build)
    run(layout, rank, budgets, iters, side, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
