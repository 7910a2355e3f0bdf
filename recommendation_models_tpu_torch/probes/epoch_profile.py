"""The main path's epoch on the card: epoch_seconds over repeated fits, and
one profiled sweep's device time by kernel.

    python -m recommendation_models_tpu_torch.probes.epoch_profile \
        [--reps 3] [--scale ml25m] [--rank 64] [--sweeps 10] [--hot-cols C]

Makes the synthetic data of ``--scale`` and both auto layouts at ``--rank``
as ``ALS(rank=...).fit`` builds them (hot columns, dense threshold and
bucket growth of the rank; ``--hot-cols C`` sets the hot width as
``ALS(hot_cols=C)`` does), uploads them and warms up with one sweep. Then
each of ``--reps`` fits of ``--sweeps`` sweeps from the bench's warm start
is timed as ``bench.py`` times epoch_seconds: host wall time from the first
sweep to the history readback (the fit's one sync), over the sweeps. Last,
one sweep runs under ``torch.profiler`` (CUDA activity): its device time,
the device's idle share of the median epoch, the launches of the solve
kernels and the top kernels by device time; then the device ms a sweep of
B1's and B2's kernels (``solve_kernel``), from a trace of the last of
three sweeps that recorded every launch of its sweep (null for a kernel
whose launches it did not all record). Prints one JSON line.

``chip_smoke.py`` builds its main-path data, times its epoch and profiles
its sweep with the functions of this module, and the port's bench
(``recommendation_models_tpu_torch.bench``) runs its train mode through
them. The probe runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import (
    SCALES, device_rows, step_rows)

# the main path's rank and sweeps: the defaults of the functions below
RANK = 64
SWEEPS = 10


def main_path_layouts(scale: str = "ml25m", rank: int = RANK, coo=None,
                      dcfg=None):
    """The synthetic ratings of ``scale`` (``SCALES``; ``coo`` = (u, i, r)
    reuses them) and both layouts under ``dcfg``, by default the auto
    policies of ``rank`` as ``ALS(rank=rank).fit`` builds them: ((u, i, r),
    user layout, item layout)."""
    from recommendation_models_tpu_torch.config import (
        DataConfig, bucket_growth_for_rank, dense_min_degree_for_rank)
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops.cholesky import hot_cols_auto
    n_users, n_items, n_obs = SCALES[scale]
    if coo is None:
        coo = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    u, i, r = coo
    dcfg = dcfg or DataConfig(
        hot_cols=hot_cols_auto(rank),
        dense_min_degree=dense_min_degree_for_rank(rank),
        bucket_growth=bucket_growth_for_rank(rank))
    ul = layout_from_coo(u, i, r, n_users, n_items, config=dcfg)
    il = layout_from_coo(u, i, r, n_users, n_items, transpose=True,
                         config=dcfg)
    return (u, i, r), ul, il


def warm_start(n_users: int, n_items: int, rank: int = RANK):
    """The bench's warm start: 0.01 N(0, 1) from default_rng(0), f32."""
    g = np.random.default_rng(0)
    U0 = 0.01 * g.standard_normal((n_users, rank)).astype(np.float32)
    V0 = 0.01 * g.standard_normal((n_items, rank)).astype(np.float32)
    return U0, V0


class ScannedFits(NamedTuple):
    """What ``scanned_fits`` returns: the whole fit, the one-sweep fit, the
    warm start on the device, the uploaded user buckets (what
    ``masked_sse`` reads) and the solve config."""
    fit: object
    one: object
    U0: torch.Tensor
    V0: torch.Tensor
    user_buckets: tuple
    cfg: object


def scanned_fits(ul, il, nnz: int, dev, rank: int = RANK,
                 alpha: Optional[float] = None, sweeps: int = SWEEPS,
                 **solve) -> ScannedFits:
    """The solver's whole-fit loop on the uploaded layouts, as ``bench.py``
    runs it (``SolveConfig(rank, reg=0.1, alpha, **solve)``: ``solve`` may
    set ``solver``, ``compute_dtype``, ``sse_mode`` and
    ``gather_budget_mb``), warmed up by one sweep."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets, make_scanned_fit)
    ub = device_buckets(ul, block_batch(rank), dev)
    ib = device_buckets(il, block_batch(rank), dev)
    cfg = SolveConfig(rank=rank, reg=0.1, alpha=alpha, **solve)
    U0, V0 = (torch.from_numpy(a).to(dev)
              for a in warm_start(ul.n_rows, il.n_rows, rank))
    one = make_scanned_fit(ub, ib, ul.n_rows, il.n_rows, cfg, 1, nnz=nnz)
    one(U0.clone(), V0.clone())
    fit = make_scanned_fit(ub, ib, ul.n_rows, il.n_rows, cfg, sweeps,
                           nnz=nnz)
    return ScannedFits(fit, one, U0, V0, ub, cfg)


def time_fit(fit, U0, V0):
    """One fit from (U0, V0), timed as ``bench.py`` times epoch_seconds:
    (seconds per sweep, U, V, the per-sweep SSE on the host, sweeps
    done). The SSE readback is the fit's one sync; the seconds are over
    the fit's sweep count (the history's length)."""
    if U0.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, V, sse, n_done = fit(U0.clone(), V0.clone())
    sse_h = sse.cpu().numpy()
    return (time.perf_counter() - t0) / sse_h.shape[0], U, V, sse_h, n_done


def profile_sweep(one, U, V, epoch_s: float, top: int = 15) -> dict:
    """Device time of one sweep (``one`` from ``scanned_fits``) by kernel,
    and the device's idle share of an unprofiled ``epoch_s``."""
    rows = device_rows(lambda: one(U, V), reps=1, warm=0)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"device_ms_per_sweep": device_ms, "epoch_ms": epoch_s * 1e3,
            "idle_share": 1.0 - device_ms / (epoch_s * 1e3),
            "top": [{"name": n, "ms": t / 1e3, "calls": c}
                    for t, c, n in rows[:top]]}


def solve_kernel(name: str):
    """The regime solve (``ops.cholesky.REGIME_KINDS``) a device kernel's
    name (as ``torch.profiler`` gives it, cut at 70 characters) belongs
    to, or None: ``chol_solve_kernel<NTH, NT, HOT, TWO_G, ...>`` of
    csrc/cholesky_solve.cu by its flags, and ``rank_panel_kernel<NTH, NT,
    NQ, SCHED, SROWS, FUSE>`` of csrc/cholesky_rank_panel.cu by FUSE (0:
    B1's panel frame in a fit, which launches no other variant; 1: B3; 2:
    B2)."""
    m = re.search(r"chol_solve_kernel<([^>]*)", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        return ("cholesky_solve_hot" if args[2] == "true"
                else "cholesky_solve_2g" if args[3] == "true"
                else "cholesky_solve_batched")
    m = re.search(r"rank_panel_kernel<([^>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        fuse = args[5] if len(args) > 5 else "0"
        return {"0": "cholesky_solve_batched", "1": "cholesky_solve_2g",
                "2": "cholesky_solve_hot"}[fuse]
    return None


def solve_ms_per_sweep(one, U, V, kinds=("cholesky_solve_batched",
                                          "cholesky_solve_hot")) -> dict:
    """Device ms a sweep of each regime solve in ``kinds`` (its kernels by
    ``solve_kernel``) and its launches a sweep, from the last of three
    sweeps traced by ``step_rows``: {kind: {"ms": ms or None, "launches":
    n, "recorded": calls}}; ms is None unless the trace recorded every
    launch of its sweep."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    ch.reset_counts()
    rows = step_rows(lambda: one(U, V))
    out = {}
    for kind in kinds:
        mine = [(us, c) for us, c, n in rows if solve_kernel(n) == kind]
        recorded = sum(c for _, c in mine)
        launches = ch.LAUNCHES[kind] // 3
        out[kind] = {"ms": (sum(us for us, _ in mine) / 1e3
                            if recorded == launches else None),
                     "launches": launches, "recorded": recorded}
    return out


def main(argv=None) -> int:
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.gram import full_f32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scale", default="ml25m", choices=sorted(SCALES))
    ap.add_argument("--rank", type=int, default=RANK)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    ap.add_argument("--hot-cols", type=int, default=None,
                    help="hot columns (default: the rank's auto policy)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("epoch_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    full_f32()
    dcfg = None
    if args.hot_cols is not None:
        from recommendation_models_tpu_torch.config import (
            DataConfig, bucket_growth_for_rank, dense_min_degree_for_rank)
        dcfg = DataConfig(
            hot_cols=args.hot_cols,
            dense_min_degree=dense_min_degree_for_rank(args.rank),
            bucket_growth=bucket_growth_for_rank(args.rank))
    (_, _, r), ul, il = main_path_layouts(args.scale, args.rank, dcfg=dcfg)
    fits = scanned_fits(ul, il, r.shape[0], dev, args.rank,
                        sweeps=args.sweeps)
    epochs = []
    for _ in range(args.reps):
        epoch_s, U, V, _, _ = time_fit(fits.fit, fits.U0, fits.V0)
        epochs.append(epoch_s)
    median = float(np.median(epochs))
    ch.reset_counts()
    prof = profile_sweep(fits.one, U, V, median, top=12)
    launches = {n: ch.LAUNCHES[n] for n in ("cholesky_solve_batched",
                                            "cholesky_solve_hot")}
    latency = {n: ch.LATENCY_LAUNCHES[n] for n in launches}
    solves = solve_ms_per_sweep(fits.one, U, V)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scale": args.scale,
        "rank": args.rank, "sweeps": args.sweeps,
        "hot_cols": 0 if ul.hot_ids is None else int(ul.hot_ids.shape[0]),
        "epoch_seconds": epochs, "median_epoch_seconds": median,
        **{key: prof[key] for key in ("device_ms_per_sweep", "idle_share",
                                      "top")},
        "solve_launches_per_sweep": launches,
        "latency_launches_per_sweep": latency,
        "solve_device_ms_per_sweep": solves}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
