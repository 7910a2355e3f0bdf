"""IMC on the card: the ML-1M side-feature config of ``bench.py::imc_bench``.

    python -m recommendation_models_tpu_torch.probes.imc \
        [--scale ml1m] [--platform cpu] [--reps 5]

The port's counterpart of ``imc_bench`` (BASELINE config 4). The data of
``--scale`` (``SCALES``; at most 2,000,000 observations): side features
``synthetic_side_features(n_users, n_items, 64, 48, seed=0)`` and
observations ``synthetic_imc_ratings(X, Y, n_obs, rank=32, noise=0.05,
seed=0)``; users in the last 10% of ids are held out of training. Then:

- quality: ``IMC(rank=32, reg=0.1, n_sweeps=8, cg_iters=30, seed=0)`` fit on
  the training users through ``IMC.fit``, its objective history, and the
  cold-start RMSE on the held-out users, whom it never saw;
- throughput: the fit's sweep loop on uploaded layouts from the same init
  (the default: ``default_rng(0)``, 0.1 scale, W then H), warmed up by
  one 8-sweep fit;
  then ``--reps`` fits' worth of sweeps as one loop, ended by the history's
  readback (the loop's only sync), over ``--reps``: fit_seconds, and
  obs/s = training observations x 8 / fit_seconds;
- one sweep under ``torch.profiler``: its device time by kernel and its
  launches, beside the sweep's wall time (synchronised), the host's time to
  enqueue it, and the device's idle share of the timed fit's sweeps;
- the CPU baseline, as ``imc_bench`` takes it: the port's copy of the NumPy
  oracle (``oracle.OracleIMC``, 30 CG steps) for one sweep on the first
  ``ORACLE_OBS`` training observations, scaled to obs/s.

Prints lines, then one JSON line in ``imc_bench``'s schema: ``metric``,
``value`` (obs/s), ``unit``, ``vs_baseline`` (value over the oracle's
obs/s) and ``extra`` (``fit_seconds``, ``cold_start_rmse``,
``train_objective``, ``oracle_obs_per_sec``, ``device``, the card's name
and power limit, the split). With ``--platform cpu`` (default scale
``tiny``) the fits run on the host, untimed, and every device number and
``vs_baseline`` are null.
``chip_smoke.py`` phase 7 runs the ML-1M config with these functions, and
phase 10 the same fit sharded four ways on one card (``sharded_fit``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import (
    PROFILE_TRIES, SCALES, step_rows,
)

RANK = 32            # bench.py's BENCH_RANK=64 capped at 32 for IMC
D_USER, D_ITEM = 64, 48
REG = 0.1
SWEEPS = 8
CG_ITERS = 30
REPS = 5
SPLIT_REPS = 5      # sweeps of the wall and enqueue medians
MAX_OBS = 2_000_000
TRAIN_SHARE = 0.9    # users below 0.9 x n_users train; the rest are cold
ORACLE_OBS = 100_000  # imc_bench's oracle subsample


def imc_data(scale: str, rank: int = RANK):
    """(X, Y, users, items, ratings, cold): the features, the observations
    (a rank-``rank`` bilinear truth) and the mask of observations of
    held-out (cold-start) users."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_imc_ratings, synthetic_side_features)
    n_users, n_items, n_obs = SCALES[scale]
    X, Y = synthetic_side_features(n_users, n_items, D_USER, D_ITEM, seed=0)
    users, items, ratings, _, _ = synthetic_imc_ratings(
        X, Y, min(n_obs, MAX_OBS), rank=rank, noise=0.05, seed=0)
    cold = users >= int(TRAIN_SHARE * n_users)
    return X, Y, users, items, ratings, cold


def quality_fit(data, platform=None, rank: int = RANK):
    """``imc_bench``'s estimator fit on the training users: (model, seconds
    on the host clock, layouts and upload included, cold-start RMSE)."""
    from recommendation_models_tpu_torch import IMC
    X, Y, users, items, ratings, cold = data
    tr = ~cold
    t0 = time.perf_counter()
    model = IMC(rank=rank, reg=REG, n_sweeps=SWEEPS, cg_iters=CG_ITERS,
                seed=0, platform=platform).fit(
        (users[tr], items[tr], ratings[tr]), X, Y)
    secs = time.perf_counter() - t0
    pred = model.predict(users[cold], items[cold])
    cold_rmse = float(np.sqrt(np.mean((pred - ratings[cold]) ** 2)))
    return model, secs, cold_rmse


def sharded_fit(data, mesh):
    """``quality_fit``'s estimator with ``n_shards = mesh.size``, fit on
    ``mesh`` (``IMC._fit``: a one-card host runs S shards only through an
    explicit ``Mesh((cuda:0,) * S)``): (model, seconds on the host clock,
    layouts and upload included)."""
    from recommendation_models_tpu_torch import IMC
    X, Y, users, items, ratings, cold = data
    tr = ~cold
    t0 = time.perf_counter()
    model = IMC(rank=RANK, reg=REG, n_sweeps=SWEEPS, cg_iters=CG_ITERS,
                seed=0, n_shards=mesh.size)
    model._fit((users[tr], items[tr], ratings[tr]), X, Y, None, None, mesh)
    return model, time.perf_counter() - t0


def uploaded(data, device, rank: int = RANK):
    """The sweep loop's inputs on ``device``, as ``IMC.fit`` builds them
    (its layouts and its default init, seed 0): (user buckets, item
    buckets, X, Y, W0, H0, n_users, n_items)."""
    from recommendation_models_tpu_torch import IMC
    from recommendation_models_tpu_torch.ops.gram import full_f32
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    X, Y, users, items, ratings, cold = data
    tr = ~cold
    n_users, n_items = X.shape[0], Y.shape[0]
    model = IMC(rank=rank, seed=0)
    ul, il = model._build_layouts(users[tr], items[tr], ratings[tr],
                                  n_users, n_items, model._data_config())
    W0, H0 = model._init_factors_host(D_USER, D_ITEM)
    full_f32()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (device_buckets(ul, 1, device), device_buckets(il, 1, device),
            t(X), t(Y), t(W0), t(H0), n_users, n_items)


def run_sweeps(inputs, n_sweeps: int):
    """The fit's whole-fit loop: (W, H, history on the host, float64)."""
    from recommendation_models_tpu_torch.models.imc import _imc_fit
    ub, ib, X, Y, W0, H0, n_users, n_items = inputs
    W, H, hist, n_done = _imc_fit(W0, H0, X, Y, ub, ib, REG, CG_ITERS,
                                  n_sweeps, n_users, n_items)
    return W, H, hist.cpu().numpy().astype(np.float64)[:n_done]


def timed_fit(inputs, reps: int = REPS):
    """fit_seconds as ``imc_bench`` times it: one warm fit, then ``reps``
    fits' worth of sweeps as one loop ended by the history's readback, over
    ``reps``. Returns (fit_seconds, the long loop's history)."""
    run_sweeps(inputs, SWEEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, hist = run_sweeps(inputs, SWEEPS * reps)
    return (time.perf_counter() - t0) / reps, hist


def gram_gathers(buckets, k: int, chunk: int = 512) -> int:
    """Gathers (``index_select`` calls) of one half's grams: one per row
    block and degree chunk of each bucket."""
    from recommendation_models_tpu_torch.models.imc import gram_block_rows
    from recommendation_models_tpu_torch.solver.als_sweep import (
        resolve_gather_budget)
    budget = resolve_gather_budget(0, k, buckets, for_sse=True)
    n = 0
    for b in buckets:
        bsz, p = b["indices"].shape
        n += -(-bsz // gram_block_rows(p, k, budget, chunk)) * -(-p // chunk)
    return n


def sweep_split(inputs, fit_s: float):
    """One sweep's device ms by kernel and its launches (``torch.profiler``
    in its active step after a warm-up step; a trace short of the grams'
    gathers is taken again, up to ``PROFILE_TRIES`` times); the median over ``SPLIT_REPS`` sweeps of its wall ms
    (synchronised on both sides) and of the host's ms to enqueue it; and
    the device's idle share of the timed fit's sweeps (1 - device ms / the
    timed fit's ms per sweep)."""
    from recommendation_models_tpu_torch.models.imc import _imc_sweep
    ub, ib, X, Y, W0, H0, n_users, n_items = inputs
    rank = W0.shape[1]

    def sweep():
        return _imc_sweep(W0, H0, X, Y, ub, ib, REG, CG_ITERS, n_users,
                          n_items)
    want = gram_gathers(ub, rank) + gram_gathers(ib, rank)
    for _ in range(PROFILE_TRIES):
        rows = step_rows(sweep)
        traced = sum(n for _, n, name in rows if "gather" in name)
        if traced == want:
            break
    device_ms = sum(r[0] for r in rows) / 1e3
    enqueue, wall = [], []
    for _ in range(SPLIT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    sweep_ms = fit_s / SWEEPS * 1e3
    return {
        "device_ms": device_ms,
        "launches": int(sum(r[1] for r in rows)),
        "wall_ms": float(np.median(wall)),
        "enqueue_ms": float(np.median(enqueue)),
        "timed_sweep_ms": sweep_ms,
        "idle_share": 1.0 - device_ms / sweep_ms,
        "complete": traced == want,     # every gram gather traced
        "top_kernels": [[name, us / 1e3, n] for us, n, name in rows[:6]],
    }


def oracle_obs_per_sec(data, rank: int = RANK) -> float:
    """The CPU baseline of ``imc_bench`` (``bench.py:319-326``): obs/s of
    one sweep of the NumPy oracle on the first ``ORACLE_OBS`` training
    observations (the bench scales the time to the whole set and back,
    which leaves this)."""
    from recommendation_models_tpu_torch.oracle import OracleIMC
    X, Y, users, items, ratings, cold = data
    tr = ~cold
    sub = min(ORACLE_OBS, int(tr.sum()))
    o = OracleIMC(rank=rank, reg=REG, n_sweeps=1, cg_iters=CG_ITERS, seed=0)
    t0 = time.perf_counter()
    o.fit(users[tr][:sub], items[tr][:sub], ratings[tr][:sub], X, Y)
    return sub / (time.perf_counter() - t0)


def measure(data, device, scale: str, reps: int = REPS, rank: int = RANK):
    """Every number of the probe at ``rank`` (``data`` from ``imc_data`` at
    the same rank): (the JSON record, the quality model)."""
    from recommendation_models_tpu_torch.probes.gather_latency import card
    X, Y, users, items, ratings, cold = data
    train_obs = int((~cold).sum())
    on_card = device.type == "cuda"
    model, fit_quality_s, cold_rmse = quality_fit(data, device.type, rank)
    print(f"# quality fit IMC(rank={rank}, reg={REG}, n_sweeps={SWEEPS}, "
          f"cg_iters={CG_ITERS}): {fit_quality_s:.2f}s on the host clock "
          f"(layouts and upload included) history="
          f"{[float(h) for h in model.history_]} cold_start_rmse="
          f"{cold_rmse:.6f} (rating std {float(np.std(ratings)):.4f})",
          flush=True)
    fit_s = split = peak = None
    if on_card:
        inputs = uploaded(data, device, rank)
        torch.cuda.reset_peak_memory_stats()
        fit_s, long_hist = timed_fit(inputs, reps)
        peak = torch.cuda.max_memory_allocated()
        split = sweep_split(inputs, fit_s)
        print(f"# timed fit: {fit_s:.4f} s a fit ({reps} fits' sweeps in "
              f"one loop); first sweeps {long_hist[:2].tolist()}; one "
              f"sweep: device {split['device_ms']:.3f} ms, wall "
              f"{split['wall_ms']:.3f} ms, enqueue {split['enqueue_ms']:.3f}"
              f" ms, {split['launches']} launches (every gather traced: "
              f"{split['complete']}), idle share {split['idle_share']:.3f}",
              flush=True)
    value = baseline = None
    if on_card:
        value = train_obs * SWEEPS / fit_s
        baseline = oracle_obs_per_sec(data, rank)
        print(f"# CPU oracle (oracle.OracleIMC, one sweep on "
              f"{min(ORACLE_OBS, train_obs)} obs): {baseline:.0f} obs/s; "
              f"vs_baseline {value / baseline:.2f}", flush=True)
    return {
        "metric": f"imc_obs_per_sec_per_chip_rank{rank}_{scale}_synth",
        "value": value,
        "unit": "obs/s/chip",
        "vs_baseline": None if value is None else value / baseline,
        "extra": {
            "fit_seconds": fit_s,
            "timed_fits": reps,
            "n_sweeps": SWEEPS,
            "cg_iters": CG_ITERS,
            "train_obs": train_obs,
            "cold_start_rmse": cold_rmse,
            "rating_std": float(np.std(ratings)),
            "train_objective": float(model.history_[-1]),
            "history": [float(h) for h in model.history_],
            "quality_fit_seconds": fit_quality_s,
            "sweep_split": split,
            "max_memory_allocated": peak,
            "oracle_obs_per_sec": baseline,
            "oracle_obs": min(ORACLE_OBS, train_obs),
            "device": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
            "card": card() if on_card else None,
        },
    }, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default=None, choices=sorted(SCALES),
                    help="default: ml1m on the card, tiny on the CPU")
    ap.add_argument("--platform", default=None,
                    help="'cpu': on the host, untimed; default: the card")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    if args.platform == "cpu":
        device, scale = torch.device("cpu"), args.scale or "tiny"
    else:
        if not torch.cuda.is_available():
            print("imc: needs a CUDA card (or --platform cpu)",
                  file=sys.stderr)
            return 2
        device, scale = torch.device("cuda"), args.scale or "ml1m"
    data = imc_data(scale)
    print(f"# data {scale}: {data[0].shape[0]} users x {data[1].shape[0]} "
          f"items, features {D_USER}/{D_ITEM}, {data[2].shape[0]} obs, "
          f"{int((~data[5]).sum())} in training, {int(data[5].sum())} of "
          f"held-out users", flush=True)
    record, _ = measure(data, device, scale, args.reps)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
