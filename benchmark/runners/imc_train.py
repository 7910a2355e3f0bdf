"""IMC training sweeps, back to back: the traffic of the ``*.imc-train``
cells.

Set-up: the ratings are drawn on the device from the seed
(``datagen.ratings``, the ALS cells' law: for one seed the same pairs and
values), then from the same generator the item features (``genome``: the
tag genome's relevance scores for the ``genome_items`` item ids the law
makes most popular, ids 0 to ``genome_items − 1``; the other items' rows
are 0), and from them the user features (``profiles``: each user's
rating-weighted mean of the genome rows of the items it rated). Each
feature column is then centred and scaled over the rows that carry
features (``standardised``); zero rows stay zero. The warm start is drawn
as ``IMC`` draws it: W, then H, from NumPy's ``default_rng(seed)``,
``init_scale · N(0, 1)``, cast to float32. The port builds both layouts as
``IMC.fit`` does (``IMC._build_layouts`` under ``IMC._data_config``),
uploads them with ``device_buckets``, and its whole-fit function
``models.imc.imc_fit`` runs ``n_sweeps`` sweeps a call. The first call,
from the warm start, is the set-up's warm-up and the first steps that the
reference follows.

Window: calls back to back, each from the previous call's W and H and each
ending in its one history readback, until ``--seconds`` have passed; a
copy of each call's start is kept on the device until the next call
(``als_train.window_calls``).

Traced run (after the window): one call of ``trace_sweeps`` sweeps under
the profiler.

Comparison (after the window, the program's state freed): the reference
(``references/imc.py``) runs a call's sweeps twice, from the warm start
against the set-up's first call and from the window's last call's start
against that call (``imc_numbers``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark import check, datagen, trace, work_imc
from benchmark.references import imc as ref_imc
from benchmark.runners import als_train

# users whose genome rows are summed at once by ``profiles``
_PROFILE_USERS = 512


def genome(cfg: dict, g: torch.Generator, dev) -> torch.Tensor:
    """(n_items, d_item) float32 relevance scores in (0, 1):
    ``sigmoid(a_i · b_t / √latent + noise · ε − offset)`` with ``a_i, b_t ~
    N(0, I_latent)``, ``ε ~ N(0, 1)``, for items ``0 .. genome_items − 1``;
    the other rows 0."""
    law = cfg["genome_law"]
    n, d, lat = int(cfg["genome_items"]), int(cfg["d_item"]), int(
        law["latent"])
    a = torch.randn((n, lat), generator=g, device=dev)
    b = torch.randn((d, lat), generator=g, device=dev)
    eps = torch.randn((n, d), generator=g, device=dev)
    Y = torch.zeros((int(cfg["n_items"]), d), dtype=torch.float32,
                    device=dev)
    Y[:n] = torch.sigmoid(a @ b.T / math.sqrt(lat)
                          + float(law["noise"]) * eps
                          - float(law["offset"]))
    return Y


def profiles(users, items, vals, Y: torch.Tensor, n_users: int):
    """(n_users, d) float32: each user's rating-weighted mean of the rows
    of Y that carry features (a row of 0 carries none) over the items it
    rated; 0 for a user who rated none of them. ``users`` sorted."""
    dev = Y.device
    has = (Y != 0).any(1)
    w = vals * has[items].to(vals.dtype)
    deg = torch.bincount(users, minlength=n_users)
    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    X = torch.zeros((n_users, Y.shape[1]), dtype=torch.float32, device=dev)
    for s in range(0, n_users, _PROFILE_USERS):
        e = min(s + _PROFILE_USERS, n_users)
        width = int(deg[s:e].max())
        if width == 0:
            continue
        offs = torch.arange(width, device=dev)
        valid = offs[None, :] < deg[s:e, None]
        pos = torch.where(valid, indptr[s:e, None] + offs[None, :], 0)
        wp = w[pos] * valid                                  # (B, P)
        num = torch.bmm(wp[:, None, :], Y[items[pos]])[:, 0]  # (B, d)
        den = wp.sum(1, keepdim=True)
        X[s:e] = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return X


def standardised(F: torch.Tensor) -> torch.Tensor:
    """F with each column centred and scaled to unit deviation over the
    rows that are not all zero (statistics in float64); zero rows stay
    zero."""
    rows = (F != 0).any(1)
    sub = F[rows].double()
    mu = sub.mean(0)
    sd = sub.std(0, correction=0).clamp_min(1e-12)
    out = torch.zeros_like(F)
    out[rows] = ((sub - mu) / sd).to(F.dtype)
    return out


def warm_start(cfg: dict, seed: int):
    """(W0, H0) float32 host tensors as ``IMC`` draws them with
    ``seed``: W then H from NumPy's ``default_rng``, scaled, then cast."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    k, scale = int(cfg["rank"]), float(cfg["init_scale"])
    return tuple(torch.from_numpy(
        (scale * rng.standard_normal((int(cfg[d]), k))).astype(np.float32))
        for d in ("d_user", "d_item"))


def inputs(cfg: dict, seed: int, dev):
    """The run's inputs from the seed: host ratings (users, items, values),
    the features X and Y on the device, and the warm start (W0, H0) on the
    host."""
    if int(cfg["d_user"]) != int(cfg["d_item"]):
        raise ValueError("the user features are profiles in the item "
                         "features' space: d_user must equal d_item")
    g = datagen.generator(seed, dev)
    users, items, vals = datagen.ratings(cfg, g, dev)
    Y = genome(cfg, g, dev)
    X = standardised(profiles(users, items, vals, Y, int(cfg["n_users"])))
    Y = standardised(Y)
    coo = (users.to(torch.int32).cpu().numpy(),
           items.to(torch.int32).cpu().numpy(), vals.cpu().numpy())
    return coo, X, Y, warm_start(cfg, seed)


def program(cfg: dict, dev):
    """The port's estimator for the configuration."""
    from recommendation_models_tpu_torch.models.imc import IMC
    return IMC(rank=int(cfg["rank"]), reg=float(cfg["reg"]),
               cg_iters=int(cfg["cg_iters"]),
               init_scale=float(cfg["init_scale"]),
               platform=None if dev.type == "cuda" else "cpu")


def build(cfg: dict, est, coo, X, Y, dev, n_sweeps: int):
    """Layouts as ``IMC.fit`` builds them, their upload, and the whole-fit
    function: (fit, layout build seconds, (user buckets, item buckets))."""
    from recommendation_models_tpu_torch.models.imc import imc_fit
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    u, i, v = coo
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    t = time.perf_counter()
    layouts = est._build_layouts(u, i, v, n_users, n_items,
                                 est._data_config())
    layout_s = time.perf_counter() - t
    buckets = tuple(device_buckets(lay, 1, dev) for lay in layouts)
    return fit_fn(cfg, X, Y, buckets, n_sweeps, imc_fit), layout_s, buckets


def fit_fn(cfg: dict, X, Y, buckets, n_sweeps: int, imc_fit):
    """fit(W, H) -> (W, H, hist, n_done): ``imc_fit`` of ``n_sweeps``
    sweeps on the uploaded buckets."""
    reg, iters = float(cfg["reg"]), int(cfg["cg_iters"])

    def fit(W, H):
        return imc_fit(W, H, X, Y, *buckets, reg, iters, n_sweeps,
                       X.shape[0], Y.shape[0])
    return fit


def reference(cfg: dict, ratings, X, Y, W0, H0, dev, n_sweeps: int,
              dtype=torch.float64, product=None):
    """The reference's sweeps from (W0, H0): (objective list, W, H) in
    ``dtype`` on ``dev``."""
    W, H, hist = ref_imc.fit(*ratings, X.to(dev), Y.to(dev), W0.to(dev),
                         H0.to(dev), float(cfg["reg"]),
                         int(cfg["cg_iters"]), n_sweeps, dtype=dtype,
                         product=product)
    return hist, W, H


def imc_numbers(got, ref, ratings, X, Y) -> dict:
    """``loss_gap`` (the widest relative gap of the objective history),
    ``rmse_gap`` (the relative gap of the training RMSE of X W Hᵀ Yᵀ, the
    program's W and H recomputed in float64, against the reference's) and
    ``factor_gap`` (``check.worst_row_gap`` over W and H) of a call:
    ``got`` the program's (history, W, H), ``ref`` the reference's."""
    prog_obj, prog_W, prog_H = got
    ref_obj, ref_W, ref_H = ref
    prog_obj = np.asarray(prog_obj, np.float64)
    ref_obj = np.asarray(ref_obj, np.float64)
    if prog_obj.shape != ref_obj.shape or not np.isfinite(prog_obj).all():
        loss_gap = math.inf
    else:
        loss_gap = float(np.max(np.abs(prog_obj - ref_obj) / ref_obj))
    X64, Y64 = X.to(ref_W.device, torch.float64), Y.to(ref_W.device,
                                                       torch.float64)
    W = prog_W.to(ref_W.device, torch.float64)
    H = prog_H.to(ref_H.device, torch.float64)
    nnz = int(ratings[0].shape[0])
    if bool(torch.isfinite(W).all()) and bool(torch.isfinite(H).all()):
        prog_rmse = check.rmse([float(ref_imc.sse(*ratings, X64 @ W,
                                                  Y64 @ H))], nnz)[0]
        ref_rmse = check.rmse([float(ref_imc.sse(
            *ratings, X64 @ ref_W.double(), Y64 @ ref_H.double()))], nnz)[0]
        rmse_gap = float(abs(prog_rmse - ref_rmse) / ref_rmse)
    else:
        rmse_gap = math.inf
    factor_gap = max(check.worst_row_gap(W, ref_W),
                     check.worst_row_gap(H, ref_H))
    return {"loss_gap": loss_gap, "rmse_gap": rmse_gap,
            "factor_gap": factor_gap}


def compare(cfg: dict, coo, X, Y, dev, n_sweeps: int, calls: dict) -> dict:
    """The numbers of each compared call: ``calls`` maps a prefix to
    (starting (W, H), the program's (history, W, H)); the reference runs
    the call's sweeps from the same start."""
    ratings = als_train.device_ratings(coo, dev)
    numbers = {}
    for prefix, (start, got) in calls.items():
        ref = reference(cfg, ratings, X, Y, *start, dev, n_sweeps)
        for name, value in imc_numbers(got, ref, ratings, X, Y).items():
            numbers[prefix + name] = value
        del ref
    return numbers


def needed_work(cfg: dict, coo) -> dict:
    """Needed work of one sweep: {"sweep_flops", "imc_grams", "imc_cg"},
    the last two (FLOP, bytes) pairs (``work_imc``)."""
    u, i, _ = coo
    sizes = (int(cfg["n_users"]), int(cfg["n_items"]))
    k, iters = int(cfg["rank"]), int(cfg["cg_iters"])
    dims = (int(cfg["d_user"]), int(cfg["d_item"]))
    return {"sweep_flops": work_imc.sweep_flops(int(u.shape[0]), *sizes,
                                                *dims, k, iters),
            "imc_grams": work_imc.grams_work(u, i, *sizes, k),
            "imc_cg": work_imc.cg_work(*sizes, *dims, k, iters)}


def run(r) -> None:
    from recommendation_models_tpu_torch.models.imc import imc_fit
    cfg, tr, dev = r.config, r.traffic, r.device
    cuda = dev.type == "cuda"
    n_sweeps = int(tr["sweeps_per_call"])
    coo, X, Y, (W0, H0) = inputs(cfg, r.seed, dev)
    als_train._sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    est = program(cfg, dev)
    fit, r.layout_build_s, buckets = build(cfg, est, coo, X, Y, dev,
                                           n_sweeps)
    W, H, first = als_train.first_call(fit, W0.to(dev), H0.to(dev))
    als_train._sync(dev)
    r.setup_s = time.perf_counter() - r.t_start
    r.phase_s["setup"] = r.setup_s

    t0 = time.perf_counter()
    calls, start, (W, H), last_h = als_train.window_calls(fit, W, H,
                                                          r.seconds)
    r.window = {"seconds": calls[-1][1] - t0,
                "sweeps": sum(c[2] for c in calls), "calls": calls}
    r.attempted = len(calls)
    r.failed = sum(1 for c in calls if not c[3])
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev) if cuda
                           else 0)
    last = (tuple(x.cpu() for x in start), (last_h, W.cpu(), H.cpu()))
    del start

    t = time.perf_counter()
    r.phase_s["window"] = t - t0
    if r.trace:
        units = int(tr["trace_sweeps"])
        tfit = fit_fn(cfg, X, Y, buckets, units, imc_fit)

        def traced():
            with torch.profiler.record_function(trace.PREFIX + "call"):
                tfit(W, H)[2].cpu()
        with trace.spans(tr["spans"]):
            r.capture = trace.capture(traced, cuda)
        r.traced_units = units
        r.work = needed_work(cfg, coo)

    r.phase_s["trace"] = time.perf_counter() - t
    # the program's state goes before the reference runs
    t = time.perf_counter()
    del fit, buckets, W, H, est
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.numbers = compare(cfg, coo, X, Y, dev, n_sweeps,
                        {"": ((W0, H0), first), "window_": last})
    r.phase_s["reference"] = time.perf_counter() - t
