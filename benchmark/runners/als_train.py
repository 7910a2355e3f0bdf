"""ALS training sweeps, back to back: the traffic of the ``*.train`` cells.

Set-up: the ratings are drawn on the device from the seed and copied to
the host once; the warm start is drawn after them from the same generator
(``init_scale · N(0, 1)``, as ``ALS.fit`` draws it). The port builds both
layouts with ``layout_from_coo`` under the rank's auto policy
(``ALS(...)._data_config()``, as ``ALS.fit`` builds them), uploads them
with ``device_buckets``, and makes the whole-fit function with
``make_scanned_fit`` (``n_sweeps`` sweeps a call). The first call, from the
warm start, is the set-up's warm-up and the first steps that the reference
follows.

Window: calls of that same function back to back, each continuing from the
previous call's factors and ending in its one history readback, until
``--seconds`` have passed; ``sweep_s`` is the window's wall time over the
sweeps of its calls. A copy of each call's starting factors is kept on the
device until the next call, so the window's last call can be followed.

Traced run (after the window): one call of a ``trace_sweeps``-sweep fit on
the same uploaded layouts under the profiler, with the traffic file's
spans around the port's functions.

Comparison (after the window, the program's state freed): the reference
runs a call's sweeps from the same start, twice: from the seeded warm start
against the set-up's first call, and from the window's last call's starting
factors against that call (the program's own state: a fault that shows only
in later calls, such as a call that computes from an earlier call's
inputs, shows there). Each call's history, U and V are held against the
reference's (``check``).
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from benchmark import check, datagen, trace, work


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def program(cfg: dict, dev, compute_dtype=None):
    """The port's estimator for the configuration: (estimator, data
    config, solve config)."""
    from recommendation_models_tpu_torch.models.als import ALS
    est = ALS(rank=int(cfg["rank"]), reg=float(cfg["reg"]),
              alpha=cfg.get("alpha"),
              compute_dtype=compute_dtype or cfg["compute_dtype"],
              platform=None if dev.type == "cuda" else "cpu")
    return est, est._data_config(), est._solve_config()


def inputs(cfg: dict, seed: int, dev):
    """The run's inputs from the seed: host ratings (users, items, values)
    and the warm start (U0, V0) on the device."""
    g = datagen.generator(seed, dev)
    users, items, vals = datagen.ratings(cfg, g, dev)
    k, scale = int(cfg["rank"]), float(cfg["init_scale"])
    U0 = datagen.normal_table(g, int(cfg["n_users"]), k, scale, dev)
    V0 = datagen.normal_table(g, int(cfg["n_items"]), k, scale, dev)
    coo = (users.to(torch.int32).cpu().numpy(),
           items.to(torch.int32).cpu().numpy(), vals.cpu().numpy())
    return coo, U0, V0


def build(cfg: dict, coo, dev, dcfg, scfg, n_sweeps: int):
    """Layouts, uploaded buckets and the whole-fit function of the port:
    (fit, (user layout, item layout), layout build seconds, buckets)."""
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets, make_scanned_fit)
    u, i, v = coo
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    t = time.perf_counter()
    ul = layout_from_coo(u, i, v, n_users, n_items, dcfg)
    il = layout_from_coo(u, i, v, n_users, n_items, dcfg, transpose=True)
    layout_s = time.perf_counter() - t
    block = block_batch(int(cfg["rank"]))
    ub = device_buckets(ul, block, dev)
    ib = device_buckets(il, block, dev)
    fit = make_scanned_fit(ub, ib, n_users, n_items, scfg, n_sweeps,
                           nnz=int(u.shape[0]))
    return fit, (ul, il), layout_s, (ub, ib)


def first_call(fit, U0, V0):
    """The first steps: one call from the warm start. Returns the call's
    (U, V) on the device and (history SSE, U, V) on the host."""
    U, V, hist, n_done = fit(U0.clone(), V0.clone())
    h = hist.cpu().numpy()[:n_done]
    return U, V, (h, U.cpu(), V.cpu())


def window_calls(fit, U, V, seconds: float):
    """Calls back to back from (U, V) until ``seconds`` have passed, each
    ending in its one readback: ([(start, end, sweeps, finite)], the last
    call's starting (U, V) on the device, its end (U, V) on the device and
    its history SSE)."""
    calls = []
    t0 = t = time.perf_counter()
    while t - t0 < seconds:
        start = (U.clone(), V.clone())
        U, V, hist, n_done = fit(U, V)
        h = hist.cpu().numpy()[:n_done]          # the call's one readback
        t1 = time.perf_counter()
        calls.append((t, t1, int(n_done), bool(np.isfinite(h).all())))
        t = t1
    return calls, start, (U, V), h


def device_ratings(coo, dev):
    """The ratings (users, items int64; values) on ``dev``."""
    u, i, v = (torch.as_tensor(a, device=dev) for a in coo)
    return u.long(), i.long(), v


def reference(cfg: dict, ratings, U0, V0, dev, n_sweeps: int,
              dtype=torch.float64):
    """The reference's sweeps from (U0, V0): (SSE list, U, V), in
    ``dtype`` (float64 unless a witness asks for less) on ``dev``."""
    ref = importlib.import_module(
        f"benchmark.references.{cfg['reference']}")
    U, V, hist = ref.fit(*ratings, int(cfg["n_users"]), int(cfg["n_items"]),
                         U0.to(dev), V0.to(dev), float(cfg["reg"]),
                         n_sweeps, dtype=dtype)
    return hist, U, V


def compare(cfg: dict, coo, dev, n_sweeps: int, calls: dict) -> dict:
    """The numbers of each compared call: ``calls`` maps a prefix to
    (starting (U, V), the program's (history SSE, U, V)); the reference
    runs the call's sweeps from the same start."""
    ratings = device_ratings(coo, dev)
    numbers = {}
    for prefix, (start, got) in calls.items():
        ref = reference(cfg, ratings, *start, dev, n_sweeps)
        for name, value in check.train_numbers(got, ref, ratings).items():
            numbers[prefix + name] = value
        del ref
    return numbers


def needed_work(cfg: dict, coo, layouts) -> dict:
    """Needed work of one sweep by layer, from the ratings and the rows and
    columns the program's layouts hand to each layer (its dense rows and
    hot columns): {"sweep_flops", "dense", "gram", "solve"} with
    (FLOP, bytes) pairs; "dense" is None without a dense block."""
    k = int(cfg["rank"])
    u, i, _ = coo
    sizes = (int(cfg["n_users"]), int(cfg["n_items"]))
    dense = [0, 0.0, 0.0]
    gram = [0.0, 0.0]
    solve = [0.0, 0.0]
    for rows, cols, (n_rows, n_cols), lay in ((u, i, sizes, layouts[0]),
                                              (i, u, sizes[::-1],
                                               layouts[1])):
        is_dense = np.zeros(n_rows, bool)
        if lay.dense_ids is not None:
            is_dense[lay.dense_ids] = True
        is_hot = np.zeros(n_cols, bool)
        if lay.hot_ids is not None:
            is_hot[lay.hot_ids] = True
        d_obs = is_dense[rows]
        h_obs = ~d_obs & is_hot[cols]
        b_obs = ~d_obs & ~h_obs
        if d_obs.any():
            f, b = work.gram_work(
                int(d_obs.sum()), int(is_dense.sum()),
                int(np.count_nonzero(np.bincount(cols[d_obs],
                                                 minlength=n_cols))), k)
            dense = [dense[0] + 1, dense[1] + f, dense[2] + b]
        b_rows = np.count_nonzero(np.bincount(rows[b_obs],
                                              minlength=n_rows))
        f, b = work.gram_work(
            int(b_obs.sum()), int(b_rows),
            int(np.count_nonzero(np.bincount(cols[b_obs],
                                             minlength=n_cols))), k)
        gram = [gram[0] + f, gram[1] + b]
        f, b = work.solve_work(n_rows, k, hot_obs=int(h_obs.sum()),
                               n_hot=int(is_hot.sum()))
        solve = [solve[0] + f, solve[1] + b]
    return {"sweep_flops": work.sweep_flops(int(u.shape[0]), sizes[0],
                                            sizes[1], k),
            "dense": tuple(dense[1:]) if dense[0] else None,
            "gram": tuple(gram), "solve": tuple(solve)}


def run(r) -> None:
    cfg, tr, dev = r.config, r.traffic, r.device
    cuda = dev.type == "cuda"
    n_sweeps = int(tr["sweeps_per_call"])
    coo, U0, V0 = inputs(cfg, r.seed, dev)
    U0h, V0h = U0.cpu(), V0.cpu()
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _, dcfg, scfg = program(cfg, dev)
    fit, layouts, r.layout_build_s, buckets = build(cfg, coo, dev, dcfg,
                                                    scfg, n_sweeps)
    U, V, first = first_call(fit, U0, V0)
    del U0, V0
    _sync(dev)
    r.setup_s = time.perf_counter() - r.t_start
    r.phase_s["setup"] = r.setup_s

    t0 = time.perf_counter()
    calls, start, (U, V), last_h = window_calls(fit, U, V, r.seconds)
    t = calls[-1][1]
    r.window = {"seconds": t - t0, "sweeps": sum(c[2] for c in calls),
                "calls": calls}
    r.attempted = len(calls)
    r.failed = sum(1 for c in calls if not c[3])
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev) if cuda
                           else 0)
    last = (tuple(x.cpu() for x in start), (last_h, U.cpu(), V.cpu()))
    del start

    t = time.perf_counter()
    r.phase_s["window"] = t - t0
    if r.trace:
        from recommendation_models_tpu_torch.solver.als_sweep import (
            make_scanned_fit)
        units = int(tr["trace_sweeps"])
        tfit = make_scanned_fit(*buckets, int(cfg["n_users"]),
                                int(cfg["n_items"]), scfg, units,
                                nnz=int(coo[0].shape[0]))

        def traced():
            with torch.profiler.record_function(trace.PREFIX + "call"):
                tfit(U, V)[2].cpu()
        with trace.spans(tr["spans"]):
            r.capture = trace.capture(traced, cuda)
        r.traced_units = units
        r.work = needed_work(cfg, coo, layouts)

    r.phase_s["trace"] = time.perf_counter() - t
    # the program's state goes before the reference runs
    t = time.perf_counter()
    del fit, buckets, layouts, U, V
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.numbers = compare(cfg, coo, dev, n_sweeps,
                        {"": ((U0h, V0h), first), "window_": last})
    r.phase_s["reference"] = time.perf_counter() - t
