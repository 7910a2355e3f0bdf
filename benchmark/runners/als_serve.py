"""Top-n serving from fitted tables in a closed loop: the traffic of the
``*.serve*`` cells.

Set-up: the ratings are drawn on the device from the seed and become the
users' CSR of rated items; the factor tables are drawn after them from the
same generator, ``N(0, 1) / sqrt(rank)``, and the order of users is a
seeded permutation of all users. The port's estimator comes from
``ALS.from_reference_state`` with the tables and the CSR
(``train_indptr``, ``train_indices``), and ``warmup_calls`` calls of
``recommend`` warm it up (they upload the catalog once).

Window: one caller calls ``ALS.recommend(ids, n, exclude_seen)`` back to
back, each call with the next ``users_per_call`` users of the permutation
(wrapping), until ``--seconds`` have passed. A call returns NumPy, so it
ends synchronised; its latency is the host clock around it.

Traced run (after the window): ``trace_calls`` further calls under the
profiler, with the traffic file's spans around the port's functions.

Comparison (after the window, the estimator freed): every answer of every
call in the window against the reference's exact top n of the same users
(``check``).
"""

from __future__ import annotations

import gc
import importlib
import math
import time

import numpy as np
import torch

from benchmark import check, datagen, trace, work


def inputs(cfg: dict, seed: int, dev):
    """The run's inputs from the seed, on the host: (indptr int64, indices
    int32, U float32, V float32, order of users int64)."""
    g = datagen.generator(seed, dev)
    users, items, _ = datagen.ratings(cfg, g, dev)
    n_users, n_items = int(cfg["n_users"]), int(cfg["n_items"])
    k = int(cfg["rank"])
    U = datagen.normal_table(g, n_users, k, 1.0 / math.sqrt(k), dev)
    V = datagen.normal_table(g, n_items, k, 1.0 / math.sqrt(k), dev)
    order = torch.randperm(n_users, generator=g, device=dev)
    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(users, minlength=n_users), 0)
    return (indptr.cpu().numpy(), items.to(torch.int32).cpu().numpy(),
            U.cpu().numpy(), V.cpu().numpy(), order.cpu().numpy())


def program(cfg: dict, dev, indptr, indices, U, V):
    """The port's fitted estimator over the tables and the CSR."""
    from recommendation_models_tpu_torch.models.als import ALS
    state = {"U_": U, "V_": V, "n_users_": U.shape[0],
             "n_items_": V.shape[0], "history_": [],
             "params": {"rank": int(cfg["rank"]), "reg": float(cfg["reg"]),
                        "platform": None if dev.type == "cuda" else "cpu"}}
    return ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)


def call_ids(order, call: int, per_call: int):
    """The users of call ``call``: the next ``per_call`` of the order,
    wrapping."""
    return order[(call * per_call + np.arange(per_call)) % order.shape[0]]


def reference(cfg: dict, U, V, n: int, indptr, indices, dev,
              dtype=torch.float64):
    """The reference's top-n scores and items of every user, and the
    tables in float64, on ``dev``."""
    ref = importlib.import_module(
        f"benchmark.references.{cfg['reference']}")
    U64 = torch.as_tensor(U, device=dev).double()
    V64 = torch.as_tensor(V, device=dev).double()
    ip = torch.as_tensor(indptr, device=dev)
    ix = None if indices is None else torch.as_tensor(indices, device=dev)
    top_s, top_i = ref.topn(U64, V64, n, ip if ix is not None else None, ix,
                            dtype=dtype)
    return top_s, top_i, U64, V64


def seen_keys(indptr, indices, n_items: int, dev):
    """Sorted ``user · n_items + item`` of every rated pair, on ``dev``."""
    users = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64),
                      np.diff(indptr))
    key = torch.as_tensor(users * n_items + indices, device=dev)
    return torch.sort(key)[0]


def run(r) -> None:
    cfg, tr, dev = r.config, r.traffic, r.device
    cuda = dev.type == "cuda"
    n, per_call = int(tr["n"]), int(tr["users_per_call"])
    excl = bool(tr["exclude_seen"])
    indptr, indices, U, V, order = inputs(cfg, r.seed, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    est = program(cfg, dev, indptr, indices, U, V)
    for w in range(int(tr["warmup_calls"])):
        est.recommend(call_ids(order, -(w + 1), per_call), n, excl)
    r.setup_s = time.perf_counter() - r.t_start
    r.phase_s["setup"] = r.setup_s

    calls, answers = [], []
    t0 = t = time.perf_counter()
    c = 0
    while t - t0 < r.seconds:
        ids = call_ids(order, c, per_call)
        sc, it = est.recommend(ids, n, excl)
        t1 = time.perf_counter()
        calls.append((t, t1, per_call))
        answers.append((ids, it, sc))
        t, c = t1, c + 1
    r.window = {"seconds": t - t0, "users": sum(x[2] for x in calls),
                "calls": calls, "latencies": [b - a for a, b, _ in calls]}
    r.attempted = len(calls)
    r.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev) if cuda
                           else 0)

    t = time.perf_counter()
    r.phase_s["window"] = t - t0
    if r.trace:
        units = int(tr["trace_calls"])
        traced_ids = [call_ids(order, c + j, per_call) for j in range(units)]

        def traced():
            for ids in traced_ids:
                with torch.profiler.record_function(trace.PREFIX + "call"):
                    est.recommend(ids, n, excl)
        with trace.spans(tr["spans"]):
            r.capture = trace.capture(traced, cuda)
        r.traced_units = units
        degs = np.diff(indptr)
        n_excl = (float(np.mean([degs[ids].sum() for ids in traced_ids]))
                  if excl else 0)
        r.work = {"call": work.topk_work(per_call, V.shape[0],
                                         int(cfg["rank"]), int(n_excl), n)}

    r.phase_s["trace"] = time.perf_counter() - t
    t = time.perf_counter()
    del est
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    top_s, _, U64, V64 = reference(cfg, U, V, n, indptr,
                                   indices if excl else None, dev)
    keys = seen_keys(indptr, indices, V.shape[0], dev) if excl else None
    numbers, bad_rows = check.serve_numbers(
        np.concatenate([a[0] for a in answers]),
        np.concatenate([a[1] for a in answers]),
        np.concatenate([a[2] for a in answers]),
        U64, V64, top_s, keys, V.shape[0])
    r.numbers = numbers
    r.phase_s["reference"] = time.perf_counter() - t
    r.failed = int(np.unique(bad_rows // per_call).shape[0])
