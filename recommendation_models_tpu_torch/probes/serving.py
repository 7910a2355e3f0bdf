"""Top-k serving on the card: quality and throughput of the serving config.

    python -m recommendation_models_tpu_torch.probes.serving \
        [--scale ml25m] [--platform cpu]

The port's counterpart of ``bench.py::serving_bench``. On the synthetic
ratings of ``--scale`` (``SCALES``; ``synthetic_ratings(..., rank=16,
seed=0)``), a leave-2-out split (seed 0) trains ``ALS(rank=64, alpha=1.0,
reg=0.1, n_sweeps=8, seed=0)``. Then:

- quality: ``recommend(exclude_seen=True)`` for the first 20,000 users
  with held-out items, once with ``method="auto"`` and once with
  ``method="exact"`` (both select exactly in the port), each timed on the
  host clock (the call returns NumPy, so it ends synchronised), and their
  recall@10 and NDCG@10;
- throughput: a 65,536-user query batch (the first users' factors) of
  ``topk_scores`` at k=10 with no exclusion, 50 calls between two CUDA
  events (the only host sync besides the selection's own tie check, one
  per item block), users/s against the bound of the unfused path
  (``bound_ms``);
- the device-time split of one such batch by ``torch.profiler``: the
  scoring product (GEMM kernels), the selection (``torch.topk``'s
  kernels) and the rest (sorts that order the picks, merges, masks);
- the host oracle: NumPy scores and ``argpartition`` for 512 users, as
  ``bench.py`` times it.

Prints one JSON line in ``serving_bench``'s schema, its ``extra`` extended
with the card's name and power limit, ``max_memory_allocated`` and the
split. With ``--platform cpu`` (default scale ``ml100k``) every step runs on
the host and no device number is given (null). ``chip_smoke.py`` runs the
ML-25M serving config with these functions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch.probes import (
    PROFILE_TRIES, SCALES, step_rows,
)
from recommendation_models_tpu_torch.probes.gather_latency import card

RANK = 64
SWEEPS = 8
K = 10
EVAL_USERS = 20_000
QUERY_BATCH = 65_536
REPS = 50
RECALL_TARGET = 0.95        # bench.py's default dial; exact selection here
ORACLE_ROWS = 512
# H100 SXM peaks (NVIDIA data sheet), as in chip_smoke.py
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def serving_split(coo, n_users: int, n_items: int):
    """The leave-2-out split of ``serving_bench``: (train CSR, train
    observations, eval users (the first ``EVAL_USERS`` with held-out
    items), their held-out items as a CSR pair)."""
    from recommendation_models_tpu_torch.evaluate import (
        grouped_by_user, leave_n_out, take_groups)
    users, items, ratings = coo
    tr, te = leave_n_out(users, items, ratings, n=2, seed=0)
    train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                          shape=(n_users, n_items))
    rel_indptr, rel_items = grouped_by_user(users[te], items[te], n_users)
    eval_users = np.flatnonzero(np.diff(rel_indptr) > 0)[:EVAL_USERS]
    return (train, int(tr.sum()), eval_users,
            take_groups(rel_indptr, rel_items, eval_users))


def fit_serving_model(train, platform=None):
    """``serving_bench``'s model: implicit ALS at rank 64, 8 sweeps."""
    from recommendation_models_tpu_torch import ALS
    return ALS(rank=RANK, alpha=1.0, reg=0.1, n_sweeps=SWEEPS, seed=0,
               platform=platform).fit(train)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_quality(model, eval_users, rel_eval, device):
    """recommend(exclude_seen=True) with 'auto' and with 'exact': per
    method its ids, recall@10, NDCG@10 and host seconds."""
    from recommendation_models_tpu_torch.evaluate import (
        ndcg_at_k, recall_at_k)
    out = {}
    for method in ("auto", "exact"):
        _sync(device)
        t0 = time.perf_counter()
        _, ids = model.recommend(eval_users, n=K, exclude_seen=True,
                                 method=method, recall_target=RECALL_TARGET)
        secs = time.perf_counter() - t0
        out[method] = dict(ids=ids, recall=recall_at_k(ids, rel_eval),
                           ndcg=ndcg_at_k(ids, rel_eval), seconds=secs)
    return out


def bound_ms(batch: int, n_items: int, rank: int = RANK):
    """(unfused, fused) least ms of a query batch on the card: the f32
    product's 2·B·n·r flops at the f32 peak, plus, unfused, one read of the
    (B, n) f32 score matrix by the selection (its write can hide under the
    product)."""
    t_ops = 2.0 * batch * n_items * rank / PEAK_F32_FLOPS * 1e3
    t_read = 4.0 * batch * n_items / PEAK_BYTES_PER_S * 1e3
    return t_ops + t_read, t_ops


def query_batch(model, device, batch: int = QUERY_BATCH):
    """The throughput run's inputs: the first ``batch`` users' factors and
    the catalog (item order), on ``device``."""
    batch = min(batch, model.U_.shape[0])
    Uq = torch.as_tensor(model.U_[:batch], device=device)
    V = torch.as_tensor(model.V_, device=device)
    return Uq, V


def throughput(Uq, V, reps: int = REPS):
    """ms per ``topk_scores`` call at k=10 over ``reps`` calls between two
    CUDA events (after one warm-up call), and the peak memory of the run."""
    from recommendation_models_tpu_torch.ops.topk import topk_scores

    def call():
        return topk_scores(Uq, V, K, recall_target=RECALL_TARGET)
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, torch.cuda.max_memory_allocated()


def _part(name: str) -> str:
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "product"
    if "topk" in low:
        return "selection"
    return "other"


def device_split(Uq, V):
    """Device ms of one ``topk_scores`` call by part (``torch.profiler``):
    product, selection, other; the top kernels of each part; and whether
    the trace holds every product call (one per item block). A trace short
    of product calls is taken again, up to ``PROFILE_TRIES`` times."""
    from recommendation_models_tpu_torch.ops.topk import (
        _EXACT_BLOCK, _SMALL_N, topk_scores)
    n_items = V.shape[0]
    blocks = 1 if n_items <= _SMALL_N else -(-n_items // _EXACT_BLOCK)
    for _ in range(PROFILE_TRIES):
        rows = step_rows(lambda: topk_scores(Uq, V, K))
        traced = sum(n for _, n, name in rows if _part(name) == "product")
        if traced == blocks:
            break
    split = {"product": 0.0, "selection": 0.0, "other": 0.0}
    kernels = {p: [] for p in split}
    for us, calls, name in rows:
        split[_part(name)] += us / 1e3
        kernels[_part(name)].append([name, us / 1e3, calls])
    split["total"] = sum(split.values())
    split["complete"] = traced == blocks
    split["kernels"] = {p: v[:4] for p, v in kernels.items()}
    return split


def host_oracle(model, rows: int = ORACLE_ROWS) -> float:
    """users/s of the NumPy reference ``top_n``: full scores and
    ``argpartition`` (``bench.py``'s oracle)."""
    sample = min(rows, model.U_.shape[0])
    t = time.perf_counter()
    s = np.asarray(model.U_[:sample]) @ np.asarray(model.V_).T
    np.argpartition(-s, K, axis=1)[:, :K]
    return sample / (time.perf_counter() - t)


def measure(model, train_obs, eval_users, rel_eval, device, scale: str):
    """Every number of the probe on a fitted model: the JSON record."""
    n_users, n_items = model.n_users_, model.n_items_
    q = serve_quality(model, eval_users, rel_eval, device)
    Uq, V = query_batch(model, device)
    batch = Uq.shape[0]
    ms = peak = split = None
    bound = (None, None)
    if device.type == "cuda":
        bound = bound_ms(batch, n_items)
        ms, peak = throughput(Uq, V)
        split = device_split(Uq, V)
    qps = None if ms is None else batch / ms * 1e3
    oracle = host_oracle(model)
    return {
        "metric": f"topk_retrieval_users_per_sec_rank{RANK}_{scale}_synth",
        "value": qps,
        "unit": "users/s/chip",
        "vs_baseline": None if qps is None else qps / oracle,
        "extra": {
            "recall_at_10": q["auto"]["recall"],
            "ndcg_at_10": q["auto"]["ndcg"],
            "recall_at_10_exact": q["exact"]["recall"],
            "ndcg_at_10_exact": q["exact"]["ndcg"],
            "auto_ids_equal_exact": bool(np.array_equal(q["auto"]["ids"],
                                                        q["exact"]["ids"])),
            "recommend_seconds": {m: q[m]["seconds"] for m in q},
            "train_obs": train_obs,
            "eval_users": int(eval_users.shape[0]),
            "n_users": n_users, "n_items": n_items,
            "oracle_users_per_sec": oracle,
            "topk_method": "exact",
            "recall_target": RECALL_TARGET,
            "query_batch": batch,
            "batch_ms": ms,
            "bound_ms": bound[0], "bound_ms_fused": bound[1],
            "max_memory_allocated": peak,
            "device_split_ms": split,
            "device": (torch.cuda.get_device_name(0)
                       if device.type == "cuda" else "cpu"),
            "card": card() if device.type == "cuda" else None,
        },
    }, q


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default=None, choices=sorted(SCALES),
                    help="default: ml25m on the card, ml100k on the CPU")
    ap.add_argument("--platform", default=None,
                    help="'cpu': on the host, untimed; default: the card")
    args = ap.parse_args(argv)
    if args.platform == "cpu":
        device, scale = torch.device("cpu"), args.scale or "ml100k"
    else:
        if not torch.cuda.is_available():
            print("serving: needs a CUDA card (or --platform cpu)",
                  file=sys.stderr)
            return 2
        device, scale = torch.device("cuda"), args.scale or "ml25m"
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_users, n_items, n_obs = SCALES[scale]
    coo = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    train, train_obs, eval_users, rel_eval = serving_split(coo, n_users,
                                                           n_items)
    model = fit_serving_model(train, platform=device.type)
    record, _ = measure(model, train_obs, eval_users, rel_eval, device,
                        scale)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
