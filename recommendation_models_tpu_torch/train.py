"""Training CLI of the port — ``python -m recommendation_models_tpu_torch.train ...``.

The JAX package's ``train.py`` on PyTorch: the same argument groups,
options, defaults and choices, the same per-sweep JSONL records and summary,
for batch jobs. Data selection (MovieLens file or synthetic), estimator
hyperparameters, checkpointing, metrics (JSONL + TensorBoard), and profiler
tracing (``torch.profiler``, a Chrome trace in ``--trace-dir``).

It runs on the CUDA card unless ``--platform cpu``; with no card and no
``--platform`` the estimator raises. ``--n-shards S`` fits the 1-D sharded
ALS, or with ``--model imc`` the sharded IMC, over S cards (S entries of
the host with ``--platform cpu``); ``--topology obs_parallel --num-slices
D`` fits the 2-D observation-parallel ALS over ``D x S/D`` of them. Each
logs its per-sweep collective bytes.

Several processes: ``--coordinator host:port --num-processes P
--process-id i`` in each of P processes starts a gloo process group
(``parallel.mesh.initialize_distributed``), and ``--n-shards S`` then
spans every process, ``S / P`` shards each (``--topology obs_parallel``:
one slice a process). Each process runs the same code, and so the same
collectives in the same order; only process 0 writes the metrics and
prints the summary and ``--top-n``. On a host with several cards give each
process its own card (``CUDA_VISIBLE_DEVICES``); on one card two
processes share it.

Examples:
  python -m recommendation_models_tpu_torch.train --synthetic ml1m --rank 64
  python -m recommendation_models_tpu_torch.train --ratings ml-25m/ratings.csv \\
      --rank 64 --alpha 40 --checkpoint-dir ckpt --metrics-jsonl run.jsonl
  python -m recommendation_models_tpu_torch.train --synthetic tiny --rank 8 \\
      --n-sweeps 2 --platform cpu
  # two processes, one shard each (run both; i = 0 and 1)
  python -m recommendation_models_tpu_torch.train --synthetic ml1m \\
      --n-shards 2 --coordinator 127.0.0.1:29500 --num-processes 2 \\
      --process-id i
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


SYNTH_SCALES = {
    "ml100k": (943, 1_682, 100_000),
    "ml1m": (6_040, 3_706, 1_000_209),
    "ml25m": (162_541, 62_423, 25_000_000),
    "tiny": (2_000, 1_500, 120_000),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="recommendation_models_tpu_torch.train",
        description="Fit an ALS/IMC recommendation model on a CUDA card.")
    data = p.add_argument_group("data")
    data.add_argument("--ratings", help="MovieLens ratings file "
                      "(u.data / ratings.dat / ratings.csv)")
    data.add_argument("--synthetic", choices=sorted(SYNTH_SCALES),
                      help="synthetic dataset at a MovieLens-like scale")
    data.add_argument("--synthetic-rank", type=int, default=16,
                      help="latent rank of the synthetic generator")
    data.add_argument("--holdout", type=int, default=0,
                      help="leave-n-out per user for eval (0 = train on all)")
    model = p.add_argument_group("model")
    model.add_argument("--model", choices=["als", "imc"], default="als")
    model.add_argument("--rank", type=int, default=64)
    model.add_argument("--reg", type=float, default=0.1)
    model.add_argument("--alpha", type=float, default=None,
                       help="implicit-feedback confidence (None = explicit)")
    model.add_argument("--n-sweeps", type=int, default=10)
    model.add_argument("--tol", type=float, default=0.0)
    model.add_argument("--seed", type=int, default=0)
    model.add_argument("--side-features", type=int, default=0,
                       help="IMC: synthesize this many side features per side")
    engine = p.add_argument_group("engine")
    engine.add_argument("--solver", default="auto",
                        choices=["auto", "xla", "pallas", "lu"],
                        help="'auto'/'pallas': the hand-written CUDA solve "
                             "kernels; 'xla': the library Cholesky; 'lu'")
    engine.add_argument("--compute-dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"])
    engine.add_argument("--n-shards", type=int, default=None,
                        help="> 1: the sharded ALS (or IMC) over that "
                             "many cards (host entries with --platform "
                             "cpu)")
    engine.add_argument("--num-slices", type=int, default=None,
                        help="slices of a sharded fit's mesh (must "
                             "divide --n-shards)")
    engine.add_argument("--sse-mode", default="auto",
                        choices=["auto", "riding", "separate"],
                        help="per-sweep SSE strategy (measured per-config"
                             "-class auto policy, config.sse_separate_for)")
    engine.add_argument("--gather-budget-mb", type=int, default=0,
                        help="row-block gather budget (MB); 0 = rank- and "
                             "size-aware auto (config.gather_budget_for_rank)")
    engine.add_argument("--hot-cols", type=int, default=None,
                        help="hot-column block width; default auto "
                             "(the kernel's cap at this rank), 0 disables")
    engine.add_argument("--dense-min-degree", type=int, default=None,
                        help="rows denser than this solve on the dense "
                             "gramian path; default auto (rank-aware "
                             "break-even, config.dense_min_degree_for_rank)")
    engine.add_argument("--topology", default="1d",
                        choices=["1d", "obs_parallel"],
                        help="'obs_parallel': the 2-D observation-parallel "
                             "sharded ALS over (--num-slices, --n-shards / "
                             "--num-slices) devices")
    engine.add_argument("--exchange", default="allgather",
                        choices=["allgather", "all_to_all", "hybrid"])
    engine.add_argument("--exchange-head", type=int, default=None,
                        help="hybrid exchange: replicate this many Zipf-head "
                             "columns (default auto)")
    engine.add_argument("--platform", default=None,
                        help="force a device platform (e.g. cpu); default: "
                             "the CUDA card")
    dist = p.add_argument_group("distributed")
    dist.add_argument("--coordinator", default=None,
                      help="multi-host coordinator address host:port "
                           "(a gloo process group)")
    dist.add_argument("--num-processes", type=int, default=None)
    dist.add_argument("--process-id", type=int, default=None)
    out = p.add_argument_group("output")
    out.add_argument("--checkpoint-dir", default=None)
    out.add_argument("--checkpoint-every", type=int, default=0)
    out.add_argument("--resume", action="store_true",
                     help="resume factors from the latest checkpoint and "
                     "continue for --n-sweeps more sweeps")
    out.add_argument("--metrics-jsonl", default=None)
    out.add_argument("--tensorboard-dir", default=None)
    out.add_argument("--trace-dir", default=None,
                     help="torch.profiler Chrome trace output "
                          "(*.pt.trace.json)")
    out.add_argument("--top-n", type=int, default=0,
                     help="after fit, print top-N recs for user 0 (smoke)")
    out.add_argument("-v", "--verbose", action="count", default=1)
    return p


def _load_data(args):
    if args.ratings:
        from recommendation_models_tpu_torch.data.movielens import (
            load_ratings_file)
        d = load_ratings_file(args.ratings)
        users, items, ratings = d["users"], d["items"], d["ratings"]
        n_users, n_items = d["n_users"], d["n_items"]
    elif args.synthetic:
        from recommendation_models_tpu_torch.data.synthetic import (
            synthetic_ratings)
        n_users, n_items, n_obs = SYNTH_SCALES[args.synthetic]
        users, items, ratings = synthetic_ratings(
            n_users, n_items, n_obs, rank=args.synthetic_rank, seed=args.seed)
    else:
        raise SystemExit("one of --ratings / --synthetic is required")
    return users, items, ratings, n_users, n_items


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    from recommendation_models_tpu_torch.parallel.mesh import (
        barrier, initialize_distributed, process_index)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    # every process fits; process 0 alone writes the metrics and prints
    lead = process_index() == 0
    verbose = args.verbose if lead else 0

    import scipy.sparse as sp
    from recommendation_models_tpu_torch.evaluate import leave_n_out
    from recommendation_models_tpu_torch.utils.logging import MetricsLogger
    from recommendation_models_tpu_torch.utils.profiling import (
        Timer, trace_sweeps)

    users, items, ratings, n_users, n_items = _load_data(args)
    nnz = ratings.shape[0]
    if verbose:
        print(f"[train] {nnz} interactions, {n_users} users x {n_items} items")

    test = None
    if args.holdout > 0:
        tr, te = leave_n_out(users, items, ratings, n=args.holdout,
                             seed=args.seed)
        test = sp.csr_matrix((ratings[te], (users[te], items[te])),
                             shape=(n_users, n_items))
        users, items, ratings = users[tr], items[tr], ratings[tr]
    R = sp.csr_matrix((ratings, (users, items)), shape=(n_users, n_items))

    metrics = MetricsLogger(args.metrics_jsonl if lead else None,
                            args.tensorboard_dir if lead else None)
    if args.model == "als":
        from recommendation_models_tpu_torch.models.als import ALS
        model = ALS(rank=args.rank, reg=args.reg, alpha=args.alpha,
                    n_sweeps=args.n_sweeps, tol=args.tol, seed=args.seed,
                    solver=args.solver, compute_dtype=args.compute_dtype,
                    sse_mode=args.sse_mode,
                    gather_budget_mb=args.gather_budget_mb,
                    n_shards=args.n_shards, num_slices=args.num_slices,
                    topology=args.topology, exchange=args.exchange,
                    exchange_head=args.exchange_head,
                    platform=args.platform, hot_cols=args.hot_cols,
                    dense_min_degree=args.dense_min_degree,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    verbose=max(args.verbose - 1, 0))
        with trace_sweeps(args.trace_dir), Timer() as t:
            if args.resume and args.checkpoint_dir:
                step = model.resume()
                if verbose:
                    print(f"[train] resumed from sweep {step}")
                model.fit(R, U0=model.U_, V0=model.V_)
            else:
                model.fit(R)
    else:
        if args.topology != "1d":
            # loud, not silent: IMC has no 2-D observation-parallel program
            raise SystemExit(
                f"--topology {args.topology} applies to --model als only; "
                "IMC shards data-parallel on the 1-D mesh")
        from recommendation_models_tpu_torch.models.imc import IMC
        rng = np.random.default_rng(args.seed)
        d = args.side_features or max(4, args.rank)
        X = rng.standard_normal((n_users, d)).astype(np.float32)
        Y = rng.standard_normal((n_items, d)).astype(np.float32)
        model = IMC(rank=args.rank, reg=args.reg, n_sweeps=args.n_sweeps,
                    tol=args.tol, seed=args.seed, n_shards=args.n_shards,
                    num_slices=args.num_slices,
                    platform=args.platform,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    verbose=max(args.verbose - 1, 0))
        with trace_sweeps(args.trace_dir), Timer() as t:
            if args.resume and args.checkpoint_dir:
                step = model.resume()
                if verbose:
                    print(f"[train] resumed from sweep {step}")
                model.fit(R, X, Y, W0=model.W_, H0=model.H_)
            else:
                model.fit(R, X, Y)

    rows = (n_users + n_items) * len(getattr(model, "history_", [0]))
    # per-sweep collective traffic of a sharded exchange
    xbytes = getattr(model, "exchange_bytes_per_sweep_", None)
    for i, rmse in enumerate(model.history_):
        rec = dict(train_rmse=float(rmse))
        if xbytes is not None:
            rec["collective_bytes"] = int(xbytes["per_sweep_total"])
        metrics.log(i + 1, **rec)
    summary = dict(
        train_rmse=float(model.history_[-1]),
        fit_seconds=round(t.elapsed, 3),
        rows_per_sec=round(t.rows_per_sec(rows), 1),
    )
    if xbytes is not None:
        summary["collective_bytes_per_sweep"] = int(
            xbytes["per_sweep_total"])
        summary["collective_bytes_with_standalone_sse"] = int(
            xbytes.get("per_sweep_with_sse", xbytes["per_sweep_total"]))
    if test is not None and hasattr(model, "rmse"):
        summary["test_rmse"] = float(model.rmse(test))
    if test is not None and hasattr(model, "recommend") and args.model == "als":
        from recommendation_models_tpu_torch.evaluate import (
            grouped_by_user, ndcg_at_k, recall_at_k, take_groups)
        tu, ti = test.nonzero()
        rel_indptr, rel_items = grouped_by_user(tu, ti, n_users)
        holdout_users = np.flatnonzero(np.diff(rel_indptr) > 0)
        eval_users = holdout_users[:50_000]
        if eval_users.shape[0] < holdout_users.shape[0] and verbose:
            # no silent caps: say when ranking metrics cover a user SAMPLE
            print(f"[train] recall/ndcg evaluated on the first "
                  f"{eval_users.shape[0]} of {holdout_users.shape[0]} "
                  f"holdout users")
        rel_eval = take_groups(rel_indptr, rel_items, eval_users)
        _, topk = model.recommend(eval_users, n=10, exclude_seen=True)
        summary["recall_at_10"] = round(float(recall_at_k(topk, rel_eval)), 4)
        summary["ndcg_at_10"] = round(float(ndcg_at_k(topk, rel_eval)), 4)
        summary["eval_users"] = int(eval_users.shape[0])
        summary["holdout_users"] = int(holdout_users.shape[0])
    metrics.log(len(model.history_), **summary)
    metrics.close()
    if verbose:
        print("[train] " + " ".join(f"{k}={v}" for k, v in summary.items()))
    if args.top_n and hasattr(model, "recommend"):
        scores, top = model.recommend([0], n=args.top_n)
        if lead:
            print(f"[train] top-{args.top_n} for user 0: {top[0].tolist()}")
    barrier()       # every process ends its collectives before any exits
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
