"""Readings that the limits of ``correct`` are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 ... \
        [--control-seeds 3] [--out FILE]

For each seed, at the cell's own size and through the runners' own
functions, prints one JSON line of readings (training: of the set-up's
first call and, under ``window_``, of the last call of a window of
``run_seconds``, as a run makes them):

- ``sound``: the numbers of the program as the configuration states it;
- ``control`` (the first ``--control-seeds`` seeds): the numbers of the
  nearest lower precision. Training: the program's own bfloat16 path
  (``compute_dtype="bfloat16"``) on the same layouts. Serving: the
  reference computed in bfloat16 put in the program's place;
- training only, on the same seeds, the numbers of two faults planted in
  the program: ``fault_half`` (half of the rows of every half-sweep left
  out: they stay 0) and ``fault_row`` (one row of every half-sweep's
  answer replaced by another row's). A step that returns its state
  unchanged reads 1 by ``factor_gap``'s measure and needs no run. And
  ``fault_stale``: every call of the window computing from the first
  call's inputs (as a captured graph replayed on stale buffers would): the
  first call's answer read against the window's reference;
- training only, ``witness_f32``: the reference itself in float32 against
  float64, from both starts: what rounding alone does to the numbers.

Serving compares one pass of calls over every user (each user's answer is
the same in every call of a window) and the control over every user.
Runs on the card; ``--device cpu`` runs the same at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import check, harness
from benchmark.runners import als_serve, als_train


@contextlib.contextmanager
def planted(kind: str):
    """A fault planted in the port's half-sweep while the block runs."""
    from recommendation_models_tpu_torch.solver import als_sweep
    orig = als_sweep.solve_all_buckets

    def faulty(*args, **kwargs):
        U, sse = orig(*args, **kwargs)
        U = U.clone()
        if kind == "half":
            U[1::2] = 0.0
        elif kind == "row":
            U[0] = U[1]
        return U, sse
    als_sweep.solve_all_buckets = faulty
    try:
        yield
    finally:
        als_sweep.solve_all_buckets = orig


def train_readings(cfg, tr, seed, dev, control: bool,
                   seconds: float) -> dict:
    n_sweeps = int(tr["sweeps_per_call"])
    coo, U0, V0 = als_train.inputs(cfg, seed, dev)
    _, dcfg, scfg = als_train.program(cfg, dev)
    fit, layouts, _, buckets = als_train.build(cfg, coo, dev, dcfg, scfg,
                                               n_sweeps)
    U, V, first = als_train.first_call(fit, U0, V0)
    calls, start, end, last_h = als_train.window_calls(fit, U, V, seconds)
    starts = {"": (U0, V0), "window_": start}
    runs = {"sound": {"": first,
                      "window_": (last_h, *(x.cpu() for x in end))}}
    del U, V, end
    if control:
        from recommendation_models_tpu_torch.solver.als_sweep import (
            make_scanned_fit)
        _, _, scfg16 = als_train.program(cfg, dev, "bfloat16")
        fit16 = make_scanned_fit(*buckets, int(cfg["n_users"]),
                                 int(cfg["n_items"]), scfg16, n_sweeps,
                                 nnz=int(coo[0].shape[0]))
        runs["control"] = {p: als_train.first_call(fit16, *s0)[2]
                           for p, s0 in starts.items()}
        for kind in ("half", "row"):
            with planted(kind):
                runs[f"fault_{kind}"] = {
                    p: als_train.first_call(fit, *s0)[2]
                    for p, s0 in starts.items()}
        runs["fault_stale"] = {"window_": first}
    del fit, layouts, buckets
    gc.collect()
    ratings = als_train.device_ratings(coo, dev)
    refs, ref_s = {}, {}
    for p, s0 in starts.items():
        t = time.perf_counter()
        refs[p] = als_train.reference(cfg, ratings, *s0, dev, n_sweeps)
        ref_s[p] = time.perf_counter() - t
    out = {name: {p + k: v for p, got in by.items()
                  for k, v in check.train_numbers(got, refs[p],
                                                  ratings).items()}
           for name, by in runs.items()}
    out["witness_f32"] = {
        p + k: v for p, s0 in starts.items()
        for k, v in check.train_numbers(
            als_train.reference(cfg, ratings, *s0, dev, n_sweeps,
                                torch.float32), refs[p], ratings).items()}
    out["reference_s"] = ref_s
    out["window_calls"] = len(calls)
    out["rows"] = {p: row_gaps(runs["sound"][p], refs[p], coo, cfg)
                   for p in starts}
    return out


def row_gaps(got, ref, coo, cfg) -> dict:
    """Where the sound run's row gaps lie: per table, their quantiles and
    the worst row's degree and norms."""
    out = {}
    for name, P, R, ids, n in (("U", got[1], ref[1], coo[0], cfg["n_users"]),
                               ("V", got[2], ref[2], coo[1], cfg["n_items"])):
        R = R.double()
        P = P.to(R.device).double()
        d = (P - R).norm(dim=1)
        nr = R.norm(dim=1)
        ratio = (d / torch.clamp_min(nr, float(nr.median()))).cpu().numpy()
        deg = np.bincount(ids, minlength=int(n))
        w = int(np.argmax(ratio))
        out[name] = {"q50": float(np.quantile(ratio, 0.5)),
                     "q99": float(np.quantile(ratio, 0.99)),
                     "q999": float(np.quantile(ratio, 0.999)),
                     "max": float(ratio[w]), "worst_row": w,
                     "worst_degree": int(deg[w]),
                     "worst_norm": float(nr[w]),
                     "median_norm": float(nr.median())}
    return out


def serve_readings(cfg, tr, seed, dev, control: bool,
                   seconds: float) -> dict:
    n, per_call = int(tr["n"]), int(tr["users_per_call"])
    excl = bool(tr["exclude_seen"])
    indptr, indices, U, V, order = als_serve.inputs(cfg, seed, dev)
    est = als_serve.program(cfg, dev, indptr, indices, U, V)
    n_calls = -(-order.shape[0] // per_call)
    answers = []
    for c in range(n_calls):
        ids = als_serve.call_ids(order, c, per_call)
        sc, it = est.recommend(ids, n, excl)
        answers.append((ids, it, sc))
    del est
    gc.collect()
    t = time.perf_counter()
    top_s, _, U64, V64 = als_serve.reference(
        cfg, U, V, n, indptr, indices if excl else None, dev)
    ref_s = time.perf_counter() - t
    keys = (als_serve.seen_keys(indptr, indices, V.shape[0], dev)
            if excl else None)
    out = {"sound": check.serve_numbers(
        *(np.concatenate([a[j] for a in answers]) for j in range(3)),
        U64, V64, top_s, keys, V.shape[0])[0], "reference_s": ref_s}
    if control:
        c_s, c_i, _, _ = als_serve.reference(
            cfg, U, V, n, indptr, indices if excl else None, dev,
            dtype=torch.bfloat16)
        users = np.arange(U.shape[0])
        out["control"] = check.serve_numbers(
            users, c_i.cpu().numpy(), c_s.float().cpu().numpy(), U64, V64,
            top_s, keys, V.shape[0])[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Benchmark()
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    readings = (train_readings if tr["runner"] == "als_train"
                else serve_readings)
    out = open(args.out, "a") if args.out else None
    try:
        for j, seed in enumerate(args.seeds):
            t = time.perf_counter()
            got = readings(cfg, tr, seed, dev, j < args.control_seeds,
                           bench.spec["run_seconds"])
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "seconds": time.perf_counter() - t, **got})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
