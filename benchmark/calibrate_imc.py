"""Readings that the limits of ``correct`` of the IMC cells are set from.

    python3 -m benchmark.calibrate_imc --workload <name> --seeds 1 2 ... \
        [--control-seeds 3] [--seconds S] [--out FILE]

For each seed, at the cell's own size and through the runner's own
functions, prints one JSON line of readings of the set-up's first call and,
under ``window_``, of the last call of a window of ``--seconds`` (default
``run_seconds``), as a run makes them:

- ``sound``: the numbers of the program as the configuration states it;
- ``control`` (the first ``--control-seeds`` seeds): the reference in
  float32 with its CG operator's products computed in bfloat16 (operands
  rounded to bfloat16, ``bf16_product``), against the float64 reference:
  a precision below the configuration's float32, made here and not by a
  switch in the port; ``control_tf32`` the same with the products in TF32;
- on the same seeds, three faults planted in the port from here:
  ``fault_half`` (half of W's rows left at their start in every sweep),
  ``fault_skip`` (one CG operator pass of every half-step skipped: the
  pass serving the first CG step returns zeros, so that step is a zero
  step and its block's next directions are no longer conjugate) and
  ``fault_stale`` (every call of the window computing from the first
  call's inputs: the first call's answer read against the window's
  reference);
- ``witness_f32``: the reference itself in float32 against float64, from
  both starts: what rounding alone does to the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.runners import als_train, imc_train

# the operator pass of every ``_cg`` call that ``fault_skip`` skips: the
# first is the block's true residual, the second serves the first step
SKIPPED_PASS = 2


def bf16_product(a, b):
    """``a @ b`` with both operands rounded to bfloat16 (the products
    accumulate in float32 on a card), returned in a's dtype."""
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(a.dtype)


def tf32_product(a, b):
    """``a @ b`` of float32 operands in TF32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def planted(kind: str):
    """A fault planted in the port's IMC solver while the block runs."""
    from recommendation_models_tpu_torch.models import imc
    name = {"half": "_solve_factor", "skip": "_cg"}[kind]
    orig = getattr(imc, name)
    calls = [0]

    def half_left(F, Z, buckets, n_rows, M0, *args, **kwargs):
        M, sse = orig(F, Z, buckets, n_rows, M0, *args, **kwargs)
        calls[0] += 1
        if calls[0] % 2:                     # the W half of each sweep
            M = M.clone()
            M[1::2] = M0[1::2]
        return M, sse

    def skipped(matvec, b, x0, iters, restart=16):
        passes = [0]

        def mv(v):
            passes[0] += 1
            if passes[0] == SKIPPED_PASS:
                return torch.zeros_like(v)
            return matvec(v)
        return orig(mv, b, x0, iters, restart)

    setattr(imc, name, half_left if kind == "half" else skipped)
    try:
        yield
    finally:
        setattr(imc, name, orig)


def readings(cfg, tr, seed, dev, control: bool, seconds: float) -> dict:
    n_sweeps = int(tr["sweeps_per_call"])
    coo, X, Y, (W0, H0) = imc_train.inputs(cfg, seed, dev)
    est = imc_train.program(cfg, dev)
    fit, _, buckets = imc_train.build(cfg, est, coo, X, Y, dev, n_sweeps)
    W, H, first = als_train.first_call(fit, W0.to(dev), H0.to(dev))
    calls, start, end, last_h = als_train.window_calls(fit, W, H, seconds)
    starts = {"": (W0.to(dev), H0.to(dev)), "window_": start}
    runs = {"sound": {"": first,
                      "window_": (last_h, *(x.cpu() for x in end))}}
    del W, H, end
    if control:
        for kind in ("half", "skip"):
            with planted(kind):
                runs[f"fault_{kind}"] = {
                    p: als_train.first_call(fit, *s0)[2]
                    for p, s0 in starts.items()}
        runs["fault_stale"] = {"window_": first}
    del fit, buckets, est
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ratings = als_train.device_ratings(coo, dev)
    refs, ref_s = {}, {}
    for p, s0 in starts.items():
        t = time.perf_counter()
        refs[p] = imc_train.reference(cfg, ratings, X, Y, *s0, dev, n_sweeps)
        ref_s[p] = time.perf_counter() - t
    lower = {"witness_f32": None}
    if control:
        lower.update(control=bf16_product, control_tf32=tf32_product)
    for name, product in lower.items():
        runs[name] = {p: imc_train.reference(cfg, ratings, X, Y, *s0, dev,
                                             n_sweeps, torch.float32,
                                             product)
                      for p, s0 in starts.items()}
    out = {name: {p + k: v for p, got in by.items()
                  for k, v in imc_train.imc_numbers(got, refs[p], ratings,
                                                    X, Y).items()}
           for name, by in runs.items()}
    out["history"] = {p: list(map(float, runs["sound"][p][0]))
                      for p in starts}
    out["reference_history"] = {p: refs[p][0] for p in starts}
    out["reference_s"] = ref_s
    out["window_calls"] = len(calls)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate_imc: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Benchmark()
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    seconds = (bench.spec["run_seconds"] if args.seconds is None
               else args.seconds)
    out = open(args.out, "a") if args.out else None
    try:
        for j, seed in enumerate(args.seeds):
            t = time.perf_counter()
            got = readings(cfg, tr, seed, dev, j < args.control_seeds,
                           seconds)
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
