"""IMC quality parity against the full NumPy CG oracle at ML-1M shape.

    python -m recommendation_models_tpu_torch.probes.quality_parity_imc \
        [--seeds 0,1,2] [--platform cpu] [--oracle-only --out FILE.npz]

The port's counterpart of ``scripts/quality_parity_imc.py`` (BASELINE.json:5
for IMC). The same problem: side features ``synthetic_side_features(6040,
3706, 64, 48, seed=0)``, observations ``synthetic_imc_ratings(X, Y,
1_000_000, rank=16, noise=0.05, seed=0)``; users in the last 10% of ids are
held out of training entirely (cold start), and 10% of the rest's
observations (``default_rng(1)``) are the test set. For each seed, W0 and
H0 are ``0.1 N(0, 1)`` from ``default_rng(seed)`` (f32, W then H), and both
the port's copy of the oracle (``oracle.OracleIMC``, f64, 30 CG steps) and
``IMC(rank=16, reg=0.1, n_sweeps=6, cg_iters=30)`` are fit from them on the
training observations: final objective, test RMSE and cold-start RMSE of
each, and the per-sweep objective histories and the test predictions.

The gate (``check``) is the JAX package's test of IMC against its oracle
(tests/test_imc.py): the histories within rtol 2e-2 sweep by sweep, and
the test predictions within rtol 2e-2, atol 2e-2. At ML-1M shape the
first sweep's 30 CG steps from the random start stop short of
convergence, and an f32 fit's first objective is 4.8% off the f64
oracle's in both packages (seed 0: the JAX package's ``IMC`` on a CPU
551,506.6, this port's 551,504.5, the oracle 526,103.3); from the second
sweep on they agree within 0.5%. So at ML-1M the first sweep is held
within 2e-2 of the JAX package's f32 history instead (``JAX_HISTORY``,
recorded on a CPU by the command beside it), and every later sweep within
2e-2 of the oracle's.

Prints one JSON line in the script's schema (``"oracle"`` and ``"tpu"``
lists per metric, ``"tpu"`` naming the estimator's side, rounded as the
script rounds them), with ``history_rel_diff`` and ``pred_max_abs_diff``
per seed, ``device``, ``platform`` and ``ok``, the gate. The estimator runs
on the CUDA card, or on the host with ``--platform cpu``; the oracle on the
host (about 20 s a sweep on one core: a seed is about 2 minutes).
``--oracle-only`` fits only the oracle for the seeds and saves its factors
and histories to ``--out``; ``chip_smoke.py`` phase 13 runs it so, one
child process a seed beside the card's other work, and the estimator's
side in the process (``run(oracles=...)``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

ML1M = (6_040, 3_706, 64, 48, 1_000_000)   # users, items, d_u, d_i, obs
RANK, REG, SWEEPS, CG = 16, 0.1, 6, 30
SEEDS = (0, 1, 2)
METRICS = ("objective", "test_rmse", "cold_rmse")
DIGITS = {"objective": 2, "test_rmse": 5, "cold_rmse": 5}
RTOL = ATOL = 2e-2     # tests/test_imc.py's oracle parity
# The JAX package's f32 histories of this protocol at ML-1M shape, recorded
# on a CPU:
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np
#   from recommendation_models_tpu.data.synthetic import (
#       synthetic_imc_ratings, synthetic_side_features)
#   from recommendation_models_tpu.models.imc import IMC
#   X, Y = synthetic_side_features(6040, 3706, 64, 48, seed=0)
#   u, i, r, _, _ = synthetic_imc_ratings(X, Y, 1_000_000, rank=16,
#                                         noise=0.05, seed=0)
#   cold = u >= int(0.9 * 6040)
#   test = (~cold) & (np.random.default_rng(1).random(u.shape[0]) < 0.1)
#   tr = (~cold) & (~test)
#   for seed in (0, 1, 2):
#       g = np.random.default_rng(seed)
#       W0 = (0.1 * g.standard_normal((64, 16))).astype(np.float32)
#       H0 = (0.1 * g.standard_normal((48, 16))).astype(np.float32)
#       m = IMC(rank=16, reg=0.1, n_sweeps=6, cg_iters=30,
#               platform="cpu").fit((u[tr], i[tr], r[tr]), X, Y,
#                                   W0=W0, H0=H0)
#       print(seed, [float(h) for h in m.history_])'
JAX_HISTORY = {
    0: [551506.625, 3377.533935546875, 3284.4111328125, 3231.427490234375,
        3291.8349609375, 3262.73583984375],
    1: [399272.78125, 3518.895751953125, 3462.987060546875, 3485.328125,
        3420.06982421875, 3467.627197265625],
    2: [391013.0, 3872.65380859375, 3792.753173828125, 3800.32861328125,
        3797.83056640625, 3798.579345703125],
}


def problem(shape=ML1M):
    """(X, Y, users, items, ratings, train, test, cold): the script's data
    and split at ``shape`` (users, items, d_u, d_i, observations)."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_imc_ratings, synthetic_side_features)
    n_users, n_items, d_u, d_i, n_obs = shape
    X, Y = synthetic_side_features(n_users, n_items, d_u, d_i, seed=0)
    users, items, ratings, _, _ = synthetic_imc_ratings(
        X, Y, n_obs, rank=RANK, noise=0.05, seed=0)
    cold = users >= int(0.9 * n_users)
    test = (~cold) & (np.random.default_rng(1).random(users.shape[0]) < 0.1)
    train = (~cold) & (~test)
    return X, Y, users, items, ratings, train, test, cold


def warm(seed: int, X, Y):
    rng = np.random.default_rng(seed)
    W0 = (0.1 * rng.standard_normal((X.shape[1], RANK))).astype(np.float32)
    H0 = (0.1 * rng.standard_normal((Y.shape[1], RANK))).astype(np.float32)
    return W0, H0


def oracle_seed(seed: int, data) -> dict:
    """The oracle's fit of one seed (host only): its factors and history."""
    from recommendation_models_tpu_torch.oracle import OracleIMC
    X, Y, users, items, ratings, train, _, _ = data
    W0, H0 = warm(seed, X, Y)
    o = OracleIMC(rank=RANK, reg=REG, n_sweeps=SWEEPS, cg_iters=CG)
    o.fit(users[train], items[train], ratings[train], X, Y, W0=W0, H0=H0)
    return {"W": o.W_, "H": o.H_, "history": np.asarray(o.history_)}


def estimator_seed(seed: int, data, platform=None) -> dict:
    """``IMC.fit`` of one seed on ``platform`` (None: the card)."""
    from recommendation_models_tpu_torch import IMC
    X, Y, users, items, ratings, train, _, _ = data
    W0, H0 = warm(seed, X, Y)
    m = IMC(rank=RANK, reg=REG, n_sweeps=SWEEPS, cg_iters=CG,
            platform=platform).fit((users[train], items[train],
                                    ratings[train]), X, Y, W0=W0, H0=H0)
    return {"model": m, "history": np.asarray(m.history_, np.float64)}


def _oracle_predict(o, X, Y, users, items):
    X64, Y64 = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    return np.einsum("ok,ok->o", X64[users] @ o["W"], Y64[items] @ o["H"])


def run(seeds=SEEDS, platform=None, oracles=None, shape=ML1M,
        data=None) -> dict:
    """Both sides at each seed (``oracles``: ``oracle_seed``'s results by
    seed, already computed): {metric: {"oracle": [...], "tpu": [...]}},
    unrounded, with per seed: the estimator's ``history``,
    ``history_rel_diff`` (the largest relative difference of the two
    histories), ``later_rel_diff`` (the same from the second sweep on) and
    ``pred_rel_excess`` (the largest test prediction difference over its
    tolerance, atol + rtol |oracle|: at most 1 within it)."""
    data = data or problem(shape)
    X, Y, users, items, ratings, _, test, cold = data
    out = {m: {"oracle": [], "tpu": []} for m in METRICS}
    out["seeds"] = list(seeds)
    for key in ("history", "history_rel_diff", "later_rel_diff",
                "pred_rel_excess", "pred_max_abs_diff"):
        out[key] = []
    for seed in seeds:
        o = (oracles or {}).get(seed) or oracle_seed(seed, data)
        e = estimator_seed(seed, data, platform)
        m = e["model"]
        for mask, key in ((test, "test_rmse"), (cold, "cold_rmse")):
            po = _oracle_predict(o, X, Y, users[mask], items[mask])
            pm = m.predict(users[mask], items[mask])
            out[key]["oracle"].append(
                float(np.sqrt(np.mean((ratings[mask] - po) ** 2))))
            out[key]["tpu"].append(
                float(np.sqrt(np.mean((ratings[mask] - pm) ** 2))))
            if key == "test_rmse":
                diff = np.abs(pm - po)
                out["pred_max_abs_diff"].append(float(diff.max()))
                out["pred_rel_excess"].append(
                    float((diff / (ATOL + RTOL * np.abs(po))).max()))
        out["objective"]["oracle"].append(float(o["history"][-1]))
        out["objective"]["tpu"].append(float(e["history"][-1]))
        rel = np.abs(e["history"] - o["history"]) / np.abs(o["history"])
        out["history"].append([float(h) for h in e["history"]])
        out["history_rel_diff"].append(float(rel.max()))
        out["later_rel_diff"].append(float(rel[1:].max()))
    return out


def check(out, first_sweep=None) -> list:
    """tests/test_imc.py's gate on ``run``'s output: what fails (empty:
    parity). ``first_sweep``: {seed: an f32 history} to hold the first
    sweep to instead of the oracle's (``JAX_HISTORY`` at ML-1M shape)."""
    bad = []
    for i, seed in enumerate(out["seeds"]):
        h = out["history_rel_diff"][i]
        if first_sweep is not None:
            ref = first_sweep[seed][0]
            first = abs(out["history"][i][0] - ref) / abs(ref)
            h = max(out["later_rel_diff"][i], first)
        if not h <= RTOL:
            bad.append(f"seed {seed}: history rel diff {h} > {RTOL}")
        p = out["pred_rel_excess"][i]
        if not p <= 1.0:
            bad.append(f"seed {seed}: test predictions off by {p} x "
                       f"(atol {ATOL} + rtol {RTOL} |oracle|)")
    return bad


def rounded(out) -> dict:
    line = {m: {side: [round(float(v), DIGITS[m]) for v in vals]
                for side, vals in out[m].items()} for m in METRICS}
    for key in ("history_rel_diff", "later_rel_diff", "pred_max_abs_diff"):
        line[key] = out[key]
    return line


def save_oracles(path, oracles: dict) -> None:
    np.savez(path, **{f"{key}_{seed}": v for seed, o in oracles.items()
                      for key, v in o.items()})


def load_oracles(path) -> dict:
    """``save_oracles``'s file: {seed: oracle_seed's result}."""
    f = np.load(path)
    seeds = sorted({int(n.rsplit("_", 1)[1]) for n in f.files})
    return {s: {key: f[f"{key}_{s}"] for key in ("W", "H", "history")}
            for s in seeds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the estimator on the host")
    ap.add_argument("--oracle-only", action="store_true",
                    help="fit only the oracle and save it to --out")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.oracle_only:
        if not args.out:
            ap.error("--oracle-only needs --out")
        data = problem()
        save_oracles(args.out, {s: oracle_seed(s, data) for s in seeds})
        return 0
    import torch
    if args.platform != "cpu" and not torch.cuda.is_available():
        print("quality_parity_imc: needs a CUDA card (or --platform cpu)",
              file=sys.stderr)
        return 2
    out = run(seeds, args.platform)
    bad = check(out, JAX_HISTORY)
    line = rounded(out)
    line["device"] = (torch.cuda.get_device_name(0)
                      if args.platform != "cpu" else "cpu")
    line["platform"] = "cpu" if args.platform == "cpu" else "cuda"
    line["ok"] = not bad
    for b in bad:
        print(f"# {b}", file=sys.stderr)
    print(json.dumps(line))
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
