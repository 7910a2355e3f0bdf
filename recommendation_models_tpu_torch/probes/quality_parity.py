"""ALS quality parity against the full NumPy oracle at ML-100K shape.

    python -m recommendation_models_tpu_torch.probes.quality_parity \
        [--seeds 0,1,2] [--platform cpu]

The port's counterpart of ``scripts/quality_parity.py`` (BASELINE.json:5's
gate). The same data and split: ``synthetic_ratings(943, 1682, 100_000,
rank=8, noise=0.3, seed=11)`` and ``leave_n_out(n=3, seed=1)``. For each
seed the port's copy of the oracle (``oracle.OracleALS``) is fit in full
from its own ``init_factors``, and ``ALS`` from the same warm start:

- explicit: ``rank=10, reg=0.5, n_sweeps=6`` on the mean-centred training
  ratings, test RMSE of both;
- implicit: ``rank=16, reg=0.05, alpha=2.0, n_sweeps=6`` on the training
  ratings, recall@10 and NDCG@10 of both on the held-out items (training
  items excluded), for every user with a held-out item.

The gate (``check``) is the JAX package's test of the same protocol
(tests/test_integration.py): per seed, the estimator's RMSE within
max(1e-3, 0.1 x the oracle's seed band) of the oracle's, and recall@10 and
NDCG@10 within 0.01; the means within the oracle's band widened by a
quarter (RMSE) or by max(half the band, 5e-3) (recall).

Prints one JSON line in the script's schema (``"oracle"`` and ``"tpu"``
lists per metric, ``"tpu"`` naming the estimator's side, rounded as the
script rounds them), ``device`` the card's name, ``platform`` "cuda" or
"cpu", and ``ok``, the gate. The estimator runs on the CUDA card (its
solve kernels), or on the host with ``--platform cpu``; the oracle on the
host. ``chip_smoke.py`` phase 13 runs it with these functions.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import scipy.sparse as sp

N_USERS, N_ITEMS, N_OBS = 943, 1_682, 100_000
SEEDS = (0, 1, 2)
EXPLICIT = dict(rank=10, reg=0.5, n_sweeps=6)
IMPLICIT = dict(rank=16, reg=0.05, alpha=2.0, n_sweeps=6)
K = 10
METRICS = ("explicit_rmse", "recall_at_10", "ndcg_at_10")
DIGITS = {"explicit_rmse": 5, "recall_at_10": 4, "ndcg_at_10": 4}


def split():
    """(train, centred train, (test users, items, ratings), mean, eval
    users, their held-out items): the script's data, split and eval set."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.evaluate import (leave_n_out,
                                                          relevant_by_user)
    users, items, ratings = synthetic_ratings(
        N_USERS, N_ITEMS, N_OBS, rank=8, noise=0.3, seed=11)
    tr, te = leave_n_out(users, items, ratings, n=3, seed=1)
    train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                          shape=(N_USERS, N_ITEMS))
    test = users[te], items[te], ratings[te]
    mu = train.data.mean()
    cen = train.copy()
    cen.data = cen.data - mu
    rel = relevant_by_user(test[0], test[1], N_USERS)
    eval_users = np.flatnonzero([len(r) > 0 for r in rel])
    return train, cen, test, mu, eval_users, [rel[u] for u in eval_users]


def test_rmse(U, V, test, mu) -> float:
    tu, ti, tr = test
    pred = np.einsum("ok,ok->o", np.asarray(U)[tu], np.asarray(V)[ti]) + mu
    return float(np.sqrt(np.mean((tr - pred) ** 2)))


def _ranking(topk, rel_eval):
    from recommendation_models_tpu_torch.evaluate import (ndcg_at_k,
                                                          recall_at_k)
    return (float(recall_at_k(topk, rel_eval)),
            float(ndcg_at_k(topk, rel_eval)))


def oracle_seed(seed: int, data=None) -> dict:
    """The oracle's side of one seed (host only): its test RMSE, recall@10
    and NDCG@10, and the warm starts it drew (for the estimator)."""
    from recommendation_models_tpu_torch.oracle import OracleALS
    train, cen, test, mu, eval_users, rel_eval = data or split()
    o = OracleALS(seed=seed, **EXPLICIT)
    U0, V0 = o.init_factors(N_USERS, N_ITEMS)
    o.fit(cen, U0=U0, V0=V0)
    rmse = test_rmse(o.U_, o.V_, test, mu)
    oi = OracleALS(seed=seed, **IMPLICIT)
    U0i, V0i = oi.init_factors(N_USERS, N_ITEMS)
    oi.fit(train, U0=U0i, V0=V0i)
    topk = np.stack([oi.top_n(u, K, exclude=train[u].indices)
                     for u in eval_users])
    recall, ndcg = _ranking(topk, rel_eval)
    return {"explicit_rmse": rmse, "recall_at_10": recall,
            "ndcg_at_10": ndcg, "warm": [U0, V0], "warm_implicit": [U0i, V0i]}


def estimator_seed(oracle: dict, platform=None, data=None) -> dict:
    """The estimator's side of one seed, from the oracle's warm starts:
    ``ALS.fit`` on ``platform`` (None: the card), ``recommend`` for the
    implicit fit."""
    from recommendation_models_tpu_torch import ALS
    train, cen, test, mu, eval_users, rel_eval = data or split()
    U0, V0 = oracle["warm"]
    m = ALS(platform=platform, **EXPLICIT).fit(cen, U0=U0, V0=V0)
    rmse = test_rmse(m.U_, m.V_, test, mu)
    U0, V0 = oracle["warm_implicit"]
    m = ALS(platform=platform, **IMPLICIT).fit(train, U0=U0, V0=V0)
    _, topk = m.recommend(eval_users, n=K, exclude_seen=True)
    recall, ndcg = _ranking(topk, rel_eval)
    return {"explicit_rmse": rmse, "recall_at_10": recall,
            "ndcg_at_10": ndcg}


def run(seeds=SEEDS, platform=None) -> dict:
    """Both sides at each seed: {metric: {"oracle": [...], "tpu": [...]}},
    unrounded."""
    data = split()
    out = {m: {"oracle": [], "tpu": []} for m in METRICS}
    for seed in seeds:
        o = oracle_seed(seed, data)
        e = estimator_seed(o, platform, data)
        for m in METRICS:
            out[m]["oracle"].append(o[m])
            out[m]["tpu"].append(e[m])
    return out


def check(out) -> list:
    """The JAX package's gate of this protocol (tests/test_integration.py)
    on ``run``'s output: the list of what fails (empty: parity)."""
    bad = []
    o, t = out["explicit_rmse"]["oracle"], out["explicit_rmse"]["tpu"]
    band = max(o) - min(o)
    for ov, tv in zip(o, t):
        if abs(tv - ov) > max(1e-3, 0.1 * band):
            bad.append(f"explicit RMSE {tv} vs oracle {ov} (band {band})")
    if len(o) > 1 and not (min(o) - 0.25 * band <= float(np.mean(t))
                           <= max(o) + 0.25 * band):
        bad.append(f"mean explicit RMSE {np.mean(t)} outside the oracle's "
                   f"band {o}")
    for m in ("recall_at_10", "ndcg_at_10"):
        for ov, tv in zip(out[m]["oracle"], out[m]["tpu"]):
            if abs(tv - ov) > 0.01:
                bad.append(f"{m} {tv} vs oracle {ov}")
    o, t = out["recall_at_10"]["oracle"], out["recall_at_10"]["tpu"]
    rb = max(max(o) - min(o), 0.0)
    slack = max(0.5 * rb, 5e-3)
    if not min(o) - slack <= float(np.mean(t)) <= max(o) + slack:
        bad.append(f"mean recall@10 {np.mean(t)} outside the oracle's band "
                   f"{o}")
    return bad


def rounded(out) -> dict:
    """``run``'s output rounded as the script prints it."""
    return {m: {side: [round(float(v), DIGITS[m]) for v in vals]
                for side, vals in out[m].items()} for m in METRICS}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the estimator on the host")
    args = ap.parse_args(argv)
    if args.platform != "cpu" and not torch.cuda.is_available():
        print("quality_parity: needs a CUDA card (or --platform cpu)",
              file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    out = run(seeds, args.platform)
    bad = check(out)
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
