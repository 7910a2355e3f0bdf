"""Serving quality at one fit seed: recall@10 and NDCG@10 through the
estimator's ``recommend`` and through a frozen exact NumPy path.

    python -m recommendation_models_tpu_torch.probes.serving_quality \
        [--platform cpu]
    SEED=1 NPZ_OUT=f.npz python -m \
        recommendation_models_tpu_torch.probes.serving_quality
    NPZ_IN=f.npz python -m \
        recommendation_models_tpu_torch.probes.serving_quality

The port's counterpart of the JAX package's
``scripts/serving_quality_probe.py``, the tool for seed bands. It runs
``bench.py::serving_bench``'s pipeline: the synthetic ratings of ``SCALE``
(``synthetic_ratings(..., rank=16, seed=0)``), a leave-2-out split (seed
0), ``ALS(rank=RANK, alpha=1.0, reg=0.1, n_sweeps=SWEEPS, seed=SEED)``,
and the first 20,000 users with a held-out item. The data and the split
are fixed; ``SEED`` moves only the fit's init. Then recall@10 and NDCG@10
of

(a) ``model.recommend(eval_users, n=10, exclude_seen=True)``, and
(b) ``frozen_numpy_recommend``: full f64 scores, the training items
    excluded, exact top-k; it uses none of the port's serving code.

The two must agree. ``SCALES`` are the script's: its ML-1M shape draws
1,000,000 ratings, not the 1,000,209 of ``probes.SCALES``; the JAX
package's records were taken at them.

``NPZ_OUT`` saves the factors (``U``, ``V``); ``NPZ_IN`` skips the fit and
serves saved factors through a fitted estimator built from them
(``ALS.from_reference_state`` with the training CSR rows, so ``recommend``
excludes the seen items as after a fit). The JSON line has the script's
keys, the factor hashes (first 16 hex digits of the SHA-256 of the f32
bytes) and the metrics rounded to 5 places; ``platform`` is "cuda" or
"cpu". Runs on the CUDA card unless ``--platform cpu`` is given, where
``SCALE`` defaults to ``ml100k``.

Env (the script's): SCALE (ml1m), RANK (64), SWEEPS (8), SEED (0),
NPZ_OUT, NPZ_IN.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import scipy.sparse as sp

from recommendation_models_tpu_torch.probes import SCALES as _SHAPES

# the script's sizes: the probes' shapes, but ML-1M draws the script's
# 1,000,000 ratings
SCALES = {"ml25m": _SHAPES["ml25m"],
          "ml1m": (*_SHAPES["ml1m"][:2], 1_000_000),
          "ml100k": _SHAPES["ml100k"]}
K = 10
EVAL_USERS = 20_000


def frozen_numpy_recommend(U, V, eval_users, train_csr, k):
    """Exact reference serving: full f64 scores, exclude seen, top-k."""
    out = np.empty((eval_users.shape[0], k), np.int64)
    indptr, indices = train_csr.indptr, train_csr.indices
    B = 2048
    for s in range(0, eval_users.shape[0], B):
        us = eval_users[s:s + B]
        sc = U[us].astype(np.float64) @ V.astype(np.float64).T
        for j, u in enumerate(us):
            seen = indices[indptr[u]:indptr[u + 1]]
            sc[j, seen] = -np.inf
        part = np.argpartition(-sc, k, axis=1)[:, :k]
        rows = np.arange(us.shape[0])[:, None]
        order = np.argsort(-sc[rows, part], axis=1)
        out[s:s + B] = part[rows, order]
    return out


def serving_data(scale: str):
    """The fixed data and split of ``scale``: (n_users, n_items, train CSR,
    eval users, their held-out items as a CSR pair)."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.evaluate import (
        grouped_by_user, leave_n_out, take_groups)
    n_users, n_items, n_obs = SCALES[scale]
    users, items, ratings = synthetic_ratings(n_users, n_items, n_obs,
                                              rank=16, seed=0)
    tr, te = leave_n_out(users, items, ratings, n=2, seed=0)
    train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                          shape=(n_users, n_items))
    rel_indptr, rel_items = grouped_by_user(users[te], items[te], n_users)
    eval_users = np.flatnonzero(np.diff(rel_indptr) > 0)[:EVAL_USERS]
    return (n_users, n_items, train, eval_users,
            take_groups(rel_indptr, rel_items, eval_users))


def factor_hash(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()[:16]


def run(scale: str = "ml1m", rank: int = 64, sweeps: int = 8, seed: int = 0,
        npz_in=None, npz_out=None, platform=None, data=None) -> dict:
    """The script's record on the port (``data`` = ``serving_data(scale)``
    reuses a built split)."""
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.evaluate import (
        ndcg_at_k, recall_at_k)
    device = resolve_device(platform)
    n_users, n_items, train, eval_users, rel_eval = (
        serving_data(scale) if data is None else data)
    params = dict(rank=rank, alpha=1.0, reg=0.1, n_sweeps=sweeps, seed=seed,
                  platform=device.type)
    if npz_in:
        with np.load(npz_in) as d:
            U, V = d["U"], d["V"]
        model = ALS.from_reference_state(
            dict(U_=U, V_=V, n_users_=n_users, n_items_=n_items,
                 history_=[], params=params),
            train_indptr=train.indptr, train_indices=train.indices)
        fit_note = "loaded"
    else:
        model = ALS(**params).fit(train)
        U, V = np.asarray(model.U_), np.asarray(model.V_)
        fit_note = "fit"
    if npz_out:
        np.savez(npz_out, U=U, V=V)

    _, topk = model.recommend(eval_users, n=K, exclude_seen=True)
    topk_frozen = frozen_numpy_recommend(U, V, eval_users, train, K)
    return {
        "scale": scale, "rank": rank, "sweeps": sweeps, "seed": seed,
        "fit": fit_note, "U_hash": factor_hash(U), "V_hash": factor_hash(V),
        "recall_model_path": round(float(recall_at_k(topk, rel_eval)), 5),
        "ndcg_model_path": round(float(ndcg_at_k(topk, rel_eval)), 5),
        "recall_frozen_path": round(float(recall_at_k(topk_frozen,
                                                      rel_eval)), 5),
        "ndcg_frozen_path": round(float(ndcg_at_k(topk_frozen, rel_eval)),
                                  5),
        "platform": device.type,
    }


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    on_cpu = args.platform == "cpu"
    rec = run(scale=env.get("SCALE", "ml100k" if on_cpu else "ml1m"),
              rank=int(env.get("RANK", "64")),
              sweeps=int(env.get("SWEEPS", "8")),
              seed=int(env.get("SEED", "0")),
              npz_in=env.get("NPZ_IN"), npz_out=env.get("NPZ_OUT"),
              platform=args.platform)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
