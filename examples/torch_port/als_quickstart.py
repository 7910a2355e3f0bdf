"""Explicit-feedback ALS end to end on the PyTorch port: fit, predict,
score, recommend.

The port's counterpart of ``examples/als_quickstart.py``. It runs on the
CUDA card (the solve kernels) unless given ``--platform cpu``; the port
never falls back to the host on its own. With a real MovieLens download,
replace the synthetic block with:

    from recommendation_models_tpu_torch.data.movielens import load_ratings_file
    d = load_ratings_file("ml-1m/ratings.dat")   # returns a dict
    users, items, ratings = d["users"], d["items"], d["ratings"]
    n_users, n_items = d["n_users"], d["n_items"]

    python examples/torch_port/als_quickstart.py [--platform cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import scipy.sparse as sp

from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.evaluate import (
    leave_n_out, ndcg_at_k, recall_at_k)
from recommendation_models_tpu_torch.evaluate.protocol import relevant_by_user

ap = argparse.ArgumentParser(description="ALS quickstart on the port")
ap.add_argument("--platform", default=None,
                help="'cpu' for the host; default: the CUDA card")
platform = ap.parse_args().platform

n_users, n_items = 943, 1682  # ML-100K shape
users, items, ratings = synthetic_ratings(n_users, n_items, 100_000, rank=16, seed=0)

# per-user leave-2-out split for ranking metrics
train_idx, test_idx = leave_n_out(users, items, ratings, n=2, seed=0)
R_train = sp.csr_matrix(
    (ratings[train_idx], (users[train_idx], items[train_idx])),
    shape=(n_users, n_items))
R_test = sp.csr_matrix(
    (ratings[test_idx], (users[test_idx], items[test_idx])),
    shape=(n_users, n_items))

# reg tuned for this synthetic set (heavier than typical MovieLens values)
model = ALS(rank=32, reg=5.0, n_sweeps=10, tol=1e-4, seed=0,
            platform=platform).fit(R_train)

print(f"train RMSE {model.rmse(R_train):.4f}  test RMSE {model.rmse(R_test):.4f}")
print("score (neg RMSE):", model.score(R_test))
print("predict pairs:", model.predict([(0, 42), (7, 9)]))

# top-10 recommendations, excluding already-rated items
scores, rec_items = model.recommend([0, 1, 2], n=10)
print("user 0 top-10 items:", rec_items[0])

# ranking quality on the holdout
all_scores, all_items = model.recommend(np.arange(n_users), n=10)
relevant = relevant_by_user(users[test_idx], items[test_idx], n_users)
print(f"recall@10 {recall_at_k(all_items, relevant):.3f}  "
      f"NDCG@10 {ndcg_at_k(all_items, relevant):.3f}")
