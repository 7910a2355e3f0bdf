"""Top-k serving on the PyTorch port with measured quality: exclusion,
recall@k, and the method dial.

The port's counterpart of ``examples/serving_quality.py``. The serving
path is ``recommend()``: a scoring product against the catalog on the card
and ``torch.topk`` over a fixed random permutation of it (the reference's
``serving_permutation``), the training items of each user dropped by
overfetch-and-filter. Where the JAX package selects with TPU-native
``approx_max_k``, the port selects exactly for every ``method``: 'auto',
'exact' and 'approx' return the same items, and ``recall_target`` is
accepted for the reference's signature only. The contract to hold a
deployment to stays the same: the served recall@k must match an exact
selector's on the same factors.

It runs on the CUDA card unless given ``--platform cpu``.

    python examples/torch_port/serving_quality.py [--platform cpu]
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
    grouped_by_user, leave_n_out, ndcg_at_k, recall_at_k, take_groups)

ap = argparse.ArgumentParser(description="serving quality on the port")
ap.add_argument("--platform", default=None,
                help="'cpu' for the host; default: the CUDA card")
platform = ap.parse_args().platform

# ML-100K-shaped synthetic interactions; leave-2-out split per user
n_users, n_items = 943, 1_682
users, items, ratings = synthetic_ratings(n_users, n_items, 100_000,
                                          rank=16, seed=0)
tr, te = leave_n_out(users, items, ratings, n=2, seed=0)
R_train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                        shape=(n_users, n_items))

model = ALS(rank=32, alpha=1.0, reg=0.1, n_sweeps=6, seed=0,
            platform=platform).fit(R_train)

k = 10
rel_indptr, rel_items = grouped_by_user(users[te], items[te], n_users)
eval_users = np.flatnonzero(np.diff(rel_indptr) > 0)
relevant = take_groups(rel_indptr, rel_items, eval_users)

# served top-k (exclude_seen drops each user's training items by
# overfetch-and-filter - never a scatter into materialized scores)
_, topk_served = model.recommend(eval_users, n=k, exclude_seen=True)
# the exact-selection reference on the SAME factors: served quality must
# match this
_, topk_exact = model.recommend(eval_users, n=k, exclude_seen=True,
                                method="exact")

r_served = recall_at_k(topk_served, relevant)
r_exact = recall_at_k(topk_exact, relevant)
print(f"recall@{k}: served={r_served:.4f} exact={r_exact:.4f} "
      f"(delta {abs(r_served - r_exact):.4f})")
print(f"ndcg@{k}:   served={ndcg_at_k(topk_served, relevant):.4f}")
if abs(r_served - r_exact) > 5e-3:
    raise SystemExit("served quality must track exact")

# the method dial: the port selects exactly at every recall_target, so
# 'approx' serves the same items as 'exact'
_, topk_fast = model.recommend(eval_users, n=k, exclude_seen=True,
                               method="approx", recall_target=0.95)
print(f"recall@{k} at recall_target=0.95: "
      f"{recall_at_k(topk_fast, relevant):.4f}")

# single-user convenience mirrors the reference's top_n
print("top-5 for user 0:", model.top_n(0, n=5))
