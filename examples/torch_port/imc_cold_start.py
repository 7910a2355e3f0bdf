"""Inductive matrix completion on the PyTorch port: learn a bilinear model
over side features and predict for users NEVER seen in training (cold
start).

r_hat(u, i) = x_u' W H' y_i  - W, H are learned; x_u, y_i are feature rows.

The port's counterpart of ``examples/imc_cold_start.py``. It runs on the
CUDA card unless given ``--platform cpu``.

    python examples/torch_port/imc_cold_start.py [--platform cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import scipy.sparse as sp

from recommendation_models_tpu_torch import IMC
from recommendation_models_tpu_torch.data.synthetic import (
    synthetic_imc_ratings, synthetic_side_features)

ap = argparse.ArgumentParser(description="IMC cold start on the port")
ap.add_argument("--platform", default=None,
                help="'cpu' for the host; default: the CUDA card")
platform = ap.parse_args().platform

n_users, n_items, d_user, d_item = 2_000, 1_500, 40, 30
X, Y = synthetic_side_features(n_users, n_items, d_user, d_item, seed=0)
users, items, r, W_true, H_true = synthetic_imc_ratings(X, Y, 120_000, rank=8, seed=0)

# hold out the LAST 200 users entirely: cold-start set
warm = users < n_users - 200
R_train = sp.csr_matrix((r[warm], (users[warm], items[warm])),
                        shape=(n_users, n_items))

model = IMC(rank=8, reg=0.05, n_sweeps=10, cg_iters=50,
            platform=platform).fit(R_train, X, Y)

cold = ~warm
pred = model.predict(users[cold], items[cold])  # uses stored X, Y rows
rmse = float(np.sqrt(np.mean((pred - r[cold]) ** 2)))
print(f"cold-start RMSE {rmse:.4f}  (signal sigma {r.std():.2f})")

# brand-new user, known only by features:
x_new = np.random.default_rng(1).standard_normal((1, d_user)).astype(np.float32)
scores, items_top = model.recommend([0], n=5, X=x_new)
print("top-5 for an unseen user:", items_top[0])
