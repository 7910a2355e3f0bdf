"""Implicit feedback + sharding + checkpointing on the PyTorch port.

The port's counterpart of ``examples/als_implicit_sharded.py``.

- ``alpha=40`` switches to the Hu-Koren-Volinsky confidence-weighted
  objective (ratings treated as interaction counts).
- ``n_shards`` row-shards the factor tables over a mesh of devices: every
  CUDA card of the host (a host with one card runs the single-device
  path), or with ``--platform cpu`` 8 entries of the host.
- Checkpoints are the port's own (``utils/checkpoint.py``); ``resume()``
  restores the latest. Checkpoints of the JAX package do not load here.

    python examples/torch_port/als_implicit_sharded.py [--platform cpu]
"""

import argparse
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import tempfile

import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings

ap = argparse.ArgumentParser(description="implicit sharded ALS on the port")
ap.add_argument("--platform", default=None,
                help="'cpu' for the host; default: the CUDA card")
platform = ap.parse_args().platform

n_users, n_items = 6_040, 3_706  # ML-1M shape
users, items, ratings = synthetic_ratings(n_users, n_items, 1_000_000, rank=16, seed=0)
R = sp.csr_matrix((ratings, (users, items)), shape=(n_users, n_items))

n_shards = 8 if platform == "cpu" else min(8, torch.cuda.device_count())
ckpt = tempfile.mkdtemp(prefix="als_ckpt_")

model = ALS(rank=64, reg=0.1, alpha=40.0, n_sweeps=8,
            n_shards=n_shards, exchange="allgather", platform=platform,
            checkpoint_dir=ckpt, checkpoint_every=2, verbose=1)
model.fit(R)
print(f"fitted on {n_shards} shard(s); factors U{model.U_.shape} V{model.V_.shape}")

# restart-resume: a fresh estimator picks up the latest checkpoint
restored = ALS(rank=64, alpha=40.0, checkpoint_dir=ckpt, platform=platform)
sweep = restored.resume()
print(f"resumed at sweep {sweep}; top-5 for user 0: {restored.top_n(0, 5)}")
