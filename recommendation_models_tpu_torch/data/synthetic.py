"""Synthetic ratings generator (host-side numpy).

The same generator as the JAX package's ``data/synthetic.py``: for a given
seed both produce byte-identical triplets, so the two packages train on
the same data. Degrees are power-law over items (like MovieLens) and
ratings come from a noisy low-rank ground truth.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_ratings(
    n_users: int,
    n_items: int,
    n_obs: int,
    rank: int = 16,
    noise: float = 0.3,
    popularity_exponent: float = 1.0,
    seed: int = 0,
    rating_scale: Optional[Tuple[float, float]] = (1.0, 5.0),
    dedupe: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample ``n_obs`` (user, item, rating) triplets.

    Users are uniform; items follow ``p(i) ∝ (i+1)^-popularity_exponent``.
    Ratings are ``<u_f, v_f> + noise`` mapped into ``rating_scale`` and
    rounded to half-stars. Returns ``(users int32, items int32, ratings
    float32)``; after dedupe the count can be slightly below ``n_obs``.
    """
    rng = np.random.default_rng(seed)

    users = rng.integers(0, n_users, size=n_obs, dtype=np.int64)
    pop = (np.arange(1, n_items + 1, dtype=np.float64)) ** (-popularity_exponent)
    pop /= pop.sum()
    # inverse-CDF sampling (rng.choice's per-draw alias setup is far slower)
    cdf = np.cumsum(pop)
    cdf[-1] = 1.0
    items = np.searchsorted(cdf, rng.random(n_obs), side="right")
    items = np.minimum(items, n_items - 1).astype(np.int64)

    if dedupe:
        key = users * n_items + items
        _, first = np.unique(key, return_index=True)
        users, items = users[first], items[first]

    uf = rng.standard_normal((n_users, rank)).astype(np.float32) / np.sqrt(rank)
    vf = rng.standard_normal((n_items, rank)).astype(np.float32) / np.sqrt(rank)
    # chunked in-place product keeps the (n_obs, rank) temporaries bounded
    scores = np.empty(users.shape[0], np.float32)
    for s0 in range(0, users.shape[0], 4_000_000):
        sl = slice(s0, min(s0 + 4_000_000, users.shape[0]))
        p = uf[users[sl]]
        p *= vf[items[sl]]
        scores[sl] = p.sum(axis=1)
    scores += noise * rng.standard_normal(scores.shape[0]).astype(np.float32)

    if rating_scale is not None:
        lo, hi = rating_scale
        s = (scores - scores.mean()) / (scores.std() + 1e-9)
        ratings = np.clip(lo + (hi - lo) * (s + 2.5) / 5.0, lo, hi)
        ratings = np.round(ratings * 2.0) / 2.0
    else:
        ratings = scores

    return users.astype(np.int32), items.astype(np.int32), ratings.astype(np.float32)


__all__ = ["synthetic_ratings"]
