"""Synthetic ratings and side features (host-side numpy).

The same generators as the JAX package's ``data/synthetic.py``: for a given
seed both produce byte-identical arrays, so the two packages train on the
same data. ``synthetic_ratings``: degrees power-law over items (like
MovieLens), ratings from a noisy low-rank ground truth.
``synthetic_side_features`` and ``synthetic_imc_ratings``: dense feature
matrices and observations of a bilinear ground truth, for IMC.
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


def synthetic_side_features(
    n_users: int,
    n_items: int,
    d_user: int,
    d_item: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense side-feature matrices X (n_users, d_user) and Y (n_items,
    d_item), f32, unit-variance rows over the feature width."""
    rng = np.random.default_rng(seed + 17)
    X = rng.standard_normal((n_users, d_user)).astype(np.float32) / np.sqrt(d_user)
    Y = rng.standard_normal((n_items, d_item)).astype(np.float32) / np.sqrt(d_item)
    return X, Y


def synthetic_imc_ratings(
    X: np.ndarray,
    Y: np.ndarray,
    n_obs: int,
    rank: int = 8,
    noise: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Observations of a ground-truth bilinear model r = x' W* H*' y + eps,
    deduplicated by (user, item).

    Returns (users, items, ratings, W_true, H_true); a model that learns W
    and H predicts for rows it never saw, through their features."""
    rng = np.random.default_rng(seed + 29)
    n_users, d_user = X.shape
    n_items, d_item = Y.shape
    W = rng.standard_normal((d_user, rank)).astype(np.float32)
    H = rng.standard_normal((d_item, rank)).astype(np.float32)
    users = rng.integers(0, n_users, size=n_obs).astype(np.int32)
    items = rng.integers(0, n_items, size=n_obs).astype(np.int32)
    key = users.astype(np.int64) * n_items + items
    _, first = np.unique(key, return_index=True)
    users, items = users[first], items[first]
    r = np.einsum("ok,ok->o", X[users] @ W, Y[items] @ H)
    r += noise * rng.standard_normal(r.shape[0]).astype(np.float32)
    return users, items, r.astype(np.float32), W, H


__all__ = ["synthetic_ratings", "synthetic_side_features",
           "synthetic_imc_ratings"]
