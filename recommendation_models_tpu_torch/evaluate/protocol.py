"""Train/eval split protocols (SURVEY.md N10: leave-n-out).

All host prep here is vectorized NumPy (group-by via sort) — no per-
observation Python. The reference evaluates at ML-100K scale where loops
are fine; the config-5 quality gate (BASELINE.json: recall@10/NDCG@10 at
ML-25M/100M) needs these to run over 10^7-10^8 observations in seconds.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def leave_n_out(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    n: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Hold out up to ``n`` random interactions per user.

    Returns (train_mask, test_mask) boolean arrays over the observation
    list. Users with fewer than ``n + 1`` interactions keep everything in
    train (never strand a user with zero training data).

    Vectorized: assign each observation a random priority, sort by
    (user, priority), and hold out the first min(n, count_u - 1) of each
    user's run — O(n_obs log n_obs), no Python loop (25M obs: ~3 s).
    """
    users = np.asarray(users)
    n_obs = users.shape[0]
    rng = np.random.default_rng(seed)
    prio = rng.permutation(n_obs)
    order = np.lexsort((prio, users))          # by user, then random
    su = users[order]
    # start offset of each user's contiguous run in the sorted view
    new_run = np.empty(n_obs, dtype=bool)
    if n_obs:
        new_run[0] = True
        np.not_equal(su[1:], su[:-1], out=new_run[1:])
    starts = np.flatnonzero(new_run)
    counts = np.diff(np.append(starts, n_obs))
    run_id = np.cumsum(new_run) - 1
    rank_in_user = np.arange(n_obs) - starts[run_id]
    take = np.minimum(n, counts - 1)[run_id]   # keep >= 1 in train
    test_sorted = rank_in_user < take
    test_mask = np.zeros(n_obs, dtype=bool)
    test_mask[order] = test_sorted
    return ~test_mask, test_mask


def grouped_by_user(users: np.ndarray, items: np.ndarray,
                    n_users: int) -> Tuple[np.ndarray, np.ndarray]:
    """Group item ids by user id: returns CSR-style (indptr, sorted_items).

    ``sorted_items[indptr[u]:indptr[u+1]]`` are user u's items. One sort;
    this is the scale-safe core behind ``relevant_by_user``.
    """
    users = np.asarray(users)
    items = np.asarray(items)
    order = np.argsort(users, kind="stable")
    su, si = users[order], items[order]
    indptr = np.searchsorted(su, np.arange(n_users + 1))
    return indptr, si


def relevant_by_user(users: np.ndarray, items: np.ndarray,
                     n_users: int) -> List[np.ndarray]:
    """Group held-out item ids per user (for recall/NDCG).

    Returns a list of per-user arrays (views into one sorted buffer).
    For the fully-vectorized metric path at scale, prefer passing
    ``grouped_by_user``'s (indptr, items) straight to the metrics — they
    accept both forms.
    """
    indptr, si = grouped_by_user(users, items, n_users)
    return [si[indptr[u]:indptr[u + 1]] for u in range(n_users)]


__all__ = ["leave_n_out", "relevant_by_user", "grouped_by_user"]
