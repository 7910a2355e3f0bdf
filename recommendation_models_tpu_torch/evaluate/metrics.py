"""Eval metrics (SURVEY.md N10): RMSE, recall@k, NDCG@k.

These back the quality-parity gates (BASELINE.json: "RMSE and recall@k on
MovieLens within run-to-run variance"; recall@10 / NDCG@10 for the retrieval
serving config).

``recall_at_k`` / ``ndcg_at_k`` accept the relevant sets either as a
sequence of per-user arrays (row-aligned with ``topk_items``) or as a
CSR-style ``(indptr, items)`` pair (from ``protocol.grouped_by_user`` /
``take_groups``). Both paths are fully vectorized: membership tests run as
one searchsorted over sorted (row, item) keys, never a per-user Python loop
— required at the config-5 eval scale (10^5 users x 10 candidates).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Relevant = Union[Sequence[np.ndarray], Tuple[np.ndarray, np.ndarray]]


def rmse(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    return float(np.sqrt(np.mean((pred - target) ** 2)))


def take_groups(indptr: np.ndarray, items: np.ndarray,
                rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a CSR-style grouping down to ``rows`` (vectorized fancy-gather).

    Returns (indptr_sub, items_sub) aligned with ``rows``' order, suitable
    as the ``relevant`` argument when topk rows are a user subset.
    """
    rows = np.asarray(rows)
    lo = indptr[rows]
    ln = indptr[rows + 1] - lo
    out_ptr = np.concatenate(([0], np.cumsum(ln)))
    row_of = np.repeat(np.arange(rows.shape[0]), ln)
    offs = np.arange(out_ptr[-1]) - out_ptr[row_of]
    return out_ptr, items[lo[row_of] + offs]


def _flatten_relevant(relevant: Relevant, n_rows: int):
    """-> (sizes (B,), rel_rows, rel_items), all int64 NumPy."""
    if (isinstance(relevant, tuple) and len(relevant) == 2
            and isinstance(relevant[0], np.ndarray)
            and relevant[0].ndim == 1
            and relevant[0].shape[0] == n_rows + 1):
        indptr, items = relevant
        sizes = np.diff(indptr).astype(np.int64)
        rel_rows = np.repeat(np.arange(n_rows, dtype=np.int64), sizes)
        return sizes, rel_rows, np.asarray(items, np.int64)
    sizes = np.fromiter((np.size(r) for r in relevant), np.int64,
                        count=len(relevant))
    rel_rows = np.repeat(np.arange(n_rows, dtype=np.int64), sizes)
    if sizes.sum() == 0:
        return sizes, rel_rows, np.empty(0, np.int64)
    rel_items = np.concatenate(
        [np.asarray(r, np.int64).ravel() for r in relevant if np.size(r)])
    return sizes, rel_rows, rel_items


def _hits(topk: np.ndarray, sizes, rel_rows, rel_items) -> np.ndarray:
    """(B, k) bool: is topk[b, j] in row b's relevant set. One searchsorted
    over sorted (row * M + item) keys — no per-row loop."""
    B, k = topk.shape
    if rel_items.size == 0:
        return np.zeros((B, k), bool)
    M = int(max(int(topk.max(initial=0)), int(rel_items.max()))) + 2
    keys = np.sort(rel_rows * M + rel_items)
    q = (np.arange(B, dtype=np.int64)[:, None] * M
         + np.asarray(topk, np.int64)).ravel()
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    return (keys[pos] == q).reshape(B, k)


def recall_at_k(topk_items: np.ndarray, relevant: Relevant) -> float:
    """Mean over users of |topk ∩ relevant| / min(k, |relevant|).

    topk_items: (n_users, k) ranked item ids. relevant: per-user held-out
    item ids (sequence of arrays, or a CSR (indptr, items) pair). Users
    with no held-out items are skipped.
    """
    topk_items = np.asarray(topk_items)
    k = topk_items.shape[1]
    sizes, rel_rows, rel_items = _flatten_relevant(relevant,
                                                   topk_items.shape[0])
    active = sizes > 0
    if not active.any():
        return 0.0
    hits = _hits(topk_items, sizes, rel_rows, rel_items).sum(1)
    denom = np.minimum(k, np.maximum(sizes, 1))
    return float(np.mean((hits / denom)[active]))


def ndcg_at_k(topk_items: np.ndarray, relevant: Relevant) -> float:
    """Binary-relevance NDCG@k averaged over users with held-out items."""
    topk_items = np.asarray(topk_items)
    k = topk_items.shape[1]
    sizes, rel_rows, rel_items = _flatten_relevant(relevant,
                                                   topk_items.shape[0])
    active = sizes > 0
    if not active.any():
        return 0.0
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    cum = np.concatenate(([0.0], np.cumsum(discounts)))
    gains = _hits(topk_items, sizes, rel_rows, rel_items).astype(np.float64)
    dcg = gains @ discounts
    ideal = cum[np.minimum(k, sizes)]
    return float(np.mean((dcg / np.maximum(ideal, 1e-12))[active]))


__all__ = ["rmse", "recall_at_k", "ndcg_at_k", "take_groups"]
