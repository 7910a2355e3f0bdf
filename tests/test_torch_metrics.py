"""The port's ``evaluate`` (split protocol and metrics) against the JAX
package's on the cases of tests/test_metrics.py: exact equality."""

import numpy as np
import pytest
import torch

from recommendation_models_tpu import evaluate as ref
from recommendation_models_tpu_torch import evaluate as port

torch.set_num_threads(2)


def test_exports_match_reference():
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name).__module__.startswith(
            "recommendation_models_tpu_torch.evaluate.")


@pytest.mark.parametrize("pred,target", [
    ([1.0, 2.0], [1.0, 2.0]), ([0.0, 0.0], [3.0, 4.0]),
    (np.linspace(0, 1, 17), np.linspace(1, 0, 17)),
])
def test_rmse(pred, target):
    assert port.rmse(pred, target) == ref.rmse(pred, target)
    assert abs(port.rmse([0.0, 0.0], [3.0, 4.0]) - np.sqrt(12.5)) < 1e-9


@pytest.mark.parametrize("topk,rel", [
    (np.array([[1, 2, 3], [4, 5, 6]]), [np.array([2]), np.array([7, 8])]),
    (np.array([[1, 2, 3], [4, 5, 6]]), [np.array([1]), np.array([])]),
    (np.array([[5, 6, 7]]), [np.array([5, 6, 7])]),
    (np.array([[5, 6, 7]]), [np.array([9])]),
    (np.array([[1, 5, 2]]), [np.array([5])]),
    (np.array([[1, 5, 2]]), [np.array([])]),
])
def test_recall_and_ndcg_match_reference(topk, rel):
    assert port.recall_at_k(topk, rel) == ref.recall_at_k(topk, rel)
    assert port.ndcg_at_k(topk, rel) == ref.ndcg_at_k(topk, rel)


def test_known_values():
    topk = np.array([[1, 2, 3], [4, 5, 6]])
    assert port.recall_at_k(topk, [np.array([2]), np.array([7, 8])]) == 0.5
    assert port.recall_at_k(topk, [np.array([1]), np.array([])]) == 1.0
    assert port.ndcg_at_k(np.array([[5, 6, 7]]), [np.array([5, 6, 7])]) == 1.0
    v = port.ndcg_at_k(np.array([[1, 5, 2]]), [np.array([5])])
    assert abs(v - 1.0 / np.log2(3)) < 1e-9


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 3), (5, 1)])
def test_leave_n_out_masks_bitwise(n, seed):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 40, 600)
    items = rng.integers(0, 30, 600)
    r = np.ones(600, np.float32)
    got = port.leave_n_out(users, items, r, n=n, seed=seed)
    want = ref.leave_n_out(users, items, r, n=n, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() + got[1].sum() == 600


def test_leave_n_out_small_case():
    users = np.array([0, 0, 0, 1, 1, 2])
    items = np.array([0, 1, 2, 0, 1, 0])
    r = np.ones(6, np.float32)
    train, test = port.leave_n_out(users, items, r, n=1, seed=0)
    for u in range(3):
        assert (users[train] == u).sum() >= 1
    assert not test[5]
    rel = port.relevant_by_user(users[test], items[test], 3)
    want = ref.relevant_by_user(users[test], items[test], 3)
    assert len(rel) == 3
    for a, b in zip(rel, want):
        np.testing.assert_array_equal(a, b)


def test_vectorized_metrics_match_reference_at_random():
    rng = np.random.default_rng(7)
    B, k, n_items = 200, 10, 500
    topk = np.stack([rng.choice(n_items, k, replace=False) for _ in range(B)])
    rel = [rng.choice(n_items, rng.integers(0, 6), replace=False)
           for _ in range(B)]
    assert port.recall_at_k(topk, rel) == ref.recall_at_k(topk, rel)
    assert port.ndcg_at_k(topk, rel) == ref.ndcg_at_k(topk, rel)


def test_csr_grouping_and_take_groups_match_reference():
    rng = np.random.default_rng(3)
    n_users, n_items = 50, 80
    tu = rng.integers(0, n_users, 300)
    ti = rng.integers(0, n_items, 300)
    indptr, items = port.grouped_by_user(tu, ti, n_users)
    r_indptr, r_items = ref.grouped_by_user(tu, ti, n_users)
    np.testing.assert_array_equal(indptr, r_indptr)
    np.testing.assert_array_equal(items, r_items)
    eval_users = np.flatnonzero(np.diff(indptr) > 0)
    topk = np.stack([rng.choice(n_items, 10, replace=False)
                     for _ in eval_users])
    csr_form = port.take_groups(indptr, items, eval_users)
    want = ref.take_groups(indptr, items, eval_users)
    np.testing.assert_array_equal(csr_form[0], want[0])
    np.testing.assert_array_equal(csr_form[1], want[1])
    rel_list = port.relevant_by_user(tu, ti, n_users)
    list_form = [rel_list[u] for u in eval_users]
    assert port.recall_at_k(topk, csr_form) == ref.recall_at_k(topk,
                                                               list_form)
    assert port.ndcg_at_k(topk, csr_form) == ref.ndcg_at_k(topk, csr_form)
    rows = np.array([3, 0, 17, 17, 5])
    sub_ptr, sub_items = port.take_groups(indptr, items, rows)
    for j, u in enumerate(rows):
        np.testing.assert_array_equal(sub_items[sub_ptr[j]:sub_ptr[j + 1]],
                                      items[indptr[u]:indptr[u + 1]])
