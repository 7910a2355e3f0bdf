"""The port's serving (``ALS.recommend`` and ``top_n``) at the ML-100K
shape of tests/test_serving_quality.py, fit with ``platform="cpu"``: against
a frozen exact f64 selector, the pinned recall@10 and NDCG@10, and the JAX
package's exact selector on the same factors."""

import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu.data.synthetic import (
    synthetic_ratings as ref_synthetic)
from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.evaluate import (
    grouped_by_user, leave_n_out, ndcg_at_k, recall_at_k, take_groups)
from recommendation_models_tpu_torch.ops.topk import serving_permutation

torch.set_num_threads(2)
K = 10


def _split(n_users=943, n_items=1682, n_obs=100_000):
    users, items, ratings = synthetic_ratings(n_users, n_items, n_obs,
                                              rank=16, seed=0)
    tr, te = leave_n_out(users, items, ratings, n=2, seed=0)
    train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                          shape=(n_users, n_items))
    rel_indptr, rel_items = grouped_by_user(users[te], items[te], n_users)
    eval_users = np.flatnonzero(np.diff(rel_indptr) > 0)
    rel_eval = take_groups(rel_indptr, rel_items, eval_users)
    return train, eval_users, rel_eval


def _frozen_exact_topk(U, V, eval_users, train, k):
    """Full f64 scores, seen items excluded, exact top-k: independent of
    every ops.topk code path."""
    sc = U[eval_users].astype(np.float64) @ V.astype(np.float64).T
    indptr, indices = train.indptr, train.indices
    for j, u in enumerate(eval_users):
        sc[j, indices[indptr[u]:indptr[u + 1]]] = -np.inf
    part = np.argpartition(-sc, k, axis=1)[:, :k]
    rows = np.arange(eval_users.shape[0])[:, None]
    order = np.argsort(-sc[rows, part], axis=1)
    return part[rows, order]


@pytest.fixture(scope="module")
def served():
    train, eval_users, rel_eval = _split()
    model = ALS(rank=32, alpha=1.0, reg=0.1, n_sweeps=4, seed=0,
                platform="cpu").fit(train)
    _, topk_model = model.recommend(eval_users, n=K, exclude_seen=True)
    topk_frozen = _frozen_exact_topk(model.U_, model.V_, eval_users, train, K)
    return model, train, eval_users, rel_eval, topk_model, topk_frozen


def test_split_is_the_reference_data():
    u, i, r = synthetic_ratings(943, 1682, 100_000, rank=16, seed=0)
    ru, ri, rr = ref_synthetic(943, 1682, 100_000, rank=16, seed=0)
    for a, b in ((u, ru), (i, ri), (r, rr)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", [recall_at_k, ndcg_at_k])
def test_serving_matches_frozen_exact_reference(served, metric):
    _, _, _, rel_eval, topk_model, topk_frozen = served
    got, want = metric(topk_model, rel_eval), metric(topk_frozen, rel_eval)
    assert abs(got - want) <= 2e-3, (got, want)


def test_serving_recall_pinned_fixed_seed(served):
    """The JAX package's pins at this seed (tests/test_serving_quality.py):
    recall@10 0.22163, NDCG@10 0.15443."""
    _, _, _, rel_eval, topk_model, _ = served
    assert recall_at_k(topk_model, rel_eval) == pytest.approx(0.22163,
                                                              abs=5e-3)
    assert ndcg_at_k(topk_model, rel_eval) == pytest.approx(0.15443,
                                                            abs=5e-3)


def test_served_items_are_unseen_and_top_n_agrees(served):
    model, train, eval_users, _, topk_model, _ = served
    assert topk_model.shape == (eval_users.shape[0], K)
    for j in range(0, eval_users.shape[0], 37):
        u = int(eval_users[j])
        seen = set(train[u].indices.tolist())
        assert not seen & set(topk_model[j].tolist())
        np.testing.assert_array_equal(model.top_n(u, n=K), topk_model[j])


def test_cached_catalog_is_permuted_and_results_exact():
    rng = np.random.default_rng(0)
    n_users, n_items, k = 30, 200, 8
    R = sp.random(n_users, n_items, density=0.2, random_state=1,
                  data_rvs=lambda s: rng.uniform(1, 5, s).astype(np.float32))
    m = ALS(rank=6, n_sweeps=2, seed=0, platform="cpu").fit(R.tocsr())
    sc, it = m.recommend(np.arange(10), n=k, exclude_seen=False,
                         method="exact")
    pb, _ = serving_permutation(n_items)
    key, cached = m._vdev_cache
    assert key is m.V_ and cached.device.type == "cpu"
    np.testing.assert_array_equal(cached.numpy(), m.V_[pb])
    s_ref = m.U_[:10] @ m.V_.T
    it_ref = np.argsort(-s_ref, axis=1)[:, :k]
    np.testing.assert_allclose(sc, np.take_along_axis(s_ref, it_ref, axis=1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(it, it_ref)
    # a new V_ (another array) is uploaded again
    m.V_ = m.V_.copy()
    m.recommend([0], n=k)
    assert m._vdev_cache[0] is m.V_


def test_recommend_degree_bucketed_matches_bruteforce():
    rng = np.random.default_rng(11)
    n_users, n_items = 60, 120
    rows, cols, vals = [], [], []
    for u in range(n_users):
        deg = 100 if u == 7 else int(rng.integers(1, 12))  # one whale
        its = rng.choice(n_items, deg, replace=False)
        rows += [u] * deg
        cols += list(its)
        vals += list(rng.uniform(1, 5, deg))
    R = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    model = ALS(rank=6, n_sweeps=3, seed=0, platform="cpu").fit(R)
    users = np.arange(n_users)
    sc, it = model.recommend(users, n=5, exclude_seen=True, method="exact")
    full = model.U_ @ model.V_.T
    for u in users:
        seen = set(R[int(u)].indices.tolist())
        order = [i for i in np.argsort(-full[u]) if i not in seen][:5]
        np.testing.assert_array_equal(it[u], order)


@pytest.mark.parametrize("ids", [[-1], [943], [0, 5, 10_000]])
def test_recommend_validates_user_ids(served, ids):
    model = served[0]
    with pytest.raises(ValueError, match=r"user ids must be in \[0, 943\)"):
        model.recommend(ids)


def test_n_is_clamped_to_the_catalog():
    R = sp.csr_matrix(np.eye(6, 5, dtype=np.float32) * 3.0)
    m = ALS(rank=2, n_sweeps=2, platform="cpu").fit(R)
    sc, it = m.recommend([0, 1], n=50, exclude_seen=False)
    assert it.shape == (2, 5)
    assert sorted(it[0].tolist()) == list(range(5))


@pytest.fixture(scope="module")
def carried():
    """The JAX estimator fit at the same shape, its factors carried into the
    port with the training CSR."""
    train, eval_users, _ = _split()
    ref = RefALS(rank=32, alpha=1.0, reg=0.1, n_sweeps=4, seed=0,
                 platform="cpu").fit(train)
    state = dict(U_=ref.U_, V_=ref.V_, n_users_=ref.n_users_,
                 n_items_=ref.n_items_, history_=ref.history_,
                 params=ref.get_params())
    state["params"]["platform"] = "cpu"
    port = ALS.from_reference_state(state, train_indptr=train.indptr,
                                    train_indices=train.indices)
    return ref, port, state, eval_users


def _near_tie_swaps(U, V, users, got, want):
    """Positions where the two id lists differ, each checked to be a near
    tie: the f64 scores of the two items differ by less than 1e-6·|score|."""
    swaps = []
    for r, c in zip(*np.nonzero(got != want)):
        u = users[r]
        a = float(U[u].astype(np.float64) @ V[got[r, c]].astype(np.float64))
        b = float(U[u].astype(np.float64) @ V[want[r, c]].astype(np.float64))
        assert abs(a - b) < 1e-6 * max(abs(a), abs(b)), (u, c, a, b)
        swaps.append((int(u), int(c), got[r, c], want[r, c], a - b))
    return swaps


@pytest.mark.parametrize("exclude_seen", [True, False])
def test_carried_factors_serve_the_reference_ids(carried, exclude_seen):
    ref, port, _, eval_users = carried
    np.testing.assert_array_equal(port.U_, ref.U_)
    s_got, got = port.recommend(eval_users, n=K, exclude_seen=exclude_seen,
                                method="exact")
    s_want, want = ref.recommend(eval_users, n=K, exclude_seen=exclude_seen,
                                 method="exact")
    swaps = _near_tie_swaps(ref.U_, ref.V_, eval_users, got, want)
    print(f"near-tie swaps (exclude_seen={exclude_seen}): {swaps}")
    np.testing.assert_allclose(s_got, s_want, rtol=1e-5, atol=1e-6)


def test_carried_without_training_lists_warns_and_serves_unfiltered(carried):
    _, port, state, eval_users = carried
    bare = ALS.from_reference_state(state)
    with pytest.warns(UserWarning, match="canNOT be excluded"):
        _, got = bare.recommend(eval_users[:50], n=K, exclude_seen=True)
    _, want = port.recommend(eval_users[:50], n=K, exclude_seen=False)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="BOTH"):
        ALS.from_reference_state(state, train_indptr=np.zeros(3))


def test_pickle_after_recommend_drops_the_device_catalog(carried):
    _, port, _, eval_users = carried
    _, before = port.recommend(eval_users[:20], n=K)
    assert hasattr(port, "_vdev_cache")
    back = pickle.loads(pickle.dumps(port))
    assert "_vdev_cache" not in back.__dict__
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, after = back.recommend(eval_users[:20], n=K)
    np.testing.assert_array_equal(after, before)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_in_place_edit_of_v_serves_the_current_catalog(tmp_path, package):
    """ROADMAP Queue 3: fit with checkpoints, resume into a fresh
    estimator, serve, then ``V_ *= -1`` and serve again. Both packages
    serve the exact top-5 of the current factors each time (the ``V_``
    setter drops the cached catalog)."""
    rng = np.random.default_rng(0)
    R = sp.random(60, 40, density=0.2, random_state=1,
                  data_rvs=lambda s: rng.uniform(1, 5, s).astype(np.float32)
                  ).tocsr()
    cls = ALS if package == "port" else RefALS
    ckpt = tmp_path / package
    ckpt.mkdir()             # the JAX package's async save needs the root
    kw = dict(rank=4, n_sweeps=3, seed=0, checkpoint_every=1,
              checkpoint_dir=str(ckpt), platform="cpu")
    cls(**kw).fit(R)
    model = cls(**kw)
    model.resume()

    def exact_top5():
        sc = model.U_[:5].astype(np.float64) @ model.V_.astype(np.float64).T
        return np.argsort(-sc, axis=1, kind="stable")[:, :5]

    _, before = model.recommend(np.arange(5), 5, exclude_seen=False)
    np.testing.assert_array_equal(before, exact_top5())
    model.V_ *= -1
    _, after = model.recommend(np.arange(5), 5, exclude_seen=False)
    np.testing.assert_array_equal(after, exact_top5())
    assert (after != before).any()
