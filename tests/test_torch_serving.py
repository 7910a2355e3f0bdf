"""The port's serving (``ALS.recommend`` and ``top_n``) at the ML-100K
shape of tests/test_serving_quality.py, fit with ``platform="cpu"``: against
a frozen exact f64 selector, the pinned recall@10 and NDCG@10, and the JAX
package's exact selector on the same factors; and the exclusion by masking
from the training lists' device copy, against the overfetch path, the JAX
estimator and brute force, with that copy's cache."""

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


# -- exclusion by masking (ALS's single-device backend) ---------------------

def _lists_state(n_items, degrees, seed, dup_rows=0, dup_ids=0, rank=6):
    """Factors with ``dup_rows`` repeated catalog rows (exact score ties)
    and training lists of the given degrees, ``dup_ids`` of each list's ids
    repeated."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((len(degrees), rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    if dup_rows:
        V[rng.choice(n_items, dup_rows, replace=False)] = V[0]
    lists = []
    for d in degrees:
        dup = min(dup_ids, d // 2)
        ids = rng.choice(n_items, d - dup, replace=False)
        lists.append(np.concatenate([ids, ids[:dup]]))
    indptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    indices = (np.concatenate(lists) if lists else np.empty(0)).astype(
        np.int32)
    state = dict(U_=U, V_=V, n_users_=len(degrees), n_items_=n_items,
                 history_=[], params={"rank": rank, "platform": "cpu"})
    return state, indptr.astype(np.int64), indices


def _ref_estimator(state, indptr, indices):
    ref = RefALS(rank=state["params"]["rank"], platform="cpu")
    ref.U_, ref.V_ = state["U_"], state["V_"]
    ref.n_users_, ref.n_items_ = state["n_users_"], state["n_items_"]
    ref._train_indptr, ref._train_indices = indptr, indices
    return ref


def _overfetch_path(port, users, n):
    """The overfetch-and-filter path on the port's single-device backend:
    the parent's path for every user."""
    from recommendation_models_tpu_torch.ops.topk import (
        grouped_exclusion_topk)
    query_rows, topk, _ = port._topk_backend("exact", 0.99)
    return grouped_exclusion_topk(users, n, port._train_indptr,
                                  port._train_indices, query_rows, topk)


@pytest.mark.parametrize("n_items,degrees,n,dup_ids,fallback", [
    # past _SMALL_N: item blocks of 16,384 and 3,616 (the last partial)
    (20_000, [0, 3, 40, 129, 300, 0, 17, 513, 64, 5], 10, 0, 0),
    # the same with repeated seen ids
    (20_000, [0, 3, 40, 129, 300, 0, 17, 513, 64, 5], 10, 3, 0),
    # at _SMALL_N and under it: one product and one selection
    (8_192, [7, 0, 250, 31, 33, 1_000], 12, 2, 0),
    (300, [0, 0, 0], 10, 0, 0),
    (300, [5, 20, 100, 7, 0, 60], 10, 4, 0),
    # fewer than n unseen items: 295 distinct seen of 300
    (300, [5, 295, 40, 200], 10, 0, 1),
    # and 291 ids with one repeated (degree past n_items - n, 10 unseen):
    # both fall back
    (300, [5, 295, 40, 291], 10, 1, 2),
])
def test_masked_exclusion_matches_the_overfetch_path_and_reference(
        n_items, degrees, n, dup_ids, fallback):
    from recommendation_models_tpu_torch.utils import profiling
    state, indptr, indices = _lists_state(n_items, degrees, seed=n_items,
                                          dup_rows=20, dup_ids=dup_ids)
    port = ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)
    users = np.arange(len(degrees))[::-1].copy()
    profiling.reset()
    s_got, got = port.recommend(users, n=n, exclude_seen=True)
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert counters["serve.exclusion_fallback_users"] == fallback
    assert counters["serve.exclusion_ids"] == sum(degrees)
    s_old, old = _overfetch_path(port, users, n)
    np.testing.assert_array_equal(got, old)
    # the same products; the overfetch path groups users by degree, and a
    # product's rounding may follow the number of rows (one ulp)
    np.testing.assert_allclose(s_got, s_old, rtol=2e-7, atol=1e-7)
    s_ref, ref = _ref_estimator(state, indptr, indices).recommend(
        users, n=n, exclude_seen=True, method="exact")
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_allclose(s_got, np.asarray(s_ref), rtol=1e-5,
                               atol=1e-6)
    full = state["U_"][users] @ state["V_"].T
    for r, u in enumerate(users):
        seen = set(indices[indptr[u]:indptr[u + 1]].tolist())
        finite = np.isfinite(s_got[r])
        assert not seen & set(got[r][finite].tolist())
        assert finite.sum() == min(n, n_items - len(seen))
        np.testing.assert_allclose(s_got[r][finite], full[r][got[r][finite]],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_items", [300, 20_000])
def test_unfiltered_serving_is_unchanged(n_items):
    state, indptr, indices = _lists_state(n_items, [4, 90, 0, 30], seed=2,
                                          dup_rows=20)
    port = ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)
    users = np.arange(4)
    s_got, got = port.recommend(users, n=10, exclude_seen=False)
    assert "_seen_dev_cache" not in port.__dict__
    query_rows, topk, _ = port._topk_backend("auto", 0.99)
    s_want, want = topk(query_rows(users), 10, None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s_got, s_want)
    s_ref, ref = _ref_estimator(state, indptr, indices).recommend(
        users, n=10, exclude_seen=False, method="exact")
    np.testing.assert_array_equal(got, np.asarray(ref))


def _bruteforce_unseen(U, V, users, indptr, indices, n):
    full = U[users].astype(np.float64) @ V.astype(np.float64).T
    for r, u in enumerate(users):
        full[r, indices[indptr[u]:indptr[u + 1]]] = -np.inf
    return np.argsort(-full, axis=1, kind="stable")[:, :n]


def test_seen_lists_follow_the_training_lists():
    """The device lists are built at the first exclude_seen call, hold the
    items as serving rows, and are built again after a refit and for an
    estimator carried over with other training lists."""
    def ratings(seed):
        r = np.random.default_rng(seed)
        return sp.random(40, 90, density=0.15, random_state=seed,
                         data_rvs=lambda s: r.uniform(1, 5, s)).tocsr()
    R1, R2 = ratings(1), ratings(2)
    m = ALS(rank=4, n_sweeps=2, seed=0, platform="cpu").fit(R1)
    users = np.arange(40)
    m.recommend(users, n=5, exclude_seen=False)
    assert "_seen_dev_cache" not in m.__dict__
    _, it = m.recommend(users, n=5)
    ip, ix, lists = m._seen_dev_cache
    assert ip is m._train_indptr and ix is m._train_indices
    _, pf = serving_permutation(90)
    np.testing.assert_array_equal(lists.rows.numpy(), pf[R1.indices])
    np.testing.assert_array_equal(lists.indptr.numpy(), R1.indptr)
    assert lists.rows.dtype == torch.int32
    np.testing.assert_array_equal(
        it, _bruteforce_unseen(m.U_, m.V_, users, R1.indptr, R1.indices, 5))
    m.recommend(users, n=5)
    assert m._seen_dev_cache[2] is lists            # cached
    m.fit(R2)
    _, it = m.recommend(users, n=5)
    assert m._seen_dev_cache[0] is m._train_indptr
    np.testing.assert_array_equal(m._seen_dev_cache[2].rows.numpy(),
                                  pf[R2.indices])
    np.testing.assert_array_equal(
        it, _bruteforce_unseen(m.U_, m.V_, users, R2.indptr, R2.indices, 5))
    state = dict(U_=m.U_, V_=m.V_, n_users_=40, n_items_=90, history_=[],
                 params=m.get_params())
    for R in (R1, R2):
        carried = ALS.from_reference_state(state, train_indptr=R.indptr,
                                           train_indices=R.indices)
        _, it = carried.recommend(users, n=5)
        np.testing.assert_array_equal(carried._seen_dev_cache[2].rows.numpy(),
                                      pf[R.indices])
        np.testing.assert_array_equal(
            it, _bruteforce_unseen(m.U_, m.V_, users, R.indptr, R.indices,
                                   5))


def test_seen_lists_are_dropped_with_the_serving_caches(tmp_path):
    rng = np.random.default_rng(0)
    R = sp.random(30, 50, density=0.2, random_state=1,
                  data_rvs=lambda s: rng.uniform(1, 5, s)).tocsr()
    kw = dict(rank=4, n_sweeps=2, seed=0, platform="cpu",
              checkpoint_dir=str(tmp_path), checkpoint_every=1)
    m = ALS(**kw).fit(R)
    m.recommend([0, 1], n=5)
    assert "_seen_dev_cache" in m.__dict__
    back = pickle.loads(pickle.dumps(m))
    assert "_seen_dev_cache" not in back.__dict__
    assert "_seen_dev_cache" not in m.__getstate__()
    np.testing.assert_array_equal(back.recommend([0, 1], n=5)[1],
                                  m.recommend([0, 1], n=5)[1])
    m._drop_serving_caches()
    assert "_seen_dev_cache" not in m.__dict__
    m.recommend([0, 1], n=5)
    m.V_ = m.V_.copy()                  # the setter drops the caches
    assert "_seen_dev_cache" not in m.__dict__
    m.recommend([0, 1], n=5)
    m.resume()
    assert "_seen_dev_cache" not in m.__dict__


def test_seen_lists_refuse_item_ids_outside_the_catalog():
    state, indptr, indices = _lists_state(50, [3, 4], seed=0)
    indices[2] = 50
    port = ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)
    with pytest.raises(ValueError, match=r"item ids must be in \[0, 50\)"):
        port.recommend([0, 1], n=5)


@pytest.mark.parametrize("n_items,edges", [
    (20_000, [0, 1, 16_382, 16_383, 16_384, 16_385, 19_998, 19_999]),
    (8_192, [0, 1, 8_190, 8_191]),
])
def test_masking_reaches_the_edges_of_every_block(n_items, edges):
    """Items at the first and last serving rows of each item block score
    highest for every user and are seen by every user: one left unmasked
    would lead the answer."""
    pb, _ = serving_permutation(n_items)
    rng = np.random.default_rng(7)
    U = rng.standard_normal((5, 4)).astype(np.float32)
    U[:, 0] = np.abs(U[:, 0]) + 1
    V = rng.standard_normal((n_items, 4)).astype(np.float32)
    top = pb[edges]
    V[top] = [50.0, 0, 0, 0]
    indptr = np.arange(6, dtype=np.int64) * len(top)
    indices = np.tile(top, 5).astype(np.int32)
    state = dict(U_=U, V_=V, n_users_=5, n_items_=n_items, history_=[],
                 params={"rank": 4, "platform": "cpu"})
    port = ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)
    users = np.arange(5)
    _, got = port.recommend(users, n=10)
    np.testing.assert_array_equal(
        got, _bruteforce_unseen(U, V, users, indptr, indices, 10))
    assert not set(got.ravel()) & set(top.tolist())
