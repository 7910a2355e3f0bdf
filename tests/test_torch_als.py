"""The port's ALS estimator against the reference's (pinned warm starts, the
same numpy inputs), and its sklearn surface (cases from
tests/test_estimator_api.py)."""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from sklearn.base import clone

from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.config import (
    DataConfig, FitConfig, MeshConfig, SolveConfig,
)
from tests.conftest import tiny_problem

torch.set_num_threads(2)


def _warm(n_users, n_items, k, seed=9):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal((n_users, k))).astype(np.float32),
            (0.1 * rng.standard_normal((n_items, k))).astype(np.float32))


def _skewed_R(seed=7, n_users=120, n_items=90, n_obs=4000):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_obs)
    pop = np.arange(1, n_items + 1) ** -1.0
    pop /= pop.sum()
    items = rng.choice(n_items, size=n_obs, p=pop)
    uniq = np.unique(users * n_items + items)
    vals = (rng.integers(1, 11, uniq.shape[0]) * 0.5).astype(np.float32)
    return sp.csr_matrix((vals, (uniq // n_items, uniq % n_items)),
                         shape=(n_users, n_items))


FIT_CASES = [
    ("explicit", dict(rank=5, reg=0.2)),
    ("implicit", dict(rank=4, reg=0.3, alpha=3.0)),
    ("weighted_lambda", dict(rank=5, reg=0.05, reg_by_degree=True)),
    ("hot_dense", dict(rank=8, reg=0.5, hot_cols=16, dense_min_degree=24)),
]


@pytest.mark.parametrize("name,kw", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_matches_reference(name, kw):
    R = _skewed_R() if name == "hot_dense" else tiny_problem(
        40, 30, density=0.4, seed=11)
    U0, V0 = _warm(*R.shape, kw["rank"])
    ref = RefALS(n_sweeps=3, platform="cpu", **kw).fit(R, U0=U0, V0=V0)
    got = ALS(n_sweeps=3, platform="cpu", **kw).fit(R, U0=U0, V0=V0)
    # f32 sums in another order; atol scales with the factors' magnitude
    for a, b in ((got.U_, ref.U_), (got.V_, ref.V_)):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=3e-5 * max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(got.history_, ref.history_, rtol=1e-4)
    assert len(got.history_) == 3
    assert got.history_[-1] < got.history_[0]


def test_predict_score_from_reference_state():
    """A port estimator built from the reference's fitted state predicts
    and scores identically."""
    R = tiny_problem(30, 25, density=0.4, seed=12)
    ref = RefALS(rank=4, n_sweeps=3, platform="cpu", seed=0,
                 data_config=None).fit(R)
    state = dict(U_=np.asarray(ref.U_), V_=np.asarray(ref.V_),
                 n_users_=ref.n_users_, n_items_=ref.n_items_,
                 history_=np.asarray(ref.history_), params=ref.get_params())
    m = ALS.from_reference_state(state)
    assert m.get_params().keys() == ref.get_params().keys()
    pairs = np.array([[0, 1], [3, 2], [29, 24]])
    np.testing.assert_array_equal(m.predict(pairs), ref.predict(pairs))
    np.testing.assert_array_equal(m.predict(pairs[:, 0], pairs[:, 1]),
                                  ref.predict(pairs[:, 0], pairs[:, 1]))
    np.testing.assert_array_equal(m.predict_all(3), ref.predict_all(3))
    assert m.rmse(R) == ref.rmse(R)
    assert m.score(R) == ref.score(R) == -m.rmse(R)
    np.testing.assert_array_equal(m.history_, ref.history_)
    # a reference DataConfig in the params converts to the port's
    from recommendation_models_tpu.config import DataConfig as RefDC
    state["params"] = dict(state["params"], data_config=RefDC(max_bucket=64))
    m2 = ALS.from_reference_state(state)
    assert m2.data_config == DataConfig(max_bucket=64)


@pytest.mark.parametrize("alpha", [None, 3.0])
def test_fold_in_matches_reference(alpha):
    R = tiny_problem(40, 30, density=0.4, seed=51)
    rng = np.random.default_rng(4)
    U0, V0 = _warm(40, 30, 5)
    ref = RefALS(rank=5, reg=0.3, alpha=alpha, n_sweeps=2,
                 platform="cpu").fit(R, U0=U0, V0=V0)
    m = ALS(rank=5, reg=0.3, alpha=alpha, n_sweeps=2,
            platform="cpu").fit(R, U0=U0, V0=V0)
    m.U_, m.V_ = np.asarray(ref.U_), np.asarray(ref.V_)
    mask = rng.random((6, 30)) < 0.5
    Rn = sp.csr_matrix(np.where(mask, rng.integers(1, 11, mask.shape) / 2.0,
                                0.0))
    np.testing.assert_allclose(m.fold_in(Rn, side="user"),
                               ref.fold_in(Rn, side="user"),
                               rtol=2e-4, atol=2e-5)
    Rni = sp.csr_matrix(np.where(rng.random((40, 4)) < 0.5,
                                 rng.integers(1, 11, (40, 4)) / 2.0, 0.0))
    np.testing.assert_allclose(m.fold_in(Rni, side="item"),
                               ref.fold_in(Rni, side="item"),
                               rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="item space"):
        m.fold_in(sp.csr_matrix(np.ones((3, 7))), side="user")
    with pytest.raises(ValueError, match="side"):
        m.fold_in(Rn, side="both")


def test_get_set_params_clone_and_pickle():
    m, r = ALS(rank=7, reg=0.2, alpha=1.5), RefALS(rank=7, reg=0.2, alpha=1.5)
    assert m.get_params() == r.get_params()
    m.set_params(rank=9)
    assert m.rank == 9
    with pytest.raises(ValueError):
        m.set_params(bogus=1)
    c = clone(ALS(rank=5, reg=0.7, lambda_=0.7))
    assert (c.rank, c.reg, c.lambda_) == (5, 0.7, 0.7)
    R = tiny_problem(20, 15, seed=5)
    fitted = ALS(rank=4, n_sweeps=2, platform="cpu").fit(R)
    # pickled after serving: the device copy of the catalog is dropped
    _, served = fitted.recommend([0, 3], n=4)
    back = pickle.loads(pickle.dumps(fitted))
    assert "_vdev_cache" not in back.__dict__
    np.testing.assert_array_equal(back.U_, fitted.U_)
    np.testing.assert_array_equal(back.predict([[0, 1]]),
                                  fitted.predict([[0, 1]]))
    assert back.history_ == fitted.history_
    np.testing.assert_array_equal(back.recommend([0, 3], n=4)[1], served)


def test_aliases_and_validation():
    R = tiny_problem(25, 18, seed=9)
    U0, V0 = _warm(25, 18, 4)
    a = ALS(rank=4, lambda_=0.3, max_iter=3, platform="cpu").fit(
        R, U0=U0, V0=V0)
    b = ALS(rank=4, reg=0.3, n_sweeps=3, platform="cpu").fit(R, U0=U0, V0=V0)
    np.testing.assert_array_equal(a.U_, b.U_)
    assert len(a.history_) == 3
    for kw in (dict(reg=0.1, lambda_=0.5), dict(n_sweeps=10, max_iter=3)):
        with pytest.raises(ValueError, match="only one"):
            ALS(rank=4, platform="cpu", **kw).fit(R)
    for kw in (dict(rank=0), dict(reg=-1.0), dict(n_sweeps=0)):
        with pytest.raises(ValueError):
            ALS(platform="cpu", **kw).fit(R)
    with pytest.raises(ValueError, match="BOTH"):
        ALS(rank=4, platform="cpu").fit(R, U0=U0)
    with pytest.raises(RuntimeError, match="not fitted"):
        ALS().predict([0], [0])
    with pytest.raises(ValueError):
        ALS(rank=4, platform="cpu").fit(np.zeros((2, 3, 4)))


def test_data_config_auto_policy_matches_reference():
    for rank in (4, 10, 64, 128):
        for kw in (dict(), dict(dense_min_degree=700, hot_cols=0),
                   dict(bucket_growth=1.5, max_bucket=64)):
            a = ALS(rank=rank, **kw)._data_config()
            b = RefALS(rank=rank, **kw)._data_config()
            assert vars(a) == vars(b)
    assert ALS(rank=64)._data_config().hot_cols == 128
    m = ALS.from_configs(solve=SolveConfig(rank=128),
                         data=DataConfig(dense_min_degree=512))
    assert m._data_config().dense_min_degree == 512
    m = ALS.from_configs(
        solve=SolveConfig(rank=7, reg=0.25, alpha=1.5),
        mesh=MeshConfig(platform="cpu"),
        data=DataConfig(max_bucket=128, dense_whales=False),
        fit=FitConfig(n_sweeps=3, seed=9))
    p = m.get_params()
    assert (p["rank"], p["reg"], p["alpha"], p["platform"]) == (
        7, 0.25, 1.5, "cpu")
    assert m._data_config().max_bucket == 128
    assert m._data_config().dense_whales is False
    assert m._data_config().bucket_growth == 1.12
    assert m._solve_config() == SolveConfig(rank=7, reg=0.25, alpha=1.5)


def test_layout_cache_tol_and_verbose_paths(tmp_path, capsys):
    R = tiny_problem(25, 18, seed=6)
    prefix = str(tmp_path / "ml")
    m1 = ALS(rank=3, n_sweeps=2, layout_cache=prefix, platform="cpu").fit(R)
    assert list(tmp_path.glob("ml*.user.npz"))
    assert list(tmp_path.glob("ml*.item.npz"))
    m2 = ALS(rank=3, n_sweeps=2, layout_cache=prefix, platform="cpu").fit(R)
    np.testing.assert_array_equal(m1.U_, m2.U_)
    U0, V0 = _warm(25, 18, 3)
    early = ALS(rank=3, n_sweeps=20, tol=1.0, platform="cpu").fit(
        R, U0=U0, V0=V0)
    assert len(early.history_) == 2
    loud = ALS(rank=3, n_sweeps=2, verbose=1, platform="cpu").fit(
        R, U0=U0, V0=V0)
    quiet = ALS(rank=3, n_sweeps=2, platform="cpu", sse_mode="separate").fit(
        R, U0=U0, V0=V0)
    assert "sweep 2" in capsys.readouterr().out
    np.testing.assert_allclose(loud.history_, quiet.history_, rtol=1e-5)
    np.testing.assert_array_equal(loud.U_, quiet.U_)


def test_empty_rows_and_reg_zero_solve_to_zero():
    """Cases of tests/test_edge_cases.py: empty rows and columns solve to
    exactly 0; at reg=0 the ridge floor keeps them (and padding rows) 0 and
    the fit finite."""
    u = np.array([1, 2, 3, 4], np.int64)
    i = np.array([1, 2, 3, 1], np.int64)
    r = np.array([3.0, 4.0, 2.0, 5.0], np.float32)
    R = sp.csr_matrix((r, (u, i)), shape=(6, 5))
    m = ALS(rank=3, n_sweeps=3, platform="cpu").fit(R)
    np.testing.assert_array_equal(m.U_[[0, 5]], 0.0)
    np.testing.assert_array_equal(m.V_[[0, 4]], 0.0)
    R = np.zeros((5, 4), np.float32)
    R[0] = [3.0, 1.0, 2.0, 4.0]
    R[2] = [2.0, 4.0, 1.0, 3.0]
    U0, V0 = _warm(5, 4, 2)
    m = ALS(rank=2, reg=0.0, n_sweeps=2, platform="cpu").fit(
        sp.csr_matrix(R), U0=U0, V0=V0)
    ref = RefALS(rank=2, reg=0.0, n_sweeps=2, platform="cpu").fit(
        sp.csr_matrix(R), U0=U0, V0=V0)
    assert np.isfinite(m.U_).all() and np.isfinite(m.V_).all()
    np.testing.assert_array_equal(m.U_[[1, 3, 4]], 0.0)
    np.testing.assert_allclose(m.U_, ref.U_, rtol=1e-4, atol=1e-5)
