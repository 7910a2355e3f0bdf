"""The port's IMC (``models/imc.py``) against the JAX package's on the same
numpy inputs, and its single-device cases from tests/test_imc.py.

Tolerances: the history within rtol 1e-3 of the JAX package's (the port's
HISTORY_RTOL) at 30 and 50 CG steps, the factors within 1e-3 of their
largest entry at 50 steps and 5e-3 at 30; the grams within 1e-5, one CG
solve within 1e-4; against the NumPy oracle, the reference's own 2e-2. The ``gpu`` test at the end fits on
the card and holds it against the CPU: ``python -m pytest --noconftest -m
gpu tests/test_torch_imc.py``."""

import glob
import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch import IMC
from recommendation_models_tpu_torch.config import DataConfig
from recommendation_models_tpu_torch.data.layout import layout_from_coo
from recommendation_models_tpu_torch.data.synthetic import (
    synthetic_imc_ratings, synthetic_side_features,
)
from recommendation_models_tpu_torch.models import imc as port_imc
from recommendation_models_tpu_torch.solver.als_sweep import device_buckets

try:
    import jax.numpy as jnp
    from recommendation_models_tpu import IMC as RefIMC
    from recommendation_models_tpu.config import DataConfig as RefDC
    from recommendation_models_tpu.data import synthetic as ref_synth
    from recommendation_models_tpu.data.layout import (
        layout_from_coo as ref_layout_from_coo)
    from recommendation_models_tpu.models import imc as ref_imc
    from recommendation_models_tpu.oracle.imc_numpy import OracleIMC
    from recommendation_models_tpu.solver.als_sweep import (
        device_buckets as ref_device_buckets)
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    jnp = RefIMC = None

torch.set_num_threads(2)
HISTORY_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if RefIMC is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture(scope="module")
def imc_problem():
    X, Y = synthetic_side_features(60, 50, d_user=12, d_item=10, seed=1)
    users, items, r, _, _ = synthetic_imc_ratings(X, Y, n_obs=900, rank=4,
                                                  noise=0.02, seed=2)
    return X, Y, users, items, r


def _warm(X, Y, k=4, seed=3):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((X.shape[1], k)),
            0.1 * rng.standard_normal((Y.shape[1], k)))


def _fit(X, Y, users, items, r, W0=None, H0=None, **kw):
    return IMC(platform="cpu", **kw).fit((users, items, r), X, Y, W0=W0,
                                         H0=H0)


# ------------------------------------------------------------ the data

@pytest.mark.parametrize("args", [
    (60, 50, 12, 10, 1, 900, 4, 0.02, 2),
    (6040 // 8, 3706 // 8, 64, 48, 0, 20_000, 32, 0.05, 0),
])
def test_generators_byte_identical(args):
    n_u, n_i, du, di, fseed, n_obs, rank, noise, oseed = args
    got = synthetic_side_features(n_u, n_i, du, di, seed=fseed)
    want = ref_synth.synthetic_side_features(n_u, n_i, du, di, seed=fseed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = synthetic_imc_ratings(*got, n_obs, rank=rank, noise=noise,
                                seed=oseed)
    want = ref_synth.synthetic_imc_ratings(*want, n_obs, rank=rank,
                                           noise=noise, seed=oseed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,scale,warm", [
    (0, 0.1, None), (7, 0.3, None), (0, 0.1, "W0"), (0, 0.1, "H0"),
])
def test_init_bit_equal_to_reference(imc_problem, monkeypatch, seed, scale,
                                     warm):
    """The W and H each package's fit starts from, captured at its sweep
    program: bitwise equal (a warm start of one table takes the first draw
    for the other, as in the reference)."""
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    kw = {"W0": dict(W0=W0), "H0": dict(H0=H0), None: {}}[warm]
    seen = {}

    def ref_program(*a, **k):
        def run(W, H, *rest):
            seen["ref"] = (np.asarray(W), np.asarray(H))
            return W, H, jnp.zeros((1,), jnp.float32), 1
        return run

    def port_fit(W, H, *a, **k):
        seen["port"] = (W.numpy().copy(), H.numpy().copy())
        return W, H, torch.zeros(1), 1

    monkeypatch.setattr(ref_imc, "_imc_program", ref_program)
    monkeypatch.setattr(port_imc, "imc_fit", port_fit)
    RefIMC(rank=4, n_sweeps=1, seed=seed, init_scale=scale).fit(
        (users, items, r), X, Y, **kw)
    IMC(rank=4, n_sweeps=1, seed=seed, init_scale=scale,
        platform="cpu").fit((users, items, r), X, Y, **kw)
    for a, b in zip(seen["port"], seen["ref"]):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------ parity with the JAX fit

@pytest.mark.parametrize("cg_iters", [30, 50])
@pytest.mark.parametrize("init", ["warm", "default"])
def test_fit_matches_reference(imc_problem, init, cg_iters):
    """Same inputs and init: history within HISTORY_RTOL; factors within
    1e-3 of their largest entry at 50 CG steps (measured 9e-5), 5e-3 at 30,
    where the unconverged directions carry the two packages' f32 rounding
    further (measured 1.3e-3; both are that far from an f64 run of the same
    steps)."""
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    kw = dict(W0=W0, H0=H0) if init == "warm" else {}
    cfg = dict(rank=4, reg=0.1, n_sweeps=3, cg_iters=cg_iters, seed=0)
    got = IMC(platform="cpu", **cfg).fit((users, items, r), X, Y, **kw)
    ref = RefIMC(**cfg).fit((users, items, r), X, Y, **kw)
    np.testing.assert_allclose(got.history_, ref.history_,
                               rtol=HISTORY_RTOL)
    factor_tol = HISTORY_RTOL if cg_iters == 50 else 5e-3
    for a, b in ((got.W_, ref.W_), (got.H_, ref.H_)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=factor_tol * np.abs(b).max())
    assert len(got.history_) == 3
    assert got.history_[-1] < got.history_[0]


def _both_buckets(users, items, r, n_u, n_i, transpose=False):
    cfg = dict(dense_whales=False, hot_cols=0, bucket_growth=1.12)
    lay = layout_from_coo(users, items, r, n_u, n_i, DataConfig(**cfg),
                          transpose=transpose)
    ref = ref_layout_from_coo(users, items, r, n_u, n_i, RefDC(**cfg),
                              transpose=transpose)
    return device_buckets(lay, 1, "cpu"), ref_device_buckets(ref)


@pytest.mark.parametrize("budget_mb", [0, 1])
def test_factor_grams_match_reference(budget_mb):
    """The grams, RHS and Σr² of both packages on the same buckets, also
    with row blocks forced (1 MB), and the blocked grams equal to the
    unblocked ones."""
    rng = np.random.default_rng(23)
    n_rows, n_cols, k = 600, 80, 6
    u = rng.integers(0, n_rows, 6000)
    i = rng.integers(0, n_cols, 6000)
    v = rng.uniform(1, 5, 6000).astype(np.float32)
    bk, rbk = _both_buckets(u, i, v, n_rows, n_cols)
    Z = rng.standard_normal((n_cols, k)).astype(np.float32)
    got = port_imc._factor_grams(torch.from_numpy(Z), bk, n_rows,
                                 gather_budget_mb=budget_mb)
    want = ref_imc._factor_grams(jnp.asarray(Z), rbk, n_rows,
                                 gather_budget_mb=budget_mb)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    whole = port_imc._factor_grams(torch.from_numpy(Z), bk, n_rows,
                                   gather_budget_mb=4096)
    for a, b in zip(got, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_gram_rows_unique_across_buckets_and_fit_repeats(imc_problem):
    """Each real row lies in one bucket of the IMC layout (padding rows
    carry the sentinel n_rows), so the grams' indexed add lands once per
    row and the fit repeats bitwise."""
    X, Y, users, items, r = imc_problem
    for transpose, n in ((False, X.shape[0]), (True, Y.shape[0])):
        bk, _ = _both_buckets(users, items, r, X.shape[0], Y.shape[0],
                              transpose=transpose)
        rid = torch.cat([b["row_ids"] for b in bk]).numpy()
        real = rid[rid < n]
        assert np.unique(real).size == real.size
        assert (rid <= n).all()
    a = _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=20)
    b = _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=20)
    np.testing.assert_array_equal(a.W_, b.W_)
    assert a.history_ == b.history_


@pytest.mark.parametrize("side", ["user", "item"])
def test_solve_factor_matches_reference(imc_problem, side):
    """One half-step of each package from the same state: the factor
    within 1e-4 of its largest entry, the SSE within 1e-5."""
    X, Y, users, items, r = imc_problem
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    W0, H0 = (a.astype(np.float32) for a in _warm(X, Y))
    if side == "user":
        F, Z, M0, n = X, Y @ H0, W0, X.shape[0]
        bk, rbk = _both_buckets(users, items, r, X.shape[0], Y.shape[0])
    else:
        F, Z, M0, n = Y, X @ W0, H0, Y.shape[0]
        bk, rbk = _both_buckets(users, items, r, X.shape[0], Y.shape[0],
                                transpose=True)
    M, sse = port_imc._solve_factor(torch.from_numpy(F), torch.from_numpy(Z),
                                    bk, n, torch.from_numpy(M0), 0.1, 25)
    Mr, sser = ref_imc._solve_factor(jnp.asarray(F), jnp.asarray(Z), rbk, n,
                                     jnp.asarray(M0), 0.1, 25)
    Mr = np.asarray(Mr)
    np.testing.assert_allclose(M.numpy(), Mr, rtol=0,
                               atol=1e-4 * np.abs(Mr).max())
    np.testing.assert_allclose(float(sse), float(sser), rtol=1e-5)


def _spd(n=20, seed=4):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = (Q @ Q.T / n + np.diag(np.linspace(0.5, 3.0, n))).astype(np.float32)
    return A, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("iters,restart", [(5, 16), (16, 16), (20, 16),
                                           (33, 8), (50, 16), (32, 8)])
def test_cg_matches_reference_and_counts_matvecs(iters, restart):
    """The same SPD operator through both packages' restarted CG: within
    1e-5 of the solution's largest entry, and exactly cg_matvec_count
    matvecs (counted in Python: the port's loop runs eagerly)."""
    A, b = _spd()
    calls = {"n": 0}

    def matvec(x):
        calls["n"] += 1
        return torch.from_numpy(A) @ x

    x = port_imc._cg(matvec, torch.from_numpy(b), torch.zeros(20), iters,
                     restart=restart)
    assert calls["n"] == port_imc.cg_matvec_count(iters, restart) == (
        iters + -(-iters // restart)) == ref_imc.cg_matvec_count(iters,
                                                                 restart)
    want = np.asarray(ref_imc._cg(lambda v: jnp.asarray(A) @ v,
                                  jnp.asarray(b), jnp.zeros(20, jnp.float32),
                                  iters, restart=restart))
    np.testing.assert_allclose(x.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if iters >= 20:
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b),
                                   rtol=1e-4, atol=1e-5)


def test_oracle_parity(imc_problem):
    """Same init and algorithm as the NumPy oracle: predictions and history
    within the reference's 2e-2."""
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    m = _fit(X, Y, users, items, r, W0, H0, rank=4, reg=0.1, n_sweeps=3,
             cg_iters=25)
    o = OracleIMC(rank=4, reg=0.1, n_sweeps=3, cg_iters=25).fit(
        users, items, r, X, Y, W0=W0, H0=H0)
    pred_m = m.predict(users[:50], items[:50])
    pred_o = o.predict(users[:50], items[:50], np.asarray(X, np.float64),
                       np.asarray(Y, np.float64))
    np.testing.assert_allclose(pred_m, pred_o, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(m.history_, o.history_, rtol=2e-2)


# ---------------------------------------- cases of tests/test_imc.py

def test_objective_decreases(imc_problem):
    X, Y, users, items, r = imc_problem
    m = _fit(X, Y, users, items, r, rank=4, reg=0.05, n_sweeps=5,
             cg_iters=30)
    h = m.history_
    assert all(h[i + 1] <= h[i] + 1e-3 for i in range(len(h) - 1))
    assert m.rmse((users, items, r)) < 0.2


def test_cold_start_generalization(imc_problem):
    X, Y, users, items, r = imc_problem
    train = users < 50          # users 50..59 never seen in training
    m = _fit(X, Y, users[train], items[train], r[train], rank=4, reg=0.05,
             n_sweeps=6, cg_iters=30)
    cold = ~train
    assert cold.sum() > 0
    rmse_cold = m.rmse((users[cold], items[cold], r[cold]))
    assert rmse_cold < np.std(r) * 0.7
    ref = RefIMC(rank=4, reg=0.05, n_sweeps=6, cg_iters=30).fit(
        (users[train], items[train], r[train]), X, Y)
    np.testing.assert_allclose(
        rmse_cold, ref.rmse((users[cold], items[cold], r[cold])),
        rtol=HISTORY_RTOL)


def test_imc_accepts_sparse_matrix(imc_problem):
    X, Y, users, items, r = imc_problem
    R = sp.csr_matrix((r, (users, items)), shape=(X.shape[0], Y.shape[0]))
    m = IMC(rank=4, n_sweeps=2, cg_iters=10, platform="cpu").fit(R, X, Y)
    assert np.isfinite(m.history_).all()
    _, items_rec = m.recommend([0, 1], n=5)
    assert items_rec.shape == (2, 5)
    ref = RefIMC(rank=4, n_sweeps=2, cg_iters=10).fit(R, X, Y)
    np.testing.assert_allclose(m.history_, ref.history_, rtol=HISTORY_RTOL)


@pytest.mark.parametrize("tol,cg_iters", [(1.0, 30), (2.0, 25)])
def test_imc_tol_early_stop_matches_reference(imc_problem, tol, cg_iters):
    """The no-readback path stops after the same sweep as the JAX
    package's device-side while_loop."""
    X, Y, users, items, r = imc_problem
    kw = dict(rank=4, reg=0.05, n_sweeps=30, tol=tol, cg_iters=cg_iters,
              seed=0)
    m = _fit(X, Y, users, items, r, **kw)
    ref = RefIMC(**kw).fit((users, items, r), X, Y)
    assert 2 <= len(m.history_) < 30
    assert len(m.history_) == len(ref.history_)
    assert abs(m.history_[-2] - m.history_[-1]) < tol
    np.testing.assert_allclose(m.history_, ref.history_, rtol=HISTORY_RTOL)


def test_imc_device_side_tol_matches_host_loop(imc_problem, capsys):
    X, Y, users, items, r = imc_problem
    kw = dict(rank=4, reg=0.05, n_sweeps=30, cg_iters=25, tol=2.0, seed=0)
    dev = _fit(X, Y, users, items, r, **kw)
    host = _fit(X, Y, users, items, r, verbose=1, **kw)
    assert "[IMC] sweep 2" in capsys.readouterr().out
    assert 2 <= len(dev.history_) < 30
    assert len(dev.history_) == len(host.history_)
    np.testing.assert_allclose(dev.history_, host.history_, rtol=1e-5)
    np.testing.assert_array_equal(dev.W_, host.W_)


def test_imc_layout_cache(imc_problem, tmp_path):
    X, Y, users, items, r = imc_problem
    prefix = str(tmp_path / "lay")
    m1 = _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=10,
              layout_cache=prefix)
    assert glob.glob(prefix + ".imc.*.user.npz")
    assert glob.glob(prefix + ".imc.*.item.npz")
    m2 = _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=10,
              layout_cache=prefix)            # loads from the cache
    np.testing.assert_array_equal(m1.W_, m2.W_)


def test_imc_layout_cache_invalidated_on_different_data(imc_problem,
                                                        tmp_path):
    X, Y, users, items, r = imc_problem
    prefix = str(tmp_path / "lay")
    _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15,
         layout_cache=prefix)
    n_before = len(glob.glob(prefix + "*.npz"))
    perm = np.random.default_rng(99).permutation(users.shape[0])[
        : users.shape[0] // 2]
    u2, i2, r2 = users[perm], items[perm], r[perm]
    m2 = _fit(X, Y, u2, i2, r2, rank=4, n_sweeps=2, cg_iters=15,
              layout_cache=prefix)
    assert len(glob.glob(prefix + "*.npz")) == 2 * n_before
    ref = _fit(X, Y, u2, i2, r2, rank=4, n_sweeps=2, cg_iters=15)
    np.testing.assert_allclose(m2.W_, ref.W_, rtol=1e-5, atol=1e-6)


def test_imc_layout_cache_invalidated_on_resized_tables(imc_problem,
                                                        tmp_path):
    X, Y, users, items, r = imc_problem
    prefix = str(tmp_path / "lay")
    _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15,
         layout_cache=prefix)
    n_before = len(glob.glob(prefix + "*.npz"))
    X2 = np.vstack([X, np.zeros((5, X.shape[1]), np.float32)])
    m2 = _fit(X2, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15,
              layout_cache=prefix)
    assert len(glob.glob(prefix + "*.npz")) == 2 * n_before
    ref = _fit(X2, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15)
    np.testing.assert_allclose(m2.W_, ref.W_, rtol=1e-5, atol=1e-6)


def test_imc_recommend_topk_path(imc_problem):
    X, Y, users, items, r = imc_problem
    m = _fit(X, Y, users, items, r, rank=4, reg=0.1, n_sweeps=3,
             cg_iters=20, seed=0)
    uq = np.unique(users)[:8]
    sc, it = m.recommend(uq, n=5, method="exact")
    s_ref = (X[uq] @ m.W_) @ (Y @ m.H_).T
    np.testing.assert_allclose(sc[:, 0], s_ref.max(1), rtol=1e-5)
    assert it.shape == (uq.shape[0], 5)
    _, it_ex = m.recommend(uq, n=5, exclude_seen=True, method="exact")
    for i, u in enumerate(uq):
        assert not set(it_ex[i].tolist()) & set(items[users == u].tolist())
    Xc = np.random.default_rng(0).standard_normal((3, X.shape[1])
                                                  ).astype(np.float32)
    sc_c, _ = m.recommend([0, 1, 2], n=4, X=Xc, exclude_seen=True,
                          method="exact")
    np.testing.assert_allclose(sc_c[:, 0],
                               ((Xc @ m.W_) @ (Y @ m.H_).T).max(1),
                               rtol=1e-5)
    assert m.top_n(int(uq[0]), 3).shape == (3,)
    np.testing.assert_allclose(m.predict_all(int(uq[0])), s_ref[0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("exclude_seen", [False, True])
def test_recommend_matches_reference_on_same_factors(imc_problem,
                                                     exclude_seen):
    """Both packages serving the same fitted factors: equal ids, scores
    within 1e-5 (exact selection on both sides)."""
    X, Y, users, items, r = imc_problem
    ref = RefIMC(rank=4, reg=0.1, n_sweeps=2, cg_iters=20).fit(
        (users, items, r), X, Y)
    m = _fit(X, Y, users, items, r, rank=4, reg=0.1, n_sweeps=2,
             cg_iters=20)
    m.W_, m.H_ = np.asarray(ref.W_), np.asarray(ref.H_)
    uq = np.arange(20)
    sc, it = m.recommend(uq, n=7, exclude_seen=exclude_seen,
                         method="exact")
    sc_r, it_r = ref.recommend(uq, n=7, exclude_seen=exclude_seen,
                               method="exact")
    np.testing.assert_array_equal(it, it_r)
    np.testing.assert_allclose(sc, sc_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.predict_all(3), ref.predict_all(3),
                               rtol=1e-5, atol=1e-6)


def test_imc_recommend_whale_batch_and_veff_cache():
    rng = np.random.default_rng(7)
    n_users, n_items = 40, 120
    X = rng.standard_normal((n_users, 8)).astype(np.float32)
    Y = rng.standard_normal((n_items, 6)).astype(np.float32)
    whale_items = np.arange(110)
    tail_u, tail_i = [], []
    for u in range(1, n_users):
        tail_u += [u] * 5
        tail_i += rng.choice(n_items, size=5, replace=False).tolist()
    users = np.concatenate([np.zeros(110, np.int32),
                            np.asarray(tail_u, np.int32)])
    items = np.concatenate([whale_items.astype(np.int32),
                            np.asarray(tail_i, np.int32)])
    ratings = rng.standard_normal(users.shape[0]).astype(np.float32)
    m = _fit(X, Y, users, items, ratings, rank=4, reg=0.1, n_sweeps=2,
             cg_iters=15, seed=0)
    uq = np.arange(6)
    sc, it = m.recommend(uq, n=8, exclude_seen=True, method="exact")
    for i, u in enumerate(uq):
        assert not set(it[i].tolist()) & set(items[users == u].tolist())
    s_ref = (X[[0]] @ m.W_) @ (Y @ m.H_).T
    s_ref[0, list(whale_items)] = -np.inf
    np.testing.assert_allclose(sc[0, 0], s_ref.max(), rtol=1e-5)

    assert m._veff_cache is not None
    cache_id = id(m._veff_cache)
    m.recommend(uq, n=4, method="exact")
    assert id(m._veff_cache) == cache_id
    Y2 = rng.standard_normal((50, 6)).astype(np.float32)
    m.recommend(uq, n=4, Y=Y2, method="exact")
    assert id(m._veff_cache) == cache_id
    m.fit((users, items, ratings), X, Y)
    assert m._veff_cache is None
    m.recommend(uq, n=4, method="exact")
    veff_old = np.asarray(m._veff_cache[2][0])
    m.H_ = np.ascontiguousarray(m.H_ * 2.0)
    m.recommend(uq, n=4, method="exact")
    np.testing.assert_allclose(np.asarray(m._veff_cache[2][0]),
                               veff_old * 2.0, rtol=1e-5)
    m.H_ *= 0.5                 # in place: the content key sees it
    m.recommend(uq, n=4, method="exact")
    np.testing.assert_allclose(np.asarray(m._veff_cache[2][0]), veff_old,
                               rtol=1e-5)


def test_predict_all_reads_the_catalog_order_copy(imc_problem):
    """predict_all uses the cached catalog-order projection beside the
    permuted device copy: no un-permute per call."""
    X, Y, users, items, r = imc_problem
    m = _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15)
    row = m.predict_all(2)
    dev, perm_back, perm_fwd, cat = m._veff_cache[2]
    np.testing.assert_array_equal(cat, m._Y @ m.H_)
    np.testing.assert_array_equal(dev.numpy(), cat[perm_back])
    np.testing.assert_array_equal(row, cat @ (m._X[2] @ m.W_))
    m.predict_all(5)
    assert m._veff_cache[2][3] is cat         # reused, not rebuilt


def test_fresh_catalog_exclusion_not_applied(imc_problem):
    X, Y, users, items, r = imc_problem
    m = _fit(X, Y, users, items, r, rank=4, reg=0.1, n_sweeps=2,
             cg_iters=15, seed=0)
    Ynew = np.random.default_rng(9).standard_normal(
        (30, Y.shape[1])).astype(np.float32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, it = m.recommend([0, 1], n=5, Y=Ynew, exclude_seen=True)
    assert any("fresh Y" in str(x.message) for x in rec)
    _, ref_i = m.recommend([0, 1], n=5, Y=Ynew, exclude_seen=False)
    np.testing.assert_array_equal(it, ref_i)


def test_failed_refit_keeps_serving_state_consistent(imc_problem):
    X, Y, users, items, r = imc_problem
    m = _fit(X, Y, users, items, r, rank=4, reg=0.1, n_sweeps=2,
             cg_iters=15, seed=0)
    before = (m._train_indptr.copy(), m._train_items.copy())
    bad_users = users.copy()
    bad_users[0] = 10_000
    with pytest.raises(ValueError, match="exceed feature rows"):
        m.fit((bad_users, items, r), X, Y)
    np.testing.assert_array_equal(m._train_indptr, before[0])
    np.testing.assert_array_equal(m._train_items, before[1])
    with pytest.raises(ValueError, match="non-negative"):
        m.fit((users, np.where(np.arange(items.size) == 0, -1, items), r),
              X, Y)


def test_resumed_predict_gives_guided_error(tmp_path, imc_problem):
    X, Y, users, items, r = imc_problem
    d = str(tmp_path / "ck")
    _fit(X, Y, users, items, r, rank=4, reg=0.1, n_sweeps=2, cg_iters=10,
         seed=0, checkpoint_dir=d, checkpoint_every=1)
    m = IMC(rank=4, platform="cpu")
    m.resume(d)
    with pytest.raises(RuntimeError, match="pass X and Y"):
        m.predict([0], [1])
    with pytest.raises(RuntimeError, match="pass X and Y"):
        m.predict_all(0)
    assert m.predict([0], [1], X=X, Y=Y).shape == (1,)


def test_imc_checkpoint_resume(imc_problem, tmp_path):
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y, seed=5)
    d = str(tmp_path / "ckpt")
    full = IMC(rank=4, reg=0.1, n_sweeps=4, cg_iters=20, platform="cpu",
               checkpoint_dir=d, checkpoint_every=2).fit(
        (users, items, r), X, Y, W0=W0, H0=H0)
    fresh = IMC(rank=4, reg=0.1, cg_iters=20, checkpoint_dir=d)
    assert fresh.resume() == 4
    np.testing.assert_array_equal(fresh.W_, full.W_)
    np.testing.assert_array_equal(fresh.H_, full.H_)
    np.testing.assert_allclose(fresh.history_, full.history_, rtol=1e-6)
    # a fit without checkpoints takes the no-readback path: same factors
    plain = _fit(X, Y, users, items, r, W0, H0, rank=4, reg=0.1,
                 n_sweeps=4, cg_iters=20)
    np.testing.assert_array_equal(plain.W_, full.W_)
    # 2 sweeps from the step-2 checkpoint continue to the 4-sweep state
    from recommendation_models_tpu_torch.utils.checkpoint import (
        load_checkpoint)
    st = load_checkpoint(d, 2)
    assert st["metadata"]["rank"] == 4
    cont = _fit(X, Y, users, items, r, st["W"], st["H"], rank=4, reg=0.1,
                n_sweeps=2, cg_iters=20)
    np.testing.assert_allclose(cont.W_, full.W_, rtol=1e-4, atol=1e-5)


def test_imc_resumed_recommend_behavior(imc_problem, tmp_path):
    X, Y, users, items, r = imc_problem
    _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=15,
         checkpoint_dir=str(tmp_path), checkpoint_every=1)
    m2 = IMC(rank=4, checkpoint_dir=str(tmp_path), platform="cpu")
    m2.resume()
    with pytest.raises(RuntimeError, match="feature matrices"):
        m2.recommend([0], n=3)
    with pytest.warns(UserWarning, match="exclude_seen"):
        m2.recommend([0], n=3, X=X, Y=Y, exclude_seen=True)


def test_resume_drops_previous_fit_serving_state(imc_problem, tmp_path):
    """A resumed estimator serves the checkpoint's factors only: the
    previous fit's features, training lists and catalog are gone."""
    X, Y, users, items, r = imc_problem
    d = str(tmp_path / "ck")
    _fit(X, Y, users, items, r, rank=4, n_sweeps=2, cg_iters=10,
         checkpoint_dir=d, checkpoint_every=1)
    m = _fit(X[:30], Y, users[users < 30], items[users < 30],
             r[users < 30], rank=4, n_sweeps=2, cg_iters=10)
    m.recommend([0], n=3)
    m.resume(d)
    for key in ("_X", "_Y", "_train_indptr", "_train_items"):
        assert not hasattr(m, key)
    assert m._veff_cache is None
    with pytest.warns(UserWarning, match="canNOT be excluded"):
        m.recommend([0], n=3, X=X, Y=Y, exclude_seen=True)


# ------------------------------------------------------- estimator API

def test_get_params_clone_pickle_and_aliases(imc_problem):
    from sklearn.base import clone
    X, Y, users, items, r = imc_problem
    for kw in ({}, dict(rank=7, reg=0.2, tol=0.5, checkpoint_every=3,
                        lambda_=0.2, max_iter=4, platform="cpu")):
        assert IMC(**kw).get_params() == RefIMC(**kw).get_params()
    c = clone(IMC(rank=5, reg=0.7, lambda_=0.7))
    assert (c.rank, c.reg, c.lambda_) == (5, 0.7, 0.7)
    W0, H0 = _warm(X, Y)
    a = _fit(X, Y, users, items, r, W0, H0, rank=4, lambda_=0.3,
             max_iter=2, cg_iters=15)
    b = _fit(X, Y, users, items, r, W0, H0, rank=4, reg=0.3, n_sweeps=2,
             cg_iters=15)
    np.testing.assert_array_equal(a.W_, b.W_)
    with pytest.raises(ValueError, match="only one"):
        _fit(X, Y, users, items, r, rank=4, reg=0.1, lambda_=0.5)
    with pytest.raises(ValueError, match="rank"):
        _fit(X, Y, users, items, r, rank=0)
    with pytest.raises(RuntimeError, match="not fitted"):
        IMC().predict([0], [0])
    _, served = a.recommend([0, 3], n=4)
    back = pickle.loads(pickle.dumps(a))
    assert "_veff_cache" not in back.__dict__
    np.testing.assert_array_equal(back.recommend([0, 3], n=4)[1], served)
    np.testing.assert_array_equal(back.predict([1], [2]), a.predict([1], [2]))


def test_fit_without_platform_raises_without_card(imc_problem, monkeypatch):
    X, Y, users, items, r = imc_problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = IMC(rank=4, n_sweeps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.fit((users, items, r), X, Y)


# ------------------------------------------------------------ the card

@pytest.mark.gpu
def test_imc_on_the_card_matches_the_cpu(imc_problem):
    """The fixture's fit on the card (platform=None) against the same fit
    on the CPU: history within HISTORY_RTOL, factors within 1e-3 of their
    largest entry, the projected catalog on the card, and the ids served
    to every user equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, Y, users, items, r = imc_problem
    W0, H0 = _warm(X, Y)
    cfg = dict(rank=4, reg=0.1, n_sweeps=3, cg_iters=50, seed=0)
    card = IMC(**cfg).fit((users, items, r), X, Y, W0=W0, H0=H0)
    cpu = IMC(platform="cpu", **cfg).fit((users, items, r), X, Y, W0=W0,
                                         H0=H0)
    np.testing.assert_allclose(card.history_, cpu.history_,
                               rtol=HISTORY_RTOL)
    for a, b in ((card.W_, cpu.W_), (card.H_, cpu.H_)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=HISTORY_RTOL * np.abs(b).max())
    uq = np.arange(X.shape[0])
    _, it = card.recommend(uq, n=5, exclude_seen=True, method="exact")
    assert card._veff_cache[2][0].is_cuda
    card.W_, card.H_ = cpu.W_, cpu.H_
    _, it_card = card.recommend(uq, n=5, exclude_seen=True, method="exact")
    _, it_cpu = cpu.recommend(uq, n=5, exclude_seen=True, method="exact")
    np.testing.assert_array_equal(it_card, it_cpu)
    assert it.shape == (X.shape[0], 5)
