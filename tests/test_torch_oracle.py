"""The port's NumPy oracles (``oracle/``) against the JAX package's: the same
inputs give bitwise equal factors, histories and answers. That they load by
file path without torch or JAX is checked in tests/test_torch_import.py."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu.oracle import als_numpy as ref_als
from recommendation_models_tpu.oracle import imc_numpy as ref_imc
from recommendation_models_tpu_torch.oracle import OracleALS, OracleIMC
from recommendation_models_tpu_torch.oracle import imc_numpy as port_imc

torch.set_num_threads(2)


def _ratings(n_users=40, n_items=30, n_obs=400, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_obs)
    i = rng.integers(0, n_items, n_obs)
    r = (rng.integers(1, 11, n_obs) / 2.0).astype(np.float32)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    R.sum_duplicates()
    return R


@pytest.mark.parametrize("kwargs", [
    dict(rank=5, reg=0.1),
    dict(rank=4, reg=0.05, alpha=2.0),
    dict(rank=3, reg=0.2, reg_by_degree=True, seed=3),
])
def test_oracle_als_bitwise(kwargs):
    R = _ratings()
    got = OracleALS(n_sweeps=3, **kwargs).fit(R)
    want = ref_als.OracleALS(n_sweeps=3, **kwargs).fit(R)
    for name in ("U_", "V_"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.history_ == want.history_
    assert got.score(R) == want.score(R)
    np.testing.assert_array_equal(got.top_n(2, 5, exclude=np.array([0, 1])),
                                  want.top_n(2, 5, exclude=np.array([0, 1])))
    np.testing.assert_array_equal(
        got.half_sweep(R, want.V_), want.half_sweep(R, want.V_))


def test_oracle_als_warm_start_bitwise():
    R = _ratings(seed=1)
    rng = np.random.default_rng(1)
    U0 = rng.standard_normal((40, 4)).astype(np.float32)
    V0 = rng.standard_normal((30, 4)).astype(np.float32)
    got = OracleALS(rank=4).fit(R, U0=U0, V0=V0, n_sweeps=2)
    want = ref_als.OracleALS(rank=4).fit(R, U0=U0, V0=V0, n_sweeps=2)
    np.testing.assert_array_equal(got.U_, want.U_)
    assert got.history_ == want.history_


def test_oracle_imc_bitwise():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((25, 6))
    Y = rng.standard_normal((20, 5))
    users = rng.integers(0, 25, 300)
    items = rng.integers(0, 20, 300)
    r = rng.standard_normal(300)
    got = OracleIMC(rank=3, n_sweeps=3, cg_iters=20).fit(users, items, r,
                                                         X, Y)
    want = ref_imc.OracleIMC(rank=3, n_sweeps=3, cg_iters=20).fit(
        users, items, r, X, Y)
    np.testing.assert_array_equal(got.W_, want.W_)
    np.testing.assert_array_equal(got.H_, want.H_)
    assert got.history_ == want.history_
    assert got.rmse(users, items, r, X, Y) == want.rmse(users, items, r,
                                                        X, Y)
    W0, H0 = want.W_ * 0.5, want.H_ * 0.5
    np.testing.assert_array_equal(
        OracleIMC(rank=3, n_sweeps=1).fit(users, items, r, X, Y, W0=W0,
                                          H0=H0).W_,
        ref_imc.OracleIMC(rank=3, n_sweeps=1).fit(users, items, r, X, Y,
                                                  W0=W0, H0=H0).W_)


def test_cg_bitwise():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((12, 12))
    A = A @ A.T + np.eye(12)
    b = rng.standard_normal(12)
    x0 = np.zeros(12)
    np.testing.assert_array_equal(
        port_imc._cg(lambda v: A @ v, b, x0, iters=8),
        ref_imc._cg(lambda v: A @ v, b, x0, iters=8))


def test_imc_probe_baseline_runs_the_port_oracle(monkeypatch):
    """``probes/imc.py``'s ``vs_baseline`` divides by the obs/s of one sweep
    of the port's ``OracleIMC`` on a subsample, as ``bench.py::imc_bench``
    does with the JAX package's."""
    from recommendation_models_tpu_torch.probes import imc as pi
    calls = []
    real_fit = OracleIMC.fit

    def fit(self, users, items, *args, **kwargs):
        calls.append((self.n_sweeps, self.cg_iters, users.shape[0]))
        return real_fit(self, users, items, *args, **kwargs)
    monkeypatch.setattr(OracleIMC, "fit", fit)
    monkeypatch.setattr(pi, "ORACLE_OBS", 500)
    X, Y, users, items, ratings, cold = pi.imc_data("ml100k")
    rate = pi.oracle_obs_per_sec((X, Y, users, items, ratings, cold))
    assert calls == [(1, pi.CG_ITERS, 500)] and rate > 0
