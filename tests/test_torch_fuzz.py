"""Randomized differential fuzz of the port's estimator: the counterpart of
tests/test_fuzz.py::test_fuzz_als_smoke.

Trial t draws what scripts/fuzz_parity.py::one_trial draws from
``default_rng(0)``, in the same order (shape, density, rank, objective,
reg-by-degree, shard count, bucket policy, hot/dense blocks, chunk, gather
budget, ratings, warm start, and the exchange when more than one shard was
drawn), so trial t is that script's trial t. The port runs one shard
whatever was drawn (sharding is ROADMAP Queue 1 item 13), on the CPU, with
``sse_mode="separate"``: the riding-SSE identity loses near-interpolation
fits to f32 cancellation in both packages (ROADMAP Queue 3). Each trial
checks, as the script does: the 3-sweep history against ``OracleALS``, the
one-sweep factors against it, and exact serving with and without
exclusion; and, against the JAX estimator, the one-sweep factors and the
served ids on the same factors."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu.oracle.als_numpy import OracleALS
from recommendation_models_tpu_torch import ALS

torch.set_num_threads(2)
N_TRIALS = 8


def _draw(rng, trial):
    n_users = int(rng.integers(3, 120))
    n_items = int(rng.integers(3, 100))
    density = float(rng.uniform(0.02, 0.6))
    rank = int(rng.integers(1, 13))
    alpha = None if rng.random() < 0.5 else float(rng.uniform(0.1, 20))
    reg = float(rng.uniform(0.01, 2.0))
    rbd = bool(rng.random() < 0.3)
    n_shards = int(rng.choice([1, 1, 1, 2, 4, 8]))
    cfg = dict(
        rank=rank, reg=reg, alpha=alpha, reg_by_degree=rbd,
        min_bucket=int(rng.choice([8, 8, 16])),
        max_bucket=int(rng.choice([32, 64, 4096])),
        bucket_growth=float(rng.choice([1.12, 1.25, 2.0])),
        hot_cols=int(rng.choice([0, 0, 8, 32])),
        dense_min_degree=int(rng.choice([8, 24, 512])),
        chunk=int(rng.choice([16, 512])),
        gather_budget_mb=int(rng.choice([0, 1, 64])),
        seed=trial,
    )
    mask = rng.random((n_users, n_items)) < density
    mask[int(rng.integers(n_users)), int(rng.integers(n_items))] = True
    R = np.where(mask, rng.integers(1, 11, mask.shape) / 2.0, 0.0
                 ).astype(np.float32)
    U0 = (0.1 * rng.standard_normal((n_users, rank))).astype(np.float32)
    V0 = (0.1 * rng.standard_normal((n_items, rank))).astype(np.float32)
    if n_shards > 1:
        rng.choice(["allgather", "all_to_all"])   # the script's exchange
    tag = (f"trial {trial}: {n_users}x{n_items} d={density:.2f} {cfg} "
           f"(drawn shards={n_shards}, run on 1)")
    return cfg, sp.csr_matrix(R), U0, V0, tag


@functools.lru_cache(maxsize=1)
def _trials():
    rng = np.random.default_rng(0)
    return [_draw(rng, t) for t in range(N_TRIALS)]


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_fuzz_als_against_oracle_and_reference(trial):
    cfg, Rs, U0, V0, tag = _trials()[trial]
    n_users, n_items = Rs.shape
    oracle_kw = dict(rank=cfg["rank"], reg=cfg["reg"], alpha=cfg["alpha"],
                     reg_by_degree=cfg["reg_by_degree"])
    o = OracleALS(n_sweeps=3, **oracle_kw).fit(Rs, U0=U0, V0=V0)
    m = ALS(n_sweeps=3, platform="cpu", sse_mode="separate", **cfg).fit(
        Rs, U0=U0, V0=V0)
    hist_o, hist_m = np.asarray(o.history_), np.asarray(m.history_)
    dh = np.abs(hist_o - hist_m).max() / max(hist_o[-1], 1e-3)
    assert dh < 5e-2, f"history diverged ({dh:.3e})\n{tag}\n{hist_o}\n{hist_m}"
    assert np.isfinite(m.U_).all() and np.isfinite(m.V_).all(), tag

    # one sweep: the oracle (f64), and the JAX estimator (same f32 math)
    scale = max(np.abs(o.U_).max(), 1.0)
    o1 = OracleALS(n_sweeps=1, **oracle_kw).fit(Rs, U0=U0, V0=V0)
    m1 = ALS(n_sweeps=1, platform="cpu", **cfg).fit(Rs, U0=U0, V0=V0)
    du = np.abs(m1.U_ - o1.U_).max() / scale
    assert du < 5e-3, f"1-sweep U diverged ({du:.3e})\n{tag}"
    r1 = RefALS(n_sweeps=1, platform="cpu", **cfg).fit(Rs, U0=U0, V0=V0)
    for a, b in ((m1.U_, r1.U_), (m1.V_, r1.V_)):
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=3e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=tag)

    # serving on the fitted model: exact top-k, both exclusion modes
    uq = np.arange(min(n_users, 5))
    nq = min(4, n_items)
    sc, _ = m.recommend(uq, n=nq, exclude_seen=False, method="exact")
    s_ref = m.U_[uq] @ m.V_.T
    np.testing.assert_allclose(sc[:, 0], s_ref.max(1), rtol=1e-4, atol=1e-5,
                               err_msg=tag)
    sc_x, it_x = m.recommend(uq, n=nq, exclude_seen=True, method="exact")
    s_excl = s_ref.copy()
    for i, u in enumerate(uq):
        s_excl[i, Rs[u].indices] = -np.inf
    np.testing.assert_allclose(sc_x[:, 0], s_excl.max(1), rtol=1e-4,
                               atol=1e-5, err_msg=tag)

    # the same factors served by both packages: the same ids
    carried = ALS.from_reference_state(
        dict(U_=r1.U_, V_=r1.V_, n_users_=n_users, n_items_=n_items,
             history_=r1.history_,
             params=dict(r1.get_params(), platform="cpu")),
        train_indptr=Rs.indptr, train_indices=Rs.indices)
    for excl in (False, True):
        got = carried.recommend(uq, n=nq, exclude_seen=excl, method="exact")
        want = r1.recommend(uq, n=nq, exclude_seen=excl, method="exact")
        np.testing.assert_array_equal(got[1], want[1], err_msg=tag)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6,
                                   err_msg=tag)
