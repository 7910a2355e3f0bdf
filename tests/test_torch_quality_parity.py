"""The quality-parity probes' protocols (``probes/quality_parity.py``,
``probes/quality_parity_imc.py``) in both packages at one seed, held as the
JAX package's tests hold its own: tests/test_integration.py (per seed, the
explicit test RMSE within max(1e-3, 0.1 x the oracle's band) of the
oracle's, which at one seed is 1e-3, and recall@10 and NDCG@10 within 0.01)
and tests/test_imc.py (the history and the predictions within rtol 2e-2 of
the oracle's). The ALS protocol runs at its ML-100K shape; the IMC one at
its feature widths (64, 48) and rank on a tenth of ML-1M's users and items
and 40,000 observations, so that the oracle's CG fits take seconds. The
two packages' oracles, the same NumPy code, agree to float64 rounding."""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.probes import quality_parity as qp
from recommendation_models_tpu_torch.probes import quality_parity_imc as qi

torch.set_num_threads(2)
SEED = 0
IMC_SHAPE = (604, 371, 64, 48, 40_000)


@pytest.fixture(scope="module")
def als_data():
    return qp.split()


def test_als_probe_protocol_on_the_port():
    out = qp.run((SEED,), platform="cpu")
    assert qp.check(out) == []
    line = qp.rounded(out)
    assert set(line) == set(qp.METRICS)
    assert all(len(v) == 1 for m in qp.METRICS for v in line[m].values())


def test_als_probe_protocol_in_the_jax_package(als_data):
    """The script's protocol through the JAX package (its ``ALS`` on the
    CPU and its oracle) beside the port's oracle and estimator."""
    from recommendation_models_tpu import ALS
    from recommendation_models_tpu.oracle.als_numpy import OracleALS
    train, cen, test, mu, eval_users, rel_eval = als_data
    port_o = qp.oracle_seed(SEED, als_data)
    port_e = qp.estimator_seed(port_o, "cpu", als_data)
    o = OracleALS(seed=SEED, **qp.EXPLICIT)
    U0, V0 = o.init_factors(qp.N_USERS, qp.N_ITEMS)
    o.fit(cen, U0=U0, V0=V0)
    m = ALS(**qp.EXPLICIT).fit(cen, U0=U0, V0=V0)
    ref = {"explicit_rmse": (qp.test_rmse(o.U_, o.V_, test, mu),
                             qp.test_rmse(m.U_, m.V_, test, mu))}
    oi = OracleALS(seed=SEED, **qp.IMPLICIT)
    U0, V0 = oi.init_factors(qp.N_USERS, qp.N_ITEMS)
    oi.fit(train, U0=U0, V0=V0)
    topk_o = np.stack([oi.top_n(u, qp.K, exclude=train[u].indices)
                       for u in eval_users])
    mi = ALS(**qp.IMPLICIT).fit(train, U0=U0, V0=V0)
    _, topk_t = mi.recommend(eval_users, n=qp.K, exclude_seen=True)
    (ro, no), (rt, nt) = (qp._ranking(t, rel_eval) for t in (topk_o, topk_t))
    ref["recall_at_10"], ref["ndcg_at_10"] = (ro, rt), (no, nt)
    for metric, tol in (("explicit_rmse", 1e-3), ("recall_at_10", 0.01),
                        ("ndcg_at_10", 0.01)):
        jax_oracle, jax_als = ref[metric]
        # the JAX package against its oracle, as its own test holds it
        assert abs(jax_als - jax_oracle) <= tol, (metric, ref[metric])
        # the two oracles are one NumPy algorithm
        assert port_o[metric] == pytest.approx(jax_oracle, rel=1e-9,
                                               abs=1e-12), metric
        # the port against the oracle and against the JAX package
        assert abs(port_e[metric] - jax_oracle) <= tol, metric
        assert abs(port_e[metric] - jax_als) <= tol, metric


@pytest.fixture(scope="module")
def imc_data():
    return qi.problem(IMC_SHAPE)


def test_imc_probe_protocol_on_the_port(imc_data):
    out = qi.run((SEED,), platform="cpu", data=imc_data)
    assert qi.check(out) == []
    assert out["history_rel_diff"][0] <= qi.RTOL
    line = qi.rounded(out)
    assert set(qi.METRICS) <= set(line)


def test_imc_probe_protocol_in_the_jax_package(imc_data):
    """The script's IMC protocol through the JAX package's ``IMC`` (CPU)
    and its oracle, beside the port's side of the same seed."""
    from recommendation_models_tpu import IMC
    from recommendation_models_tpu.oracle.imc_numpy import OracleIMC
    X, Y, users, items, ratings, train, test, cold = imc_data
    W0, H0 = qi.warm(SEED, X, Y)
    o = OracleIMC(rank=qi.RANK, reg=qi.REG, n_sweeps=qi.SWEEPS,
                  cg_iters=qi.CG)
    o.fit(users[train], items[train], ratings[train], X, Y, W0=W0, H0=H0)
    m = IMC(rank=qi.RANK, reg=qi.REG, n_sweeps=qi.SWEEPS, cg_iters=qi.CG,
            platform="cpu").fit((users[train], items[train],
                                 ratings[train]), X, Y, W0=W0, H0=H0)
    X64, Y64 = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    pred_o = o.predict(users[test], items[test], X64, Y64)
    # tests/test_imc.py's oracle parity, for the JAX package
    np.testing.assert_allclose(m.predict(users[test], items[test]), pred_o,
                               rtol=qi.RTOL, atol=qi.ATOL)
    np.testing.assert_allclose(m.history_, o.history_, rtol=qi.RTOL)
    # the port's oracle is the same algorithm; its estimator holds to both
    port_o = qi.oracle_seed(SEED, imc_data)
    np.testing.assert_allclose(port_o["history"], o.history_, rtol=1e-9)
    port_e = qi.estimator_seed(SEED, imc_data, "cpu")
    pm = port_e["model"].predict(users[test], items[test])
    np.testing.assert_allclose(pm, pred_o, rtol=qi.RTOL, atol=qi.ATOL)
    np.testing.assert_allclose(port_e["history"], o.history_, rtol=qi.RTOL)
    np.testing.assert_allclose(port_e["history"], m.history_, rtol=qi.RTOL)


def test_imc_oracle_file_round_trip(imc_data, tmp_path):
    """``--oracle-only``'s file (``save_oracles``) gives ``run`` the same
    oracle side as fitting it in the process."""
    oracles = {SEED: qi.oracle_seed(SEED, imc_data)}
    path = str(tmp_path / "oracle.npz")
    qi.save_oracles(path, oracles)
    loaded = qi.load_oracles(path)
    assert set(loaded) == {SEED}
    for key in ("W", "H", "history"):
        np.testing.assert_array_equal(loaded[SEED][key], oracles[SEED][key])
    a = qi.run((SEED,), "cpu", oracles=loaded, data=imc_data)
    b = qi.run((SEED,), "cpu", data=imc_data)
    assert a == b


def test_probes_refuse_without_a_card(capsys):
    assert qp.main([]) == 2
    assert qi.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        qi.main(["--oracle-only"])


def test_imc_gate_holds_the_first_sweep_to_the_f32_history():
    """At ML-1M shape the first sweep is held to the JAX package's f32
    history (``JAX_HISTORY``) and every later sweep to the oracle's; with
    no such history every sweep is held to the oracle's."""
    first = qi.JAX_HISTORY[0][0]
    out = {"seeds": [0], "history": [[first * 1.001, 3300.0]],
           "history_rel_diff": [0.048], "later_rel_diff": [0.004],
           "pred_rel_excess": [0.2]}
    assert qi.check(out, qi.JAX_HISTORY) == []
    assert len(qi.check(out)) == 1
    out["history"][0][0] = first * 1.03
    assert len(qi.check(out, qi.JAX_HISTORY)) == 1
    out["later_rel_diff"], out["pred_rel_excess"] = [0.03], [1.5]
    assert len(qi.check(out)) == 2
