"""The port's IMC fit against the benchmark's plain reference
(``benchmark/references/imc.py``, float64) on the CPU, and the fit's spans
and counters.

The problem: seeded Gaussian features with a third of the item rows zero
(items with no features), a seeded warm start, rank 8, 20 CG steps, 3
sweeps. The tolerances come from the gaps float32 rounding leaves (the
port's, and the reference's own run in float32): the history within
HISTORY_RTOL and the factors' rows within FACTOR_TOL, each a few times the
widest gap measured. One CG step fewer in the port must leave them."""

import numpy as np
import pytest
import torch

from benchmark.references import imc as ref
from recommendation_models_tpu_torch.models.imc import IMC, cg_matvec_count
from recommendation_models_tpu_torch.solver.als_sweep import device_buckets
from recommendation_models_tpu_torch.utils import profiling

torch.set_num_threads(2)
N_USERS, N_ITEMS, D_USER, D_ITEM = 400, 150, 24, 20
RANK, REG, CG_ITERS, SWEEPS = 8, 0.1, 20, 3
# gaps measured against the float64 reference: the port 5.5e-8 in the
# history and 3.0e-5 in the factor rows, the reference in float32 3.6e-8
# and 2.0e-5; one CG step fewer in the port 4.4e-5 and 0.042. Each
# tolerance sits about ten times above rounding and far below the fault.
HISTORY_RTOL = 1e-6
FACTOR_TOL = 3e-4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(26)
    key = np.unique(rng.integers(0, N_USERS * N_ITEMS, 5000))
    users, items = key // N_ITEMS, key % N_ITEMS
    r = (rng.integers(1, 11, users.shape[0]) / 2).astype(np.float32)
    X = rng.standard_normal((N_USERS, D_USER)).astype(np.float32)
    Y = rng.standard_normal((N_ITEMS, D_ITEM)).astype(np.float32)
    Y[rng.random(N_ITEMS) < 1 / 3] = 0.0
    W0 = (0.1 * rng.standard_normal((D_USER, RANK))).astype(np.float32)
    H0 = (0.1 * rng.standard_normal((D_ITEM, RANK))).astype(np.float32)
    return (users.astype(np.int32), items.astype(np.int32), r, X, Y, W0,
            H0)


@pytest.fixture(scope="module")
def reference(problem):
    u, i, r, X, Y, W0, H0 = (torch.from_numpy(a) for a in problem)
    W, H, hist = ref.fit(u.long(), i.long(), r, X, Y, W0, H0, REG, CG_ITERS,
                         SWEEPS)
    return np.asarray(hist), W.numpy(), H.numpy()


def port_fit(problem, cg_iters):
    u, i, r, X, Y, W0, H0 = problem
    m = IMC(rank=RANK, reg=REG, n_sweeps=SWEEPS, cg_iters=cg_iters,
            platform="cpu").fit((u, i, r), X, Y, W0=W0, H0=H0)
    return np.asarray(m.history_), m.W_, m.H_


def row_gap(P, R):
    """max over rows of ‖P_r − R_r‖ / max(‖R_r‖, median_r ‖R_r‖)."""
    n = np.linalg.norm(R, axis=1)
    return float(np.max(np.linalg.norm(P - R, axis=1)
                        / np.maximum(n, np.median(n))))


def gaps(got, want):
    hist = float(np.max(np.abs(got[0] - want[0]) / want[0]))
    return hist, max(row_gap(got[1], want[1]), row_gap(got[2], want[2]))


@pytest.mark.parametrize("port_iters", [CG_ITERS, CG_ITERS - 1],
                         ids=["same_steps", "one_step_fewer"])
def test_the_port_fit_against_the_plain_reference(problem, reference,
                                                  port_iters):
    hist, factor = gaps(port_fit(problem, port_iters), reference)
    if port_iters == CG_ITERS:
        assert hist <= HISTORY_RTOL and factor <= FACTOR_TOL, (hist, factor)
    else:
        assert hist > HISTORY_RTOL and factor > FACTOR_TOL, (hist, factor)


def test_the_reference_in_float32_keeps_inside_the_tolerances(problem,
                                                              reference):
    u, i, r, X, Y, W0, H0 = (torch.from_numpy(a) for a in problem)
    W, H, hist = ref.fit(u.long(), i.long(), r, X, Y, W0, H0, REG, CG_ITERS,
                         SWEEPS, dtype=torch.float32)
    h, f = gaps((np.asarray(hist), W.double().numpy(), H.double().numpy()),
                reference)
    assert h <= HISTORY_RTOL and f <= FACTOR_TOL, (h, f)


# -- spans and counters -------------------------------------------------------

@pytest.fixture
def fresh():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("profiled", [False, True])
def test_an_imc_fit_records_its_sweeps_cg_passes_and_gathers(problem, fresh,
                                                             profiled):
    from torch.profiler import ProfilerActivity, profile
    u, i, r, X, Y, W0, H0 = problem
    est = IMC(rank=RANK, reg=REG, n_sweeps=SWEEPS, cg_iters=CG_ITERS,
              platform="cpu")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            est.fit((u, i, r), X, Y, W0=W0, H0=H0)
    else:
        est.fit((u, i, r), X, Y, W0=W0, H0=H0)
    s = fresh.summary()
    count = {k: v["count"] for k, v in s["spans"].items()}
    assert count["imc.fit"] == 1 and count["imc.sweep"] == SWEEPS
    assert count["imc.half_sweep"] == 2 * SWEEPS
    for name in ("imc.grams", "imc.cg"):
        assert count.get(name, 0) == (2 * SWEEPS if profiled else 0)
    # each half-step: the CG's passes and the objective's one
    assert s["counters"]["imc.cg_matvecs"] == 2 * SWEEPS * (
        cg_matvec_count(CG_ITERS) + 1)
    # every rating sits in a gather bucket of each orientation, walked
    # once a half-step
    ul, il = est._build_layouts(u, i, r, N_USERS, N_ITEMS,
                                est._data_config())
    slots = sum(int(b["indices"].numel()) for lay in (ul, il)
                for b in device_buckets(lay, 1, "cpu"))
    assert s["counters"]["imc.gather_slots"] == SWEEPS * slots
    assert s["counters"]["imc.gather_ratings"] == 2 * SWEEPS * u.shape[0]
    recs = fresh.recent()
    by = {rec.id: rec for rec in recs}
    (fit,) = [rec for rec in recs if rec.name == "imc.fit"]
    assert fit.call == fit.id
    assert all(rec.call == fit.id for rec in recs
               if rec.name.startswith("imc."))
    for rec in recs:
        if rec.name in ("imc.grams", "imc.cg"):
            assert by[rec.parent].name == "imc.half_sweep"
        if rec.name == "imc.half_sweep":
            assert by[rec.parent].name == "imc.sweep"
