"""The port's sweep against the reference's: grams, the dense block, one
half-sweep with hot columns and a dense block (the reference's Pallas
kernels in interpret mode), the SSE passes and the scanned fit."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import recommendation_models_tpu.config as rc
import recommendation_models_tpu_torch.config as pc
from recommendation_models_tpu.data.layout import layout_from_coo as r_layout
from recommendation_models_tpu.ops import gram as rgram
from recommendation_models_tpu.solver import als_sweep as rsw
from recommendation_models_tpu_torch.data.layout import (
    layout_from_coo as p_layout,
)
from recommendation_models_tpu_torch.ops import cholesky as pchol
from recommendation_models_tpu_torch.ops import gram as pgram
from recommendation_models_tpu_torch.solver import als_sweep as psw

torch.set_num_threads(2)

N_USERS, N_ITEMS = 120, 90
# a hot block (16 Zipf-head columns) and a dense block (rows of degree > 20)
HOT_DENSE = dict(hot_cols=16, hot_min_count=5, dense_min_degree=20,
                 bucket_growth=1.12)


def _skewed(seed=7, n_obs=3000):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, n_obs)
    pop = np.arange(1, N_ITEMS + 1) ** -1.0
    pop /= pop.sum()
    items = rng.choice(N_ITEMS, size=n_obs, p=pop)
    uniq = np.unique(users * N_ITEMS + items)
    users, items = (uniq // N_ITEMS).astype(np.int64), uniq % N_ITEMS
    vals = (rng.integers(1, 11, uniq.shape[0]) * 0.5).astype(np.float32)
    return users, items, vals


def _both_buckets(cfg, k, transpose=False, seed=7):
    u, i, v = _skewed(seed)
    rl = r_layout(u, i, v, N_USERS, N_ITEMS, rc.DataConfig(**cfg),
                  transpose=transpose)
    pl_ = p_layout(u, i, v, N_USERS, N_ITEMS, pc.DataConfig(**cfg),
                   transpose=transpose)
    from recommendation_models_tpu.ops.pallas.cholesky import block_batch
    return (rsw.device_buckets(rl, block_batch(k)),
            psw.device_buckets(pl_, pchol.block_batch(k), "cpu"), rl)


def _scfg(mod, **kw):
    return mod.SolveConfig(**kw)


@pytest.mark.parametrize("alpha", [None, 10.0])
def test_half_sweep_matches_reference_pallas(alpha):
    """One half-sweep with hot columns and a dense block: the reference with
    solver='pallas' (both Pallas kernels, interpret mode) vs the port."""
    k = 8
    for transpose in (False, True):
        rb, pb, lay = _both_buckets(HOT_DENSE, k, transpose)
        assert lay.hot_ids is not None and lay.dense_ids is not None
        n_rows, n_cols = lay.n_rows, lay.n_cols
        V = np.random.default_rng(1).standard_normal((n_cols, k)
                                                     ).astype(np.float32)
        kw = dict(rank=k, reg=0.1, alpha=alpha, solver="pallas",
                  compute_dtype="float32")
        ref = rsw.half_sweep(jnp.asarray(V), rb, n_rows,
                             _scfg(rc, **kw), with_sse=alpha is None)
        got = psw.half_sweep(torch.from_numpy(V), pb, n_rows,
                             _scfg(pc, **kw), with_sse=alpha is None)
        if alpha is None:
            (ref, rsse), (got, gsse) = ref, got
            np.testing.assert_allclose(float(gsse), float(rsse), rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reg_by_degree,reg", [(True, 0.05), (False, 0.0)])
def test_half_sweep_ridge_variants_match_reference(reg_by_degree, reg):
    """Weighted-lambda ridge and the reg=0 floor (empty and padding rows
    solve to exactly 0), against the reference's XLA path."""
    k = 6
    rb, pb, lay = _both_buckets(HOT_DENSE, k)
    V = np.random.default_rng(2).standard_normal((N_ITEMS, k)
                                                 ).astype(np.float32)
    kw = dict(rank=k, reg=reg, reg_by_degree=reg_by_degree, solver="xla",
              compute_dtype="float32")
    ref = np.asarray(rsw.half_sweep(jnp.asarray(V), rb, N_USERS,
                                    _scfg(rc, **kw)))
    for solver in ("auto", "xla"):
        kw["solver"] = solver
        got = psw.half_sweep(torch.from_numpy(V), pb, N_USERS,
                             _scfg(pc, **kw)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("init", [False, True])
def test_gram_rhs_matches_reference(rng, init):
    b, p, n, k = 6, 37, 30, 5
    V = rng.standard_normal((n, k)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, p)).astype(np.int32)
    wg = (rng.random((b, p)) < 0.7).astype(np.float32)
    wr = wg * rng.uniform(1, 5, size=(b, p)).astype(np.float32)
    G0 = rng.standard_normal((k, k, b)).astype(np.float32)
    r0 = rng.standard_normal((k, b)).astype(np.float32)
    kw = dict(chunk=8)
    rinit = (jnp.asarray(G0), jnp.asarray(r0)) if init else None
    pinit = (torch.from_numpy(G0), torch.from_numpy(r0)) if init else None
    Gr, rr = rgram.gram_rhs_t(jnp.asarray(V), jnp.asarray(idx),
                              jnp.asarray(wg), jnp.asarray(wr), init=rinit,
                              **kw)
    Gp, rp = pgram.gram_rhs_t(torch.from_numpy(V), torch.from_numpy(idx),
                              torch.from_numpy(wg), torch.from_numpy(wr),
                              init=pinit, **kw)
    np.testing.assert_allclose(Gp.numpy(), np.asarray(Gr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rr), rtol=1e-5,
                               atol=1e-5)
    Gb, rbm = pgram.gram_rhs(torch.from_numpy(V), torch.from_numpy(idx),
                             torch.from_numpy(wg), torch.from_numpy(wr), 512)
    Gr2, rr2 = rgram.gram_rhs(jnp.asarray(V), jnp.asarray(idx),
                              jnp.asarray(wg), jnp.asarray(wr))
    np.testing.assert_allclose(Gb.numpy(), np.asarray(Gr2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rbm.numpy(), np.asarray(rr2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [None, 3.0])
def test_dense_gram_rhs_matches_reference(rng, dtype, alpha):
    w, n, k = 7, 50, 6
    V = rng.standard_normal((n, k)).astype(np.float32)
    vals = np.where(rng.random((w, n)) < 0.4,
                    rng.integers(1, 11, (w, n)) * 0.5, 0).astype(np.float16)
    ref = rsw.dense_gram_rhs(jnp.asarray(V), jnp.asarray(vals), alpha,
                             jnp.dtype(dtype), col_chunk=16)
    got = psw.dense_gram_rhs(torch.from_numpy(V), torch.from_numpy(vals),
                             alpha, getattr(torch, dtype), col_chunk=16)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


def test_masked_sse_and_riding_identity_match_reference():
    k = 5
    rb, pb, lay = _both_buckets(HOT_DENSE, k)
    rbi, pbi, _ = _both_buckets(HOT_DENSE, k, transpose=True)
    rng = np.random.default_rng(3)
    U = (0.3 * rng.standard_normal((N_USERS, k))).astype(np.float32)
    V = (0.3 * rng.standard_normal((N_ITEMS, k))).astype(np.float32)
    ref = float(rsw.masked_sse(jnp.asarray(U), jnp.asarray(V), rb))
    got = float(psw.masked_sse(torch.from_numpy(U), torch.from_numpy(V), pb))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the riding identity of the item half equals the separate pass
    cfg = pc.SolveConfig(rank=k, reg=0.05, compute_dtype="float32")
    U2 = psw.half_sweep(torch.from_numpy(V), pb, N_USERS, cfg)
    V2, sse_ride = psw.half_sweep(U2, pbi, N_ITEMS, cfg, with_sse=True)
    sse_sep = psw.masked_sse(U2, V2, pb)
    np.testing.assert_allclose(float(sse_ride), float(sse_sep), rtol=1e-4,
                               atol=1e-2)


def test_scanned_fit_matches_reference_and_sse_modes_agree():
    """A 3-sweep scanned fit: riding and separate SSE histories agree, and
    both match the reference's history and factors."""
    k = 8
    rb_u, pb_u, _ = _both_buckets(HOT_DENSE, k)
    rb_i, pb_i, _ = _both_buckets(HOT_DENSE, k, transpose=True)
    u, _, v = _skewed()
    nnz = v.shape[0]
    rng = np.random.default_rng(4)
    U0 = (0.1 * rng.standard_normal((N_USERS, k))).astype(np.float32)
    V0 = (0.1 * rng.standard_normal((N_ITEMS, k))).astype(np.float32)
    hists = {}
    for mode in ("riding", "separate"):
        cfg = pc.SolveConfig(rank=k, reg=0.1, sse_mode=mode)
        fit = psw.make_scanned_fit(pb_u, pb_i, N_USERS, N_ITEMS, cfg, 3,
                                   nnz=nnz)
        U, V, hist, n_done = fit(torch.from_numpy(U0), torch.from_numpy(V0))
        assert n_done == 3
        hists[mode] = hist.numpy()
    np.testing.assert_allclose(hists["riding"], hists["separate"], rtol=1e-4)
    rcfg = rc.SolveConfig(rank=k, reg=0.1, solver="xla",
                          compute_dtype="float32", sse_mode="separate")
    rfit = rsw.make_scanned_fit(rb_u, rb_i, N_USERS, N_ITEMS, rcfg, 3,
                                nnz=nnz)
    Ur, Vr, rhist, _ = rfit(jnp.asarray(U0), jnp.asarray(V0))
    np.testing.assert_allclose(hists["separate"], np.asarray(rhist),
                               rtol=1e-4)
    np.testing.assert_allclose(U.numpy(), np.asarray(Ur), rtol=2e-3,
                               atol=2e-4)


def test_scanned_fit_tol_stops_and_marks_unrun_sweeps():
    k = 4
    _, pb_u, _ = _both_buckets(HOT_DENSE, k)
    _, pb_i, _ = _both_buckets(HOT_DENSE, k, transpose=True)
    rng = np.random.default_rng(5)
    U0 = torch.from_numpy((0.1 * rng.standard_normal((N_USERS, k))
                           ).astype(np.float32))
    V0 = torch.from_numpy((0.1 * rng.standard_normal((N_ITEMS, k))
                           ).astype(np.float32))
    cfg = pc.SolveConfig(rank=k, reg=0.1)
    fit = psw.make_scanned_fit(pb_u, pb_i, N_USERS, N_ITEMS, cfg, 6,
                               tol=10.0, nnz=1000)
    _, _, hist, n_done = fit(U0, V0)
    assert n_done == 2
    assert (hist[:2] >= 0).all() and (hist[2:] == -1).all()
    # the stepwise functions compute the same sweep
    sweep, train_sse = psw.make_sweep_fns(pb_u, pb_i, N_USERS, N_ITEMS, cfg)
    U1, V1 = sweep(U0, V0)
    fit1 = psw.make_scanned_fit(pb_u, pb_i, N_USERS, N_ITEMS,
                                pc.SolveConfig(rank=k, reg=0.1,
                                               sse_mode="separate"), 1)
    U2, V2, h2, _ = fit1(U0, V0)
    torch.testing.assert_close(U1, U2)
    torch.testing.assert_close(train_sse(U1, V1), h2[0])


def test_bf16_dense_guard_and_parity(monkeypatch):
    """The explicit bfloat16 path matches the reference's, and the dense
    block's guard re-solves NaN / huge rows with a trace-proportional
    ridge."""
    k = 8
    rb, pb, lay = _both_buckets(HOT_DENSE, k)
    V = np.random.default_rng(6).standard_normal((N_ITEMS, k)
                                                 ).astype(np.float32)
    kw = dict(rank=k, reg=0.1, solver="xla", compute_dtype="bfloat16")
    ref = np.asarray(rsw.half_sweep(jnp.asarray(V), rb, N_USERS,
                                    _scfg(rc, **kw)))
    got = psw.half_sweep(torch.from_numpy(V), pb, N_USERS,
                         _scfg(pc, **kw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)

    calls = []
    real = psw.solve_spd_flat

    def first_call_bad(G, rhs, k_, solver, reg_vec=None):
        x = real(G, rhs, k_, solver, reg_vec=reg_vec)
        calls.append(reg_vec.clone())
        if len(calls) == 1:
            x = x.clone()
            x[0] = float("nan")
            x[1, 0] = 1e13
        return x

    monkeypatch.setattr(psw, "solve_spd_flat", first_call_bad)
    guarded = psw.half_sweep(torch.from_numpy(V), pb, N_USERS,
                             _scfg(pc, **kw))
    assert len(calls) == 2 and (calls[1] > calls[0]).all()
    assert torch.isfinite(guarded).all()
    dense_ids = torch.from_numpy(lay.dense_ids.astype(np.int64))
    plain = psw.half_sweep(torch.from_numpy(V), pb, N_USERS, _scfg(pc, **kw))
    others = torch.ones(N_USERS, dtype=torch.bool)
    others[dense_ids[:2]] = False
    torch.testing.assert_close(guarded[others], plain[others])
    assert not torch.allclose(guarded[dense_ids[0]], plain[dense_ids[0]])


def test_device_buckets_padding_and_layout(rng):
    _, pb, lay = _both_buckets(HOT_DENSE, 8)
    gathered = [b for b in pb if "indices" in b]
    assert len(gathered) == len(lay.buckets)
    for d, b in zip(gathered, lay.buckets):
        n = d["row_ids"].shape[0]
        assert n % (256 if b.n_rows >= 256 else 8) == 0 and n >= b.n_rows
        assert (d["row_ids"][b.n_rows:] == N_USERS).all()
        assert d["hot_vals"].dtype == torch.bfloat16
        assert tuple(d["hot_vals"].shape) == (n, lay.hot_ids.shape[0])
        np.testing.assert_array_equal(
            d["hot_vals"][:b.n_rows].float().numpy(),
            b.hot_vals.astype(np.float32))
    assert any("dense_vals" in b for b in pb)
    assert any("hot_ids" in b for b in pb)
    for b, p_ in ((4, 8), (8, 600), (100, 4096)):
        assert psw.widen_chunk(512, b, p_) == rsw.widen_chunk(512, b, p_)
    for budget in (0, 3):
        assert (psw.resolve_gather_budget(budget, 64, pb)
                == rsw.resolve_gather_budget(
                    budget, 64, [{"indices": np.zeros(tuple(b["indices"].shape))}
                                 for b in pb if "indices" in b]))


def test_row_blocked_solve_equals_unblocked():
    """A tiny gather budget splits buckets into row blocks; results equal
    the unsplit solve."""
    k = 8
    _, pb, _ = _both_buckets(HOT_DENSE, k)
    V = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (N_ITEMS, k)).astype(np.float32))
    a = psw.half_sweep(V, pb, N_USERS, pc.SolveConfig(rank=k, reg=0.1))
    b = psw.half_sweep(V, pb, N_USERS, pc.SolveConfig(rank=k, reg=0.1,
                                                      gather_budget_mb=4096))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
