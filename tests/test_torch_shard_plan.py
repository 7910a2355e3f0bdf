"""The port's host-side shard plan against the JAX package's, on the same
numpy inputs: ``shard_layout`` arrays bit for bit, the exchange plans
(every array, the widths, the byte counts and the padding efficiency)
equal, the analytic scaling model's values equal, and the plan-build probe
at a small scale."""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu.config import DataConfig as RefDataConfig
from recommendation_models_tpu.data import layout as ref_layout
from recommendation_models_tpu.parallel import exchange as ref_exchange
from recommendation_models_tpu.parallel import scaling as ref_scaling
from recommendation_models_tpu_torch.config import DataConfig
from recommendation_models_tpu_torch.data import layout
from recommendation_models_tpu_torch.parallel import exchange, scaling

torch.set_num_threads(2)


def _skewed(n_rows=101, n_cols=77, n_obs=2500, seed=5):
    """A Zipf-popular ratings matrix whose row count is not a multiple of
    2, 3 or 8, with rows dense enough for a dense-whale block."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n_obs)
    pop = np.arange(1, n_cols + 1) ** -0.9
    cols = rng.choice(n_cols, size=n_obs, p=pop / pop.sum())
    key = np.unique(rows * n_cols + cols)
    vals = (rng.integers(1, 11, key.shape[0]) * 0.5).astype(np.float32)
    R = sp.csr_matrix((vals, (key // n_cols, key % n_cols)),
                      shape=(n_rows, n_cols))
    return R.indptr, R.indices, R.data, n_rows, n_cols


LAYOUTS = {
    "plain": dict(dense_whales=False, hot_cols=0),
    "dense_hot": dict(hot_cols=8, dense_min_degree=20, max_bucket=64,
                      bucket_growth=1.25),
    "hot_only": dict(dense_whales=False, hot_cols=8, max_bucket=64),
}


def _layouts(kind, transpose=False):
    indptr, indices, data, n_rows, n_cols = _skewed()
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    kw = LAYOUTS[kind]
    out = []
    for mod, cfg in ((ref_layout, RefDataConfig(**kw)),
                     (layout, DataConfig(**kw))):
        out.append(mod.layout_from_coo(rows, indices, data, n_rows, n_cols,
                                       cfg, transpose=transpose))
    return out


def _assert_fields_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("transpose", [False, True], ids=["user", "item"])
def test_shard_layout_bitwise(kind, S, transpose):
    ref_l, got_l = _layouts(kind, transpose)
    if kind == "dense_hot" and not transpose:
        assert got_l.dense_ids is not None and got_l.hot_ids is not None
    for mult in (8, 32):
        want = ref_layout.shard_layout(ref_l, S, row_multiple=mult)
        got = layout.shard_layout(got_l, S, row_multiple=mult)
        _assert_fields_equal(got, want)
        # every real row appears once, on its owner, at its local id
        real = sum(int((r < got.rows_per_shard).sum()) for r in got.row_ids)
        dense = (0 if got.dense_ids is None
                 else int((got.dense_ids < got.rows_per_shard).sum()))
        assert real + dense == int(np.sum(
            [(b.row_ids < got_l.n_rows).sum() for b in got_l.buckets])) + (
            0 if got_l.dense_ids is None else got_l.dense_ids.shape[0])


def _plan_pair(S, head, kind="plain"):
    (ru, pu), (ri, pi) = _layouts(kind), _layouts(kind, transpose=True)
    out = []
    for mod_l, mod_x, ul, il in ((ref_layout, ref_exchange, ru, ri),
                                 (layout, exchange, pu, pi)):
        su = mod_l.shard_layout(ul, S)
        si = mod_l.shard_layout(il, S)
        out.append((mod_x.build_exchange_plan(su, si.rows_per_shard,
                                              head=head),
                    mod_x.build_exchange_plan(si, su.rows_per_shard,
                                              head=head)))
    return out


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("head,kind", [(0, "plain"), (12, "plain"),
                                       (12, "hot_only")])
def test_exchange_plan_equal(S, head, kind):
    want, got = _plan_pair(S, head, kind)
    for g, w in zip(got, want):
        _assert_fields_equal(g, w)
        assert g.e_rows() == w.e_rows()
        for k in (4, 64):
            assert (g.recv_bytes_per_half_sweep(k)
                    == w.recv_bytes_per_half_sweep(k))
        assert g.padding_efficiency() == w.padding_efficiency()
        assert 0.0 < g.padding_efficiency() <= 1.0
    if kind == "hot_only":     # the user half carries hot columns
        assert got[0].remapped_hot is not None and got[0].head_size >= 12


def test_exchange_plan_refuses_global_id_blocks():
    ref_l, got_l = _layouts("dense_hot", transpose=True)
    assert got_l.dense_ids is not None
    for mod_l, mod_x, lay in ((ref_layout, ref_exchange, ref_l),
                              (layout, exchange, got_l)):
        with pytest.raises(ValueError, match="dense-whale"):
            mod_x.build_exchange_plan(mod_l.shard_layout(lay, 2), 40)
    _, hot = _layouts("hot_only")
    with pytest.raises(ValueError, match="hot-column block"):
        exchange.build_exchange_plan(layout.shard_layout(hot, 2), 40)


GRID = [(c, b, s, d) for c in (0.5, 3.0) for b in (1, 10**6, 4 * 10**8)
        for s in (1, 2, 8, 32) for d in (1, 2, 4) if s % d == 0]


def test_scaling_model_equal_on_a_grid():
    links = (scaling.LinkSpec(), scaling.LinkSpec(50e9, 10e9, 8))
    ref_links = (ref_scaling.LinkSpec(), ref_scaling.LinkSpec(50e9, 10e9, 8))
    for (c, b, s, d) in GRID:
        for ln, rln in zip(links, ref_links):
            assert (scaling.sweep_time_model(c, b, s, d, ln)
                    == ref_scaling.sweep_time_model(c, b, s, d, rln))
    shard_counts = [1, 2, 8, 16, 64, 256]
    assert (scaling.project_scaling(1.3, lambda s: 1000 * s, shard_counts)
            == ref_scaling.project_scaling(1.3, lambda s: 1000 * s,
                                           shard_counts))
    for n_rows, n_cols, rank in ((162_541, 62_423, 64), (500, 10**7, 128)):
        for s, d in ((8, 1), (16, 2), (64, 4), (7, 2)):
            assert (scaling.choose_topology(n_rows, n_cols, rank, s, d)
                    == ref_scaling.choose_topology(n_rows, n_cols, rank,
                                                   s, d))
    assert scaling.LinkSpec() == scaling.LinkSpec(200e9, 25e9, 4)


def test_plan_build_probe_small(capsys):
    from recommendation_models_tpu_torch.probes import plan_build
    assert plan_build.main(["--scale", "tiny", "--shards", "2,3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["S"] for r in lines] == [2, 3]
    for r in lines:
        assert r["bytes_tail_only_mib"] > 0
        assert r["bytes_hybrid_h1024_mib"] > 0
        assert r["device"] == "host"
