"""The port's host-side data plane is byte-identical to the reference's:
synthetic data, config policies and every bucket array of the layout."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_models_tpu.config as rc
import recommendation_models_tpu_torch.config as pc
from recommendation_models_tpu.data import layout as rl
from recommendation_models_tpu.data import layout_cache as rlc
from recommendation_models_tpu.data.synthetic import synthetic_ratings as r_syn
from recommendation_models_tpu.ops.pallas import cholesky as rchol
from recommendation_models_tpu_torch.data import layout as pl_
from recommendation_models_tpu_torch.data import layout_cache as plc
from recommendation_models_tpu_torch.data.synthetic import (
    synthetic_ratings as p_syn,
)
from recommendation_models_tpu_torch.ops import cholesky as pchol
from tests.conftest import tiny_problem

torch.set_num_threads(2)


def _skewed(seed=7, n_users=120, n_items=90, n_obs=3000):
    """COO triplets with a Zipf-ish column head (tests/test_hot_columns.py)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_obs)
    pop = np.arange(1, n_items + 1) ** -1.0
    pop /= pop.sum()
    items = rng.choice(n_items, size=n_obs, p=pop)
    uniq = np.unique(users * n_items + items)
    users, items = (uniq // n_items).astype(np.int64), uniq % n_items
    vals = (rng.integers(1, 11, uniq.shape[0]) * 0.5).astype(np.float32)
    return users, items, vals, n_users, n_items


def _heavy_tail(seed=11):
    """Pareto row degrees (tests/test_layout.py)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(40), np.minimum(
        (rng.pareto(1.0, 40) * 10 + 1).astype(int), 400))
    cols = np.concatenate([rng.choice(500, size=(rows == r).sum(),
                                      replace=False) for r in range(40)])
    vals = (rng.integers(1, 11, cols.shape[0]) * 0.5).astype(np.float32)
    return rows, cols, vals, 40, 500


def _tiny(seed=1, n_users=30, n_items=20, density=0.3):
    R = tiny_problem(n_users, n_items, density=density, seed=seed).tocoo()
    return R.row, R.col, R.data.astype(np.float32), n_users, n_items


CASES = [
    ("tiny_default", _tiny, {}),
    ("tiny_small_buckets", lambda: _tiny(2, 64, 200, 0.1),
     dict(min_bucket=8, max_bucket=64)),
    ("skewed_hot", _skewed, dict(hot_cols=16, hot_min_count=5,
                                 dense_whales=False)),
    ("skewed_hot_dense", _skewed, dict(hot_cols=16, hot_min_count=5,
                                       dense_min_degree=30,
                                       bucket_growth=1.12)),
    ("heavy_dense", _heavy_tail, dict(max_bucket=16)),
    ("heavy_whole_whales", _heavy_tail, dict(max_bucket=16,
                                             dense_whales=False)),
    ("heavy_merge", _heavy_tail, dict(bucket_merge_slack=1_000_000,
                                      row_multiple=16)),
]


def _assert_same_layout(a, b):
    assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert x.pad == y.pad
        for name in ("row_ids", "indices", "values", "mask", "hot_vals"):
            u, v = getattr(x, name), getattr(y, name)
            assert (u is None) == (v is None), name
            if u is not None:
                assert u.dtype == v.dtype and u.shape == v.shape, name
                assert u.tobytes() == v.tobytes(), name
    for name in ("dense_ids", "dense_vals", "hot_ids"):
        u, v = getattr(a, name), getattr(b, name)
        assert (u is None) == (v is None), name
        if u is not None:
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), name


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name,make,cfg", CASES, ids=[c[0] for c in CASES])
def test_layout_byte_identical(name, make, cfg, transpose):
    rows, cols, vals, nr, nc = make()
    a = rl.layout_from_coo(rows, cols, vals, nr, nc, rc.DataConfig(**cfg),
                           transpose=transpose)
    b = pl_.layout_from_coo(rows, cols, vals, nr, nc, pc.DataConfig(**cfg),
                            transpose=transpose)
    _assert_same_layout(a, b)
    assert a.padding_waste() == b.padding_waste()


def test_csr_arrays_and_build_layout_identical():
    R = tiny_problem(40, 30, density=0.3, seed=7)
    for src in (R, R.toarray()):
        a, b = rl.csr_arrays(src), pl_.csr_arrays(src)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    # non-canonical CSR: duplicates summed, caller's matrix untouched
    R2 = sp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                        np.array([1, 1, 2]), np.array([0, 3])), shape=(1, 4))
    got = pl_.csr_arrays(R2)
    assert got[1].shape[0] == 2 and got[2][0] == 3.0
    assert not R2.has_canonical_format
    a = rl.build_layout(R.indptr, R.indices, R.data, *R.shape)
    b = pl_.build_layout(R.indptr, R.indices, R.data, *R.shape)
    _assert_same_layout(a, b)
    for n in (1, 7, 8, 255, 256, 1000):
        assert pl_.bucket_row_multiple(n, 256) == rl.bucket_row_multiple(n, 256)


def test_loud_validation_matches_reference():
    rng = np.random.default_rng(13)
    nu, ni = 30, 40
    u = np.concatenate([np.zeros(36, np.int64), rng.integers(1, nu, 150)])
    i = np.concatenate([np.arange(36), rng.integers(0, 8, 150)])
    v = rng.uniform(1, 5, u.shape[0]).astype(np.float32)
    v[5] = 0.0
    R = sp.csr_matrix((v, (u, i)), shape=(nu, ni))
    R.sum_duplicates()
    indptr, indices, data, _, _ = pl_.csr_arrays(R)
    bad_cfgs = [(dict(dense_min_degree=16, hot_cols=0), "dense-whale"),
                (dict(dense_whales=False, hot_cols=8, hot_min_count=1),
                 "hot columns")]
    for cfg, msg in bad_cfgs:
        for mod, cmod in ((rl, rc), (pl_, pc)):
            with pytest.raises(ValueError, match=msg):
                mod.build_layout(indptr, indices, data, nu, ni,
                                 cmod.DataConfig(**cfg))
    for mod in (rl, pl_):
        with pytest.raises(ValueError, match="column ids"):
            mod.build_layout(np.array([0, 2]), np.array([0, 4], np.int32),
                             np.ones(2, np.float32), 1, 4)
        with pytest.raises(ValueError, match="n_rows"):
            mod.build_layout(np.array([0, 2]), np.array([0, 1], np.int32),
                             np.ones(2, np.float32), 3, 8)
        with pytest.raises(ValueError, match="duplicate"):
            mod.layout_from_coo(np.zeros(40, np.int64),
                                np.concatenate([np.arange(39), [0]]),
                                np.ones(40, np.float32), 1, 39,
                                (rc if mod is rl else pc).DataConfig(
                                    dense_min_degree=16, hot_cols=0))


@pytest.mark.parametrize("args", [
    (300, 200, 6000, 8, 0.3, 1.0, 3),
    (97, 61, 2500, 16, 0.1, 1.2, 0),
])
def test_synthetic_ratings_identical(args):
    n_users, n_items, n_obs, rank, noise, expo, seed = args
    a = r_syn(n_users, n_items, n_obs, rank=rank, noise=noise,
              popularity_exponent=expo, seed=seed)
    b = p_syn(n_users, n_items, n_obs, rank=rank, noise=noise,
              popularity_exponent=expo, seed=seed)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


@pytest.mark.parametrize("cls", ["SolveConfig", "DataConfig", "FitConfig",
                                 "MeshConfig"])
def test_config_fields_and_defaults_identical(cls):
    a = dataclasses.asdict(getattr(rc, cls)())
    b = dataclasses.asdict(getattr(pc, cls)())
    assert a == b


def test_config_policies_identical():
    for k in (1, 4, 8, 10, 16, 32, 48, 64, 65, 96, 128, 160, 192, 256):
        assert pc.gather_budget_for_rank(k) == rc.gather_budget_for_rank(k)
        for nnz in (1, 5_000_000, 20_000_000, 50_000_000):
            assert (pc.gather_budget_for_rank(k, nnz)
                    == rc.gather_budget_for_rank(k, nnz))
        assert pc.bucket_growth_for_rank(k) == rc.bucket_growth_for_rank(k)
        for mb in (64, 4096):
            assert (pc.dense_min_degree_for_rank(k, mb)
                    == rc.dense_min_degree_for_rank(k, mb))
        assert pchol.hot_cols_cap(k) == rchol.hot_cols_cap(k)
        assert pchol.hot_cols_auto(k) == rchol.hot_cols_auto(k)
    assert pchol.hot_cols_auto(64) == 128
    for alpha in (None, 2.0):
        for mode in ("auto", "riding", "separate"):
            for k in (32, 64, 128):
                for nnz in (1_000_000, 19_027_200, 60_000_000, None):
                    a = rc.sse_separate_for(
                        rc.SolveConfig(rank=k, alpha=alpha, sse_mode=mode), nnz)
                    b = pc.sse_separate_for(
                        pc.SolveConfig(rank=k, alpha=alpha, sse_mode=mode), nnz)
                    assert a == b
    with pytest.raises(ValueError):
        pc.sse_separate_for(pc.SolveConfig(sse_mode="bogus"), 1)


def test_layout_cache_interchangeable(tmp_path):
    rows, cols, vals, nr, nc = _skewed()
    cfg = dict(hot_cols=16, hot_min_count=5, dense_min_degree=30)
    ref = rl.layout_from_coo(rows, cols, vals, nr, nc, rc.DataConfig(**cfg))
    mine = pl_.layout_from_coo(rows, cols, vals, nr, nc, pc.DataConfig(**cfg))
    p_ref, p_mine = str(tmp_path / "ref.npz"), str(tmp_path / "mine.npz")
    rlc.save_layout(p_ref, ref)
    plc.save_layout(p_mine, mine)
    _assert_same_layout(plc.load_layout(p_ref), ref)
    _assert_same_layout(rlc.load_layout(p_mine), mine)
    assert (plc.config_tag(pc.DataConfig(**cfg))
            == rlc.config_tag(rc.DataConfig(**cfg)))
    assert (plc.data_fingerprint(rows, cols, vals)
            == rlc.data_fingerprint(rows, cols, vals))
    calls = []

    def build():
        calls.append(1)
        return mine
    plc.cached_layout(p_mine, build)
    assert not calls
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    plc.cached_layout(str(tmp_path / "bad.npz"), build)   # corrupt: rebuilds
    assert len(calls) == 1
