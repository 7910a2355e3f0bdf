"""The port's sharded probes (``probes/sharded_scan.py``,
``probes/sharded_hot.py``) against the JAX package's scripts
``scripts/measure_sharded_scan.py`` and ``scripts/smoke_sharded_hot_tpu.py``
on the same numpy inputs, JAX on its CPU devices:

- the sharded scan at tiny scale (rank 8): the port's stepwise and scanned
  histories within the script's rtol 5e-4 (2e-3 with ``FASTPATHS``), and
  the port's scanned history within 1e-3 of the JAX
  ``ShardedALSProgram.make_fit`` history on the same layouts;
- the sharded hot smoke: the script's parity check (rtol 1e-3 against the
  single-device XLA / torch anchor) through both packages, and the two
  packages' histories within 1e-3 of each other. The JAX side runs with
  ``solver="auto"``, which the CPU resolves to its XLA anchor (interpret-
  mode Pallas cannot run under ``shard_map``); the port's side takes the
  plain versions of B1 and B2 on CPU tensors.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recommendation_models_tpu.config as rc
from recommendation_models_tpu import ALS as RefALS
from recommendation_models_tpu.data.layout import (
    layout_from_coo as ref_layout_from_coo, shard_layout as ref_shard_layout)
from recommendation_models_tpu.data.synthetic import (
    synthetic_ratings as ref_synthetic_ratings)
from recommendation_models_tpu.ops.pallas.cholesky import (
    block_batch as ref_block_batch)
from recommendation_models_tpu.parallel.mesh import get_mesh as ref_get_mesh
from recommendation_models_tpu.parallel.sharded_als import (
    ShardedALSProgram as RefProgram)
from recommendation_models_tpu_torch.probes import SCALES
from recommendation_models_tpu_torch.probes import sharded_hot, sharded_scan

torch.set_num_threads(2)

RANK = 8
SWEEPS = 3


@pytest.fixture(scope="module")
def tiny_coo():
    n_users, n_items, n_obs = SCALES["tiny"]
    return ref_synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)


@pytest.mark.parametrize("fastpaths", [False, True])
def test_stepwise_and_scanned_agree_in_the_port(tiny_coo, fastpaths):
    rec = sharded_scan.run("tiny", RANK, SWEEPS, 1, fastpaths,
                           platform="cpu", coo=tiny_coo, windows=2)
    assert rec["windows"] == 2 and rec["windows_s"] is None
    assert rec["rtol"] == (2e-3 if fastpaths else 5e-4)
    assert rec["max_rel_diff"] <= rec["rtol"]
    assert len(rec["history_scanned"]) == SWEEPS
    assert rec["stepwise_s"] is None and rec["gap_ms_per_sweep"] is None
    assert rec["nnz"] == tiny_coo[2].shape[0]
    # the host launches no kernel: each loop's profiled counts are 0
    assert rec["host_counts_per_sweep"] == dict.fromkeys(
        ("stepwise", "scanned"),
        {"launches": 0.0, "kernels": 0.0, "syncs": 0.0})


def test_scanned_history_matches_the_jax_program(tiny_coo):
    """The script's default layout (no dense block, no hot columns) on a
    1-shard mesh in both packages, the JAX ``make_fit`` against the port's
    scanned fit from ``init_factors(0, 0.01)``."""
    users, items, ratings = tiny_coo
    n_users, n_items, _ = SCALES["tiny"]
    dcfg = rc.DataConfig(dense_whales=False, hot_cols=0,
                         bucket_growth=rc.bucket_growth_for_rank(RANK))
    ul = ref_shard_layout(ref_layout_from_coo(
        users, items, ratings, n_users, n_items, config=dcfg), 1,
        row_multiple=ref_block_batch(RANK))
    il = ref_shard_layout(ref_layout_from_coo(
        users, items, ratings, n_users, n_items, config=dcfg,
        transpose=True), 1, row_multiple=ref_block_batch(RANK))
    prog = RefProgram(ul, il, ref_get_mesh(1, platform="cpu"),
                      rc.SolveConfig(rank=RANK, reg=0.1))
    U, V = prog.init_factors(seed=0, init_scale=0.01)
    _, _, sse, _ = prog.make_fit(SWEEPS)(U, V)
    want = np.asarray(sse)
    rec = sharded_scan.run("tiny", RANK, SWEEPS, 1, False, platform="cpu",
                           coo=tiny_coo)
    np.testing.assert_allclose(rec["history_scanned"], want, rtol=1e-3)


def test_the_scan_probe_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_scan.main([], env={})


@pytest.fixture(scope="module")
def hot_coo():
    return ref_synthetic_ratings(sharded_hot.N_USERS, sharded_hot.N_ITEMS,
                                 sharded_hot.N_OBS, rank=8, seed=0)


def _jax_sharded_hot(coo):
    """The script's steps in the JAX package on a 1-device CPU mesh with
    ``solver="auto"``: the smoke sweep's SSE and the train-RMSE history of
    ``make_fit(2)``, checked against ``ALS(solver="xla")`` as the script
    checks it."""
    users, items, ratings = coo
    n_u, n_i, k = sharded_hot.N_USERS, sharded_hot.N_ITEMS, sharded_hot.RANK
    dcfg = rc.DataConfig(dense_whales=False, hot_cols=sharded_hot.HOT_COLS)
    ul = ref_layout_from_coo(users, items, ratings, n_u, n_i, config=dcfg)
    assert ul.hot_ids is not None
    il = ref_layout_from_coo(users, items, ratings, n_u, n_i, config=dcfg,
                             transpose=True)
    prog = RefProgram(ref_shard_layout(ul, 1), ref_shard_layout(il, 1),
                      ref_get_mesh(1, platform="cpu"),
                      rc.SolveConfig(rank=k, reg=0.1, solver="auto"))
    U, V = prog.init_factors(seed=1, init_scale=0.1)
    U, V, sse = prog.sweep_with_sse(U, V)
    assert np.isfinite(float(sse))
    U0, V0 = sharded_hot.warm_start()
    R = sp.csr_matrix((ratings, (users, items)), shape=(n_u, n_i))
    ref = RefALS(rank=k, reg=0.1, n_sweeps=2, solver="xla", hot_cols=0,
                 dense_min_degree=10_000, platform="cpu").fit(
                     R, U0=U0, V0=V0)
    Up, Vp = prog.place_factors(U0, V0)
    _, _, hist, _ = prog.make_fit(2)(Up, Vp)
    got = np.sqrt(np.maximum(np.asarray(hist), 0) / ratings.shape[0])
    np.testing.assert_allclose(got, ref.history_, rtol=1e-3)
    return float(sse), got, np.asarray(ref.history_)


def test_sharded_hot_smoke_in_both_packages(hot_coo):
    sse, hist, anchor = _jax_sharded_hot(hot_coo)
    rec = sharded_hot.run(platform="cpu", coo=hot_coo)
    assert rec["hot_cols"] == sharded_hot.HOT_COLS
    # the wrappers took their plain versions: nothing launched or routed
    assert rec["launches"] == dict.fromkeys(sharded_hot.COUNTED, 0)
    assert rec["routed"] == {}
    np.testing.assert_allclose(rec["history"], hist, rtol=1e-3)
    np.testing.assert_allclose(rec["anchor_history"], anchor, rtol=1e-3)
    np.testing.assert_allclose(rec["sse"], sse, rtol=1e-3)
