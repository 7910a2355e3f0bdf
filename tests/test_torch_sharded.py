"""The port's 1-D sharded ALS (``parallel/sharded_als.py``, ``parallel/
mesh.py``, ``ALS(n_shards=S)``) against the JAX package's on the same numpy
inputs, JAX on its 8 forced CPU devices and the port on a CPU mesh:

- the init of the padded tables bit for bit;
- the fitted factors and histories at S = 2, 3 and 8 for each exchange,
  explicit and implicit, through the one-loop fit and the stepwise fit, at
  the port's estimator tolerances (tests/test_torch_als.py);
- the per-sweep exchange bytes exactly;
- shard-count invariance of the port against its own single-device fit
  (the cases of tests/test_sharded.py), sharded checkpoints, pickling, the
  mesh's collectives, the callers' errors and the error of what is not
  ported (the multi-process bootstrap).

The card's case (``gpu``) runs two shards on one card through B1 and B2:
``python -m pytest --noconftest -m gpu tests/test_torch_sharded.py``."""

import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.config import DataConfig, SolveConfig
from recommendation_models_tpu_torch.data.layout import (
    csr_arrays, layout_from_coo, shard_layout)
from recommendation_models_tpu_torch.parallel import mesh as pmesh
from recommendation_models_tpu_torch.parallel.sharded_als import (
    ShardedALSProgram)
from recommendation_models_tpu_torch.utils.checkpoint import load_latest

try:
    from recommendation_models_tpu import ALS as RefALS
    from recommendation_models_tpu.config import DataConfig as RefDataConfig
    from recommendation_models_tpu.config import (
        SolveConfig as RefSolveConfig)
    from recommendation_models_tpu.data import layout as ref_layout
    from recommendation_models_tpu.parallel.mesh import (
        get_mesh as ref_get_mesh)
    from recommendation_models_tpu.parallel.sharded_als import (
        ShardedALSProgram as RefProgram)
    from tests.conftest import tiny_problem
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    RefALS = None

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if RefALS is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def _init(n_users, n_items, rank, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n_users, rank)).astype(np.float32),
            0.1 * rng.standard_normal((n_items, rank)).astype(np.float32))


def _close_to_reference(got, ref):
    """The port's estimator tolerances (tests/test_torch_als.py)."""
    for a, b in ((got.U_, ref.U_), (got.V_, ref.V_)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-4,
                                   atol=3e-5 * max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(got.history_, ref.history_, rtol=1e-4)
    assert len(got.history_) == len(ref.history_)


def _invariant(shd, single):
    """tests/test_sharded.py's shard-invariance tolerance."""
    np.testing.assert_allclose(shd.U_, single.U_, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(shd.V_, single.V_, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(shd.history_, single.history_, rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("S", [2, 3, 8])
def test_init_factors_bitwise(S):
    R = tiny_problem(45, 31, density=0.3, seed=21)
    indptr, indices, data, nu, ni = csr_arrays(R)
    rows = np.repeat(np.arange(nu), np.diff(indptr))
    plain = dict(dense_whales=False, hot_cols=0)
    pu = shard_layout(layout_from_coo(rows, indices, data, nu, ni,
                                      DataConfig(**plain)), S)
    pi = shard_layout(layout_from_coo(rows, indices, data, nu, ni,
                                      DataConfig(**plain), transpose=True), S)
    ru = ref_layout.shard_layout(ref_layout.layout_from_coo(
        rows, indices, data, nu, ni, RefDataConfig(**plain)), S)
    ri = ref_layout.shard_layout(ref_layout.layout_from_coo(
        rows, indices, data, nu, ni, RefDataConfig(**plain),
        transpose=True), S)
    got = ShardedALSProgram(pu, pi, pmesh.get_mesh(S, platform="cpu"),
                            SolveConfig(rank=5))
    ref = RefProgram(ru, ri, ref_get_mesh(S, platform="cpu"),
                     RefSolveConfig(rank=5))
    for seed, scale in ((0, 0.01), (7, 0.3)):
        for a, b in zip(got.init_factors(seed, scale),
                        ref.init_factors(seed, scale)):
            b = np.asarray(b)
            assert pmesh.to_host(a).dtype == b.dtype == np.float32
            np.testing.assert_array_equal(pmesh.to_host(a), b)
    U, V = got.init_factors(0, 0.01)
    assert len(U) == S and all(u.shape == (pu.rows_per_shard, 5) for u in U)
    assert not pmesh.to_host(U)[nu:].any() and not pmesh.to_host(V)[ni:].any()


@pytest.mark.parametrize("alpha", [None, 0.5], ids=["explicit", "implicit"])
@pytest.mark.parametrize("exchange", ["allgather", "all_to_all", "hybrid"])
@pytest.mark.parametrize("S", [2, 3, 8])
def test_sharded_fit_matches_reference(S, exchange, alpha):
    R = tiny_problem(50, 40, density=0.25, seed=30)
    U0, V0 = _init(*R.shape, rank=6, seed=6)
    kw = dict(rank=6, reg=0.3, alpha=alpha, n_sweeps=3, n_shards=S,
              exchange=exchange, exchange_head=8, platform="cpu")
    ref = RefALS(**kw).fit(R, U0=U0, V0=V0)
    got = ALS(**kw).fit(R, U0=U0, V0=V0)
    assert got._U_host is None and got._U_dev is not None  # on the mesh
    _close_to_reference(got, ref)
    assert got.exchange_bytes_per_sweep_ == ref.exchange_bytes_per_sweep_
    assert got.history_[-1] < got.history_[0]


@pytest.mark.parametrize("exchange", ["allgather", "all_to_all", "hybrid"])
def test_stepwise_sharded_fit_matches_reference(exchange, capsys):
    """verbose=1 drives a sweep at a time (sweep_with_sse), with tol."""
    R = tiny_problem(40, 30, density=0.3, seed=31)
    U0, V0 = _init(*R.shape, rank=4, seed=2)
    kw = dict(rank=4, reg=0.2, n_sweeps=4, n_shards=3, exchange=exchange,
              exchange_head=6, platform="cpu", verbose=1, tol=1e-9,
              hot_cols=4, dense_min_degree=12, max_bucket=16)
    ref = RefALS(**kw).fit(R, U0=U0, V0=V0)
    ref_out = capsys.readouterr().out
    got = ALS(**kw).fit(R, U0=U0, V0=V0)
    out = capsys.readouterr().out
    _close_to_reference(got, ref)
    assert got.exchange_bytes_per_sweep_ == ref.exchange_bytes_per_sweep_
    traffic = [x for x in out.splitlines() if "collective traffic" in x]
    assert traffic == [x for x in ref_out.splitlines()
                       if "collective traffic" in x]
    assert out.count("train_rmse=") == len(got.history_) == 4


def test_default_sharded_init_matches_reference():
    """No warm start: both draw the padded tables from default_rng(seed)."""
    R = tiny_problem(40, 30, seed=32)
    kw = dict(rank=5, n_sweeps=2, n_shards=4, seed=3, platform="cpu")
    ref = RefALS(**kw).fit(R)
    got = ALS(**kw).fit(R)
    _close_to_reference(got, ref)
    assert got.U_.shape == (40, 5) and np.isfinite(got.history_).all()


@pytest.mark.parametrize("alpha", [None, 0.5], ids=["explicit", "implicit"])
@pytest.mark.parametrize("exchange", ["allgather", "all_to_all", "hybrid"])
def test_shard_count_invariance(exchange, alpha):
    R = tiny_problem(50, 40, density=0.25, seed=30)
    U0, V0 = _init(*R.shape, rank=6, seed=6)
    single = ALS(rank=6, reg=0.3, alpha=alpha, n_sweeps=3,
                 platform="cpu").fit(R, U0=U0, V0=V0)
    shd = ALS(rank=6, reg=0.3, alpha=alpha, n_sweeps=3, n_shards=8,
              exchange=exchange, platform="cpu").fit(R, U0=U0, V0=V0)
    _invariant(shd, single)


def test_sharded_uneven_rows():
    R = tiny_problem(13, 9, density=0.5, seed=31)
    U0, V0 = _init(13, 9, rank=4, seed=7)
    single = ALS(rank=4, reg=0.2, n_sweeps=2, platform="cpu").fit(
        R, U0=U0, V0=V0)
    shd = ALS(rank=4, reg=0.2, n_sweeps=2, n_shards=8,
              platform="cpu").fit(R, U0=U0, V0=V0)
    np.testing.assert_allclose(shd.U_, single.U_, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("alpha", [None, 0.5], ids=["explicit", "implicit"])
def test_sharded_allgather_dense_hot_parity(alpha):
    """'allgather' keeps the dense-whale and hot-column blocks."""
    R = tiny_problem(96, 40, density=0.5, seed=33)
    U0, V0 = _init(96, 40, rank=8, seed=8)
    kw = dict(rank=8, reg=0.3, alpha=alpha, n_sweeps=3, hot_cols=8,
              dense_min_degree=26, max_bucket=32)
    single = ALS(**kw, platform="cpu").fit(R, U0=U0, V0=V0)
    shd = ALS(**kw, n_shards=8, exchange="allgather",
              platform="cpu").fit(R, U0=U0, V0=V0)
    prog = shd._sharded_program
    assert any("dense_vals" in b for b in prog._ib[0])
    assert any("hot_ids" in b for b in prog._ub[0])
    _invariant(shd, single)


def test_hybrid_keeps_hot_column_path():
    R = tiny_problem(96, 40, density=0.5, seed=34)
    U0, V0 = _init(96, 40, rank=8, seed=9)
    kw = dict(rank=8, reg=0.3, n_sweeps=3, hot_cols=8,
              dense_min_degree=10_000, max_bucket=32)
    single = ALS(**kw, platform="cpu").fit(R, U0=U0, V0=V0)
    shd = ALS(**kw, n_shards=8, exchange="hybrid", exchange_head=12,
              platform="cpu").fit(R, U0=U0, V0=V0)
    up = shd._sharded_program._uplan_host
    assert up.remapped_hot is not None and up.remapped_hot.shape[0] == 8
    assert up.head_size >= 12
    _invariant(shd, single)


def test_sharded_dense_block_with_nondivisible_catalog():
    """The gathered table is padded past n_cols: the dense block's gram and
    SSE iterate the value matrix's width (tests/test_sharded.py:141)."""
    n_users, n_items = 45, 39
    R = tiny_problem(n_users, n_items, density=0.5, seed=77)
    U0, V0 = _init(n_users, n_items, rank=4, seed=3)
    kw = dict(rank=4, reg=0.3, n_sweeps=2, dense_min_degree=8, hot_cols=0)
    single = ALS(**kw, platform="cpu").fit(R, U0=U0, V0=V0)
    ul, _ = single._build_layouts(*csr_arrays(R)[:3], n_users, n_items,
                                  single._data_config())
    assert ul.dense_ids is not None and ul.dense_ids.size > 0
    sharded = ALS(**kw, n_shards=8, platform="cpu").fit(R, U0=U0, V0=V0)
    np.testing.assert_allclose(sharded.U_, single.U_, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sharded.history_, single.history_, rtol=1e-4)


def test_collective_bytes_accounting():
    R = tiny_problem(128, 384, density=0.02, seed=35)
    U0, V0 = _init(128, 384, rank=4, seed=10)
    out = {}
    for ex in ("allgather", "all_to_all", "hybrid"):
        m = ALS(rank=4, reg=0.2, n_sweeps=1, n_shards=8, exchange=ex,
                exchange_head=8, platform="cpu").fit(R, U0=U0, V0=V0)
        b = m.exchange_bytes_per_sweep_
        assert b["per_sweep_with_sse"] == b["per_sweep_total"] + b["user_half"]
        out[ex] = b["per_sweep_total"]
    prog = m._sharded_program
    assert out["allgather"] == 7 * (prog.ipr + prog.upr) * 4 * 4
    assert 0.0 <= prog._uplan_host.padding_efficiency() <= 1.0
    assert out["all_to_all"] < out["allgather"]
    assert out["hybrid"] < out["allgather"]
    # a single-device fit after a sharded one drops the program and bytes
    m.set_params(n_shards=None).fit(R, U0=U0, V0=V0)
    assert m._sharded_program is None
    assert not hasattr(m, "exchange_bytes_per_sweep_")


def test_sharded_checkpoint_saves_padded_tables(tmp_path):
    R = tiny_problem(29, 21, density=0.4, seed=36)
    U0, V0 = _init(29, 21, rank=3, seed=11)
    ckpt = tmp_path / "port"
    m = ALS(rank=3, n_sweeps=4, n_shards=4, platform="cpu",
            checkpoint_dir=str(ckpt), checkpoint_every=2).fit(
                R, U0=U0, V0=V0)
    prog = m._sharded_program
    step, state = load_latest(str(ckpt))
    assert step == 4
    assert state["U"].shape == (4 * prog.upr, 3) and prog.upr * 4 > 29
    assert state["V"].shape == (4 * prog.ipr, 3) and prog.ipr * 4 > 21
    np.testing.assert_array_equal(state["U"][:29], m.U_)
    assert not state["U"][29:].any()
    assert state["metadata"]["n_users"] == 29
    fresh = ALS(rank=3, platform="cpu")
    assert fresh.resume(str(ckpt)) == 4
    np.testing.assert_array_equal(fresh.U_, m.U_)
    np.testing.assert_array_equal(fresh.V_, m.V_)
    assert fresh.U_.shape == (29, 3) and fresh.V_.shape == (21, 3)
    np.testing.assert_array_equal(fresh.history_, m.history_)
    # the JAX package's sharded checkpoint holds the same padded shapes
    rdir = tmp_path / "ref"
    rdir.mkdir()
    RefALS(rank=3, n_sweeps=4, n_shards=4, platform="cpu",
           checkpoint_dir=str(rdir), checkpoint_every=2).fit(
               R, U0=U0, V0=V0)
    ref = RefALS(rank=3, platform="cpu")
    ref.resume(str(rdir))
    np.testing.assert_allclose(fresh.U_, ref.U_, rtol=2e-4, atol=3e-5)


def test_pickle_materializes_sharded_tables():
    R = tiny_problem(30, 20, density=0.4, seed=37)
    m = ALS(rank=3, n_sweeps=2, n_shards=3, platform="cpu").fit(R)
    assert m._U_host is None
    back = pickle.loads(pickle.dumps(m))
    assert back._U_dev is None and back._V_dev is None
    assert "_sharded_program" not in back.__dict__
    np.testing.assert_array_equal(back.U_, m.U_)
    np.testing.assert_array_equal(back.V_, m.V_)
    assert back.U_.shape == (30, 3)


def test_mesh_collectives():
    mesh = pmesh.Mesh([torch.device("cpu")] * 3, axis="data")
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    blocks = pmesh.shard_put(mesh, "data", x)
    assert [b.shape for b in blocks] == [(2, 4)] * 3
    np.testing.assert_array_equal(pmesh.to_host(blocks), x)
    for g in pmesh.all_gather(mesh, blocks):
        np.testing.assert_array_equal(g.numpy(), x)
    for t in pmesh.psum(mesh, blocks):
        np.testing.assert_array_equal(t.numpy(), x[:2] + x[2:4] + x[4:])
    rot = pmesh.ppermute(mesh, blocks, 1)      # s -> s + 1
    np.testing.assert_array_equal(rot[1].numpy(), x[:2])
    np.testing.assert_array_equal(rot[0].numpy(), x[4:])
    back = pmesh.ppermute(mesh, rot, -1)
    np.testing.assert_array_equal(pmesh.to_host(back), x)
    got = pmesh.take_rows(blocks, [5, 0, 3, 3], torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), x[[5, 0, 3, 3]])
    with pytest.raises(ValueError, match="row ids"):
        pmesh.take_rows(blocks, [6], torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_put(mesh, "data", x[:5])
    for r in pmesh.replicate_put(mesh, x[0]):
        np.testing.assert_array_equal(r.numpy(), x[0])
    assert pmesh.get_mesh(4, platform="cpu").devices == (
        torch.device("cpu"),) * 4


def test_errors_of_what_is_not_ported_and_of_the_caller(monkeypatch):
    R = tiny_problem(10, 8, seed=2)
    # the 2-D fit is ported (item 13e): the reference's error, the same
    # message
    with pytest.raises(ValueError) as want:
        RefALS(rank=3, n_sweeps=1, n_shards=4, num_slices=3,
               topology="obs_parallel", platform="cpu").fit(R)
    with pytest.raises(ValueError) as got:
        ALS(rank=3, n_sweeps=1, n_shards=4, num_slices=3,
            topology="obs_parallel", platform="cpu").fit(R)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        RefALS(rank=3, n_sweeps=1, n_shards=2, topology="ring",
               platform="cpu").fit(R)
    with pytest.raises(ValueError) as got:
        ALS(rank=3, n_sweeps=1, n_shards=2, topology="ring",
            platform="cpu").fit(R)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        RefALS(rank=3, n_sweeps=1, n_shards=2, exchange="gossip",
               platform="cpu").fit(R)
    with pytest.raises(ValueError) as got:
        ALS(rank=3, n_sweeps=1, n_shards=2, exchange="gossip",
            platform="cpu").fit(R)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible by num_slices"):
        pmesh.get_mesh(6, platform="cpu", num_slices=4)
    from recommendation_models_tpu.parallel.mesh import (
        get_hybrid_mesh as ref_get_hybrid_mesh)
    with pytest.raises(ValueError) as want:
        ref_get_hybrid_mesh(8, num_slices=3, platform="cpu")
    with pytest.raises(ValueError) as got:
        pmesh.get_hybrid_mesh(8, num_slices=3, platform="cpu")
    assert str(got.value) == str(want.value)
    pmesh.initialize_distributed()              # one process: nothing
    with pytest.raises(NotImplementedError, match="item 13f"):
        pmesh.initialize_distributed("localhost:1234", 2, 0)
    # too few cards: the reference's error, never a CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 shards but only 1 "
                                         "devices"):
        ALS(rank=3, n_sweeps=1, n_shards=2).fit(R)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALS(rank=3, n_sweeps=1, n_shards=2).fit(R)


@pytest.mark.gpu
def test_two_shards_on_the_card_match_the_cpu():
    """Mesh((cuda,) * 2): the sharded program with the dense block and hot
    columns launches B1 and B2 and agrees with the same program on a CPU
    mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.ops import cholesky as ch
    rng = np.random.default_rng(38)
    mask = rng.random((300, 200)) < 0.3
    R = sp.csr_matrix(np.where(mask, rng.uniform(1, 5, mask.shape), 0.0
                               ).astype(np.float32))
    indptr, indices, data, nu, ni = csr_arrays(R)
    rows = np.repeat(np.arange(nu), np.diff(indptr))
    dcfg = DataConfig(hot_cols=16, dense_min_degree=80, max_bucket=128)
    ul = shard_layout(layout_from_coo(rows, indices, data, nu, ni, dcfg),
                      2, row_multiple=256)
    il = shard_layout(layout_from_coo(rows, indices, data, nu, ni, dcfg,
                                      transpose=True), 2, row_multiple=256)
    U0, V0 = _init(nu, ni, rank=64, seed=12)
    out = []
    for dev in ("cpu", "cuda"):
        prog = ShardedALSProgram(ul, il, pmesh.Mesh([torch.device(dev)] * 2),
                                 SolveConfig(rank=64, reg=0.1))
        ch.reset_counts()
        U, V, sse, n = prog.make_fit(3, nnz=R.nnz)(
            *prog.place_factors(U0, V0))
        out.append((pmesh.to_host(U), pmesh.to_host(V), sse.cpu().numpy()))
    assert ch.LAUNCHES["cholesky_solve_batched"] > 0
    assert ch.LAUNCHES["cholesky_solve_hot"] > 0
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))
