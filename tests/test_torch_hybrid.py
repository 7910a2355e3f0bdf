"""The port's 2-D observation-parallel ALS (``parallel/hybrid_als.py``,
``parallel/mesh.py::get_hybrid_mesh`` and the 2-D collectives,
``ALS(topology='obs_parallel')``) against the JAX package's on the same
numpy inputs, JAX on its 8 forced CPU devices and the port on a CPU mesh:

- ``get_hybrid_mesh``'s shapes and errors, and the 2-D ``psum`` and
  ``all_gather`` along one axis, each group summed apart even where every
  position sits on one device;
- ``split_layout_slices`` bit for bit at D = 1, 2, 3;
- ``HybridALSProgram`` at (D, S) = (1, 8), (2, 4), (4, 2): explicit,
  implicit, ``reg_by_degree`` and ``reg=0``, at tests/test_mesh_hybrid.py's
  tolerances (factors rtol 5e-4, atol 5e-5; SSE rtol 1e-4); its init bit
  for bit, ``make_fit`` against the sweep-by-sweep path, and
  ``collective_bytes_per_sweep`` exactly;
- the estimator against the JAX estimator (rtol 2e-4), its errors with the
  reference's messages, and a 2-D refit after a 1-D sharded fit serving the
  new factors.

The card's case (``gpu``) runs (D, S) = (2, 2) on one card through B1:
``python -m pytest --noconftest -m gpu tests/test_torch_hybrid.py``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.config import DataConfig, SolveConfig
from recommendation_models_tpu_torch.data.layout import (
    build_layout, csr_arrays, layout_from_coo, shard_layout)
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.parallel import mesh as pmesh
from recommendation_models_tpu_torch.parallel.hybrid_als import (
    HybridALSProgram, split_layout_slices)
from recommendation_models_tpu_torch.parallel.mesh import to_host

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from recommendation_models_tpu import ALS as RefALS
    from recommendation_models_tpu.config import DataConfig as RefDataConfig
    from recommendation_models_tpu.config import (
        SolveConfig as RefSolveConfig)
    from recommendation_models_tpu.data import layout as ref_layout
    from recommendation_models_tpu.parallel.hybrid_als import (
        HybridALSProgram as RefProgram,
        split_layout_slices as ref_split)
    from recommendation_models_tpu.parallel.mesh import (
        get_hybrid_mesh as ref_get_hybrid_mesh)
    from tests.conftest import tiny_problem
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    RefALS = None

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if RefALS is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def _problem(seed=21, n_users=96, n_items=80, n_obs=2400):
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=5, seed=seed)
    return sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))


def _plain_layouts(R, make_layout, make_from_coo, dcfg):
    indptr, indices, data, n_users, n_items = csr_arrays(R)
    ul = make_layout(indptr, indices, data, n_users, n_items, dcfg)
    rows = np.repeat(np.arange(n_users), np.diff(indptr))
    il = make_from_coo(rows, indices, data, n_users, n_items, dcfg,
                       transpose=True)
    return ul, il


def _port_program(R, cfg, D, S, device=CPU):
    ul, il = _plain_layouts(R, build_layout, layout_from_coo,
                            DataConfig(dense_whales=False, hot_cols=0))
    mesh = pmesh.HybridMesh([[device] * S] * D)
    return HybridALSProgram(shard_layout(ul, S), shard_layout(il, S), mesh,
                            cfg)


def _ref_program(R, cfg, D, S):
    ul, il = _plain_layouts(R, ref_layout.build_layout,
                            ref_layout.layout_from_coo,
                            RefDataConfig(dense_whales=False, hot_cols=0))
    mesh = ref_get_hybrid_mesh(D * S, num_slices=D, platform="cpu")
    return RefProgram(ref_layout.shard_layout(ul, S),
                      ref_layout.shard_layout(il, S), mesh, cfg)


def _warm(n_users, n_items, k, seed=3):
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal((n_users, k)).astype(np.float32),
            0.05 * rng.standard_normal((n_items, k)).astype(np.float32))


# ------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n,slices", [(8, 2), (8, 4), (6, 3), (4, None)])
def test_get_hybrid_mesh_shapes_like_the_reference(n, slices):
    got = pmesh.get_hybrid_mesh(n, num_slices=slices, platform="cpu")
    want = ref_get_hybrid_mesh(n, num_slices=slices, platform="cpu")
    assert got.axis_names == want.axis_names == ("dcn", "data")
    assert got.shape == dict(want.shape)
    assert len(got.grid) == want.devices.shape[0]
    assert got.devices == (CPU,) * n and got.size == n
    custom = pmesh.get_hybrid_mesh(n, num_slices=slices, axes=("x", "y"),
                                   platform="cpu")
    assert custom.axis_names == ("x", "y")


def test_get_hybrid_mesh_errors(monkeypatch):
    with pytest.raises(ValueError) as want:
        ref_get_hybrid_mesh(8, num_slices=3, platform="cpu")
    with pytest.raises(ValueError) as got:
        pmesh.get_hybrid_mesh(8, num_slices=3, platform="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="rectangular"):
        pmesh.HybridMesh([[CPU, CPU], [CPU]])
    # too few cards: the reference's error, never a CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 4 shards but only 2 "
                                         "devices"):
        pmesh.get_hybrid_mesh(4, num_slices=2)
    mesh = pmesh.get_hybrid_mesh(2, num_slices=2)
    assert mesh.grid == ((torch.device("cuda", 0),),
                         (torch.device("cuda", 1),))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.get_hybrid_mesh(4, num_slices=2)


def test_collectives_along_one_axis_sum_each_group_apart():
    """(D, S) = (2, 2) with all four positions on one device and a
    different part at each: a sum along 'dcn' gives S different sums, one
    per 'data' index (a per-device sum would hand every group the first
    group's), and the same holds along 'data'; the JAX package's psum on
    its 2-D mesh gives the same numbers."""
    mesh = pmesh.HybridMesh([[CPU, CPU], [CPU, CPU]])
    parts = tuple(tuple(torch.full((2, 3), float(10 * d + s + 1))
                        for s in range(2)) for d in range(2))
    dcn = pmesh.psum_along(mesh, parts, "dcn")
    data = pmesh.psum_along(mesh, parts, "data")
    for d in range(2):
        for s in range(2):
            np.testing.assert_array_equal(
                dcn[d][s].numpy(), np.full((2, 3), (s + 1) + (10 + s + 1)))
            np.testing.assert_array_equal(
                data[d][s].numpy(), np.full((2, 3), (10 * d + 1)
                                            + (10 * d + 2)))
    assert dcn[0][0] is dcn[1][0] and dcn[0][0] is not dcn[0][1]
    gathered = pmesh.all_gather_along(mesh, parts, "data")
    for d in range(2):
        np.testing.assert_array_equal(
            gathered[d][1].numpy(),
            np.concatenate([parts[d][0].numpy(), parts[d][1].numpy()]))
    with pytest.raises(ValueError, match="axis"):
        pmesh.psum_along(mesh, parts, "model")
    # the JAX package's psum along each axis of its (2, 2) mesh
    rmesh = ref_get_hybrid_mesh(4, num_slices=2, platform="cpu")
    x = np.concatenate([np.concatenate([parts[d][s].numpy()
                                        for s in range(2)], axis=1)
                        for d in range(2)])
    for axis, got in (("dcn", dcn), ("data", data)):
        f = jax.jit(jax.shard_map(lambda v: jax.lax.psum(v, axis),
                                  mesh=rmesh, in_specs=P("dcn", "data"),
                                  out_specs=P("dcn", "data")))
        want = np.asarray(f(jnp.asarray(x)))
        for d in range(2):
            for s in range(2):
                np.testing.assert_array_equal(
                    got[d][s].numpy(), want[2 * d:2 * d + 2,
                                            3 * s:3 * s + 3])
    # a 2-D program's table comes to the host from its first slice
    np.testing.assert_array_equal(
        to_host(parts), np.concatenate([parts[0][0].numpy(),
                                        parts[0][1].numpy()]))


# ------------------------------------------------------------ the split

@pytest.mark.parametrize("D", [1, 2, 3])
def test_split_layout_slices_bitwise(D):
    R = _problem(seed=5)
    for layouts in zip(
            _plain_layouts(R, build_layout, layout_from_coo,
                           DataConfig(dense_whales=False, hot_cols=0)),
            _plain_layouts(R, ref_layout.build_layout,
                           ref_layout.layout_from_coo,
                           RefDataConfig(dense_whales=False, hot_cols=0))):
        got = split_layout_slices(shard_layout(layouts[0], 3), D)
        want = ref_split(ref_layout.shard_layout(layouts[1], 3), D)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                assert g[key].shape == w[key].shape, key
                assert g[key].tobytes() == w[key].tobytes(), key
            assert g["row_ids"].shape[2] % 8 == 0
    indptr, indices, data, n_users, n_items = csr_arrays(R)
    dense = build_layout(indptr, indices, data, n_users, n_items,
                         DataConfig(dense_min_degree=8))
    with pytest.raises(ValueError, match="dense-whale / hot-column"):
        split_layout_slices(shard_layout(dense, 2), D)


# ---------------------------------------------------------- the program

CONFIGS = {
    "explicit": dict(rank=5, reg=0.2),
    "implicit": dict(rank=5, reg=0.2, alpha=1.5),
    "reg_by_degree": dict(rank=4, reg=0.05, reg_by_degree=True),
    "reg0": dict(rank=4, reg=0.0),
}


def _config_problem(config):
    # reg=0 needs every row's gram of full rank (no ridge), so a denser
    # problem; the rest use tests/test_mesh_hybrid.py's
    if config == "reg0":
        return tiny_problem(48, 40, density=0.5, seed=22)
    return _problem(seed=22)


@pytest.mark.parametrize("D,S", [(1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_program_matches_reference(config, D, S):
    R = _config_problem(config)
    n_users, n_items = R.shape
    kw = CONFIGS[config]
    prog = _port_program(R, SolveConfig(**kw), D, S)
    ref = _ref_program(R, RefSolveConfig(**kw), D, S)
    assert (prog.collective_bytes_per_sweep()
            == ref.collective_bytes_per_sweep())
    U0, V0 = _warm(n_users, n_items, kw["rank"])
    U, V = prog.place_factors(U0, V0)
    Ur, Vr = ref.place_factors(U0, V0)
    for _ in range(2):
        U, V = prog.sweep(U, V)
        Ur, Vr = ref.sweep(Ur, Vr)
    for a, b in ((U, Ur), (V, Vr)):
        np.testing.assert_allclose(to_host(a), np.asarray(b), rtol=5e-4,
                                   atol=5e-5)
    np.testing.assert_allclose(float(prog.train_sse(U, V)),
                               float(ref.train_sse(Ur, Vr)), rtol=1e-4)
    # every slice holds the same (replicated) table
    for d in range(1, D):
        for s in range(S):
            assert torch.equal(U[d][s], U[0][s])


@pytest.mark.parametrize("D,S", [(2, 4), (4, 2)])
def test_init_make_fit_and_stepwise_path(D, S):
    """The init bit for bit; ``make_fit`` against the JAX package's, and
    against the sweep-by-sweep path of the same program (the same factors
    exactly; the riding item-side SSE against ``train_sse`` at rtol
    1e-4)."""
    R = _problem(seed=23)
    n_users, n_items = R.shape
    kw = dict(rank=5, reg=0.2)
    prog = _port_program(R, SolveConfig(**kw), D, S)
    ref = _ref_program(R, RefSolveConfig(**kw), D, S)
    U, V = prog.init_factors(7, 0.05)
    Ur, Vr = ref.init_factors(7, 0.05)
    for a, b in ((U, Ur), (V, Vr)):
        assert to_host(a).tobytes() == np.asarray(b).tobytes()
    nnz = R.nnz
    Uf, Vf, hist, n_done = prog.make_fit(2, nnz=nnz)(U, V)
    Urf, Vrf, hist_r, n_done_r = ref.make_fit(2, nnz=nnz)(Ur, Vr)
    assert n_done == int(n_done_r) == 2
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_r), rtol=1e-4)
    np.testing.assert_allclose(to_host(Uf), np.asarray(Urf), rtol=5e-4,
                               atol=5e-5)
    Us, Vs = U, V
    sse = []
    for _ in range(2):
        Us, Vs = prog.sweep(Us, Vs)
        sse.append(float(prog.train_sse(Us, Vs)))
    np.testing.assert_array_equal(to_host(Us), to_host(Uf))
    np.testing.assert_array_equal(to_host(Vs), to_host(Vf))
    np.testing.assert_allclose(hist.numpy(), sse, rtol=1e-4)
    # tol: stops once two sweeps' RMSEs differ by less than tol
    _, _, hist_t, n_t = prog.make_fit(6, tol=10.0, nnz=nnz)(U, V)
    assert n_t == 2 and (hist_t.numpy()[2:] == -1).all()


def test_program_checks_its_mesh_and_layouts():
    R = _problem(seed=24)
    ul, il = _plain_layouts(R, build_layout, layout_from_coo,
                            DataConfig(dense_whales=False, hot_cols=0))
    with pytest.raises(ValueError, match="'data' axis size"):
        HybridALSProgram(shard_layout(ul, 2), shard_layout(il, 4),
                         pmesh.HybridMesh([[CPU] * 2] * 2), SolveConfig())
    with pytest.raises(ValueError, match="need a 2-D"):
        HybridALSProgram(shard_layout(ul, 2), shard_layout(il, 2),
                         pmesh.get_mesh(2, platform="cpu"), SolveConfig())


# -------------------------------------------------------- the estimator

def _estimators(**kw):
    return (ALS(platform="cpu", **kw), RefALS(platform="cpu", **kw))


@pytest.mark.parametrize("alpha", [None, 1.0])
def test_estimator_matches_reference(alpha):
    """tests/test_mesh_hybrid.py::test_estimator_topology_obs_parallel
    through both packages: the factors within rtol 2e-4, the history and
    the bytes; the fitted tables are on the host and serve like the
    single-device route."""
    R = tiny_problem(56, 42, density=0.3, seed=11)
    U0, V0 = _warm(56, 42, 5, seed=12)
    kw = dict(rank=5, reg=0.2, alpha=alpha, n_sweeps=3, n_shards=8,
              num_slices=2, topology="obs_parallel")
    m, r = _estimators(**kw)
    m.fit(R, U0=U0, V0=V0)
    r.fit(R, U0=U0, V0=V0)
    np.testing.assert_allclose(m.U_, r.U_, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(m.V_, r.V_, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(m.history_, r.history_, rtol=2e-4)
    assert m.exchange_bytes_per_sweep_ == r.exchange_bytes_per_sweep_
    assert m._sharded_program is None and m._U_dev is None
    _, items = m.recommend([0, 1], n=5)
    _, want = r.recommend([0, 1], n=5)
    np.testing.assert_array_equal(items, want)
    # the default init: the reference's sharded draw, bit for bit
    m, r = _estimators(rank=4, n_sweeps=1, n_shards=4, num_slices=2,
                       topology="obs_parallel")
    m.fit(R)
    r.fit(R)
    np.testing.assert_allclose(m.U_, r.U_, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kwargs", [
    dict(n_shards=8, num_slices=3),                    # not divisible
    dict(n_shards=8, num_slices=2, exchange="all_to_all"),
    dict(n_shards=8),                                  # no num_slices
    dict(n_shards=8, num_slices=1),
    dict(n_shards=2, num_slices=4),
])
def test_estimator_errors_like_the_reference(kwargs):
    R = tiny_problem(20, 16, seed=2)
    m, r = _estimators(rank=3, n_sweeps=1, topology="obs_parallel",
                       **kwargs)
    with pytest.raises(ValueError) as want:
        r.fit(R)
    with pytest.raises(ValueError) as got:
        m.fit(R)
    assert str(got.value) == str(want.value)


def test_2d_refit_after_1d_fit_serves_the_new_factors():
    """A 1-D sharded fit keeps its tables on the mesh and serves from
    cached catalogs; a 2-D refit of the same estimator must drop them all,
    so ``recommend`` serves the 2-D fit's factors."""
    R = tiny_problem(40, 30, density=0.3, seed=13)
    m = ALS(rank=4, n_sweeps=2, n_shards=4, platform="cpu").fit(R)
    m.recommend([0, 1, 2], n=5)                       # fills the caches
    assert m._U_dev is not None and "_vserve_cache" in m.__dict__
    m.set_params(num_slices=2, topology="obs_parallel", n_sweeps=3, seed=4)
    m.fit(R)
    assert m._U_dev is None and m._V_dev is None
    assert m._sharded_program is None
    assert "_vserve_cache" not in m.__dict__
    sc, items = m.recommend([0, 1, 2], n=5, exclude_seen=False)
    scores = m.U_[[0, 1, 2]] @ m.V_.T
    want = np.argsort(-scores, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(items, want)
    np.testing.assert_allclose(sc, np.take_along_axis(scores, want, 1),
                               rtol=1e-5)


def test_estimator_checkpoints_the_padded_tables(tmp_path):
    """A stepwise 2-D fit checkpoints the first slice's padded tables, as
    the 1-D fit does, and ``resume`` slices them to the true sizes."""
    R = tiny_problem(30, 22, density=0.3, seed=14)
    kw = dict(rank=3, n_sweeps=2, n_shards=4, num_slices=2,
              topology="obs_parallel", platform="cpu")
    m = ALS(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw).fit(R)
    plain = ALS(**kw).fit(R)
    np.testing.assert_allclose(m.history_, plain.history_, rtol=1e-6)
    back = ALS(checkpoint_dir=str(tmp_path), **kw)
    assert back.resume() == 2
    np.testing.assert_array_equal(back.U_, m.U_)
    np.testing.assert_array_equal(back.V_, m.V_)


# ----------------------------------------------------------- the card

@pytest.mark.gpu
def test_2x2_on_the_card_matches_the_cpu():
    """HybridMesh([[cuda:0] * 2] * 2): the program launches B1 (one solve
    a position a half) and no B2, and agrees with the same program on the
    CPU (tests/test_torch_sharded.py's card tolerance, on its
    well-conditioned problem: every row's degree far above the rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.ops import cholesky as ch
    rng = np.random.default_rng(38)
    mask = rng.random((300, 200)) < 0.3
    R = sp.csr_matrix(np.where(mask, rng.uniform(1, 5, mask.shape), 0.0
                               ).astype(np.float32))
    cfg = SolveConfig(rank=16, reg=0.1)
    U0, V0 = _warm(300, 200, 16)
    out = {}
    for dev in (CPU, torch.device("cuda", 0)):
        prog = _port_program(R, cfg, 2, 2, device=dev)
        U, V = prog.place_factors(U0, V0)
        ch.reset_counts()
        U, V, hist, _ = prog.make_fit(3, nnz=R.nnz)(U, V)
        out[dev.type] = (to_host(U), to_host(V), hist.cpu().numpy(),
                         dict(ch.LAUNCHES))
    assert out["cuda"][3]["cholesky_solve_batched"] == 3 * 2 * 4
    assert out["cuda"][3]["cholesky_solve_hot"] == 0
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))
