"""The port's sharded serving (``ops.topk.sharded_topk`` and the sharded
route of ``ALS.recommend``) against the JAX package's on the same numpy
inputs, JAX on its 8 forced CPU devices and the port on a CPU mesh: the
same ids (and scores within 1e-5), with a padded last shard, exclusion and
a catalog smaller than k per shard; serving from the mesh copies no whole
table to the host. A padded row that reaches the serving back-map maps to
-1 in the port, where the reference raises (ROADMAP Queue 3, the serving
back-map divergence). The ``gpu`` test holds three shards on one card
against the CPU's:
``python -m pytest --noconftest -m gpu tests/test_torch_sharded_topk.py``."""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch import ALS
from recommendation_models_tpu_torch.ops import topk
from recommendation_models_tpu_torch.parallel.mesh import (
    Mesh, get_mesh, shard_put)

try:
    from recommendation_models_tpu import ALS as RefALS
    from recommendation_models_tpu.ops import topk as ref_topk
    from recommendation_models_tpu.parallel.mesh import (
        get_mesh as ref_get_mesh)
    from tests.conftest import tiny_problem
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    RefALS = None

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if RefALS is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def _case(seed, b, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def _both(U, V, k, S, exclude=None, **kw):
    import jax.numpy as jnp
    want = ref_topk.sharded_topk(
        jnp.asarray(U), jnp.asarray(V), k, ref_get_mesh(S, platform="cpu"),
        exclude=None if exclude is None else jnp.asarray(exclude), **kw)
    got = topk.sharded_topk(U, V, k, get_mesh(S, platform="cpu"),
                            exclude=exclude, **kw)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("b,n,d,k", [(4, 103, 6, 7), (3, 64, 5, 6),
                                     (5, 20, 4, 4), (6, 9_001, 8, 10)])
def test_sharded_topk_matches_reference(S, b, n, d, k):
    U, V = _case(b * n + S, b, n, d)
    (ws, wi), (gs, gi) = _both(U, V, k, S)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-6)
    s1, i1 = topk.topk_scores(U, torch.tensor(V), k)
    np.testing.assert_array_equal(gi, i1.numpy())


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_topk_exclusion_matches_reference(S):
    U, V = _case(1, 3, 64, 5)
    exclude = np.array([[0, 1], [10, 20], [-1, -1]], np.int32)
    (ws, wi), (gs, gi) = _both(U, V, 6, S, exclude=exclude)
    np.testing.assert_array_equal(gi, wi)
    # a catalog so small that rows-per-shard < k: the merge still pools
    # S * per candidates, wide enough to survive the exclusion
    U, V = _case(2, 5, 20, 4)
    exclude = np.tile(np.arange(12, dtype=np.int32), (5, 1))
    (ws, wi), (gs, gi) = _both(U, V, 4, S, exclude=exclude)
    np.testing.assert_array_equal(gi, wi)
    assert not (gi[:, :, None] == exclude[:, None, :]).any()


def test_sharded_topk_of_sharded_blocks_masks_the_padded_tail():
    """Blocks already on the mesh (a sharded fit's padded table): with
    ``n_valid`` the zero padding rows never become candidates."""
    U, V = _case(3, 4, 21, 6)
    U = -np.abs(U)                       # every real score below 0
    V = np.abs(V)
    mesh = Mesh([torch.device("cpu")] * 4)
    padded = np.zeros((24, 6), np.float32)
    padded[:21] = V
    blocks = shard_put(mesh, "data", padded)
    sc, it = topk.sharded_topk(U, blocks, 5, mesh, n_valid=21)
    want_s, want_i = topk.topk_scores(U, torch.tensor(V), 5)
    np.testing.assert_array_equal(it.numpy(), want_i.numpy())
    # without n_valid the zero rows outrank the negative scores
    _, it_all = topk.sharded_topk(U, blocks, 5, mesh)
    assert (it_all.numpy() >= 21).any()
    with pytest.raises(ValueError, match="k must be"):
        topk.sharded_topk(U, blocks, 22, mesh, n_valid=21)


def test_padded_rows_map_to_minus_one_where_the_reference_raises():
    """The serving back-map around a sharded backend fed a padded table
    without ``n_valid``: the port maps the padded rows to -1 (ROADMAP Queue
    3, the serving back-map divergence); the JAX package raises
    IndexError."""
    import jax.numpy as jnp
    U, V = _case(4, 3, 13, 4)
    U, V = -np.abs(U), np.abs(V)
    padded = np.zeros((16, 4), np.float32)
    padded[:13] = V
    perm_back, perm_fwd = topk.serving_permutation(13)
    mesh = get_mesh(8, platform="cpu")
    served = topk.permuted_topk(
        lambda Uq, k, excl: topk.sharded_topk(Uq, shard_put(
            mesh, "data", padded), k, mesh),
        perm_back, perm_fwd)
    _, ids = served(U, 5, None)
    assert (ids == -1).any() and ((ids >= 0) & (ids < 13) | (ids == -1)).all()
    ref_served = ref_topk.permuted_topk(
        lambda Uq, k, excl: ref_topk.sharded_topk(
            jnp.asarray(Uq), jnp.asarray(padded), k,
            ref_get_mesh(8, platform="cpu")),
        perm_back, perm_fwd)
    with pytest.raises(IndexError):
        ref_served(U, 5, None)


@pytest.fixture(scope="module")
def fitted():
    """Both estimators fit sharded 8 ways on a 500-item catalog (the
    row-multiple padding leaves zero rows in the last shard)."""
    R = tiny_problem(60, 500, density=0.08, seed=40)
    rng = np.random.default_rng(1)
    U0 = (0.1 * rng.standard_normal((60, 6))).astype(np.float32)
    V0 = (0.1 * rng.standard_normal((500, 6))).astype(np.float32)
    kw = dict(rank=6, reg=0.2, n_sweeps=2, n_shards=8, platform="cpu")
    ref = RefALS(**kw).fit(R, U0=U0, V0=V0)
    got = ALS(**kw).fit(R, U0=U0, V0=V0)
    return R, ref, got


@pytest.mark.parametrize("exclude_seen", [True, False])
def test_sharded_recommend_matches_reference(fitted, exclude_seen):
    R, ref, got = fitted
    assert got._sharded_program.ipr * 8 > 500       # a padded last shard
    users = np.arange(48)
    ws, wi = ref.recommend(users, n=7, exclude_seen=exclude_seen,
                           method="exact")
    gs, gi = got.recommend(users, n=7, exclude_seen=exclude_seen,
                           method="exact")
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)
    assert ((gi >= 0) & (gi < 500)).all()
    if exclude_seen:
        Rl = R.tolil()
        for i, u in enumerate(users):
            assert not set(gi[i]) & set(Rl.rows[u])


def test_sharded_serving_copies_no_table_to_the_host(fitted):
    R, _, got = fitted
    got._U_host = got._V_host = None     # as straight after the fit
    got.recommend(np.arange(10), n=5)
    assert got._U_host is None and got._V_host is None
    prog = got._sharded_program
    key, serve = got._vserve_cache
    assert key is got._V_dev and len(serve) == 8
    perm_back, _ = topk.serving_permutation(500)
    full = np.concatenate([b.numpy() for b in serve])
    np.testing.assert_array_equal(full[:500], got.V_[perm_back])
    assert not full[500:].any() and full.shape[0] == 8 * prog.ipr
    # exact best unseen item is rank 1, against the materialized factors
    users = np.arange(20)
    sc, it = got.recommend(users, n=3, exclude_seen=True)
    scores = got.U_[users] @ got.V_.T
    Rl = R.tolil()
    for i, u in enumerate(users):
        scores[i, Rl.rows[u]] = -np.inf
    np.testing.assert_allclose(sc[:, 0], scores.max(1), rtol=1e-5)


def test_assigning_v_drops_the_sharded_serving_catalog():
    got = ALS(rank=4, n_sweeps=2, n_shards=3, platform="cpu").fit(
        tiny_problem(20, 30, density=0.3, seed=41))
    got.recommend([0], n=3, exclude_seen=False)
    assert got._vserve_cache is not None
    V = got.V_ * -1
    got.V_ = V
    assert got._V_dev is None and "_vserve_cache" not in got.__dict__
    _, it = got.recommend(np.arange(5), n=5, exclude_seen=False)
    want = np.argsort(-(got.U_[:5] @ V.T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(it, want)


@pytest.mark.gpu
def test_sharded_topk_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.ops.gram import full_f32
    full_f32()
    U, V = _case(10, 300, 20_000, 64)
    rng = np.random.default_rng(10)
    exclude = np.where(rng.random((300, 128)) < 0.7,
                       rng.integers(0, 20_000, (300, 128)), -1)
    cpu = Mesh([torch.device("cpu")] * 3)
    card = Mesh([torch.device("cuda")] * 3)
    for ex in (None, exclude):
        c = topk.sharded_topk(U, V, 10, cpu, exclude=ex)
        g = topk.sharded_topk(U, V, 10, card, exclude=ex)
        assert g[1].is_cuda
        np.testing.assert_array_equal(g[1].cpu().numpy(), c[1].numpy())
        np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
