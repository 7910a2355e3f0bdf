"""The port's batched Cholesky solves against the reference's Pallas kernels.

On the CPU the wrappers take their kernels' plain PyTorch versions; they are
held here against the JAX kernels run in interpret mode, at the tolerance of
tests/test_pallas_cholesky.py (atol 5e-4 * scale, rtol 5e-4). The CUDA
kernels themselves are held against the plain versions by the ``gpu`` test
at the end, which runs only on a card.
"""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.ops import cholesky as pchol
from recommendation_models_tpu_torch.ops import solve as psolve

try:
    import jax.numpy as jnp
    from recommendation_models_tpu.ops import solve as rsolve
    from recommendation_models_tpu.ops.pallas import cholesky as rchol
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs, as
    # `python -m pytest --noconftest -m gpu tests/test_torch_cholesky.py`
    jnp = rsolve = rchol = None

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if rchol is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _spd(rng, b, k, jitter=0.5):
    A = rng.standard_normal((b, k, k)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + jitter * np.eye(k, dtype=np.float32)


def _close(x, ref):
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(x, ref, atol=5e-4 * scale, rtol=5e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hot_case(rng, b, k, c, density=0.4):
    hv = np.where(rng.random((b, c)) < density,
                  rng.integers(1, 11, (b, c)) * 0.5, 0.0).astype(np.float32)
    vh = (rng.standard_normal((c, k)) * 0.3).astype(np.float32)
    return hv, vh


@pytest.mark.parametrize("b,k", [(24, 8), (40, 16), (64, 32), (9, 24)])
def test_plain_matches_pallas_kernel(rng, b, k):
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    ref = np.asarray(rchol._cholesky_solve_t(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), interpret=True)).T
    x = pchol.cholesky_solve_plain(_t(G), _t(rhs), _t(reg)).numpy()
    _close(x, ref)
    exact = np.stack([np.linalg.solve(G[i] + reg[i] * np.eye(k), rhs[i])
                      for i in range(b)])
    _close(x, exact)


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_hot_plain_matches_pallas_hot_kernel(rng, alpha):
    b, k, c = 40, 16, 24
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    hv, vh = _hot_case(rng, b, k, c)
    ref = np.asarray(rchol._cholesky_solve_t_hot(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), jnp.asarray(hv.T, jnp.bfloat16),
        jnp.asarray(vh.T), alpha=alpha, interpret=True)).T
    x = pchol.cholesky_solve_hot_plain(
        _t(G), _t(rhs), _t(reg), _t(hv).to(torch.bfloat16), _t(vh),
        alpha).numpy()
    _close(x, ref)


@pytest.mark.parametrize("solver", ["pallas", "xla", "lu", "auto"])
def test_solve_spd_t_matches_reference(rng, solver):
    b, k = 48, 16
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    Gt, rt = G.transpose(1, 2, 0), rhs.T
    ref = np.asarray(rsolve.solve_spd_t(jnp.asarray(Gt), jnp.asarray(rt),
                                        solver if solver != "auto" else
                                        "pallas", reg_vec=jnp.asarray(reg)))
    x = psolve.solve_spd_t(_t(Gt), _t(rt), solver, reg_vec=_t(reg))
    assert tuple(x.shape) == (k, b)
    _close(x.numpy(), ref)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("alpha", [None, 3.0])
def test_solve_spd_t_hot_matches_reference_and_caps(rng, alpha, wide):
    """In-kernel hot terms, and a hot block wider than the kernels' caps:
    the reference folds it in XLA (C > hot_cols_cap), the port in torch
    (C > HOT_CMAX on a card); both then run the plain solve."""
    b, k = 40, 16
    c = max(rchol.hot_cols_cap(k), pchol.HOT_CMAX) + 8 if wide else 24
    assert not wide or not pchol.hot_kernel_supported(k, c)
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    hv, vh = _hot_case(rng, b, k, c, density=0.05 if wide else 0.4)
    Gt, rt = G.transpose(1, 2, 0), rhs.T
    ref = np.asarray(rsolve.solve_spd_t_hot(
        jnp.asarray(Gt), jnp.asarray(rt), jnp.asarray(hv.T),
        jnp.asarray(vh.T), alpha=alpha, solver="pallas",
        reg_vec=jnp.asarray(reg)))
    for solver in ("pallas", "xla"):
        x = psolve.solve_spd_t_hot(_t(Gt), _t(rt), _t(hv.T), _t(vh.T),
                                   alpha=alpha, solver=solver,
                                   reg_vec=_t(reg))
        _close(x.numpy(), ref)


def test_zero_and_identity_padded_systems_solve_to_zero(rng):
    """All-zero systems with rhs 0 and identity-padded systems with rhs 0
    solve to exactly 0 (tests/test_pallas_cholesky.py zero guard), beside
    real systems in the same batch, on both entries."""
    k = 8
    G = np.concatenate([np.zeros((3, k, k), np.float32),
                        np.broadcast_to(np.eye(k, dtype=np.float32),
                                        (3, k, k)),
                        _spd(rng, 4, k)])
    rhs = np.concatenate([np.zeros((6, k), np.float32),
                          rng.standard_normal((4, k)).astype(np.float32)])
    reg = np.zeros(10, np.float32)
    ref = np.asarray(rchol._cholesky_solve_t(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), interpret=True)).T
    x = pchol.cholesky_solve_plain(_t(G), _t(rhs), _t(reg)).numpy()
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[:6], 0.0)
    np.testing.assert_array_equal(ref[:6], 0.0)
    _close(x[6:], ref[6:])
    hv = np.zeros((10, 8), np.float32)
    hv[6:, :3] = 4.5
    vh = (rng.standard_normal((8, k)) * 0.3).astype(np.float32)
    xh = pchol.cholesky_solve_hot_plain(_t(G), _t(rhs), _t(reg),
                                        _t(hv).to(torch.bfloat16), _t(vh))
    np.testing.assert_array_equal(xh[:6].numpy(), 0.0)


def test_ill_conditioned_with_ridge(rng):
    b, k = 16, 32
    A = rng.standard_normal((b, k, k)).astype(np.float32)
    G = A @ A.transpose(0, 2, 1)
    G[0] *= 1e-5
    G = G + 1e-3 * np.eye(k, dtype=np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    x = pchol.cholesky_solve_plain(_t(G), _t(rhs), torch.zeros(b)).numpy()
    assert np.isfinite(x).all()
    resid = np.einsum("bij,bj->bi", G, x) - rhs
    assert np.abs(resid).max() < 1e-2 * max(np.abs(rhs).max(), 1.0)


def test_flat_entry_and_solve_spd_shapes(rng):
    b, k = 20, 16
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    ref = np.asarray(rsolve.solve_spd_flat(
        jnp.asarray(G.reshape(b, -1)), jnp.asarray(rhs), k, "pallas",
        reg_vec=jnp.asarray(reg)))
    x = psolve.solve_spd_flat(_t(G.reshape(b, -1)), _t(rhs), k, "auto",
                              reg_vec=_t(reg))
    _close(x.numpy(), ref)
    for solver in ("pallas", "xla", "lu"):
        G4 = _t(G[:12].reshape(3, 4, k, k))
        x4 = psolve.solve_spd(G4, _t(rhs[:12].reshape(3, 4, k)), solver)
        assert tuple(x4.shape) == (3, 4, k)
        ref4 = np.asarray(rsolve.solve_spd(jnp.asarray(G[:12]),
                                           jnp.asarray(rhs[:12]), "xla"))
        _close(x4.reshape(12, k).numpy(), ref4)
    assert tuple(psolve.solve_spd(torch.zeros(0, k, k), torch.zeros(0, k)
                                  ).shape) == (0, k)
    with pytest.raises(ValueError, match="solver"):
        psolve.solve_spd(_t(G), _t(rhs), "bogus")


def test_ridge_helpers_match_reference(rng):
    G = _spd(rng, 5, 6)
    deg = np.array([0.0, 1.0, 2.0, 5.0, 9.0], np.float32)
    np.testing.assert_allclose(
        psolve.add_ridge(_t(G), 0.3, _t(deg)).numpy(),
        np.asarray(rsolve.add_ridge(jnp.asarray(G), 0.3, jnp.asarray(deg))),
        rtol=1e-6)
    np.testing.assert_allclose(
        psolve.flat_ridge(_t(G.reshape(5, -1)), 6, 0.3).numpy(),
        np.asarray(rsolve.flat_ridge(jnp.asarray(G.reshape(5, -1)), 6, 0.3)),
        rtol=1e-6)
    assert psolve.resolve_compute_dtype("auto") == "float32"
    assert psolve.resolve_solver("auto") == "pallas"


def test_kernel_limits_and_routing_predicates():
    assert pchol.kernel_supported(64) and pchol.kernel_supported(128)
    assert pchol.kernel_supported(1) and not pchol.kernel_supported(129)
    assert pchol.hot_kernel_supported(64, pchol.hot_cols_auto(64))
    # the layout policy's hot width is taken at every rank the kernel takes
    assert all(pchol.hot_kernel_supported(k, pchol.hot_cols_cap(k))
               for k in range(1, pchol.KMAX + 1))
    assert pchol.hot_kernel_supported(32, 512)
    assert pchol.hot_kernel_supported(16, 1024)
    assert pchol.hot_kernel_supported(128, 256)
    assert not pchol.hot_kernel_supported(16, 1025)
    # vh (C, k) past the block's shared memory is routed
    assert pchol.hot_smem_bytes(64, 1024) > pchol.SMEM_MAX
    assert not pchol.hot_kernel_supported(64, 1024)
    assert not pchol.hot_kernel_supported(136, 8)
    assert pchol.block_batch(64) == 256
    # CPU tensors take the plain versions: no launch, no routing counted
    pchol.reset_counts()
    pchol.cholesky_solve_batched(torch.eye(4)[None].repeat(2, 1, 1),
                                 torch.zeros(2, 4), torch.zeros(2))
    assert pchol.LAUNCHES == {k: 0 for k in pchol.LAUNCHES}
    assert pchol.ROUTED == {k: 0 for k in pchol.ROUTED}
    with pytest.raises(ValueError, match="device"):
        pchol.cholesky_solve_batched(torch.empty(2, 4, 4, device="meta"),
                                     torch.empty(2, 4, device="meta"),
                                     torch.empty(2, device="meta"))


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, at the main
    path's k=64 (C=128 for the hot kernel), at the layout policy's hot
    widths of ranks 32 and 16 (C=512, 1024) and at the limits; shapes past
    the limits are routed (counted) instead of launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pchol.reset_counts()
    n_launch = 0
    for b, k in ((300, 64), (70, 128), (33, 10), (5, 1), (17, 136)):
        G = _spd(rng, b, k)
        rhs = rng.standard_normal((b, k)).astype(np.float32)
        reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
        args = [_t(a).to(dev) for a in (G, rhs, reg)]
        x = pchol.cholesky_solve_batched(*args).cpu().numpy()
        ref = pchol.cholesky_solve_plain(*args).cpu().numpy()
        _close(x, ref)
        n_launch += pchol.kernel_supported(k)
    assert pchol.LAUNCHES["cholesky_solve_batched"] == n_launch
    assert pchol.ROUTED["cholesky_solve_batched"] == 1
    hot_cases = ((300, 64, 128, None), (100, 64, 128, 2.0),
                 (40, 128, 256, None), (60, 32, 512, None),
                 (40, 16, 1024, 2.0), (20, 64, 1024, None))
    for b, k, c, alpha in hot_cases:
        G = _spd(rng, b, k)
        rhs = rng.standard_normal((b, k)).astype(np.float32)
        reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
        hv, vh = _hot_case(rng, b, k, c)
        args = [_t(G).to(dev), _t(rhs).to(dev), _t(reg).to(dev),
                _t(hv).to(dev, torch.bfloat16), _t(vh).to(dev)]
        x = pchol.cholesky_solve_hot(*args, alpha=alpha).cpu().numpy()
        ref = pchol.cholesky_solve_hot_plain(*args, alpha=alpha)
        _close(x, ref.cpu().numpy())
    assert pchol.LAUNCHES["cholesky_solve_hot"] == 5
    assert pchol.ROUTED["cholesky_solve_hot"] == 1
    # zero and identity-padded systems solve to exactly 0 on the card
    k = 64
    G = torch.zeros(4, k, k, device=dev)
    G[2:] = torch.eye(k, device=dev)
    z = pchol.cholesky_solve_batched(G, torch.zeros(4, k, device=dev),
                                     torch.zeros(4, device=dev))
    assert torch.equal(z, torch.zeros_like(z))
    with pytest.raises(TypeError):
        pchol.cholesky_solve_batched(G.double(), torch.zeros(4, k, device=dev),
                                     torch.zeros(4, device=dev))
