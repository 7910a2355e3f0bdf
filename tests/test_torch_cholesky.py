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


@pytest.mark.parametrize("b,k", [(24, 8), (40, 16), (64, 32), (9, 24),
                                 (1, 8), (257, 8)])
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
    # any batch up to k = 160; past it one block of the reference's
    assert pchol.kernel_supported(64, 65_536)
    assert pchol.kernel_supported(128, 65_536)
    assert pchol.kernel_supported(1, 1) and pchol.kernel_supported(160, 10**6)
    assert pchol.kernel_supported(168, 120)
    assert not pchol.kernel_supported(168, 121)
    assert pchol.kernel_supported(168, 56, two_operand=True)
    assert not pchol.kernel_supported(168, 57, two_operand=True)
    assert pchol.kernel_supported(656, 8)
    assert not pchol.kernel_supported(657, 1)
    assert pchol.hot_kernel_supported(64, pchol.hot_cols_auto(64))
    # the layout policy's hot width is taken at every rank the kernel takes
    assert all(pchol.hot_kernel_supported(k, pchol.hot_cols_cap(k))
               for k in range(1, pchol.KMAX + 1))
    assert pchol.hot_kernel_supported(32, 512)
    assert pchol.hot_kernel_supported(16, 1024)
    assert pchol.hot_kernel_supported(128, 32)
    assert pchol.hot_kernel_supported(160, 16)
    # past the reference's hot cap (32 at k = 128) the hot terms are folded
    assert not pchol.hot_kernel_supported(128, 256)
    assert not pchol.hot_kernel_supported(16, 1025)
    # smem_bytes of csrc/cholesky_solve.cu, both regimes: throughput
    # 4 (C kp + 2 (kp + 4) + kp (kp + 1) + 2 kp + 2 C) + 4 (C + warps),
    # latency 4 (max(C kp, 2 (4 kp + 20)) + kp (kp + 1) + 2 kp + 2 C)
    # + 4 warps
    assert pchol.hot_smem_bytes(64, 128) == 4 * (
        128 * 64 + 2 * 68 + 64 * 65 + 2 * 64 + 2 * 128) + 4 * (128 + 5)
    assert pchol.hot_smem_bytes(64, 128, latency=True) == 4 * (
        128 * 64 + 64 * 65 + 2 * 64 + 2 * 128) + 4 * 5
    assert pchol.hot_smem_bytes(7, 1, latency=True) == 4 * (
        2 * (4 * 8 + 20) + 8 * 9 + 2 * 8 + 2) + 4 * 5
    assert pchol.hot_smem_bytes(128, 32) == 4 * (
        32 * 128 + 2 * 132 + 128 * 129 + 2 * 128 + 2 * 32) + 4 * (32 + 8)
    # wherever the hot kernel is taken, the latency block fits as well
    assert all(pchol.hot_smem_bytes(k, c, latency=True) <= pchol.SMEM_MAX
               for k in range(1, pchol.KMAX + 1)
               for c in (1, 8, 128, 256, 512, 1024)
               if pchol.hot_kernel_supported(k, c))
    # vh (C, k) past the block's shared memory is routed
    assert pchol.hot_smem_bytes(64, 1024) > pchol.SMEM_MAX
    assert not pchol.hot_kernel_supported(64, 1024)
    assert pchol.hot_kernel_supported(136, 8)
    assert not pchol.hot_kernel_supported(168, 8)
    assert pchol.block_batch(64) == 256 and pchol.block_batch(16) == 512
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


@pytest.mark.parametrize("resident", [1, 396, 528, 924])
def test_latency_regime_boundary(resident):
    """The regime rule as a pure function: a batch of at most the latency
    kernel's resident blocks (one wave) takes the latency kernel, a larger
    one the persistent throughput kernel."""
    assert pchol.latency_regime(1, resident)
    assert pchol.latency_regime(resident, resident)
    assert not pchol.latency_regime(resident + 1, resident)
    assert pchol.latency_regime(max(resident - 1, 1), resident)
    assert not pchol.latency_regime(65_536, resident)
    # the main path's 256-row block is a latency launch at the card's
    # measured counts, its 4,201-row dense block a throughput one
    assert pchol.latency_regime(256, resident) == (resident >= 256)
    assert not pchol.latency_regime(4_201, resident)


def test_forced_regime_picks_one_kernel():
    """Inside ``forced_regime`` every launch takes the named regime's C
    export whatever its batch; outside it the rule picks again."""
    with pchol.forced_regime(True):
        assert pchol._pick("cholesky_solve_hot", 65_536, 64, 128, 0) == \
            "cholesky_solve_hot_lat"
    with pchol.forced_regime(False):
        assert pchol._pick("cholesky_solve_batched", 1, 64, 0, 0) == \
            "cholesky_solve_batched"
    with pytest.raises(RuntimeError):
        with pchol.forced_regime(True):
            raise RuntimeError
    assert pchol._forced is None


def _gpu_systems(gen, b, k, dev):
    """b SPD systems A Aᵀ + 0.5 I with rhs and a ridge, made on the card."""
    A = torch.randn(b, k, k, generator=gen, device=dev)
    G = (A @ A.transpose(1, 2)
         + 0.5 * torch.eye(k, device=dev)).contiguous()
    rhs = torch.randn(b, k, generator=gen, device=dev)
    reg = 0.05 + 0.15 * torch.rand(b, generator=gen, device=dev)
    return G, rhs, reg


def _gpu_hot(gen, b, k, c, dev):
    """A (b, C) bf16 hot slab whose first rows are all zero, the next all
    nonzero and the rest 28% nonzero (half-star values), and vh (C, k)."""
    stars = torch.randint(1, 11, (b, c), generator=gen, device=dev) * 0.5
    keep = torch.rand(b, c, generator=gen, device=dev) < 0.28
    keep[: b // 3] = False
    keep[b // 3: 2 * b // 3] = True
    hv = torch.where(keep, stars, 0.0).to(torch.bfloat16)
    vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
    return hv, vh


def _zero_identity_batch(gen, b, k, dev):
    """b systems, the first half all-zero or identity with rhs 0 (they
    must solve to exactly 0), the rest random SPD."""
    G, rhs, reg = _gpu_systems(gen, b, k, dev)
    h = b // 2
    G[:h] = 0.0
    G[1:h:2] = torch.eye(k, device=dev)
    rhs[:h] = 0.0
    reg[:h] = 0.0
    return G, rhs, reg, h


def _batches(resident, full=True):
    """The regimes' boundary: 1, 255, 256, 257 and the latency kernel's
    resident count and its neighbours (``full=False``: 1, 257 and the
    count's neighbours)."""
    if full:
        bs = {1, 255, 256, 257, resident - 1, resident, resident + 1}
    else:
        bs = {1, 257, resident, resident + 1}
    return sorted(b for b in bs if b >= 1)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel of the main path (and B3, its two-operand form)
    against its plain version on the card, in both regimes and at their
    boundary: B in {1, 255, 256, 257} and the latency kernel's resident
    count (as the card reports it) and that count +- 1; k in {1, 7, 63, 64,
    65, 128, 136, 157, 160}; the hot kernel at C in {1, 128, 1024} and at
    the layout policy's hot widths of ranks 32 and 16 (C=512, 1024) and the
    reference's caps at k = 128 and 160 (C=32, 16), with hot rows all zero, all nonzero and 28%
    nonzero, explicit weights and alpha=2.0. At every batch the wrapper
    takes the kernel that ``latency_regime`` names (bitwise equal to it),
    and the other regime's kernel agrees with the plain version too. Zero
    and identity systems solve to exactly 0 in each regime, and every
    kernel repeats bitwise. Shapes past the limits are routed (counted)
    instead of launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pchol.reset_counts()
    launches = dict.fromkeys(pchol.LAUNCHES, 0)
    ks = (1, 7, 63, 64, 65, 128, 136, 157, 160)

    def regime(name, b, k, c=0):
        lat, resident = pchol.solve_regime(name, b, k, c)
        assert resident >= 1
        return lat, resident

    def run(name, fn, plain, args, lat, kw=None):
        """The wrapper, then each regime's kernel, against the plain
        version; the wrapper's result is the named regime's, bitwise."""
        kw = kw or {}
        x = fn(*args, **kw)
        ref = plain(*args, **kw).cpu().numpy()
        _close(x.cpu().numpy(), ref)
        with pchol.forced_regime(lat):
            assert torch.equal(x, fn(*args, **kw)), f"{name} B={len(x)}"
        with pchol.forced_regime(not lat):
            _close(fn(*args, **kw).cpu().numpy(), ref)
        launches[name] += 3
        return x

    for k in ks:
        for name in ("cholesky_solve_batched", "cholesky_solve_2g"):
            _, resident = regime(name, 1, k)
            seen = set()
            for b in _batches(resident):
                lat = regime(name, b, k)[0]
                seen.add(lat)
                G, rhs, reg = _gpu_systems(gen, b, k, dev)
                if name == "cholesky_solve_2g":
                    G2 = _gpu_systems(gen, b, k, dev)[0]
                    run(name, pchol.cholesky_solve_2g,
                        pchol.cholesky_solve_2g_plain, (G, G2, rhs, reg), lat)
                else:
                    run(name, pchol.cholesky_solve_batched,
                        pchol.cholesky_solve_plain, (G, rhs, reg), lat)
            assert seen == {True, False}
    # the hot kernel: the main path's (k, C) = (64, 128) at every batch of
    # the boundary and both weightings; the layout policy's widths of ranks
    # 32 and 16 and the k=128 block at fewer batches, both weightings; the
    # other widths at fewer batches, one weighting each
    policy = ((32, 512), (16, 1024), (128, 32), (160, 16))
    n_routed = 0
    for k, c in [(k, c) for k in ks for c in (1, 128, 1024)] + list(policy):
        if not pchol.hot_kernel_supported(k, c):
            hv, vh = _gpu_hot(gen, 17, k, c, dev)
            pchol.cholesky_solve_hot(*_gpu_systems(gen, 17, k, dev), hv, vh)
            n_routed += 1
            launches["cholesky_solve_batched"] += 1   # the fold's solve
            continue
        _, resident = regime("cholesky_solve_hot", 1, k, c)
        main = (k, c) == (64, 128)
        seen = set()
        for i, b in enumerate(_batches(resident, full=main)):
            lat = regime("cholesky_solve_hot", b, k, c)[0]
            seen.add(lat)
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            hv, vh = _gpu_hot(gen, b, k, c, dev)
            both = main or (k, c) in policy
            for alpha in ((None, 2.0) if both else ((None, 2.0)[i % 2],)):
                run("cholesky_solve_hot", pchol.cholesky_solve_hot,
                    pchol.cholesky_solve_hot_plain, (G, rhs, reg, hv, vh),
                    lat, dict(alpha=alpha))
        assert seen == {True, False}
    assert n_routed > 0
    # zero and identity systems solve to exactly 0, and each kernel repeats
    # bitwise, in both regimes
    for k, c in ((64, 128), (7, 1024)) + policy:
        _, resident = regime("cholesky_solve_hot", 1, k, c)
        _, resident_1 = regime("cholesky_solve_batched", 1, k)
        for b in (8, resident + 1, resident_1 + 1):
            G, rhs, reg, h = _zero_identity_batch(gen, b, k, dev)
            G2 = torch.zeros_like(G)
            hv, vh = _gpu_hot(gen, b, k, c, dev)
            hv[:h] = 0
            cases = (
                ("cholesky_solve_batched", pchol.cholesky_solve_batched,
                 (G, rhs, reg)),
                ("cholesky_solve_2g", pchol.cholesky_solve_2g,
                 (G, G2, rhs, reg)),
                ("cholesky_solve_hot", pchol.cholesky_solve_hot,
                 (G, rhs, reg, hv, vh)))
            for name, fn, args in cases:
                x = fn(*args)
                assert bool(torch.isfinite(x).all())
                assert torch.equal(x[:h], torch.zeros_like(x[:h])), name
                assert torch.equal(x, fn(*args)), f"{name} not bitwise"
                launches[name] += 2
    assert {n: pchol.LAUNCHES[n] for n in pchol.REGIME_KINDS} == {
        n: launches[n] for n in pchol.REGIME_KINDS}
    assert pchol.ROUTED["cholesky_solve_hot"] == n_routed
    # past the reference's one-block batch (120 at k = 168) the solve is
    # routed to the anchor, as the reference routes it to XLA
    G, rhs, reg = _gpu_systems(gen, 121, 168, dev)
    _close(pchol.cholesky_solve_batched(G, rhs, reg).cpu().numpy(),
           pchol.anchor_solve(G, rhs, reg).cpu().numpy())
    assert pchol.ROUTED["cholesky_solve_batched"] == 1
    k = 64
    G = torch.zeros(4, k, k, device=dev)
    with pytest.raises(TypeError):
        pchol.cholesky_solve_batched(G.double(), torch.zeros(4, k, device=dev),
                                     torch.zeros(4, device=dev))
