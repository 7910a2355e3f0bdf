"""The solve kernels' range against the reference's: the routing policy
(``block_batch``, ``kernel_supported``, the hot gate) equal to the JAX
package's functions, the sweep's padded rows at rank 16, the plain versions
at the orders the CUDA kernels reach past k = 128 (the one-block regime to
k = 656 included) against the JAX package on the CPU, and a rank-160 ALS
fit through both packages. The CUDA kernels at those orders are held
against their plain versions by the ``gpu`` test, which runs only on a card.

Tolerance 5e-4 * scale (atol) and 5e-4 (rtol), as tests/test_pallas_cholesky.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recommendation_models_tpu_torch.ops import cholesky as pchol

try:
    import jax.numpy as jnp
    from recommendation_models_tpu.ops import solve as rsolve
    from recommendation_models_tpu.ops.pallas import cholesky as rchol
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs, as
    # `python -m pytest --noconftest -m gpu tests/test_torch_kernel_range.py`
    jnp = rsolve = rchol = None

torch.set_num_threads(2)

BATCHES = (1, 7, 8, 24, 47, 48, 49, 56, 88, 120, 121, 255, 256, 257, 599,
           65_536)
NEW_ORDERS = (136, 160, 168, 256, 656)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if rchol is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference package is not installed")


def _spd(rng, b, k, jitter=0.5):
    A = rng.standard_normal((b, k, k)).astype(np.float32) / np.sqrt(k)
    return A @ A.transpose(0, 2, 1) + jitter * np.eye(k, dtype=np.float32)


def _close(x, ref):
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(x, ref, atol=5e-4 * scale, rtol=5e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_block_batch_matches_reference():
    got = [pchol.block_batch(k) for k in range(1, 701)]
    assert got == [rchol.block_batch(k) for k in range(1, 701)]
    assert pchol.block_batch(16) == 512 and pchol.block_batch(168) == 120
    assert [pchol.two_operand_block(k) for k in (160, 168, 256, 656)] == [
        128, 56, 24, 8]


@pytest.mark.parametrize("two_operand", [False, True])
def test_kernel_supported_matches_pallas_supported(two_operand):
    for k in range(1, 701):
        got = [pchol.kernel_supported(k, b, two_operand) for b in BATCHES]
        want = [rchol.pallas_supported(k, b, two_operand=two_operand)
                for b in BATCHES]
        assert got == want, k


def test_hot_predicate_matches_reference_gate():
    """``hot_kernel_supported`` against ``ops/solve.py::solve_spd_t_hot``'s
    gate (pallas_supported, a 128-multiple batch block, C <= the cap) at
    the hot policy's widths (the cap and the auto width of each order) and
    around them, at every order the reference's entry takes (k % 8 == 0)."""
    for k in range(8, 705, 8):
        cap = rchol.hot_cols_cap(k)
        widths = {1, 8, 16, 32, 128, 1024, cap, cap + 8,
                  rchol.hot_cols_auto(k)} - {0}
        for c in sorted(widths):
            for b in (1, 256, 4_201):
                want = (rchol.pallas_supported(k, b)
                        and rchol.block_batch(k) % 128 == 0 and c <= cap)
                assert pchol.hot_kernel_supported(k, c) == want, (k, c, b)
    assert pchol.hot_cols_cap(160) == 16 and pchol.hot_cols_auto(160) == 0


def test_device_buckets_rows_match_reference_at_rank16():
    """At rank 16 on the ML-100K shape the sweep pads buckets to the same
    rows in both packages (512-row granules: ``block_batch`` at kp <= 32)."""
    import recommendation_models_tpu.config as rc
    import recommendation_models_tpu_torch.config as pc
    from recommendation_models_tpu.data.layout import layout_from_coo as rl
    from recommendation_models_tpu.data.synthetic import synthetic_ratings
    from recommendation_models_tpu.solver import als_sweep as rsw
    from recommendation_models_tpu_torch.data.layout import (
        layout_from_coo as pl)
    from recommendation_models_tpu_torch.solver import als_sweep as psw
    u, i, r = synthetic_ratings(943, 1682, 100_000, rank=8, noise=0.3,
                                seed=11)
    for transpose in (False, True):
        ref = rsw.device_buckets(
            rl(u, i, r, 943, 1682, rc.DataConfig(), transpose=transpose),
            rchol.block_batch(16))
        got = psw.device_buckets(
            pl(u, i, r, 943, 1682, pc.DataConfig(), transpose=transpose),
            pchol.block_batch(16), "cpu")
        want = [b["row_ids"].shape[0] for b in ref if "row_ids" in b]
        rows = [b["row_ids"].shape[0] for b in got if "row_ids" in b]
        assert rows == want
        # the 512-row granule: a 257..1024-row bucket pads to 1024 (768
        # rows at a 256-row granule)
        assert 1024 in rows


def _reference_solve(k, G, rhs, reg, G2=None):
    """The JAX package's solve of the same systems: its Pallas kernel in
    interpret mode at k <= 168 (small batches), else its XLA path."""
    Gt = jnp.asarray(G.transpose(1, 2, 0))
    Gt2 = None if G2 is None else jnp.asarray(G2.transpose(1, 2, 0))
    if k <= 168:
        return np.asarray(rchol._cholesky_solve_t(
            Gt, jnp.asarray(rhs.T), jnp.asarray(reg[None]), interpret=True,
            Gt2=Gt2)).T
    return np.asarray(rsolve.solve_spd_t(Gt, jnp.asarray(rhs.T), "xla",
                                         reg_vec=jnp.asarray(reg),
                                         Gt2=Gt2)).T


@pytest.mark.parametrize("k", NEW_ORDERS)
def test_plain_versions_at_new_orders(k):
    """B1's and B3's plain versions (the one-block kernel's too: it
    computes their functions) at the new orders against the JAX package on
    the CPU."""
    rng = np.random.default_rng(k)
    b = 3 if k <= 256 else 2
    G, G2 = _spd(rng, b, k), _spd(rng, b, k, jitter=0.1)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    ref = _reference_solve(k, G, rhs, reg)
    x = pchol.cholesky_solve_plain(_t(G), _t(rhs), _t(reg)).numpy()
    _close(x, ref)
    # the wrappers on CPU tensors take the plain versions
    assert np.array_equal(
        pchol.cholesky_solve_batched(_t(G), _t(rhs), _t(reg)).numpy(), x)
    ref2 = _reference_solve(k, G, rhs, reg, G2)
    x2 = pchol.cholesky_solve_2g_plain(_t(G), _t(G2), _t(rhs), _t(reg))
    _close(x2.numpy(), ref2)
    assert np.array_equal(pchol.cholesky_solve_2g(
        _t(G), _t(G2), _t(rhs), _t(reg)).numpy(), x2.numpy())


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_hot_plain_at_k160(alpha):
    """B2's plain version at k = 160 with the reference's cap C = 16."""
    rng = np.random.default_rng(160)
    b, k, c = 3, 160, 16
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    hv = np.where(rng.random((b, c)) < 0.4, rng.integers(1, 11, (b, c)) * 0.5,
                  0.0).astype(np.float32)
    vh = (rng.standard_normal((c, k)) * 0.3).astype(np.float32)
    ref = np.asarray(rchol._cholesky_solve_t_hot(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), jnp.asarray(hv.T, jnp.bfloat16),
        jnp.asarray(vh.T), alpha=alpha, interpret=True)).T
    x = pchol.cholesky_solve_hot_plain(
        _t(G), _t(rhs), _t(reg), _t(hv).to(torch.bfloat16), _t(vh),
        alpha).numpy()
    _close(x, ref)


def test_rank160_fit_matches_reference():
    """``ALS(rank=160, n_sweeps=3)`` on a 300 x 200 problem through both
    packages from one warm start: the port on its plain versions, the JAX
    package on its CPU path. The histories are the exact masked SSE (the
    riding identity's f32 cancellation would differ between summation
    orders), and reg = 1.0 keeps a rank-160 system of about 40 ratings a
    row well conditioned."""
    from recommendation_models_tpu import ALS as RALS
    from recommendation_models_tpu_torch import ALS as PALS
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_u, n_i, k = 300, 200, 160
    u, i, r = synthetic_ratings(n_u, n_i, 12_000, rank=8, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_u, n_i))
    g = np.random.default_rng(0)
    U0 = (0.01 * g.standard_normal((n_u, k))).astype(np.float32)
    V0 = (0.01 * g.standard_normal((n_i, k))).astype(np.float32)
    kw = dict(rank=k, reg=1.0, n_sweeps=3, sse_mode="separate")
    ref = RALS(**kw, platform="cpu").fit(R, U0=U0, V0=V0)
    got = PALS(**kw, platform="cpu").fit(R, U0=U0, V0=V0)
    np.testing.assert_allclose(got.history_, ref.history_, rtol=1e-5)
    assert got.history_[-1] < got.history_[0]


# ------------------------------------------------------------ on the card

def _gpu_systems(gen, b, k, dev, jitter=0.5):
    A = torch.randn(b, k, k, generator=gen, device=dev) / k ** 0.5
    G = (A @ A.transpose(1, 2) + jitter * torch.eye(k, device=dev)
         ).contiguous()
    rhs = torch.randn(b, k, generator=gen, device=dev)
    reg = 0.05 + 0.15 * torch.rand(b, generator=gen, device=dev)
    return G, rhs, reg


def _gpu_close(x, ref):
    _close(x.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_at_new_orders():
    """On the card: B1, B2 (C = the reference's cap) and B3 at k = 136,
    157 and 160 at 1, 256 and 4,201 systems, and the one-block kernel at
    k = 161, 168, 256, 512 and 656 at B = 1 and ``block_batch(k)`` (B3 at
    the halved block), each against its plain version, repeated bitwise,
    counted in ``LAUNCHES`` with nothing routed; zero and identity systems
    with rhs 0 solve to exactly 0; one batch past the one-block batch is
    routed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pchol.reset_counts()
    launches = dict.fromkeys(pchol.LAUNCHES, 0)

    def run(name, fn, plain, args, kw=None):
        kw = kw or {}
        x = fn(*args, **kw)
        _gpu_close(x, plain(*args, **kw))
        assert torch.equal(x, fn(*args, **kw)), name
        launches[name] += 2

    for k in (136, 157, 160):
        c = pchol.hot_cols_cap(k)
        for b in (1, 256, 4_201):
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            G2 = _gpu_systems(gen, b, k, dev, jitter=0.1)[0]
            run("cholesky_solve_batched", pchol.cholesky_solve_batched,
                pchol.cholesky_solve_plain, (G, rhs, reg))
            run("cholesky_solve_2g", pchol.cholesky_solve_2g,
                pchol.cholesky_solve_2g_plain, (G, G2, rhs, reg))
            stars = torch.randint(1, 11, (b, c), generator=gen, device=dev)
            keep = torch.rand(b, c, generator=gen, device=dev) < 0.3
            hv = torch.where(keep, stars * 0.5, 0.0).to(torch.bfloat16)
            vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
            for alpha in (None, 2.0):
                run("cholesky_solve_hot", pchol.cholesky_solve_hot,
                    pchol.cholesky_solve_hot_plain, (G, rhs, reg, hv, vh),
                    dict(alpha=alpha))
    for k in (161, 168, 256, 512, 656):
        for b in sorted({1, pchol.block_batch(k)}):
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            run("cholesky_solve_large", pchol.cholesky_solve_batched,
                pchol.cholesky_solve_plain, (G, rhs, reg))
        for b in sorted({1, pchol.two_operand_block(k)}):
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            G2 = _gpu_systems(gen, b, k, dev, jitter=0.1)[0]
            run("cholesky_solve_large", pchol.cholesky_solve_2g,
                pchol.cholesky_solve_2g_plain, (G, G2, rhs, reg))
    assert pchol.LAUNCHES == launches
    assert not any(pchol.ROUTED.values()), pchol.ROUTED
    for k in (160, 168, 656):
        b = 8
        G, rhs, reg = _gpu_systems(gen, b, k, dev)
        G[:4] = 0.0
        G[1:4:2] = torch.eye(k, device=dev)
        rhs[:4] = 0.0
        reg[:4] = 0.0
        for x in (pchol.cholesky_solve_batched(G, rhs, reg),
                  pchol.cholesky_solve_2g(G, torch.zeros_like(G), rhs, reg)):
            assert torch.equal(x[:4], torch.zeros_like(x[:4])), k
            assert bool(torch.isfinite(x).all())
    G, rhs, reg = _gpu_systems(gen, 121, 168, dev)
    _gpu_close(pchol.cholesky_solve_batched(G, rhs, reg),
               pchol.anchor_solve(G, rhs, reg))
    assert pchol.ROUTED["cholesky_solve_batched"] == 1
