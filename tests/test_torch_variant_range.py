"""The solve variants' range against the reference's: B4 (the rank-1
schedules), B5a (panel), B5b (Schur) and B5c (dual) over the JAX package's
whole Pallas range, any batch to kp = 160 and one thread-block cluster a
system to kp = 656, and the public entries' shape contract.

On the CPU the wrappers take their plain versions; they are held here
against the reference's ``_cholesky_solve_t`` with the same flags in
interpret mode (k = 136, 160, 168; Schur 144, 160, 176), and against f64
``np.linalg.solve`` at k = 256 and 656, at tests/test_pallas_cholesky.py's
tolerance (atol 5e-4 * scale, rtol 5e-4). Each wrapper's routing is held
against ``pallas_supported`` for k = 1..700. The CUDA kernels at those
orders are held against the plain versions by the ``gpu`` tests, which run
only on a card:
``python -m pytest --noconftest -m gpu tests/test_torch_variant_range.py``.
"""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.ops import cholesky as pchol

try:
    import jax.numpy as jnp
    from recommendation_models_tpu.ops.pallas import cholesky as rchol
except ImportError:
    # the card's machine has no JAX; there only the gpu tests run
    jnp = rchol = None

torch.set_num_threads(2)

# the reference's flags of each kernel instantiation (tests/
# test_torch_cholesky_variants.py's table), and the port's wrapper call
VARIANTS = {
    "rank1": dict(panel=False, pair=False, subs2=False),
    "rank1_subs2": dict(panel=False, pair=False),
    "pair_s1": dict(panel=False, pair=True, subs2=False),
    "panel": dict(panel=True),
    "schur": dict(panel=False, schur=True),
    "schur_s1": dict(panel=False, schur=True, subs2=False),
    "dual": dict(panel=False, dual=True),
}
# instantiation -> (wrapper name, kernel call, plain call), each of
# (G, rhs, reg)
KERNELS = {
    "rank1": ("cholesky_solve_rank1",
              lambda G, r, g: pchol.cholesky_solve_rank1(G, r, g, 1, 1),
              lambda G, r, g: pchol.cholesky_solve_rank1_plain(G, r, g, 1, 1)),
    "rank1_subs2": (
        "cholesky_solve_rank1",
        lambda G, r, g: pchol.cholesky_solve_rank1(G, r, g, 1, 2),
        lambda G, r, g: pchol.cholesky_solve_rank1_plain(G, r, g, 1, 2)),
    "pair_s1": ("cholesky_solve_rank1",
                lambda G, r, g: pchol.cholesky_solve_rank1(G, r, g, 2, 1),
                lambda G, r, g: pchol.cholesky_solve_rank1_plain(G, r, g, 2,
                                                                 1)),
    "panel": ("cholesky_solve_panel", pchol.cholesky_solve_panel,
              pchol.cholesky_solve_panel_plain),
    "schur": ("cholesky_solve_schur",
              lambda G, r, g: pchol.cholesky_solve_schur(G, r, g, 2),
              lambda G, r, g: pchol.cholesky_solve_schur_plain(G, r, g, 2)),
    "schur_s1": ("cholesky_solve_schur",
                 lambda G, r, g: pchol.cholesky_solve_schur(G, r, g, 1),
                 lambda G, r, g: pchol.cholesky_solve_schur_plain(G, r, g,
                                                                  1)),
    "dual": ("cholesky_solve_dual", pchol.cholesky_solve_dual,
             pchol.cholesky_solve_dual_plain),
}
SCHUR = ("schur", "schur_s1")
BATCHES = (1, 2, 7, 8, 24, 47, 48, 49, 56, 88, 112, 113, 120, 121, 255, 256,
           257, 4_201, 65_536)


def _orders(name, plain, schur):
    return schur if name in SCHUR else plain


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


def _exact(G, rhs, reg):
    k = G.shape[1]
    return np.stack([np.linalg.solve(np.float64(G[i]) + reg[i] * np.eye(k),
                                     np.float64(rhs[i]))
                     for i in range(G.shape[0])])


def _inputs(k, b, seed):
    rng = np.random.default_rng(seed)
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    return G, rhs, reg


@pytest.mark.parametrize("name,k", [
    (n, k) for n in VARIANTS
    for k in _orders(n, (136, 160, 168), (144, 160, 176))])
def test_plain_matches_pallas_variant_at_wide_orders(name, k):
    """Each plain version, through the port's batch-minor entry with the
    reference's flags, against the same variant of the Pallas kernel in
    interpret mode: past the old k = 128 cap to kp = 160 (any batch), and at
    the first one-block order (two systems: B5c's one block is even)."""
    b = 2
    G, rhs, reg = _inputs(k, b, k)
    kw = VARIANTS[name]
    ref = np.asarray(rchol._cholesky_solve_t(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), interpret=True, **kw)).T
    x = pchol.cholesky_solve_t(_t(G.transpose(1, 2, 0)), _t(rhs.T),
                               _t(reg[None]), **kw)
    assert tuple(x.shape) == (k, b)
    _close(x.numpy().T, ref)


@pytest.mark.parametrize("name,k", [(n, k) for n in VARIANTS
                                    for k in (256, 656)])
def test_plain_versions_at_one_block_orders(name, k):
    """The plain versions (the one-block kernels' references on the card)
    at k = 256 and 656 against f64 np.linalg.solve; the wrappers on CPU
    tensors take them."""
    b = 2
    G, rhs, reg = _inputs(k, b, k + 1)
    _, fn, plain = KERNELS[name]
    x = plain(_t(G), _t(rhs), _t(reg)).numpy()
    _close(x, _exact(G, rhs, reg))
    assert np.array_equal(fn(_t(G), _t(rhs), _t(reg)).numpy(), x)


def test_variant_routing_matches_pallas_supported(monkeypatch):
    """For k = 1..700 and a grid of batches, each variant wrapper, handed a
    tensor it takes for a card's, launches its kernel exactly where the
    reference's ``pallas_supported`` holds (Schur: at k % 16 == 0; it
    refuses the rest): the kernel of ``csrc/cholesky_rank_panel.cu`` to k =
    160, the one-block kernel past it, and the torch anchor (counted in
    ``ROUTED``) elsewhere. Checked up to the launch, which is replaced
    here; the shapes live on the meta device, so nothing is allocated."""
    taken = []
    monkeypatch.setattr(pchol, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pchol, "_launch_solve",
                        lambda name, *a, **kw: taken.append("rank_panel"))
    monkeypatch.setattr(pchol, "_launch_variant_large",
                        lambda name, *a: taken.append("one_block"))
    monkeypatch.setattr(pchol, "anchor_solve",
                        lambda *a: taken.append("anchor"))
    meta = torch.device("meta")
    pchol.reset_counts()
    for k in range(1, 701):
        for b in BATCHES:
            G = torch.empty((b, k, k), device=meta)
            rhs, reg = torch.empty((b, k), device=meta), torch.empty(
                (b,), device=meta)
            ok = rchol.pallas_supported(k, b)
            want = ("anchor" if not ok
                    else "one_block" if k > pchol.VARIANT_KMAX
                    else "rank_panel")
            for label, (name, fn, _) in KERNELS.items():
                if label in SCHUR and k % 16:
                    with pytest.raises(ValueError, match="k % 16"):
                        fn(G, rhs, reg)
                    continue
                taken.clear()
                fn(G, rhs, reg)
                assert taken == [want], (label, k, b)
    # past kp = 160 the one-block batch is the reference's block_batch
    assert pchol.block_batch(168) == 120 and pchol.block_batch(656) == 8
    n_routed = sum(not rchol.pallas_supported(k, b)
                   for k in range(1, 701) for b in BATCHES)
    n_schur = sum(not rchol.pallas_supported(k, b)
                  for k in range(16, 701, 16) for b in BATCHES)
    assert pchol.ROUTED == {
        **dict.fromkeys(pchol.KERNELS, 0),
        "cholesky_solve_rank1": 3 * n_routed,
        "cholesky_solve_panel": n_routed,
        "cholesky_solve_schur": 2 * n_schur,
        "cholesky_solve_dual": n_routed}


@pytest.mark.parametrize("k,frame,dual_systems", [
    (64, "rank", 2), (128, "rank", 2), (129, "panel", 1), (132, "panel", 1),
    (136, "panel", 1), (160, "panel", 1)])
def test_frame_and_dual_systems_a_block_by_order(k, frame, dual_systems):
    """``variant_frame`` and ``variant_block_systems`` mirror csrc/
    cholesky_rank_panel.cu: B4 and B5c take the rank frame to kp = 128 (the
    dual's block two systems) and the panel frame past it (one system a
    block); B5a is a panel frame and B5b a Schur frame at every order."""
    for name in ("cholesky_solve_rank1", "cholesky_solve_dual"):
        assert pchol.variant_frame(name, k) == frame
    assert pchol.variant_frame("cholesky_solve_panel", k) == "panel"
    assert pchol.variant_frame("cholesky_solve_schur", k) == "schur"
    assert pchol.variant_block_systems("cholesky_solve_dual", k) == \
        dual_systems
    for name in ("cholesky_solve_rank1", "cholesky_solve_panel",
                 "cholesky_solve_schur"):
        assert pchol.variant_block_systems(name, k) == 1


# ------------------------------------------- the public entries' contract

def _queue3_systems(b, k):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((b, k, k)).astype(np.float32)
    G = A @ A.transpose(0, 2, 1) + np.eye(k, dtype=np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    return G, rhs


@pytest.mark.parametrize("entry,b,k,error", [
    ("shaped", 200, 168, ValueError),
    ("flat", 200, 168, ValueError),
    ("flat", 300, 12, AssertionError),
])
def test_public_entries_solve_shapes_the_reference_refuses(entry, b, k,
                                                           error):
    """The reference's public ``cholesky_solve`` and ``cholesky_solve_flat``
    refuse a multi-block batch past kp = 160 (``ValueError``: its Mosaic
    lane limit), and the flat entry a k that is not a multiple of 8
    (``AssertionError``). The port solves both: on the CPU through the plain
    version, on a card through the torch anchor (counted in ``ROUTED``;
    the ``gpu`` test below) or the kernel. A difference by design."""
    G, rhs = _queue3_systems(b, k)
    if entry == "shaped":
        with pytest.raises(error):
            rchol.cholesky_solve(jnp.asarray(G), jnp.asarray(rhs))
        x = pchol.cholesky_solve(_t(G), _t(rhs))
    else:
        Gf = G.reshape(b, k * k)
        with pytest.raises(error):
            rchol.cholesky_solve_flat(jnp.asarray(Gf), jnp.asarray(rhs), k)
        x = pchol.cholesky_solve_flat(_t(Gf), _t(rhs), k)
    assert tuple(x.shape) == (b, k)
    _close(x.numpy(), _exact(G, rhs, np.zeros(b, np.float32)))


# ------------------------------------------------------------ on the card

WIDE = (136, 157, 160)            # past the old cap, any batch
WIDE_NARROW = (129, 153)          # B4 and B5c: a four-column last panel
WIDE_SCHUR = (144, 160)
ONE_BLOCK = (161, 168, 256, 512, 656)
ONE_BLOCK_SCHUR = (176, 256, 512, 656)
MULTIWAVE = (168, 256, 512, 656)      # a batch past one wave of clusters
MULTIWAVE_SCHUR = (176,)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _systems_on(dev, b, k, seed):
    """``_spd``'s systems made on the card (4,096 of order 160 are slow to
    make on the host): G = A Aᵀ / k + 0.5 I, rhs, reg in [0.05, 0.2)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(b, k, k, generator=gen, device=dev) / k ** 0.5
    G = torch.bmm(A, A.transpose(1, 2)) + 0.5 * torch.eye(k, device=dev)
    rhs = torch.randn(b, k, generator=gen, device=dev)
    reg = 0.05 + 0.15 * torch.rand(b, generator=gen, device=dev)
    return G.contiguous(), rhs, reg


def _batches(label, k):
    if k <= pchol.VARIANT_KMAX:
        # dual: an odd B past one wave too
        return ((1, 2, 37, 4_096, 4_097) if label == "dual"
                else (1, 37, 4_096))
    bb = pchol.block_batch(k)
    return (1, 3, bb - 1, bb) if label == "dual" else (1, bb)


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(KERNELS))
def test_cuda_variants_over_the_reference_range(label):
    """Each instantiation on the card, at k = 136, 157, 160 (B4 and B5c
    also 129 and 153, whose last panel is four columns wide; Schur 144,
    160) and B in {1, 37, 4096} (dual also 2 and 4,097), and at the
    one-block orders
    k = 161, 168, 256, 512, 656 (Schur 176, 256, 512, 656) at B = 1 and
    ``block_batch(k)`` (dual also at an odd B), and ``block_batch(k)``
    systems at k = 168, 256, 512, 656 (Schur 176, 256, 512, 656) in more
    than one wave of clusters (``multiwave_cluster``, bitwise equal to the
    rule's cluster): against its plain version, repeated bitwise, launched exactly where ``kernel_supported`` says
    (the one-block kernel past k = 160), nothing routed; zero and identity
    systems with rhs 0 solve to exactly 0; a batch one past the block at
    the first one-block order is routed and counted."""
    dev = _card()
    name, fn, plain = KERNELS[label]
    narrow = () if label in SCHUR or label == "panel" else WIDE_NARROW
    orders = (tuple(sorted(_orders(label, WIDE, WIDE_SCHUR) + narrow))
              + _orders(label, ONE_BLOCK, ONE_BLOCK_SCHUR))
    for k in orders:
        for b in _batches(label, k):
            G, rhs, reg = _systems_on(dev, b, k, 1000 * k + b)
            pchol.reset_counts()
            x = fn(G, rhs, reg)
            torch.cuda.synchronize()
            assert pchol.LAUNCHES[name] == 1 and not any(
                pchol.ROUTED.values()), (label, k, b)
            assert pchol.LARGE_LAUNCHES[name] == (k > pchol.VARIANT_KMAX)
            _close(x.cpu().numpy(), plain(G, rhs, reg).cpu().numpy())
            assert torch.equal(x, fn(G, rhs, reg)), (label, k, b)
        if k in MULTIWAVE or k in MULTIWAVE_SCHUR and label in SCHUR:
            # block_batch(k) systems in more than one wave of clusters,
            # bitwise equal to the rule's cluster
            b = pchol.block_batch(k)
            G, rhs, reg = _systems_on(dev, b, k, 1000 * k + b)
            x = fn(G, rhs, reg)
            pchol.reset_counts()
            with pchol.forced_cluster(pchol.multiwave_cluster(k, b)):
                xw = fn(G, rhs, reg)
                assert torch.equal(xw, fn(G, rhs, reg)), (label, k)
            assert pchol.LARGE_LAUNCHES[name] == 2
            assert torch.equal(xw, x), (label, k)
            _close(xw.cpu().numpy(), plain(G, rhs, reg).cpu().numpy())
        n = 5 if k > pchol.VARIANT_KMAX else 9
        z = torch.zeros(n, k, k, device=dev)
        z[n // 2:] = torch.eye(k, device=dev)
        out = fn(z, torch.zeros(n, k, device=dev),
                 torch.zeros(n, device=dev))
        assert torch.equal(out, torch.zeros_like(out)), (label, k)
    k = 176 if label in SCHUR else 168
    b = pchol.block_batch(k) + 1
    G, rhs, reg = _systems_on(dev, b, k, 7)
    pchol.reset_counts()
    x = fn(G, rhs, reg)
    assert pchol.ROUTED[name] == 1 and pchol.LAUNCHES[name] == 0
    _close(x.cpu().numpy(), plain(G, rhs, reg).cpu().numpy())


@pytest.mark.gpu
def test_cuda_rank_schedules_share_bits_in_the_panel_frame():
    """Past kp = 128 B4's three forms and B5c run the panel frame with
    every term alone, where their orders of terms coincide: on the card
    they give the same bits, and so do their plain versions."""
    dev = _card()
    labels = ("rank1", "rank1_subs2", "pair_s1", "dual")
    for k in WIDE_NARROW + WIDE:
        G, rhs, reg = _systems_on(dev, 37, k, k)
        assert all(pchol.variant_frame(KERNELS[n][0], k) == "panel"
                   for n in labels)
        xs = [KERNELS[n][1](G, rhs, reg) for n in labels]
        assert all(torch.equal(xs[0], x) for x in xs[1:]), k


@pytest.mark.gpu
def test_cuda_public_entries_route_the_refused_shapes():
    """The card's side of the public entries' contract: (200, 168), shaped
    and flat, is past the one-block batch, so it is routed to the torch
    anchor and counted; flat (300, 12) launches B1."""
    dev = _card()
    for entry, b, k in (("shaped", 200, 168), ("flat", 200, 168),
                        ("flat", 300, 12)):
        G, rhs = _queue3_systems(b, k)
        pchol.reset_counts()
        if entry == "shaped":
            x = pchol.cholesky_solve(_t(G).to(dev), _t(rhs).to(dev))
        else:
            x = pchol.cholesky_solve_flat(_t(G.reshape(b, k * k)).to(dev),
                                          _t(rhs).to(dev), k)
        torch.cuda.synchronize()
        routed = not pchol.kernel_supported(k, b)
        assert pchol.ROUTED["cholesky_solve_batched"] == routed
        assert pchol.LAUNCHES["cholesky_solve_batched"] == (not routed)
        _close(x.cpu().numpy(), _exact(G, rhs, np.zeros(b, np.float32)))
