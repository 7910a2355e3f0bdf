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


# B1's kernel by order at batches 1, r, r + 1, 2 r, 2 r + 1, 4,097 and
# 65,536, for the latency kernel's r resident blocks (132 on an H100 at
# k = 129-160): to kp = 128 latency or throughput; past it the throughput
# kernel only to two waves up to kp = 152, else the panel frame. B2 and B3
# take the same frames (the panel frame past kp = 128 since their panel
# kernels exist).
_L, _T, _P = "latency", "throughput", "panel"
B1_FRAMES = {
    128: (_L, _L, _T, _T, _T, _T, _T),
    129: (_L, _L, _T, _T, _P, _P, _P),
    136: (_L, _L, _T, _T, _P, _P, _P),
    144: (_L, _L, _T, _T, _P, _P, _P),
    152: (_L, _L, _T, _T, _P, _P, _P),
    153: (_L, _L, _P, _P, _P, _P, _P),
    160: (_L, _L, _P, _P, _P, _P, _P),
}


@pytest.mark.parametrize("k", sorted(B1_FRAMES))
@pytest.mark.parametrize("resident", [132, 264])
def test_b1_frame_by_order_and_batch(k, resident):
    """``solve_frame``, the one rule of the regime kernels' launches: B1,
    B2 and B3 past kp = 128 keep their latency kernel to one wave and their
    throughput kernel to two up to kp = 152, and take the panel frame of
    csrc/cholesky_rank_panel.cu beyond."""
    r = resident
    batches = (1, r, r + 1, 2 * r, 2 * r + 1, 4_097, 65_536)
    for name in pchol.REGIME_KINDS:
        got = tuple(pchol.solve_frame(name, b, k, r) for b in batches)
        assert got == B1_FRAMES[k], name


def test_b1_launch_takes_the_export_of_its_frame(monkeypatch):
    """The export each frame names (a card's 132 resident blocks assumed),
    and its library: the panel frames of B1, B2 and B3 live in
    csrc/cholesky_rank_panel.cu; ``forced_regime(False)`` takes the kernel
    of a batch past the latency kernel's wave (at two waves or fewer the
    throughput kernel to kp = 152, else the panel frame)."""
    monkeypatch.setattr(pchol, "_resident", lambda name, k, c, dev: 132)
    pick = pchol._pick
    assert pick("cholesky_solve_batched", 132, 160, 0, 0) == \
        "cholesky_solve_batched_lat"
    assert pick("cholesky_solve_batched", 264, 136, 0, 0) == \
        "cholesky_solve_batched"
    for b, k in ((133, 153), (265, 129), (65_536, 160)):
        fn = pick("cholesky_solve_batched", b, k, 0, 0)
        assert fn == "cholesky_solve_batched_panel"
        assert pchol.EXPORT_SOURCE[fn] == "cholesky_rank_panel"
        assert fn in pchol.SOURCES["cholesky_rank_panel"]
    for name in ("cholesky_solve_hot", "cholesky_solve_2g"):
        c = 16 if name == "cholesky_solve_hot" else 0
        assert pick(name, 132, 160, c, 0) == name + "_lat"
        assert pick(name, 264, 152, c, 0) == name
        assert pick(name, 65_536, 128, c, 0) == name
        for b, k in ((133, 153), (265, 129), (65_536, 160)):
            fn = pick(name, b, k, c, 0)
            assert fn == name + "_panel"
            assert pchol.EXPORT_SOURCE[fn] == "cholesky_rank_panel"
            assert fn in pchol.SOURCES["cholesky_rank_panel"]
        with pchol.forced_regime(False):
            assert pick(name, 1, 160, c, 0) == name + "_panel"
            assert pick(name, 1, 136, c, 0) == name
            assert pick(name, 1, 64, c, 0) == name
    with pchol.forced_regime(False):
        assert pick("cholesky_solve_batched", 1, 136, 0, 0) == \
            "cholesky_solve_batched"
        assert pick("cholesky_solve_batched", 265, 136, 0, 0) == \
            "cholesky_solve_batched_panel"
        assert pick("cholesky_solve_batched", 1, 160, 0, 0) == \
            "cholesky_solve_batched_panel"
        assert pick("cholesky_solve_batched", 1, 128, 0, 0) == \
            "cholesky_solve_batched"
    with pchol.forced_regime(True):
        assert pick("cholesky_solve_batched", 65_536, 160, 0, 0) == \
            "cholesky_solve_batched_lat"


def test_forced_panel_frame_takes_each_panel_export(monkeypatch):
    """``forced_regime("panel")`` takes the panel frame's export past kp =
    128 at any batch, for B1, B2 and B3 (the throughput kernel to kp =
    128), so it can be timed on the other kernels' ground; anything but
    True, False and "panel" is refused."""
    monkeypatch.setattr(pchol, "_resident", lambda name, k, c, dev: 132)
    with pchol.forced_regime("panel"):
        for name in pchol.REGIME_KINDS:
            for b in (1, 132, 264, 65_536):
                assert pchol._pick(name, b, 129, 0, 0) == name + "_panel"
                assert pchol._pick(name, b, 128, 0, 0) == name
    assert pchol._forced is None
    with pytest.raises(ValueError):
        with pchol.forced_regime("throughput"):
            pass


def _source_constant(name, source="cholesky_rank_panel.cu"):
    """An integer constant of a CUDA source (``constexpr int NAME = a *
    b;`` or ``= a;``), read from its text."""
    import re
    from recommendation_models_tpu_torch.ops import build
    text = (build.CSRC / source).read_text()
    m = re.search(rf"\b{name} = (\d+)(?: \* (\d+))?;", text)
    assert m, name
    return int(m.group(1)) * int(m.group(2) or 1)


@pytest.mark.parametrize("fused", [None, "2g", "hot"])
def test_panel_blocks_fit_with_two_slots(fused):
    """``panel_smem_bytes``, the mirror of csrc/cholesky_rank_panel.cu's
    ``layout`` past kp = 128, against the source's own constants (its
    ``SMEM_MAX``, panel width ``PW`` and ``HOT_CMAX``): B1's block, B3's
    with G2's second stage and B2's with vh (C, kp) hold two slots and fit
    at every k = 129..160 and every C <= ``hot_cols_cap(k)`` (so at every
    width the hot gate takes there), and the hot gate takes each such C."""
    smem_max = _source_constant("SMEM_MAX")
    assert smem_max == pchol.SMEM_MAX
    assert _source_constant("PW") == pchol.PANEL_WIDTH
    assert _source_constant("HOT_CMAX") == pchol.HOT_PANEL_CMAX
    for k in range(129, 161):
        kp = (k + 3) // 4 * 4
        tiles = (kp // 4) * (kp // 4 + 1) // 2
        stages = 2 if fused == "2g" else 1
        slot = (kp * (kp + 1) // 2 + 3) // 4 * 4 + 2 * kp
        caps = range(1, pchol.hot_cols_cap(k) + 1) if fused == "hot" else [0]
        for c in caps:
            two_slots = 4 * (16 * tiles * stages + 2 * 8 * (kp + 4)
                             + 2 * slot + kp + c * kp)
            assert pchol.panel_smem_bytes(k, fused, c) == two_slots, (k, c)
            assert two_slots <= smem_max, (k, c)
            if fused == "hot":
                assert c <= pchol.HOT_PANEL_CMAX
                assert pchol.hot_kernel_supported(k, c), (k, c)
    # the sizes the source's comment states (KiB), and one slot past the
    # limit
    assert round(pchol.panel_smem_bytes(136, "2g") / 1024, 1) == 158.6
    assert round(pchol.panel_smem_bytes(160, "2g") / 1024, 1) == 216.5
    assert round(pchol.panel_smem_bytes(136) / 1024, 1) == 121.4
    assert round(pchol.panel_smem_bytes(160) / 1024, 1) == 165.2
    assert round(pchol.panel_smem_bytes(136, "hot", 24) / 1024, 1) == 134.1
    assert round(pchol.panel_smem_bytes(160, "hot", 16) / 1024, 1) == 175.2
    assert pchol.panel_smem_bytes(160, "hot", 400) < 4 * (
        16 * 820 + 16 * 164 + 2 * (12880 + 320) + 160 + 400 * 160)


CTA_SMEM = 232_448     # an H100 CTA's largest dynamic shared memory
H100_SMS = 132


def _cluster_blocks(kq, c):
    """32 x 32 blocks a CTA of the one-block kernels holds at (kq, c), at
    the CTA that holds the most, counted step by step: its panels (panel p,
    rows p*32 .. kq - 1, on CTA p's place in 0 .. c-1, c-1 .. 0, ...) and,
    at each step j whose panel is another CTA's, that panel's rows from the
    CTA's first panel past j."""
    np_ = kq // 32
    order = [x for _ in range(np_) for x in (*range(c), *range(c - 1, -1, -1))]
    owner = order[:np_]
    most = 0
    for x in range(c):
        mine = [p for p in range(np_) if owner[p] == x]
        copy = 0
        for j in range(np_ - 1):
            later = [p for p in mine if p > j]
            if owner[j] != x and later:
                copy = max(copy, np_ - later[0])
        most = max(most, sum(np_ - p for p in mine) + copy)
    return most


def test_cluster_size_fills_the_card_and_fits():
    """The one-block kernels' cluster rule (``cluster_size``) for every
    padded order 161..656 and every batch 1..``block_batch``: C is at least
    1 and at most ``CLUSTER_MAX`` and the panels; a CTA's panels and its
    copy of a panel (counted here step by step) and the fixed part fit in
    232,448 bytes (``cluster_smem_bytes`` agrees); and, on a card of 132
    SMs that holds 132 // C clusters of C (the rule's count without a card;
    on one it asks the card), B x C fills the SMs as far as a C that fits
    allows: no larger C that fits keeps B x C within them, and B x C passes
    132 only where the smallest C that fits does."""
    assert pchol.CLUSTER_MAX <= pchol.CLUSTER_LIMIT
    for kp in range(161, 657):
        kq = -(-kp // 32) * 32
        fixed = (-(-6 * (kq // 32) // 4) * 4 + -(-(kq // 32) // 4) * 4
                 + 2 * kq + 32 + 32 * 32)
        fits = [c for c in range(1, min(pchol.CLUSTER_MAX, kq // 32) + 1)
                if 4 * (fixed + 1024 * _cluster_blocks(kq, c)) <= CTA_SMEM]
        for c in fits:
            assert pchol.cluster_smem_bytes(kq, c) == 4 * (
                fixed + 1024 * _cluster_blocks(kq, c))
        for b in range(1, pchol.block_batch(kp) + 1):
            c = pchol.cluster_size(kp, b, H100_SMS)
            assert 1 <= c <= min(pchol.CLUSTER_MAX, kq // 32), (kp, b, c)
            assert pchol.cluster_smem_bytes(kq, c) <= CTA_SMEM, (kp, b, c)
            if b * min(fits) <= H100_SMS:
                assert b * c <= H100_SMS, (kp, b, c)
                assert all(b * d > H100_SMS for d in fits if d > c), (kp, b)
            else:
                assert c == min(fits), (kp, b, c)
    # the sizes the design names: one SM a system where the batch fills the
    # card, two at kq = 256, eight past kp = 472
    assert pchol.cluster_size(168, 120, H100_SMS) == 1
    assert pchol.cluster_size(256, 48, H100_SMS) == 2
    assert {pchol.cluster_size(k, b, H100_SMS) for k in (472, 512, 656)
            for b in range(1, 9)} == {8}


@pytest.mark.parametrize("c,first", [
    (1, [0] * 7), (3, [0, 1, 2, 2, 1, 0, 0]), (8, [0, 1, 2, 3, 4, 5, 6])])
def test_cluster_panels_are_dealt_in_reflected_order(c, first):
    """Panel p of a cluster of c lives on CTA p of 0 .. c-1, c-1 .. 0, ...:
    the order ``cluster_owner`` gives and the shares it makes; at kq = 672
    and c = 8 every CTA holds 27 to 32 of the 231 blocks, where p mod c
    would give 20 to 39."""
    assert [pchol.cluster_owner(p, c) for p in range(7)] == first
    shares = [sum(21 - p for p in range(21) if pchol.cluster_owner(p, 8) == x)
              for x in range(8)]
    assert sum(shares) == 231 and min(shares) == 27 and max(shares) == 32


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


@pytest.mark.parametrize("alpha", [None, 1.0])
def test_rank160_hot_fit_matches_reference(alpha):
    """``ALS(rank=160, hot_cols=16, n_sweeps=3)`` on a 300 x 200 problem
    through both packages from one warm start, explicit and implicit: the
    port on its plain versions (B2's among them: a 16-wide hot block forms
    on both sides, C = ``hot_cols_cap(160)``), the JAX package on its CPU
    path. Exact masked SSE, reg = 1.0 (as the rank-160 fit above)."""
    from recommendation_models_tpu import ALS as RALS
    from recommendation_models_tpu_torch import ALS as PALS
    from recommendation_models_tpu_torch.data.layout import csr_arrays
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_u, n_i, k, c = 300, 200, 160, 16
    assert pchol.hot_cols_cap(k) == c
    u, i, r = synthetic_ratings(n_u, n_i, 12_000, rank=8, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_u, n_i))
    g = np.random.default_rng(0)
    U0 = (0.01 * g.standard_normal((n_u, k))).astype(np.float32)
    V0 = (0.01 * g.standard_normal((n_i, k))).astype(np.float32)
    kw = dict(rank=k, reg=1.0, n_sweeps=3, sse_mode="separate",
              hot_cols=c, alpha=alpha)
    ref_m = RALS(**kw, platform="cpu")
    got_m = PALS(**kw, platform="cpu")
    for m in (ref_m, got_m):
        layouts = m._build_layouts(*csr_arrays(R), m._data_config())
        assert [lay.hot_ids.shape[0] for lay in layouts] == [c, c]
    ref = ref_m.fit(R, U0=U0, V0=V0)
    got = got_m.fit(R, U0=U0, V0=V0)
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
    the halved block), and at k = 168, 256, 512 and 656 with
    ``block_batch(k)`` systems in more than one wave of clusters
    (``multiwave_cluster``, bitwise equal to the rule's cluster), each
    against its plain version, repeated bitwise, counted in ``LAUNCHES``
    with nothing routed; zero and identity systems
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
    # more than one wave of clusters: block_batch(k) systems at the
    # smallest cluster size past the rule's that the card cannot hold at
    # once, bitwise equal to the rule's launch (no element's order of terms
    # depends on the cluster)
    for k in (168, 256, 512, 656):
        b = pchol.block_batch(k)
        G, rhs, reg = _gpu_systems(gen, b, k, dev)
        x = pchol.cholesky_solve_batched(G, rhs, reg)
        launches["cholesky_solve_large"] += 1
        with pchol.forced_cluster(pchol.multiwave_cluster(k, b)):
            run("cholesky_solve_large", pchol.cholesky_solve_batched,
                pchol.cholesky_solve_plain, (G, rhs, reg))
            assert torch.equal(x, pchol.cholesky_solve_batched(G, rhs, reg))
        launches["cholesky_solve_large"] += 1
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


def _b1_batches(resident):
    return sorted({1, 255, 256, 257, resident - 1, resident, resident + 1,
                   2 * resident - 1, 2 * resident, 2 * resident + 1, 4_097,
                   65_536})


@pytest.mark.gpu
def test_cuda_b1_past_kp128_takes_its_frame_at_every_batch():
    """B1 past kp = 128 on the card at k = 129, 136, 153 and 160 and B = 1,
    255-257, the latency kernel's resident blocks +- 1, twice them +- 1,
    4,097 and 65,536 (the first 4,096 systems compared): the kernel
    ``solve_frame`` names, one launch counted (in ``LATENCY_LAUNCHES`` for
    the latency kernel), against the plain version, repeated bitwise;
    where it takes the panel frame, bitwise equal to B4 (1, 1) and (2, 1),
    whose kernel that is; zero and identity systems solve to exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    name = "cholesky_solve_batched"
    frames = set()
    for k in (129, 136, 153, 160):
        _, resident = pchol.solve_regime(name, 1, k)
        for b in _b1_batches(resident):
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            frame = pchol.solve_frame(name, b, k, resident)
            frames.add(frame)
            pchol.reset_counts()
            x = pchol.cholesky_solve_batched(G, rhs, reg)
            torch.cuda.synchronize()
            assert pchol.LAUNCHES[name] == 1 and not any(
                pchol.ROUTED.values()), (k, b)
            assert pchol.LATENCY_LAUNCHES[name] == (frame == "latency")
            n = min(b, 4_096)
            _gpu_close(x[:n], pchol.cholesky_solve_plain(G[:n], rhs[:n],
                                                         reg[:n]))
            assert torch.equal(x, pchol.cholesky_solve_batched(G, rhs, reg))
            if frame == "panel":
                for fcols in (1, 2):
                    assert torch.equal(x, pchol.cholesky_solve_rank1(
                        G, rhs, reg, fcols, 1)), (k, b, fcols)
            del G, rhs, reg, x
        z = torch.zeros(9, k, k, device=dev)
        z[4:] = torch.eye(k, device=dev)
        for b in (9, resident + 1, 2 * resident + 1):
            zb = z.repeat(-(-b // 9), 1, 1)[:b].contiguous()
            out = pchol.cholesky_solve_batched(
                zb, torch.zeros(b, k, device=dev), torch.zeros(b, device=dev))
            assert torch.equal(out, torch.zeros_like(out)), (k, b)
    assert frames == {"latency", "throughput", "panel"}
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_cuda_b2_b3_past_kp128_take_their_frame_at_every_batch():
    """B2 (C = ``hot_cols_cap(k)``, explicit and implicit weights, a slab
    28% nonzero) and B3 past kp = 128 on the card at k = 129, 136, 144, 153
    and 160 and B1's batches above (1 to 65,536; the first 4,096 systems
    compared): the kernel ``solve_frame`` names, one launch counted (in
    ``LATENCY_LAUNCHES`` for the latency kernel), nothing routed, against
    the plain version, repeated bitwise. Where the frame is the panel
    frame, B3 equals B1's panel-frame kernel (B4 (1, 1)'s there) on the f32
    sum G + G2 and B2 with an all-zero hot slab equals it on G, bit for
    bit. Zero and identity systems with rhs 0 and no hot entries solve to
    exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.probes.solve_latency import hot_slab
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    frames = set()
    for k in (129, 136, 144, 153, 160):
        c = pchol.hot_cols_cap(k)
        vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
        _, res_2g = pchol.solve_regime("cholesky_solve_2g", 1, k)
        _, res_hot = pchol.solve_regime("cholesky_solve_hot", 1, k, c)
        for b in sorted(set(_b1_batches(res_2g)) | set(_b1_batches(res_hot))):
            G, rhs, reg = _gpu_systems(gen, b, k, dev)
            G2 = _gpu_systems(gen, b, k, dev, jitter=0.1)[0]
            hv = hot_slab(b, c, gen, dev)
            n = min(b, 4_096)
            cases = [("cholesky_solve_2g", res_2g, pchol.cholesky_solve_2g,
                      pchol.cholesky_solve_2g_plain, (G, G2, rhs, reg), {})]
            cases += [("cholesky_solve_hot", res_hot,
                       pchol.cholesky_solve_hot,
                       pchol.cholesky_solve_hot_plain,
                       (G, rhs, reg, hv, vh), dict(alpha=alpha))
                      for alpha in (None, 1.0)]
            for name, resident, fn, plain, args, kw in cases:
                frame = pchol.solve_frame(name, b, k, resident)
                frames.add(frame)
                pchol.reset_counts()
                x = fn(*args, **kw)
                torch.cuda.synchronize()
                assert pchol.LAUNCHES[name] == 1 and not any(
                    pchol.ROUTED.values()), (name, k, b)
                assert pchol.LATENCY_LAUNCHES[name] == (frame == "latency")
                head = tuple(a[:n].contiguous() if a.shape[0] == b else a
                             for a in args)
                _gpu_close(x[:n], plain(*head, **kw))
                assert torch.equal(x, fn(*args, **kw)), (name, k, b)
            if pchol.solve_frame("cholesky_solve_2g", b, k, res_2g) == \
                    "panel":
                assert torch.equal(
                    pchol.cholesky_solve_2g(G, G2, rhs, reg),
                    pchol.cholesky_solve_rank1(G + G2, rhs, reg, 1, 1)), \
                    (k, b)
            if pchol.solve_frame("cholesky_solve_hot", b, k, res_hot) == \
                    "panel":
                for alpha in (None, 1.0):
                    assert torch.equal(
                        pchol.cholesky_solve_hot(G, rhs, reg,
                                                 torch.zeros_like(hv), vh,
                                                 alpha),
                        pchol.cholesky_solve_rank1(G, rhs, reg, 1, 1)), \
                        (k, b, alpha)
            del G, G2, rhs, reg, hv
        z = torch.zeros(9, k, k, device=dev)
        z[4:] = torch.eye(k, device=dev)
        for b in (9, res_hot + 1, 2 * res_hot + 1):
            zb = z.repeat(-(-b // 9), 1, 1)[:b].contiguous()
            zr = torch.zeros(b, k, device=dev)
            zg = torch.zeros(b, device=dev)
            for out in (pchol.cholesky_solve_2g(zb, torch.zeros_like(zb),
                                                zr, zg),
                        pchol.cholesky_solve_hot(
                            zb, zr, zg, torch.zeros(b, c, device=dev,
                                                    dtype=torch.bfloat16),
                            vh, 1.0)):
                assert torch.equal(out, torch.zeros_like(out)), (k, b)
    assert frames == {"latency", "throughput", "panel"}
    torch.cuda.empty_cache()
