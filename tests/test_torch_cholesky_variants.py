"""The port's solve-variant path against the reference's Pallas variants.

The variants are the reference's other factor and substitution schedules
(``_cholesky_solve_t``'s ``pair``/``subs2``/``schur``/``panel``/``dual``
flags and the two-operand ``Gt2`` form). On the CPU the wrappers take their kernels' plain
PyTorch versions; they are held here against the JAX kernels run in
interpret mode and against ``np.linalg.solve``, at the tolerance of
tests/test_pallas_cholesky.py (atol 5e-4 * scale, rtol 5e-4). The CUDA
kernels are held against the plain versions by the ``gpu`` test at the end,
which runs only on a card:
``python -m pytest --noconftest -m gpu tests/test_torch_cholesky_variants.py``.
"""

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.ops import cholesky as pchol
from recommendation_models_tpu_torch.ops import solve as psolve
from recommendation_models_tpu_torch.probes import solve_variants as probe

try:
    import jax.numpy as jnp
    from recommendation_models_tpu.ops import solve as rsolve
    from recommendation_models_tpu.ops.pallas import cholesky as rchol
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    jnp = rsolve = rchol = None

torch.set_num_threads(2)

# the variants of tests/test_pallas_cholesky.py::test_factor_variants_match,
# the probe's schur_s1, and the panel kernel
VARIANTS = {
    "rank1": dict(panel=False, pair=False, subs2=False),
    "rank1_subs2": dict(panel=False, pair=False),
    "pair_s1": dict(panel=False, pair=True, subs2=False),
    "schur": dict(panel=False, schur=True),
    "schur_s1": dict(panel=False, schur=True, subs2=False),
    "panel": dict(panel=True),
    "dual": dict(panel=False, dual=True),
}
NEW_KERNELS = ("cholesky_solve_2g", "cholesky_solve_rank1",
               "cholesky_solve_panel", "cholesky_solve_schur",
               "cholesky_solve_dual")
CASES = [(name, k) for name in VARIANTS for k in (8, 16, 32)
         if not (VARIANTS[name].get("schur") and k % 16)]


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


def _exact(G, rhs, reg):
    k = G.shape[1]
    return np.stack([np.linalg.solve(G[i] + reg[i] * np.eye(k), rhs[i])
                     for i in range(G.shape[0])])


@pytest.mark.parametrize("name,k", CASES)
def test_variant_plain_matches_pallas_variant(rng, name, k):
    """Each plain version, through the port's batch-minor entry with the
    reference's flags, against the same variant of the Pallas kernel and
    against np.linalg.solve, with a per-system ridge."""
    b = 40
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    kw = VARIANTS[name]
    ref = np.asarray(rchol._cholesky_solve_t(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), interpret=True, **kw)).T
    x = pchol.cholesky_solve_t(_t(G.transpose(1, 2, 0)), _t(rhs.T),
                               _t(reg[None]), **kw)
    assert tuple(x.shape) == (k, b)
    x = x.numpy().T
    _close(x, ref)
    _close(x, _exact(G, rhs, reg))


@pytest.mark.parametrize("plain,args", [
    (pchol.cholesky_solve_rank1_plain, (1, 1)),
    (pchol.cholesky_solve_rank1_plain, (1, 2)),
    (pchol.cholesky_solve_rank1_plain, (2, 1)),
    (pchol.cholesky_solve_panel_plain, ()),
    (pchol.cholesky_solve_schur_plain, (1,)),
    (pchol.cholesky_solve_schur_plain, (2,)),
    (pchol.cholesky_solve_dual_plain, ()),
])
def test_plain_versions_at_ragged_orders(rng, plain, args):
    """The kernels take any order 1 <= k <= 128 (the reference needs k
    even, a multiple of 8 for panels, of 16 for Schur): the plain versions
    at orders the TPU kernels do not take, against np.linalg.solve."""
    ks = (16, 48) if plain is pchol.cholesky_solve_schur_plain \
        else (1, 7, 13, 20)
    for k in ks:
        b = 12
        G = _spd(rng, b, k)
        rhs = rng.standard_normal((b, k)).astype(np.float32)
        reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
        x = plain(_t(G), _t(rhs), _t(reg), *args).numpy()
        _close(x, _exact(G, rhs, reg))


@pytest.mark.parametrize("solver", ["pallas", "xla", "lu"])
def test_solve_spd_t_two_operand_matches_reference(rng, solver):
    b, k = 48, 16
    G1 = _spd(rng, b, k)
    G2 = _spd(rng, b, k, jitter=0.1)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
    G1t, G2t, rt = G1.transpose(1, 2, 0), G2.transpose(1, 2, 0), rhs.T
    ref = np.asarray(rsolve.solve_spd_t(
        jnp.asarray(G1t), jnp.asarray(rt), solver, reg_vec=jnp.asarray(reg),
        Gt2=jnp.asarray(G2t)))
    x = psolve.solve_spd_t(_t(G1t), _t(rt), solver, reg_vec=_t(reg),
                           Gt2=_t(G2t))
    assert tuple(x.shape) == (k, b)
    _close(x.numpy(), ref)
    # the two-operand solve equals the solve of the pre-summed system
    xs = psolve.solve_spd_t(_t(G1t + G2t), _t(rt), solver, reg_vec=_t(reg))
    np.testing.assert_allclose(x.numpy(), xs.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,k", [(300, 8), (88, 192)])
def test_solve_spd_t_two_operand_partial_and_large(rng, b, k):
    """The reference's partial-block case (b=300, k=8: one and a bit of its
    halved block) and its k=192 case, which it routes to XLA (88 systems
    past its halved one-block batch of 40); the port takes any batch, and
    on a card routes the k=192 case to the torch anchor as well."""
    A = rng.standard_normal((b, k, k)).astype(np.float32) / np.sqrt(k)
    G1 = np.einsum("bij,bkj->bik", A, A) + 0.3 * np.eye(k, dtype=np.float32)
    B2 = rng.standard_normal((b, k, k)).astype(np.float32) / np.sqrt(k)
    G2 = np.einsum("bij,bkj->bik", B2, B2) + 0.3 * np.eye(k, dtype=np.float32)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    G1t, G2t = G1.transpose(1, 2, 0), G2.transpose(1, 2, 0)
    ref = np.asarray(rsolve.solve_spd_t(
        jnp.asarray(G1t), jnp.asarray(rhs.T), "pallas",
        Gt2=jnp.asarray(G2t))).T
    x = psolve.solve_spd_t(_t(G1t), _t(rhs.T), "pallas", Gt2=_t(G2t))
    x = x.numpy().T
    _close(x, ref)
    _close(x, np.stack([np.linalg.solve(G1[i] + G2[i], rhs[i])
                        for i in range(b)]))


@pytest.mark.parametrize("entry", ["shaped", "flat"])
def test_panel_entries_match_reference(rng, entry):
    b, k = 24, 40
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    if entry == "shaped":
        ref = np.asarray(rchol.cholesky_solve(jnp.asarray(G),
                                              jnp.asarray(rhs), panel=True))
        x = pchol.cholesky_solve(_t(G), _t(rhs), panel=True)
        xr = pchol.cholesky_solve(_t(G), _t(rhs), panel=False)
    else:
        reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
        Gf = G.reshape(b, k * k)
        ref = np.asarray(rchol.cholesky_solve_flat(
            jnp.asarray(Gf), jnp.asarray(rhs), k,
            reg_vec=jnp.asarray(reg), panel=True))
        x = pchol.cholesky_solve_flat(_t(Gf), _t(rhs), k, reg_vec=_t(reg),
                                      panel=True)
        xr = pchol.cholesky_solve_flat(_t(Gf), _t(rhs), k, reg_vec=_t(reg))
    assert tuple(x.shape) == (b, k)
    _close(x.numpy(), ref)
    # the reference's test_panel_variant_matches: panel against rank-1
    np.testing.assert_allclose(x.numpy(), xr.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", [*VARIANTS, "two_operand"])
def test_zero_and_identity_systems_solve_to_zero(rng, name):
    """All-zero and identity systems with rhs 0 solve to exactly 0 beside
    real systems, in every variant (tests/test_pallas_cholesky.py guard)."""
    k = 16
    G = np.concatenate([np.zeros((3, k, k), np.float32),
                        np.broadcast_to(np.eye(k, dtype=np.float32),
                                        (3, k, k)),
                        _spd(rng, 4, k)])
    rhs = np.concatenate([np.zeros((6, k), np.float32),
                          rng.standard_normal((4, k)).astype(np.float32)])
    reg = np.zeros(10, np.float32)
    Gt, rt = _t(G.transpose(1, 2, 0)), _t(rhs.T)
    if name == "two_operand":
        kw = dict(Gt2=torch.zeros_like(Gt))
        rkw = dict(Gt2=jnp.zeros(Gt.shape, jnp.float32))
    else:
        kw = rkw = VARIANTS[name]
    x = pchol.cholesky_solve_t(Gt, rt, _t(reg[None]), **kw).numpy().T
    ref = np.asarray(rchol._cholesky_solve_t(
        jnp.asarray(G.transpose(1, 2, 0)), jnp.asarray(rhs.T),
        jnp.asarray(reg[None]), interpret=True, **rkw)).T
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[:6], 0.0)
    np.testing.assert_array_equal(ref[:6], 0.0)
    _close(x[6:], ref[6:])


@pytest.mark.parametrize("case", ["schur_k24", "dual_with_gt2", "dual"])
def test_flag_errors_match_reference(rng, case):
    k = 24 if case == "schur_k24" else 16
    b = 7 if case == "dual" else 8
    G = _spd(rng, b, k)
    rhs = rng.standard_normal((b, k)).astype(np.float32)
    Gt, rt, reg = G.transpose(1, 2, 0), rhs.T, np.zeros((1, b), np.float32)
    kw = {"schur_k24": dict(schur=True),
          "dual_with_gt2": dict(dual=True),
          "dual": dict(dual=True)}[case]
    two = case == "dual_with_gt2"
    if case == "dual":
        # an odd batch: the reference refuses its odd block (it splits the
        # block into two lane halves); the port pairs systems per thread
        # block and solves it
        with pytest.raises(ValueError, match="dual"):
            rchol._cholesky_solve_t(jnp.asarray(Gt), jnp.asarray(rt),
                                    jnp.asarray(reg), interpret=True, **kw)
        x = pchol.cholesky_solve_t(_t(Gt), _t(rt), _t(reg), **kw)
        _close(x.numpy().T, _exact(G, rhs, reg[0]))
        return
    with pytest.raises(ValueError):
        rchol._cholesky_solve_t(jnp.asarray(Gt), jnp.asarray(rt),
                                jnp.asarray(reg), interpret=True,
                                Gt2=jnp.asarray(Gt) if two else None, **kw)
    with pytest.raises(ValueError):
        pchol.cholesky_solve_t(_t(Gt), _t(rt), _t(reg),
                               Gt2=_t(Gt) if two else None, **kw)


def test_schedule_arguments_are_checked():
    G, rhs, reg = torch.eye(4)[None], torch.zeros(1, 4), torch.zeros(1)
    with pytest.raises(ValueError, match="fcols"):
        pchol.cholesky_solve_rank1(G, rhs, reg, 2, 2)
    with pytest.raises(ValueError, match="srows"):
        pchol.cholesky_solve_schur(torch.eye(16)[None], torch.zeros(1, 16),
                                   reg, srows=3)
    # CPU tensors take the plain versions: no launch, no routing counted
    pchol.reset_counts()
    for fn in (pchol.cholesky_solve_rank1, pchol.cholesky_solve_panel,
               pchol.cholesky_solve_dual):
        fn(G, rhs, reg)
    pchol.cholesky_solve_2g(G, G, rhs, reg)
    assert set(pchol.LAUNCHES) == set(pchol.KERNELS)
    assert not any(pchol.LAUNCHES.values())
    assert not any(pchol.ROUTED.values())


@pytest.mark.parametrize("source", sorted(pchol.SOURCES))
def test_sources_export_what_the_wrappers_call(source):
    """Each library the wrappers load is a csrc source that defines every
    C export the wrappers declare for it, with as many arguments."""
    from recommendation_models_tpu_torch.ops import build
    text = (build.CSRC / f"{source}.cu").read_text()
    for name, argtypes in pchol.SOURCES[source].items():
        head = text.split(f"\nint {name}(", 1)
        assert len(head) == 2, f"{source}.cu does not define {name}"
        params = head[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(argtypes), name


def test_variant_resident_refuses_other_kernels():
    with pytest.raises(ValueError, match="no residency"):
        pchol.variant_resident("cholesky_solve_batched", 64)
    with pytest.raises(ValueError, match="fcols"):
        pchol.variant_resident("cholesky_solve_rank1", 64, 2, 2)
    with pytest.raises(ValueError, match="k % 16"):
        pchol.variant_resident("cholesky_solve_schur", 24)
    with pytest.raises(ValueError, match="srows"):
        pchol.variant_resident("cholesky_solve_schur", 64, srows=3)


@pytest.mark.parametrize("name,args,code", [
    ("cholesky_solve_rank1", (1, 1), (1, 1)),
    ("cholesky_solve_rank1", (2, 1), (2, 1)),
    ("cholesky_solve_panel", (), (8, 1)),
    ("cholesky_solve_schur", (1, 1), (16, 1)),
    ("cholesky_solve_schur", (1, 2), (16, 2)),
    ("cholesky_solve_dual", (), (32, 2)),
])
def test_variant_resident_asks_the_kernel_of_each_schedule(monkeypatch, name,
                                                           args, code):
    """Each kernel of csrc/cholesky_rank_panel.cu has a residency query:
    the wrapper's arguments reach the C export as the kernel's schedule
    code (enum Sched) and srows. Checked up to the library call, which is
    replaced here."""
    asked = []

    def query(sched, srows, k, device):
        asked.append((sched, srows, k, device))
        return 264

    monkeypatch.setattr(pchol, "_variant_resident", query)
    monkeypatch.setattr(pchol.torch.cuda, "current_device", lambda: 0)
    assert pchol.variant_resident(name, 64, *args) == 264
    assert asked == [(*code, 64, 0)]


@pytest.mark.parametrize("variants", ["pair,rank1,pair_s1,panel,schur,"
                                      "schur_s1", "pair,schur", "dual,pair"])
def test_probe_runs_on_cpu(capsys, variants):
    env = dict(PSV_K="16", PSV_B="64", PSV_VARIANTS=variants)
    assert probe.main(["--platform", "cpu"], env=env) == 0
    out = capsys.readouterr().out
    assert "# k=16 B=64" in out
    for v in variants.split(","):
        assert f"{v:8s} (cpu, untimed)" in out


@pytest.mark.parametrize("env,err", [
    (dict(PSV_BT="256"), SystemExit),
    (dict(PSV_VARIANTS="pair,bogus"), SystemExit),
    (dict(PSV_K="24", PSV_B="8", PSV_VARIANTS="schur"), ValueError),
])
def test_probe_refuses(env, err):
    with pytest.raises(err):
        probe.main(["--platform", "cpu"], env=env)


def _gpu_cases():
    for k in (1, 10, 16, 64, 128):
        for b in (1, 37, 4096):
            yield b, k


@pytest.mark.gpu
def test_cuda_variant_kernels_match_plain_versions():
    """Each new CUDA kernel (every instantiation) against its plain version
    on the card, at k in {1, 10, 16, 64, 128} (Schur at the multiples of
    16) and B in {1, 37, 4096} (the dual kernel also at B=2); at k = 144
    B3 launches and the variants, past their k = 128, are routed (counted). Then B4, B5a, B5b and B5c at their
    boundaries (``_rank_panel_boundaries``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    pchol.reset_counts()
    expect = dict.fromkeys(NEW_KERNELS, 0)
    for b, k in [*_gpu_cases(), (2, 64), (9, 144)]:
        G = _spd(rng, b, k)
        G2 = _spd(rng, b, k, jitter=0.1)
        rhs = rng.standard_normal((b, k)).astype(np.float32)
        reg = rng.uniform(0.05, 0.2, b).astype(np.float32)
        args = [_t(a).to(dev) for a in (G, rhs, reg)]
        g2 = _t(G2).to(dev)
        runs = [("cholesky_solve_2g", pchol.cholesky_solve_2g,
                 pchol.cholesky_solve_2g_plain, (args[0], g2, *args[1:]),
                 ())]
        runs += [("cholesky_solve_rank1", pchol.cholesky_solve_rank1,
                  pchol.cholesky_solve_rank1_plain, args, sched)
                 for sched in pchol.RANK1_SCHEDULES]
        runs.append(("cholesky_solve_panel", pchol.cholesky_solve_panel,
                     pchol.cholesky_solve_panel_plain, args, ()))
        runs.append(("cholesky_solve_dual", pchol.cholesky_solve_dual,
                     pchol.cholesky_solve_dual_plain, args, ()))
        if k % 16 == 0:
            runs += [("cholesky_solve_schur", pchol.cholesky_solve_schur,
                      pchol.cholesky_solve_schur_plain, args, (s,))
                     for s in (1, 2)]
        for name, fn, plain, a, extra in runs:
            x = fn(*a, *extra)
            ref = plain(*a, *extra)
            torch.cuda.synchronize()
            _close(x.cpu().numpy(), ref.cpu().numpy())
            if name == "cholesky_solve_2g":
                expect[name] += pchol.kernel_supported(k, b, True)
            else:
                expect[name] += k <= pchol.VARIANT_KMAX
    assert {n: pchol.LAUNCHES[n] for n in NEW_KERNELS} == {
        n: expect[n] for n in NEW_KERNELS}
    # B3 takes k = 144 (k <= 160); the variants stop at k = 128
    assert pchol.ROUTED["cholesky_solve_2g"] == 0
    assert pchol.ROUTED["cholesky_solve_rank1"] == 3
    assert pchol.ROUTED["cholesky_solve_panel"] == 1
    assert pchol.ROUTED["cholesky_solve_schur"] == 2
    assert pchol.ROUTED["cholesky_solve_dual"] == 1
    # zero and identity systems solve to exactly 0 in every kernel
    k = 64
    Gz = torch.zeros(4, k, k, device=dev)
    Gz[2:] = torch.eye(k, device=dev)
    z, zr = torch.zeros(4, k, device=dev), torch.zeros(4, device=dev)
    outs = [pchol.cholesky_solve_2g(Gz, torch.zeros_like(Gz), z, zr),
            pchol.cholesky_solve_panel(Gz, z, zr),
            pchol.cholesky_solve_dual(Gz, z, zr),
            pchol.cholesky_solve_dual(Gz[1:], z[1:], zr[1:])]
    outs += [pchol.cholesky_solve_rank1(Gz, z, zr, *s)
             for s in pchol.RANK1_SCHEDULES]
    outs += [pchol.cholesky_solve_schur(Gz, z, zr, s) for s in (1, 2)]
    for o in outs:
        assert torch.equal(o, torch.zeros_like(o))
    with pytest.raises(TypeError):
        pchol.cholesky_solve_panel(Gz.double(), z, zr)
    _rank_panel_boundaries(rng, dev)


def _rank_panel_boundaries(rng, dev):
    """The kernels of csrc/cholesky_rank_panel.cu (B4 in its three
    instantiations, B5a, B5b in both, B5c) at the orders around their tile
    configurations and panel widths (B5b at the multiples of 16), at
    batches around the 256-row block and around their own resident blocks
    (the persistent grid's wave; B5c's blocks carry two systems, so also
    B = 2, 3 and twice its resident blocks +- 1), against the plain
    versions; each repeats bitwise, and identity and zero systems with
    rhs 0, inside one wave and past it, solve to exactly 0."""
    kernels = [(f"cholesky_solve_rank1 {s}",
                lambda G, r, g, s=s: pchol.cholesky_solve_rank1(G, r, g, *s),
                lambda G, r, g, s=s: pchol.cholesky_solve_rank1_plain(
                    G, r, g, *s),
                lambda k, s=s: pchol.variant_resident(
                    "cholesky_solve_rank1", k, *s))
               for s in pchol.RANK1_SCHEDULES]
    kernels.append(("cholesky_solve_panel", pchol.cholesky_solve_panel,
                    pchol.cholesky_solve_panel_plain,
                    lambda k: pchol.variant_resident("cholesky_solve_panel",
                                                     k)))
    kernels += [(f"cholesky_solve_schur {s}",
                 lambda G, r, g, s=s: pchol.cholesky_solve_schur(G, r, g, s),
                 lambda G, r, g, s=s: pchol.cholesky_solve_schur_plain(
                     G, r, g, s),
                 lambda k, s=s: pchol.variant_resident(
                     "cholesky_solve_schur", k, srows=s))
                for s in (1, 2)]
    kernels.append(("cholesky_solve_dual", pchol.cholesky_solve_dual,
                    pchol.cholesky_solve_dual_plain,
                    lambda k: pchol.variant_resident("cholesky_solve_dual",
                                                     k)))
    for k in (1, 7, 13, 16, 64, 68, 69, 128):
        n = 4_201
        A = rng.standard_normal((n, k, max(k // 2, 1))).astype(np.float32)
        G = _t(A @ A.transpose(0, 2, 1) / max(k // 2, 1)).to(dev)
        rhs = _t(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
        reg = _t(rng.uniform(0.05, 0.2, n).astype(np.float32)).to(dev)
        for label, fn, plain, resident in kernels:
            if label.startswith("cholesky_solve_schur") and k % 16:
                continue
            res = resident(k)
            assert res >= 132, (label, k, res)
            wave = res
            batches = {1, 255, 256, 257, res - 1, res, res + 1, n}
            if label == "cholesky_solve_dual":
                wave = 2 * res
                batches |= {2, 3, wave - 1, wave, wave + 1}
            for b in sorted(batches):
                if b > n:
                    continue
                a = (G[:b].contiguous(), rhs[:b].contiguous(),
                     reg[:b].contiguous())
                x = fn(*a)
                _close(x.cpu().numpy(), plain(*a).cpu().numpy())
                assert torch.equal(x, fn(*a)), (label, k, b)
            for nz in (6, wave + 1):
                z = torch.zeros(nz, k, k, device=dev)
                z[nz // 2:] = torch.eye(k, device=dev)
                out = fn(z, torch.zeros(nz, k, device=dev),
                         torch.zeros(nz, device=dev))
                assert torch.equal(out, torch.zeros_like(out)), (label, k,
                                                                 nz)
