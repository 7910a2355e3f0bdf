"""The port's gather-rate path against the reference's gather probe P1.

P1 is ``scripts/probe_dma_gather.py::make_probe``, a per-row manual-DMA
gather whose kernel sums the gathered rows. On the CPU the port's wrapper
``ops.gather.gather_rows_sum`` takes its plain version; it is held here
against the JAX kernel run in interpret mode and against a float64 numpy
sum, per column within ``2e-6 · Σ_i |table[idx_i, j]| + 1e-6`` (the two add
the same f32 rows in different orders). The probes that run it
(``probes.dma_gather``, ``probes.gather_rates``, ``probes.ablate_epoch``,
``probes.gather_budget``) run here at small sizes. The CUDA kernel is held
against its plain version by the ``gpu`` test at the end, which runs only
on a card: ``python -m pytest --noconftest -m gpu tests/test_torch_gather.py``.
"""

import re

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.config import (
    DataConfig, SolveConfig, dense_min_degree_for_rank)
from recommendation_models_tpu_torch.data.layout import layout_from_coo
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.ops import gather as pg
from recommendation_models_tpu_torch.ops.cholesky import (
    block_batch, hot_cols_auto)
from recommendation_models_tpu_torch.probes import (
    SCALES, ablate_epoch, dma_gather, gather_budget, gather_rates)
from recommendation_models_tpu_torch.solver.als_sweep import device_buckets

try:
    import jax.numpy as jnp
    from scripts.probe_dma_gather import make_probe as ref_make_probe
except ImportError:
    # the card's machine has no JAX; there only the gpu test runs
    jnp = ref_make_probe = None

torch.set_num_threads(2)

# (n_table, k, n_gather, slots)
REF_CASES = [(64, 128, 300, 4), (64, 64, 300, 8), (1000, 128, 2048, 16),
             (50, 16, 40, 8)]


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if ref_make_probe is None and request.node.get_closest_marker("gpu") \
            is None:
        pytest.skip("the JAX reference package is not installed")


def _inputs(n, k, n_gather, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, k)).astype(np.float32)
    idx = rng.integers(0, n, n_gather).astype(np.int32)
    return table, idx


def _assert_sum_close(x, table, idx):
    """x (1, k) against the float64 sum of table[idx], per column within
    2e-6 Σ|rows| + 1e-6."""
    rows = table[idx].astype(np.float64)
    ref = rows.sum(0)
    tol = 2e-6 * np.abs(rows).sum(0) + 1e-6
    assert x.shape == (1, table.shape[1])
    assert np.all(np.abs(x[0] - ref) <= tol), np.abs(x[0] - ref).max()


@pytest.mark.parametrize("n,k,n_gather,slots", REF_CASES)
def test_gather_matches_pallas_probe(n, k, n_gather, slots):
    """The port's ``make_probe`` on CPU tensors against the reference's
    P1 kernel in interpret mode, same inputs and argument order."""
    table, idx = _inputs(n, k, n_gather)
    ref = np.asarray(ref_make_probe(n, k, n_gather, slots=slots,
                                    interpret=True)(jnp.asarray(idx),
                                                    jnp.asarray(table)))
    x = pg.make_probe(n, k, n_gather, slots=slots)(
        torch.from_numpy(idx), torch.from_numpy(table)).numpy()
    assert x.shape == ref.shape == (1, k)
    tol = 2e-6 * np.abs(table[idx]).sum(0) + 1e-6
    assert np.all(np.abs(x - ref) <= tol), np.abs(x - ref).max()
    _assert_sum_close(x, table, idx)


@pytest.mark.parametrize("k,n_gather,slots", [
    (16, 0, 8), (16, 1, 8), (16, 3, 8), (16, 31, 32),
    (1, 50, 4), (7, 50, 4), (13, 50, 4), (512, 20, 1),
])
def test_gather_ragged_against_numpy(k, n_gather, slots):
    """No ids (zeros), one id, fewer ids than slots, and orders the TPU
    kernel does not take (k = 1, 7, 13, 512), against float64 numpy. The
    reference is not compared at n_gather < slots: its warm-up starts
    copies for ids past the end of the index vector."""
    table, idx = _inputs(40, k, n_gather, seed=k + n_gather)
    x = pg.gather_rows_sum(torch.from_numpy(table), torch.from_numpy(idx),
                           slots).numpy()
    _assert_sum_close(x, table, idx)
    if n_gather == 0:
        assert np.all(x == 0)


def test_make_probe_argument_order_and_shapes():
    table, idx = _inputs(30, 8, 12)
    fn = pg.make_probe(30, 8, 12, slots=4)
    x = fn(torch.from_numpy(idx), torch.from_numpy(table))
    _assert_sum_close(x.numpy(), table, idx)
    with pytest.raises(ValueError, match="idx must have shape"):
        fn(torch.from_numpy(table), torch.from_numpy(idx))   # swapped
    with pytest.raises(ValueError, match="idx must have shape"):
        fn(torch.from_numpy(idx[:5]), torch.from_numpy(table))
    with pytest.raises(ValueError, match="table must have shape"):
        fn(torch.from_numpy(idx), torch.from_numpy(table[:20]))
    with pytest.raises(ValueError):
        pg.make_probe(30, 600, 12)


@pytest.mark.parametrize("case", ["k0", "k513", "slots0", "slots33",
                                  "table_f64", "idx_i64", "idx_2d",
                                  "noncontiguous"])
def test_gather_refuses(case):
    table = torch.zeros(10, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    slots = 8
    if case == "k0":
        table = torch.zeros(10, 0)
    elif case == "k513":
        table = torch.zeros(10, 513)
    elif case == "slots0":
        slots = 0
    elif case == "slots33":
        slots = 33
    elif case == "table_f64":
        table = table.double()
    elif case == "idx_i64":
        idx = idx.long()
    elif case == "idx_2d":
        idx = idx.view(2, 2)
    else:
        table = torch.zeros(8, 10).t()
    with pytest.raises(ValueError):
        pg.gather_rows_sum(table, idx, slots)


def test_cpu_tensors_take_the_plain_version():
    pg.reset_counts()
    table, idx = _inputs(20, 4, 9)
    pg.gather_rows_sum(torch.from_numpy(table), torch.from_numpy(idx))
    assert pg.LAUNCHES == {"gather_rows_sum": 0}
    assert pg.ring_warps(128, 8) == 8 and pg.ring_warps(512, 32) == 3


def test_dma_gather_probe_runs_on_cpu(capsys):
    assert dma_gather.main(["--platform", "cpu"], n_table=500, k=16,
                           n_gather=2000) == 0
    out = capsys.readouterr().out
    table, idx = _inputs(500, 16, 2000)
    want = table[idx].astype(np.float64).sum()
    tol = (2e-6 * np.abs(table[idx]).astype(np.float64).sum(0) + 1e-6).sum()
    sums = [float(m) for m in re.findall(r"checksum (-?[\d.]+)", out)]
    assert len(sums) == 5                       # 3 slots + 2 library lines
    for s in sums:
        assert abs(s - want) <= tol + 5e-4      # printed to 3 decimals
    for slots in dma_gather.SLOTS:
        assert f"slots={slots:3d}: (cpu, untimed)" in out


def test_gather_rates_probe_runs_on_cpu(capsys):
    env = dict(GAB_TABLE="2000", GAB_B="64", GAB_P="8")
    assert gather_rates.main(["--platform", "cpu"], env=env) == 0
    out = capsys.readouterr().out
    assert "idx (64,8) = 512 rows" in out
    assert "P1 gather_rows_sum" in out and "ok" in out


@pytest.fixture(scope="module")
def tiny_layouts():
    n_users, n_items, n_obs = SCALES["tiny"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    dcfg = DataConfig(hot_cols=hot_cols_auto(8),
                      dense_min_degree=dense_min_degree_for_rank(8))
    return (layout_from_coo(u, i, r, n_users, n_items, config=dcfg),
            layout_from_coo(u, i, r, n_users, n_items, config=dcfg,
                            transpose=True))


def test_ablate_epoch_gather_only_sums(tiny_layouts, capsys):
    """The epoch ablation at the tiny scale, rank 8, on the CPU: its P1
    gather-only sums equal numpy's sum over the same bucket ids of the
    warm-start tables."""
    ul, il = tiny_layouts
    res = ablate_epoch.run(ul, il, SolveConfig(rank=8, reg=0.1), 1, "cpu")
    assert res["ok"]
    out = capsys.readouterr().out
    assert "user half-sweep (no sse)" in out and "solve only kernel" in out
    U, V = (t.numpy() for t in ablate_epoch.warm_factors(
        ul.n_rows, il.n_rows, 8, "cpu"))
    for tag, layout, tbl in (("user", ul, V), ("item", il, U)):
        ids = np.concatenate([
            b["indices"].numpy().ravel()
            for b in device_buckets(layout, block_batch(8), "cpu")
            if "indices" in b])
        _assert_sum_close(res["gather"][tag].numpy(), tbl, ids)


def test_ablate_epoch_and_budget_mains_on_cpu(tmp_path, capsys):
    env = dict(ABL_SCALE="tiny", ABL_RANK="8", ABL_ITERS="1",
               ABL_CACHE_DIR=str(tmp_path))
    assert ablate_epoch.main(["--platform", "cpu"], env=env) == 0
    hot, dmd = hot_cols_auto(8), dense_min_degree_for_rank(8)
    for side in ("user", "item"):
        assert (tmp_path / f"tiny.hot{hot}.dmd{dmd}.{side}.npz").exists()
    env["ABL_BUDGETS"] = "64,8"
    assert gather_budget.main(["--platform", "cpu"], env=env) == 0
    assert (tmp_path / "tiny_item.npz").exists()
    out = capsys.readouterr().out
    assert "item half, gather_budget=64MB" in out
    assert "item half, gather_budget=8MB" in out


@pytest.mark.gpu
def test_cuda_gather_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at the CPU
    cases, the ragged sizes and the probe's full shape, and bitwise
    repeatable; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [*REF_CASES, (62_423, 128, 200_000, 16), (40, 16, 0, 8),
             (40, 16, 1, 8), (40, 16, 7, 8), (40, 1, 50, 4), (40, 7, 50, 4),
             (40, 13, 50, 4), (3000, 512, 5000, 32), (100_000, 64, 10_000, 1)]
    pg.reset_counts()
    for n, k, n_gather, slots in cases:
        table, idx = _inputs(n, k, n_gather)
        t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
        x = pg.gather_rows_sum(t, i, slots)
        x2 = pg.gather_rows_sum(t, i, slots)
        torch.cuda.synchronize()
        assert torch.equal(x, x2)
        ref = pg.gather_rows_sum_plain(t, i)
        tol = pg.sum_tolerance(t, i)
        assert bool(((x - ref).abs() <= tol).all()), (n, k, n_gather, slots)
        _assert_sum_close(x.cpu().numpy(), table, idx)
    assert pg.LAUNCHES["gather_rows_sum"] == 2 * len(cases)
    # a table whose rows are not 16-byte aligned takes 4-byte copies
    flat = torch.randn(600 * 64 + 1, device=dev)
    t = flat[1:].view(600, 64)
    i = torch.randint(0, 600, (3000,), device=dev, dtype=torch.int32)
    x = pg.gather_rows_sum(t, i)
    assert bool(((x - pg.gather_rows_sum_plain(t, i)).abs()
                 <= pg.sum_tolerance(t, i)).all())
    with pytest.raises(ValueError):
        pg.gather_rows_sum(t, i.cpu())
