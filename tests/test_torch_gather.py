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
    SCALES, ablate_epoch, dma_gather, gather_budget, gather_latency as gl,
    gather_rates)
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
    assert pg.lanes_per_row(128, 4) == 32 and pg.depth_for(32, 16) == 16


@pytest.mark.parametrize("k,vec,lanes,slices", [
    (1, 1, 1, 1), (4, 4, 1, 1), (7, 1, 8, 1), (13, 1, 16, 1),
    (16, 4, 4, 1), (16, 1, 16, 1), (17, 1, 32, 1), (64, 4, 16, 1),
    (64, 1, 32, 2), (68, 4, 32, 1), (128, 4, 32, 1), (500, 4, 32, 4),
    (512, 4, 32, 4), (512, 1, 32, 16),
])
def test_lanes_per_row_and_slices(k, vec, lanes, slices):
    """L lanes a row (a power of two, at most a warp) and column slices of
    32 groups: every column has one lane, and one slice holds a row of at
    most 32 groups."""
    assert pg.lanes_per_row(k, vec) == lanes
    assert pg.slices_for(k, vec, lanes) == slices
    width = lanes * vec
    assert (slices - 1) * width < k <= slices * width


def test_every_lane_loads_at_power_of_two_widths():
    """At k = 64 with 16-byte loads a warp step is two rows of 16 lanes;
    whenever the column groups are a power of two, no lane idles."""
    assert pg.lanes_per_row(64, 4) * 2 == 32
    for k, vec in ((4, 4), (8, 4), (16, 4), (32, 4), (64, 4), (128, 4),
                   (256, 4), (512, 4), (1, 1), (2, 1), (8, 1), (32, 1)):
        lanes = pg.lanes_per_row(k, vec)
        groups = k // vec
        assert lanes * pg.slices_for(k, vec, lanes) == groups \
            or (lanes == 32 and groups % 32 == 0)


@pytest.mark.parametrize("slots,lanes,depth", [
    (8, 16, 4), (4, 16, 2), (16, 16, 8), (32, 16, 16), (3, 16, 2),
    (1, 16, 1), (8, 32, 8), (16, 32, 16), (32, 32, 32), (5, 32, 8),
    (1, 32, 1), (32, 1, 1), (8, 4, 1), (32, 4, 4), (9, 8, 4),
])
def test_depth_for_rounds_slots_up_to_whole_steps(slots, lanes, depth):
    """Steps in flight: slots row copies at 32 / lanes rows a step, rounded
    up to a power of two, never above lanes (the deepest instantiation)."""
    assert pg.depth_for(slots, lanes) == depth
    assert depth * (32 // lanes) >= slots
    assert depth <= lanes


def test_depth_never_exceeds_the_instantiated_depths():
    for k in range(1, pg.KMAX + 1):
        for vec in ((1, 4) if k % 4 == 0 else (1,)):
            lanes = pg.lanes_per_row(k, vec)
            for slots in range(1, pg.SLOTS_MAX + 1):
                d = pg.depth_for(slots, lanes)
                assert d & (d - 1) == 0 and 1 <= d <= lanes


@pytest.mark.parametrize("n,lanes,depth,slices,resident,rounds,grid", [
    (0, 16, 4, 1, 1056, 4, 1),               # no ids: one block
    (1, 16, 4, 1, 1056, 4, 1),
    (256, 16, 4, 1, 1056, 4, 1),             # one block's rounds
    (257, 16, 4, 1, 1056, 4, 2),
    (22_500, 16, 4, 1, 1056, 4, 88),         # a user row block's call
    (22_500, 16, 4, 1, 1056, 2, 176),        # ... at MIN_ROUNDS 2
    (22_500, 16, 4, 1, 1056, 1, 352),        # the old rule's 352 blocks
    (14_400_000, 16, 4, 1, 1056, 4, 1056),   # a half: the resident grid
    (200_000, 32, 8, 1, 528, 4, 528),       # the probe's: resident
    (20_000, 32, 8, 1, 528, 4, 79),
    (10_000, 32, 8, 4, 528, 4, 160),         # k=512: 4 slices a part
    (10 ** 7, 32, 8, 4, 530, 4, 528),        # parts capped at resident / 4
    (10 ** 7, 32, 32, 16, 8, 4, 16),         # fewer resident than slices
])
def test_grid_rule(monkeypatch, n, lanes, depth, slices, resident, rounds,
                   grid):
    monkeypatch.setattr(pg, "MIN_ROUNDS", rounds)
    assert pg.grid_for(n, lanes, depth, slices, resident) == grid


def test_config_is_asked_of_the_card_once_per_key(monkeypatch):
    """``_config`` asks the library for the resident blocks once per (k,
    slots, vec, device); the per-call path only reads the cache."""
    import contextlib
    calls = []

    class FakeLib:
        def gather_resident(self, vec, lanes, depth, out):
            calls.append((vec, lanes, depth))
            out._obj.value = 132 * 4
            return 0

    monkeypatch.setattr(pg, "_lib", lambda: FakeLib())
    monkeypatch.setattr(pg.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(pg.torch.cuda, "current_device", lambda: 0)
    pg._config.cache_clear()
    try:
        assert pg.gather_config(64, 8, 4) == dict(lanes=16, depth=4,
                                                  slices=1, resident=528)
        with pytest.raises(ValueError):
            pg.gather_config(63, 8, 4)
        assert pg._config(64, 8, 4, 0) == (16, 4, 1, 528)
        assert pg._config(64, 8, 4, 0) == (16, 4, 1, 528)
        assert pg._config(512, 32, 4, 0) == (32, 32, 4, 528)
        assert pg._config(64, 8, 4, 1) == (16, 4, 1, 528)
        assert calls == [(4, 16, 4), (4, 32, 32), (4, 16, 4)]
        assert pg._config.cache_info().currsize == 3
    finally:
        pg._config.cache_clear()


def test_scratch_is_kept_per_device_and_stream(monkeypatch):
    """One scratch buffer (partials, then a zeroed counter) per (device,
    stream): reused on one stream, separate on two, grown when short."""
    monkeypatch.setattr(pg, "_SCRATCH", {})
    cpu = torch.device("cpu")
    p1, c1 = pg._scratch(cpu, 7, 100)
    assert c1 - p1 == 4 * 100
    assert pg._scratch(cpu, 7, 64) == (p1, c1)
    p2, _ = pg._scratch(cpu, 8, 64)
    assert p2 != p1 and len(pg._SCRATCH) == 2
    p3, c3 = pg._scratch(cpu, 7, 101)
    buf = pg._SCRATCH[(None, 7)]
    assert buf.shape[0] == 201 and c3 - p3 == 4 * 200
    assert float(buf[-1]) == 0.0


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


def test_edge_counts_straddle_each_boundary():
    """0, 1 and each step, pipeline, block, grid-rule and grid-cap count
    ± 1, at k=64 (two rows a step) with 8 slots and 1,056 resident
    blocks."""
    got = gl.edge_counts(64, 8, 4, 1056)
    per_part = pg.WARPS * 2 * 4 * pg.MIN_ROUNDS
    for m in (2, 8, 64, per_part, 2 * per_part, 1056 * per_part):
        assert {m - 1, m, m + 1} <= set(got)
    assert got[:2] == [0, 1] and got == sorted(set(got))


GPU_KS = (1, 7, 13, 16, 17, 64, 68, 128, 500, 512)


def _edge_cases(dev):
    """(k, n_gather, slots) at every width of GPU_KS and slots 1 and 32
    (8 too at k = 64 and 128), at ``gl.edge_counts`` for the card."""
    cases = []
    for k in GPU_KS:
        vec = 4 if k % 4 == 0 else 1
        for slots in ((1, 8, 32) if k in (64, 128) else (1, 32)):
            resident = pg.gather_config(k, slots, vec)["resident"]
            cases += [(k, n, slots)
                      for n in gl.edge_counts(k, slots, vec, resident)]
    return cases


def _row_block_ids(dev):
    """The ids of one row block of each half of the ML-1M-shaped rank-64
    auto layouts, with the table it gathers: [(table, ids)]."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        main_path_layouts, warm_start)
    _, ul, il = main_path_layouts("ml1m", 64)
    U0, V0 = (torch.from_numpy(a).to(dev)
              for a in warm_start(ul.n_rows, il.n_rows, 64))
    out = []
    for layout, tbl in ((ul, V0), (il, U0)):
        bs = device_buckets(layout, block_batch(64), dev)
        blocks = [b["indices"][s:e].reshape(-1) for b, s, e in
                  ablate_epoch.row_blocks(bs, SolveConfig(rank=64), 64)]
        out.append((tbl, max(blocks, key=lambda i: i.shape[0])))
    return out


@pytest.mark.gpu
def test_cuda_gather_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, at the CPU
    cases, the ragged sizes, the probe's full shape, every width of
    GPU_KS at the design's edge counts with slots 1 and 32, and a real
    row block of each half; bitwise repeatable, exact zeros for no ids,
    one launch and one device kernel per call, and the same bits from
    calls on two streams at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from recommendation_models_tpu_torch.probes import device_rows
    dev = torch.device("cuda")
    cases = [*REF_CASES, (62_423, 128, 200_000, 16), (40, 16, 0, 8),
             (40, 16, 1, 8), (40, 16, 7, 8), (40, 1, 50, 4), (40, 7, 50, 4),
             (40, 13, 50, 4), (3000, 512, 5000, 32), (100_000, 64, 10_000, 1)]
    inputs = [(*_inputs(n, k, n_gather), slots)
              for n, k, n_gather, slots in cases]
    rng = np.random.default_rng(1)
    pools = {}
    for k, n_gather, slots in _edge_cases(dev):
        if k not in pools:
            pools[k] = rng.standard_normal((1000, k)).astype(np.float32)
        ids = rng.integers(0, 1000, n_gather).astype(np.int32)
        inputs.append((pools[k], ids, slots))
    pg.reset_counts()
    for table, idx, slots in inputs:
        t, i = torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)
        x = pg.gather_rows_sum(t, i, slots)
        x2 = pg.gather_rows_sum(t, i, slots)
        torch.cuda.synchronize()
        assert torch.equal(x, x2)
        ref = pg.gather_rows_sum_plain(t, i)
        tol = pg.sum_tolerance(t, i)
        where = (table.shape, idx.shape[0], slots)
        assert bool(((x - ref).abs() <= tol).all()), where
        _assert_sum_close(x.cpu().numpy(), table, idx)
        if idx.shape[0] == 0:
            assert bool((x == 0).all()), where
    assert pg.LAUNCHES["gather_rows_sum"] == 2 * len(inputs)
    # real row blocks of both halves
    for tbl, ids in _row_block_ids(dev):
        x = pg.gather_rows_sum(tbl, ids)
        assert torch.equal(x, pg.gather_rows_sum(tbl, ids))
        assert bool(((x - pg.gather_rows_sum_plain(tbl, ids)).abs()
                     <= pg.sum_tolerance(tbl, ids)).all())
    # one device kernel per call
    t = torch.from_numpy(pools[64]).to(dev)
    i = torch.randint(0, 1000, (20_000,), device=dev, dtype=torch.int32)
    rows = device_rows(lambda: pg.gather_rows_sum(t, i), reps=10)
    assert sum(c for _, c, _ in rows) == 10, rows
    # two streams at once agree with one stream, bitwise
    big = torch.randn(62_423, 64, device=dev)
    ids = torch.randint(0, 62_423, (2_000_000,), device=dev,
                        dtype=torch.int32)
    want = pg.gather_rows_sum(big, ids)
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(pg.gather_rows_sum(big, ids))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want) for g in got)
    # a table whose rows are not 16-byte aligned takes 4-byte copies
    flat = torch.randn(600 * 64 + 1, device=dev)
    t = flat[1:].view(600, 64)
    i = torch.randint(0, 600, (3000,), device=dev, dtype=torch.int32)
    x = pg.gather_rows_sum(t, i)
    assert bool(((x - pg.gather_rows_sum_plain(t, i)).abs()
                 <= pg.sum_tolerance(t, i)).all())
    with pytest.raises(ValueError):
        pg.gather_rows_sum(t, i.cpu())
