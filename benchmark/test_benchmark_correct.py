"""A CPU rehearsal of ``correct``: the generator, and the comparison
accepting the port's output and rejecting a lower precision, a perturbed
factor row and each fault the cells can have, through the harness's own
run at a tiny size (the harness's look for a card is skipped: the run is
driven on the CPU)."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from benchmark import calibrate, datagen, harness
from benchmark.conftest import TINY, TINY_LIMITS, tiny_cell
from benchmark.runners import als_serve, als_train

CFG = {"n_users": 1_000_000, "n_items": 400, "n_ratings": 40000,
       "popularity_exponent": 1.0, "truth_rank": 4, "noise": 0.3,
       "rating_scale": [1.0, 5.0]}


def ratings(seed, cfg=CFG):
    return datagen.ratings(cfg, datagen.generator(seed, "cpu"), "cpu")


def test_generator_is_deterministic_by_seed():
    a, b, c = ratings(2**31 + 11), ratings(2**31 + 11), ratings(7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2][:100], c[2][:100])


def test_generator_keeps_its_law():
    users, items, vals = ratings(3)
    key = users * CFG["n_items"] + items
    assert torch.equal(key, torch.unique(key))          # deduped, sorted
    assert int(users.max()) < CFG["n_users"]
    assert int(items.max()) < CFG["n_items"]
    assert float(vals.min()) >= 1.0 and float(vals.max()) <= 5.0
    assert torch.equal(vals * 2, torch.round(vals * 2))  # half stars
    # item popularity (i + 1)^-1 before the dedupe: with a million users a
    # 40,000-draw sample rarely repeats a pair, so counts follow the law
    counts = torch.bincount(items, minlength=CFG["n_items"]).double()
    law = 1.0 / torch.arange(1, CFG["n_items"] + 1, dtype=torch.float64)
    law *= counts.sum() / law.sum()
    for lo, hi in ((0, 1), (1, 4), (4, 20), (20, 100), (100, 400)):
        assert float(counts[lo:hi].sum()) == pytest.approx(
            float(law[lo:hi].sum()), rel=0.1)
    assert users.shape[0] == CFG["n_ratings"]
    # where draws repeat often, it draws on until the count is whole
    dense = dict(CFG, n_users=50, n_ratings=15000)
    users, items, _ = ratings(3, dense)
    key = users * CFG["n_items"] + items
    assert key.shape[0] == 15000 and torch.equal(key, torch.unique(key))


def test_first_distinct_keeps_the_first_in_draw_order():
    keys = torch.tensor([9, 4, 9, 7, 4, 1, 3, 1, 8])
    assert datagen.first_distinct(keys, 4).tolist() == [1, 4, 7, 9]
    assert datagen.first_distinct(keys, 9).tolist() == [1, 3, 4, 7, 8, 9]


def run(root, traffic, seed=5, **kw):
    return harness.run_cell(tiny_cell(traffic), seed, 0.3, False, "cpu",
                            root=root, **kw)


@pytest.mark.parametrize("traffic", ["train", "serve", "serve-all"])
def test_the_comparison_accepts_the_ports_output(tiny_root, traffic):
    got = run(tiny_root, traffic)
    assert got["correct"], got["checks"]
    assert got["attempted"] >= 1 and got["failed"] == 0
    assert list(got)[-1] == "checks"


def test_the_ports_bf16_path_is_rejected(tiny_root, monkeypatch):
    orig = als_train.program
    monkeypatch.setattr(als_train, "program",
                        lambda cfg, dev, dt=None: orig(cfg, dev, "bfloat16"))
    got = run(tiny_root, "train")
    assert not got["correct"], got["checks"]


@contextlib.contextmanager
def state_unchanged():
    """The whole fit returns the factors it was given."""
    from recommendation_models_tpu_torch.solver import als_sweep
    orig = als_sweep.make_scanned_fit

    def make(*args, **kwargs):
        fit = orig(*args, **kwargs)

        def stale(U, V):
            _, _, hist, n = fit(U, V)
            return U, V, hist, n
        return stale
    als_sweep.make_scanned_fit = make
    try:
        yield
    finally:
        als_sweep.make_scanned_fit = orig


@contextlib.contextmanager
def stale_inputs():
    """Every call of the whole fit computes from the first call's inputs,
    as a captured graph replayed on stale buffers would."""
    from recommendation_models_tpu_torch.solver import als_sweep
    orig = als_sweep.make_scanned_fit

    def make(*args, **kwargs):
        fit = orig(*args, **kwargs)
        first = []

        def stale(U, V):
            if not first:
                first.extend((U.clone(), V.clone()))
            return fit(*first)
        return stale
    als_sweep.make_scanned_fit = make
    try:
        yield
    finally:
        als_sweep.make_scanned_fit = orig


@pytest.mark.parametrize("fault", ["unchanged", "half", "row", "stale"])
def test_train_faults_are_rejected(tiny_root, fault):
    with {"unchanged": state_unchanged, "stale": stale_inputs}.get(
            fault, lambda: calibrate.planted(fault))():
        got = run(tiny_root, "train")
    assert not got["correct"], (fault, got["checks"])
    if fault == "stale":
        # the first call is sound: only the window's last call shows it
        checks = got["checks"]
        assert all(c["value"] <= c["limit"] for n, c in checks.items()
                   if not n.startswith("window_")), checks


@contextlib.contextmanager
def served(alter):
    """``alter(scores, rows)`` applied to every top-k answer the estimator
    computes (rows are serving rows, before they map back to items)."""
    from recommendation_models_tpu_torch.models import als
    orig = als.topk_scores

    def faulty(*args, **kwargs):
        sc, ix = orig(*args, **kwargs)
        return alter(sc.clone(), ix.clone())
    als.topk_scores = faulty
    try:
        yield
    finally:
        als.topk_scores = orig


def _one_answer_altered(sc, ix):
    ix[0, 0] = (ix[0, 0] + 97) % 300
    return sc, ix


def _half_left_out(sc, ix):
    half = ix.shape[0] // 2
    ix[half:] = ix[0]
    sc[half:] = sc[0]
    return sc, ix


class _Stale:
    """Every call after the first returns the answer before it (its rows
    repeated or cut to the call's batch)."""

    def __init__(self):
        self.last = None

    def __call__(self, sc, ix):
        prev, self.last = self.last, (sc, ix)
        if prev is None:
            return sc, ix
        rows = torch.arange(ix.shape[0]) % prev[1].shape[0]
        return prev[0][rows], prev[1][rows]


@pytest.mark.parametrize("traffic", ["serve", "serve-all"])
@pytest.mark.parametrize("fault", ["answer", "half", "stale"])
def test_serve_faults_are_rejected(tiny_root, traffic, fault):
    alter = {"answer": _one_answer_altered, "half": _half_left_out,
             "stale": _Stale()}[fault]
    with served(alter):
        got = run(tiny_root, traffic)
    assert not got["correct"], (fault, got["checks"])


@pytest.mark.parametrize("traffic", ["train", "train-window", "serve"])
def test_one_perturbed_factor_row_is_rejected(tiny_root, traffic,
                                              monkeypatch):
    if traffic == "train-window":
        orig = als_train.window_calls

        def perturbed(fit, U, V, seconds):
            calls, start, (U, V), h = orig(fit, U, V, seconds)
            U = U.clone()
            U[7] *= 1.5
            return calls, start, (U, V), h
        monkeypatch.setattr(als_train, "window_calls", perturbed)
        traffic = "train"
    elif traffic == "train":
        orig = als_train.first_call

        def perturbed(fit, U0, V0):
            U, V, (h, Uh, Vh) = orig(fit, U0, V0)
            Uh = Uh.clone()
            Uh[7] *= 1.5
            return U, V, (h, Uh, Vh)
        monkeypatch.setattr(als_train, "first_call", perturbed)
    else:
        orig = als_serve.program

        def perturbed(cfg, dev, indptr, indices, U, V):
            U = U.copy()
            U[7] *= -1.0
            return orig(cfg, dev, indptr, indices, U, V)
        monkeypatch.setattr(als_serve, "program", perturbed)
    got = run(tiny_root, traffic)
    assert not got["correct"], got["checks"]


def test_the_control_fails_at_a_tiny_size():
    """The control (the program's bf16 path; the bf16 reference for
    serving) reads above the tiny cells' limits on three seeds, at a size
    the CPU holds, while the sound program reads below them."""
    bench = harness.Benchmark()
    dev = torch.device("cpu")
    for traffic in ("train", "serve"):
        limits = TINY_LIMITS[traffic]
        cfg = dict(bench.config("als-ml25m-r64"), **TINY)
        tr = bench.traffic(traffic)
        read = (calibrate.train_readings if traffic == "train"
                else calibrate.serve_readings)
        for seed in (1, 2, 3):
            got = read(cfg, tr, seed, dev, True, 0.3)
            assert all(v <= limits[k] for k, v in got["sound"].items()), got
            assert any(v > limits[k] for k, v in got["control"].items()), got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["als-ml25m-r64.train", "als-ml25m-r128.train",
                                  "als-ml25m-r64.serve",
                                  "als-ml25m-r64.serve-all"])
def test_the_control_fails_at_the_cells_size(cuda_device, cell):
    """On the card, at the cell's own size and on three seeds: the sound
    program reads within the limits, the control and (training) each
    planted fault outside one of them."""
    bench = harness.Benchmark()
    spec = bench.cell(cell)
    cfg, tr = bench.config(spec["config"]), bench.traffic(spec["traffic"])
    limits = bench.limits(cell)
    read = (calibrate.train_readings if tr["runner"] == "als_train"
            else calibrate.serve_readings)
    for seed in (11, 12, 13):
        got = read(cfg, tr, seed, cuda_device, True,
                   bench.spec["run_seconds"])
        assert all(v <= limits[k] for k, v in got["sound"].items()), got
        for run in [k for k in got if k == "control" or
                    k.startswith("fault_")]:
            assert any(v > limits[k] for k, v in got[run].items()), (run,
                                                                     got)
