"""The IMC cells on the CPU: the needed work against hand counts, a tiny
IMC cell through the harness's own run (correct, and loading no JAX), the
comparison rejecting the calibration's control and faults, and the plain
reference loading nothing of the port.

The tiny IMC cell is added by ``make_imc_root`` beside the tiny ALS cells
of ``conftest.make_root``, as new files and entries."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import calibrate_imc, check, harness, work, work_imc
from benchmark.conftest import REPO, make_root
from benchmark.test_benchmark_imports import FORBIDDEN, loaded_after

CELL = "tiny-imc.imc-train"
# the tiny IMC configuration: every layer of the cell's path at a CPU's
# size (genome rows on a third of the items, several buckets a side)
TINY_IMC = {"name": "tiny-imc", "n_users": 600, "n_items": 200,
            "n_ratings": 12000, "d_user": 24, "d_item": 24,
            "genome_items": 70, "rank": 8, "cg_iters": 20}
# set as the cell's are (calibrate_imc on the CPU, sound seeds 1-6,
# control and faults on seeds 1-3): loss_gap 3.2e-5 to 5.1e-4 sound, the
# half fault from 2.9e-2; rmse_gap 7.6e-6 to 1.3e-4 sound, the half fault
# from 1.5e-2; factor_gap 0.018 to 0.135 sound, the half fault from 2.0;
# window_loss_gap 2.2e-7 to 9.3e-6 sound, 2.9e-5 to 7.2e-5 control, the
# faults from 1.4e-4 (skip); window_rmse_gap 7.9e-8 to 2.5e-6 sound,
# 1.4e-5 to 2.2e-5 control; window_factor_gap 1.8e-3 to 0.016 sound, 0.048
# to 0.065 control
TINY_IMC_LIMITS = {"loss_gap": 4e-3, "rmse_gap": 1.5e-3, "factor_gap": 0.6,
                   "window_loss_gap": 2e-5, "window_rmse_gap": 7e-6,
                   "window_factor_gap": 0.03}
# the metrics that list the cell, beside its own three
SHARED = ("sweep_s", "idle_share.train", "kernels_per_sweep.train",
          "mfu.train", "layout_build_s")


def tiny_imc_config() -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "imc-ml25m-genome-r64.json").read_text())
    cfg.update(TINY_IMC)
    return cfg


def make_imc_root(dest):
    """``make_root(dest)`` with the tiny IMC configuration and its cell
    added, as new files and entries."""
    make_root(dest)
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    cfg_file = "benchmark/configs/tiny-imc.json"
    (dest / cfg_file).write_text(json.dumps(tiny_imc_config()))
    spec["configs"].append({"name": "tiny-imc", "source": "tests",
                            "file": cfg_file, "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny-imc",
                              "traffic": "imc-train", "chips": 1,
                              "why": "tests"})
    (dest / "benchmark" / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"limits": TINY_IMC_LIMITS}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in SHARED or m["name"].endswith(".imc"):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="module")
def imc_root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_imc_root(tmp_path_factory.mktemp("bench_imc"))


# -- needed work ------------------------------------------------------------

def test_the_cg_work_against_hand_counts():
    n, d, k = 10, 3, 2
    # F M and Fᵀ T: 2·10·3·2 each; row grams 2·10·2²; ridge 2·3·2
    assert work_imc.matvec_work(n, d, k) == (120 + 120 + 80 + 12,
                                             (30 + 10 * 3 + 2 * 6) * 4)
    # F M; the row grams 2·10·2² and their dot with T 2·10·2
    assert work_imc.objective_work(n, d, k) == (120 + 80 + 40,
                                                (30 + 10 * 3 + 6) * 4)
    assert [work_imc.cg_passes(i) for i in (1, 16, 17, 20, 50)] == [
        2, 17, 19, 22, 54]
    # two halves, users (10, 3) and items (4, 5), rank 2, 16 CG steps
    wf = 17 * 332 + 240
    hf = 17 * (4 * 4 * 5 * 2 + 2 * 4 * 4 + 2 * 5 * 2) + (
        2 * 4 * 5 * 2 + 2 * 4 * 4 + 2 * 4 * 2)
    assert work_imc.cg_work(10, 4, 3, 5, 2, 16)[0] == wf + hf
    products = 4 * 2 * (10 * 3 + 4 * 5)
    assert work_imc.sweep_flops(7, 10, 4, 3, 5, 2, 16) == (
        2 * 7 * (2 * 3 + 4) + products + wf + hf)


def test_the_grams_work_against_hand_counts():
    users = np.array([0, 0, 1, 3, 3, 3])
    items = np.array([1, 2, 2, 0, 1, 2])
    k = 2
    # each half: 6 ratings of 8 bytes, 3 distinct opposite rows of k
    # floats, 3 rows with ratings writing a triangle (3) and an rhs (k)
    want_f = 2 * 6 * (k * (k + 1) + 2 * k)
    want_b = 2 * (6 * 8 + 3 * k * 4 + 3 * (3 + k) * 4)
    assert work_imc.grams_work(users, items, 5, 4, k) == (want_f, want_b)
    assert want_f == 2 * work.obs_flops(6, k)


# -- the cell through the harness ---------------------------------------------

def test_a_tiny_imc_cell_is_correct_and_loads_no_jax(imc_root):
    os.symlink(REPO / "recommendation_models_tpu_torch",
               imc_root / "recommendation_models_tpu_torch")
    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from benchmark import run\n"
            "from benchmark.harness import run_cell\n"
            "out = [run_cell(%r, 2**31 + 26, 0.3, t, 'cpu') "
            "for t in (0, 1)]\n"
            "assert all(r['correct'] for r in out)\n"
            "assert not run.forbidden_modules()\n" % CELL)
    names = loaded_after(code, imc_root)
    assert "recommendation_models_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_a_tiny_imc_run_reports_its_metrics(imc_root):
    plain = harness.run_cell(CELL, 7, 0.3, False, "cpu", root=imc_root)
    traced = harness.run_cell(CELL, 7, 0.3, True, "cpu", root=imc_root)
    for got in (plain, traced):
        assert got["correct"], got["checks"]
        assert got["attempted"] >= 1 and got["failed"] == 0
        assert set(got["checks"]) == set(TINY_IMC_LIMITS)
    assert set(plain["metrics"]) == {"sweep_s", "setup_s"}
    # the CPU has no device trace: the device metrics read nothing there
    assert {"mfu.train", "layout_build_s",
            "enqueue_ms.imc"} <= set(traced["metrics"])
    assert "cg_roofline.imc" not in traced["metrics"]


# -- the comparison ---------------------------------------------------------

@pytest.fixture(scope="module")
def readings():
    torch.set_num_threads(2)
    tr = harness.Benchmark().traffic("imc-train")
    return calibrate_imc.readings(tiny_imc_config(), tr, 3,
                                  torch.device("cpu"), True, 0.3)


def test_the_comparison_accepts_the_port_and_rejects_control_and_faults(
        readings):
    def ok(numbers):
        return check.verdict(numbers, TINY_IMC_LIMITS)[0]
    assert ok(readings["sound"]), readings["sound"]
    for name in ("control", "fault_half", "fault_skip", "fault_stale"):
        assert not ok(readings[name]), (name, readings[name])
    # the stale fault passes the first call and fails the window's
    assert set(readings["fault_stale"]) == {
        "window_" + k for k in ("loss_gap", "rmse_gap", "factor_gap")}


def test_rounding_alone_stays_inside_the_limits(readings):
    assert check.verdict(readings["witness_f32"], TINY_IMC_LIMITS)[0]


def test_the_imc_reference_loads_nothing_of_the_port():
    names = loaded_after("import benchmark.references.imc", REPO)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"recommendation_models_tpu_torch"})
