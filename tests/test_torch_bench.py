"""The port's bench (``python -m recommendation_models_tpu_torch.bench``)
against the JAX package's ``bench.py``: the same env knobs give the same
metric, observation count, gathered rows and train RMSE; the failure
record and exit code; the serving and IMC modes on the host."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import recommendation_models_tpu  # noqa: F401  (both packages import here)
from recommendation_models_tpu.config import DataConfig
from recommendation_models_tpu.data import layout as rl
from recommendation_models_tpu.data import layout_cache as rlc
from recommendation_models_tpu_torch import bench as port_bench
from recommendation_models_tpu_torch.probes import SCALES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as ref_bench  # noqa: E402  (the JAX package's bench.py)

torch.set_num_threads(2)

# every run: tiny scale, 2 sweeps, a 200-row oracle; the JAX side on the
# CPU through its XLA solve in float32 (no Pallas interpret mode)
COMMON = dict(BENCH_SCALE="tiny", BENCH_SWEEPS="2", BENCH_ORACLE_ROWS="200",
              BENCH_SOLVER="xla", BENCH_DTYPE="float32")
# rank 128 with a dense block (threshold 256: 54 whale items) and 1 MB row
# blocks (bucket splitting at k = 128); rank 64 explicit; rank 64 implicit.
# At rank 128 both sides take the separate SSE pass: the riding identity's
# f32 cancellation differs between the packages by more than the
# tolerance here (the JAX package's reads 0.07724 against a direct RMSE of
# 0.077646; the port's 0.077650), and test_riding_history_is_the_direct_rmse
# holds the port's riding history to its direct RMSE instead
CASES = {
    "rank128_dense_rowblocks": dict(BENCH_RANK="128", BENCH_DMD="256",
                                    BENCH_GATHER_MB="1",
                                    BENCH_SSE_MODE="separate"),
    "rank64": dict(BENCH_RANK="64"),
    "rank64_implicit": dict(BENCH_RANK="64", BENCH_ALPHA="1.0"),
}
RMSE_RTOL = 1e-3


def _set_env(monkeypatch, env):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _port_run(capsys, argv=("--platform", "cpu")):
    """The port's bench in the process: (exit code, its one stdout line as
    JSON, stderr)."""
    rc = port_bench.main(list(argv))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out          # one JSON line, nothing else
    return rc, json.loads(lines[0]), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mode_matches_jax_bench(case, monkeypatch, capsys):
    _set_env(monkeypatch, {**COMMON, **CASES[case]})
    ref_bench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc, got, err = _port_run(capsys)
    assert rc == 0
    assert got["metric"] == ref["metric"]
    assert got["unit"] == ref["unit"]
    g, r = got["extra"], ref["extra"]
    assert set(r) <= set(g)              # bench.py's keys, and more
    for key in ("nnz", "gathered_rows_per_epoch", "solver",
                "compute_dtype"):
        assert g[key] == r[key], key
    # bench.py rounds train_rmse to 5 places
    np.testing.assert_allclose(g["train_rmse"], r["train_rmse"],
                               rtol=RMSE_RTOL, atol=1e-5)
    # on the host every device number is null
    for key in ("epoch_seconds", "roof_fraction", "max_memory_allocated",
                "card"):
        assert g[key] is None, key
    assert got["value"] is None and got["vs_baseline"] is None
    assert g["device"] == "cpu" and g["oracle_rows_per_sec"] > 0
    assert g["gather_roof_rows_per_s"] == pytest.approx(
        3.35e12 / (4 * int(CASES[case]["BENCH_RANK"])))
    assert g["sweeps"] == 2 and len(g["history"]) == 2
    for line in ("# data: ", "# cpu (untimed): ", "# oracle: "):
        assert line in err
    if case.startswith("rank128"):
        assert g["dense_rows"] == {"user": 0, "item": 54}
        assert g["dense_tflop_per_sweep"] == pytest.approx(
            2 * 54 * 2000 * (128 * 128 + 128) / 1e12)


@pytest.mark.parametrize("rank", ["128", "64"])
def test_riding_history_is_the_direct_rmse(rank, monkeypatch, capsys):
    """On the riding path the history's last value is the identity
    ``Σ w r² - x·rhs - reg ||x||²``; it must agree with a direct RMSE of
    the final factors (``masked_sse``), as chip_smoke.py holds it."""
    _set_env(monkeypatch, {**COMMON, "BENCH_RANK": rank,
                           "BENCH_DMD": "256", "BENCH_GATHER_MB": "1"})
    rc, got, _ = _port_run(capsys)
    assert rc == 0
    g = got["extra"]
    assert g["sse_mode"] == "riding"
    np.testing.assert_allclose(g["train_rmse"], g["direct_rmse"], rtol=1e-3)


@pytest.mark.parametrize("env,argv,error", [
    (dict(BENCH_SCALE="nope"), ["--platform", "cpu"], "KeyError: 'nope'"),
    (dict(BENCH_SCALE="tiny"), [], "RuntimeError: no CUDA device"),
    (dict(BENCH_SCALE="tiny", BENCH_DEADLINE_S="1"), ["--platform", "cpu"],
     "TimeoutError: bench exceeded BENCH_DEADLINE_S=1s"),
])
def test_failure_record_and_exit_code(env, argv, error):
    """A failure prints bench.py's failure record as the one stdout line
    and exits 1: an unknown scale, no card without ``--platform cpu``, the
    watchdog's deadline."""
    run_env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")}
    run_env.update(env, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "recommendation_models_tpu_torch.bench",
         *argv], cwd=REPO, env=run_env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 1, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "bench_failed"
    assert rec["value"] == -1.0 and rec["vs_baseline"] == -1.0
    assert rec["unit"] == "error"
    assert rec["error"].startswith(error), rec["error"]


@pytest.mark.parametrize("mode,rank,metric", [
    ("serving", "64", "topk_retrieval_users_per_sec_rank64_tiny_synth"),
    ("imc", "64", "imc_obs_per_sec_per_chip_rank32_tiny_synth"),
])
def test_serving_and_imc_modes_on_the_host(mode, rank, metric, monkeypatch,
                                           capsys):
    """``BENCH_MODE=serving|imc`` with ``--platform cpu`` runs the probe's
    config at tiny scale, every device field null; IMC caps the rank at 32
    and says so."""
    _set_env(monkeypatch, dict(BENCH_MODE=mode, BENCH_SCALE="tiny",
                               BENCH_RANK=rank))
    rc, got, err = _port_run(capsys)
    assert rc == 0
    assert got["metric"] == metric
    assert got["value"] is None and got["vs_baseline"] is None
    ex = got["extra"]
    assert ex["device"] == "cpu" and ex["card"] is None
    assert ex["max_memory_allocated"] is None
    if mode == "serving":
        assert ex["batch_ms"] is None and ex["bound_ms"] is None
        assert 0 < ex["recall_at_10"] <= 1 and ex["auto_ids_equal_exact"]
    else:
        assert "# imc: BENCH_RANK=64 capped to 32" in err
        assert ex["fit_seconds"] is None and ex["sweep_split"] is None
        assert np.isfinite(ex["cold_start_rmse"])


def test_layout_cache_writes_bench_py_files(monkeypatch, capsys, tmp_path):
    """``BENCH_LAYOUT_CACHE`` caches each side under bench.py's file name,
    in the format the JAX package reads, and a second run loads it."""
    _set_env(monkeypatch, {**COMMON, "BENCH_LAYOUT_CACHE": str(tmp_path)})
    rc, first, _ = _port_run(capsys)
    assert rc == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["tiny.hot128.dmd512.g1.12.item.npz",
                     "tiny.hot128.dmd512.g1.12.user.npz"]
    from recommendation_models_tpu.data.synthetic import synthetic_ratings
    n_users, n_items, n_obs = SCALES["tiny"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    cfg = DataConfig(hot_cols=128, dense_min_degree=512, bucket_growth=1.12)
    for which, transpose in (("user", False), ("item", True)):
        got = rlc.load_layout(
            str(tmp_path / f"tiny.hot128.dmd512.g1.12.{which}.npz"))
        want = rl.layout_from_coo(u, i, r, n_users, n_items,
                                  transpose=transpose, config=cfg)
        assert got.padded_slots == want.padded_slots
        np.testing.assert_array_equal(got.dense_ids if transpose else
                                      got.hot_ids,
                                      want.dense_ids if transpose else
                                      want.hot_ids)
    rc, second, _ = _port_run(capsys)
    assert rc == 0
    assert second["extra"]["train_rmse"] == first["extra"]["train_rmse"]
    assert (second["extra"]["gathered_rows_per_epoch"]
            == first["extra"]["gathered_rows_per_epoch"])


def test_config_from_env_reads_bench_py_knobs():
    env = dict(BENCH_SCALE="ml1m", BENCH_RANK="128", BENCH_SWEEPS="3",
               BENCH_SOLVER="xla", BENCH_DTYPE="float32", BENCH_MODE="imc",
               BENCH_ALPHA="2.5", BENCH_HOT_COLS="0", BENCH_DMD="100",
               BENCH_GROWTH="1.5", BENCH_GATHER_MB="64",
               BENCH_SSE_MODE="separate", BENCH_LAYOUT_CACHE="d",
               BENCH_ORACLE_ROWS="300")
    cfg = port_bench.BenchConfig.from_env(env)
    assert cfg == port_bench.BenchConfig(
        scale="ml1m", rank=128, sweeps=3, solver="xla",
        compute_dtype="float32", mode="imc", alpha=2.5, hot_cols=0,
        dense_min_degree=100, growth=1.5, gather_mb=64, sse_mode="separate",
        layout_cache="d", oracle_rows=300)
    assert cfg.metric() == "als_implicit_rows_solved_per_sec_per_chip_" \
        "rank128_ml1m_synth"
    d = cfg.data_config()
    assert (d.hot_cols, d.dense_min_degree, d.bucket_growth) == (0, 100, 1.5)
    assert cfg.solve_options()["gather_budget_mb"] == 64
    # unset: the defaults of bench.py and the rank's auto policies
    cfg = port_bench.BenchConfig.from_env({"BENCH_RANK": "128",
                                           "BENCH_ALPHA": ""})
    assert (cfg.scale, cfg.sweeps, cfg.mode, cfg.alpha, cfg.oracle_rows) == (
        "ml25m", 10, "train", None, 1000)
    d = cfg.data_config()
    assert (d.hot_cols, d.dense_min_degree, d.bucket_growth) == (0, 2048,
                                                                 1.25)
    assert "gather_budget_mb" not in cfg.solve_options()
