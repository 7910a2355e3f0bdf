"""The port's training CLI (``train.py``) against the JAX package's: the
cases of tests/test_train_cli.py run through both CLIs with ``--platform
cpu`` and ``--sse-mode separate``, on the same real-format ratings file
(each CLI on its own copy: both loaders write the same cache name). The
summaries have the same keys (the port's also carry its spans and
counters), and ``train_rmse`` and ``test_rmse`` agree within rtol 1e-3, as do the per-sweep records; a sharded fit logs the same
collective bytes, as do the sharded IMC (``--model imc --n-shards``) and
the 2-D ALS (``--topology obs_parallel``), and a 2-process CLI
(``--coordinator``, ``--num-processes``, ``--process-id``), whose bootstrap
refuses a run without its process id; with no ``--platform`` and no card
the CLI raises the port's ``RuntimeError``;
``build_parser()`` has the JAX one's options, defaults and choices."""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from recommendation_models_tpu import train as ref_train
from recommendation_models_tpu_torch import train

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-3


def _write_ratings_csv(path, n_users=60, n_items=45, n_obs=1500, seed=3):
    rng = np.random.default_rng(seed)
    u = rng.integers(1, n_users + 1, n_obs)
    i = rng.integers(1, n_items + 1, n_obs)
    # dedup (user,item) pairs so leave-n-out groups are well-formed
    key = u.astype(np.int64) * (n_items + 1) + i
    _, first = np.unique(key, return_index=True)
    u, i = u[first], i[first]
    r = rng.integers(1, 11, u.shape[0]) / 2.0
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for k in range(u.shape[0]):
            f.write(f"{u[k]},{i[k]},{r[k]},1234{k}\n")
    return u.shape[0]


@pytest.fixture
def csv_pair(tmp_path):
    """The same ratings.csv in two directories: (port's, JAX package's)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port_csv = tmp_path / "port" / "ratings.csv"
    _write_ratings_csv(port_csv)
    ref_csv = tmp_path / "ref" / "ratings.csv"
    shutil.copy2(port_csv, ref_csv)
    return port_csv, ref_csv


def _port_records(path):
    """The port's JSONL records, each summary's ``spans`` and ``counters``
    (``utils.profiling``) checked and taken out, so that the records
    compare key for key with the JAX CLI's."""
    recs = [json.loads(line) for line in open(path)]
    assert "spans" in recs[-1] and "counters" in recs[-1]
    for r in recs:
        if "spans" in r:
            spans, counters = r.pop("spans"), r.pop("counters")
            assert all(set(v) == {"count", "total_ms", "self_ms"}
                       for v in spans.values())
            assert all(isinstance(v, int) for v in counters.values())
    return recs


def _run_both(args_for, tmp_path):
    """Run both CLIs (``args_for(side)`` gives each its argv); returns the
    JSONL records of each: (port's, JAX package's)."""
    out = []
    for side, cli in (("port", train), ("ref", ref_train)):
        jsonl = tmp_path / f"{side}.jsonl"
        argv = args_for(side) + ["--platform", "cpu", "--sse-mode",
                                 "separate", "--metrics-jsonl", str(jsonl)]
        assert cli.main(argv) == 0
        out.append(_port_records(jsonl) if side == "port" else
                   [json.loads(line) for line in open(jsonl)])
    return out


def _agree(got, want, keys=("train_rmse", "test_rmse")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in keys:
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=RTOL), (k, g, w)


def test_cli_real_format_end_to_end(tmp_path, csv_pair):
    port_csv, ref_csv = csv_pair
    csv = {"port": port_csv, "ref": ref_csv}
    got, want = _run_both(lambda side: [
        "--ratings", str(csv[side]), "--rank", "6", "--n-sweeps", "3",
        "--holdout", "1", "-v"], tmp_path)
    _agree(got, want)
    summary = got[-1]
    assert summary["train_rmse"] < 1.5
    assert "test_rmse" in summary and "recall_at_10" in summary
    assert 0.0 <= summary["recall_at_10"] <= 1.0
    assert summary["eval_users"] == want[-1]["eval_users"]
    assert summary["holdout_users"] == want[-1]["holdout_users"]
    # parser npz cache written next to the source file
    assert os.path.exists(str(port_csv) + ".rmtpu.npz")
    # second run hits the npz cache (delete the csv to prove it's not reread)
    os.remove(port_csv)
    os.remove(ref_csv)
    (tmp_path / "again").mkdir()
    got, want = _run_both(lambda side: [
        "--ratings", str(csv[side]), "--rank", "6", "--n-sweeps", "2",
        "-v"], tmp_path / "again")
    _agree(got, want)


def _same_bytes(got, want):
    """Each sweep's ``collective_bytes`` and the summary's
    ``collective_bytes_per_sweep`` equal, and not zero."""
    per_sweep = [r for r in got if "collective_bytes" in r]
    assert len(per_sweep) == 2 and per_sweep[0]["collective_bytes"] > 0
    assert ([r["collective_bytes"] for r in per_sweep]
            == [r["collective_bytes"] for r in want
                if "collective_bytes" in r])
    assert (got[-1]["collective_bytes_per_sweep"]
            == want[-1]["collective_bytes_per_sweep"] > 0)


def test_cli_sharded_raises_naming_item_13(tmp_path, csv_pair):
    """The sharded ALS fit of tests/test_train_cli.py through both CLIs:
    the same records, each sweep's ``collective_bytes`` and the summary's
    ``collective_bytes_per_sweep`` equal. The sharded IMC fit, which raised
    the ``NotImplementedError`` naming ROADMAP item 13 until it was ported,
    agrees with the JAX CLI's the same way (its objective history within
    tests/test_imc.py's rtol 5e-3)."""
    port_csv, ref_csv = csv_pair
    csv = {"port": port_csv, "ref": ref_csv}
    got, want = _run_both(lambda side: [
        "--ratings", str(csv[side]), "--rank", "4", "--n-sweeps", "2",
        "--n-shards", "8", "--exchange", "hybrid", "--exchange-head", "16"],
        tmp_path)
    _agree(got, want)
    _same_bytes(got, want)
    (tmp_path / "imc").mkdir()
    got, want = _run_both(lambda side: [
        "--ratings", str(csv[side]), "--model", "imc", "--rank", "4",
        "--n-sweeps", "2", "--n-shards", "8"], tmp_path / "imc")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["train_rmse"] == pytest.approx(w["train_rmse"], rel=5e-3)
    _same_bytes(got, want)


def test_cli_obs_parallel_matches_reference(tmp_path, csv_pair):
    """``--topology obs_parallel`` through both CLIs: the same records at
    the estimator tolerance, the same collective bytes; with ``--model
    imc`` both CLIs refuse the topology with the same message."""
    port_csv, ref_csv = csv_pair
    csv = {"port": port_csv, "ref": ref_csv}
    got, want = _run_both(lambda side: [
        "--ratings", str(csv[side]), "--rank", "4", "--n-sweeps", "2",
        "--n-shards", "8", "--num-slices", "2", "--topology",
        "obs_parallel", "--holdout", "1"], tmp_path)
    _agree(got, want)
    _same_bytes(got, want)
    argv = ["--ratings", str(port_csv), "--model", "imc", "--rank", "4",
            "--n-sweeps", "1", "--n-shards", "2", "--topology",
            "obs_parallel", "--platform", "cpu"]
    with pytest.raises(SystemExit) as want:
        ref_train.main(argv)
    with pytest.raises(SystemExit) as got:
        train.main(argv)
    assert str(got.value) == str(want.value) and "als only" in str(got.value)


@pytest.mark.parametrize("argv", [
    ["--coordinator", "localhost:1234", "--num-processes", "2"],
    ["--num-processes", "2", "--process-id", "0"],
    ["--model", "imc", "--n-shards", "2"],
    ["--topology", "obs_parallel", "--n-shards", "2", "--num-slices", "2"],
])
def test_cli_unported_paths_raise_naming_item_13(argv, tmp_path):
    """The paths that raised the ``NotImplementedError`` naming ROADMAP
    item 13 until they were ported. The multi-process bootstrap (item 13f)
    refuses a run without ``--process-id``, and a 2-process CLI at
    ``--n-shards 2`` (one shard a process) agrees with the JAX CLI's
    2-shard run in one process. The sharded IMC and the 2-D ALS (items 13d
    and 13e) agree with the JAX CLI's."""
    base = ["--synthetic", "tiny", "--rank", "2", "--n-sweeps", "1"]
    if "--coordinator" in argv:
        with pytest.raises(ValueError, match="--process-id"):
            train.main(base + ["--platform", "cpu"] + argv)
        return
    if "--num-processes" in argv:
        from recommendation_models_tpu_torch.probes.multiprocess import (
            launch)
        two = tmp_path / "two.jsonl"
        res = launch(lambda rank, coord: [
            sys.executable, "-m", "recommendation_models_tpu_torch.train",
            *base, "--n-shards", "2", "--platform", "cpu", "--sse-mode",
            "separate", "--metrics-jsonl", str(two), "--coordinator", coord,
            "--num-processes", "2", "--process-id", str(rank)], 2, 240,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        for rc, out, err in res:
            assert rc == 0, f"rc={rc}\n{out}\n{err[-3000:]}"
        got = _port_records(two)
        _, want = _run_both(lambda side: base + ["--n-shards", "2"],
                            tmp_path)
    else:
        got, want = _run_both(lambda side: base + argv, tmp_path)
    assert len(got) == len(want) == 2
    assert sorted(got[-1]) == sorted(want[-1])
    assert got[-1]["train_rmse"] == pytest.approx(want[-1]["train_rmse"],
                                                  rel=5e-3)
    assert (got[-1]["collective_bytes_per_sweep"]
            == want[-1]["collective_bytes_per_sweep"])


def test_cli_process_id_alone_does_nothing(tmp_path):
    """With neither --coordinator nor --num-processes the bootstrap does
    nothing, as the reference's does."""
    assert train.main(["--synthetic", "ml100k", "--rank", "2", "--n-sweeps",
                       "1", "--platform", "cpu", "--process-id", "0"]) == 0


def test_cli_synthetic_imc(tmp_path):
    got, want = _run_both(lambda side: [
        "--synthetic", "tiny", "--model", "imc", "--rank", "4",
        "--n-sweeps", "2", "--side-features", "6"], tmp_path)
    _agree(got, want)


def test_cli_checkpoint_resume(tmp_path, csv_pair):
    port_csv, ref_csv = csv_pair
    csv = {"port": port_csv, "ref": ref_csv}

    def args(side):
        return ["--ratings", str(csv[side]), "--rank", "5", "--n-sweeps",
                "3", "--checkpoint-dir", str(tmp_path / f"ckpt_{side}"),
                "--checkpoint-every", "1"]
    got, want = _run_both(args, tmp_path)
    _agree(got, want)
    got, want = _run_both(lambda side: args(side) + ["--resume"], tmp_path)
    _agree(got, want)                 # both jsonl files hold both runs now
    assert len(got) == 2 * (3 + 1)
    # the resumed fit continued from the first fit's factors
    assert got[-1]["train_rmse"] <= got[3]["train_rmse"] * (1 + RTOL)


def test_cli_without_platform_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--synthetic", "ml100k", "--rank", "2",
                    "--n-sweeps", "1"])


def test_cli_needs_data():
    with pytest.raises(SystemExit, match="--ratings / --synthetic"):
        train.main(["--rank", "2", "--platform", "cpu"])


def _options(parser):
    out = {}
    for group in parser._action_groups:
        for a in group._group_actions:
            out[tuple(a.option_strings) or a.dest] = dict(
                group=group.title, dest=a.dest, default=a.default,
                choices=a.choices, type=a.type, nargs=a.nargs,
                action=type(a).__name__, required=a.required)
    return out


def test_build_parser_matches_reference():
    got, want = train.build_parser(), ref_train.build_parser()
    assert _options(got) == _options(want)
    assert got.prog == "recommendation_models_tpu_torch.train"
    assert train.SYNTH_SCALES == ref_train.SYNTH_SCALES
    assert isinstance(got, argparse.ArgumentParser)


def test_module_entry_point_runs_here(tmp_path):
    """``python -m recommendation_models_tpu_torch.train`` as a batch job
    runs on the host with --platform cpu and imports no JAX."""
    jsonl = tmp_path / "m.jsonl"
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "recommendation_models_tpu_torch.train", "--synthetic", "tiny",
         "--rank", "8", "--n-sweeps", "2", "--platform", "cpu",
         "--metrics-jsonl", str(jsonl)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[train] train_rmse=" in res.stdout
    imported = {line.split("|")[-1].strip()
                for line in res.stderr.splitlines()
                if line.startswith("import time:")}
    assert "jax" not in imported and "recommendation_models_tpu" not in \
        imported
    lines = [json.loads(line) for line in open(jsonl)]
    assert len(lines) == 3 and np.isfinite(lines[-1]["train_rmse"])
