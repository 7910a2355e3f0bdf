"""The harness is driven by data: a configuration, a cell and a per-layer
metric added as new files and new ``BENCHMARK.json`` entries are found and
run with no existing file edited; and the measurement path refuses to run
without a card."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.conftest import REPO, make_root

METRIC = '''"""ratings_per_sweep.train: a count of the added configuration's
ratings over the sweeps of the traced call (a test metric)."""


def read(run):
    if run.capture is None:
        return None
    return float(run.window["sweeps"]) / max(run.traced_units, 1)
'''


def digests(root):
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            out[str(path.relative_to(root))] = hashlib.sha256(
                path.read_bytes()).hexdigest()
    return out


def run_in(root, code, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_added_files_are_found_and_run(tmp_path):
    # the repository's benchmark as it stands, then the additions
    root = make_root(tmp_path)
    os.symlink(REPO / "recommendation_models_tpu_torch",
               root / "recommendation_models_tpu_torch")
    before = {f"benchmark/{k}": v
              for k, v in digests(REPO / "benchmark").items()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "ratings_per_sweep.train", "unit": "sweeps",
        "better": "higher", "source": "host_clock", "layer": "Sweep loop",
        "moves": "sweep_s", "workloads": ["tiny.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "metrics" / "ratings_per_sweep.train.py"
     ).write_text(METRIC)
    code = ("import json, benchmark, torch; torch.set_num_threads(2)\n"
            "from benchmark.harness import run_cell\n"
            "assert benchmark.__file__.startswith(%r)\n"
            "for t in (0, 1):\n"
            "    print(json.dumps(run_cell('tiny.train', 9, 0.3, t, 'cpu')))\n"
            % str(root))
    done = run_in(root, code)
    assert done.returncode == 0, done.stderr[-3000:]
    plain, traced = (json.loads(line) for line in
                     done.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"sweep_s", "train_ratings_per_s",
                                     "setup_s"}
    assert "ratings_per_sweep.train" in traced["metrics"]
    assert "layout_build_s" in traced["metrics"]
    # nothing that was there before was edited
    after = {k: v for k, v in digests(root).items() if k in before}
    assert after == before


def test_the_measurement_path_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "als-ml25m-r64.train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
