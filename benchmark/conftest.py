"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
configuration small enough for the CPU and one cell of each traffic mix.

Run them from the root of the repository with ``python -m pytest
benchmark/ -q``; tests marked ``gpu`` decide inside the test whether there
is a card and skip without one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# the tiny configuration: every layer of the rank-64 path at a CPU's size
# (a dense item block, hot columns, several buckets)
TINY = {"name": "tiny", "n_users": 2000, "n_items": 300, "n_ratings": 42000,
        "rank": 16}
TRAFFICS = ("train", "serve", "serve-all")
# the tiny cells' limits, set as the cells' are (calibrate.py on the CPU,
# float32 against the bfloat16 control; sound seeds 1-6, control seeds
# 1-3): loss_gap 4.6e-6 to 7.2e-6 sound, 5.9e-4 to 8.8e-4 control;
# rmse_gap 1.1e-8 to 2.5e-7 sound, 1.3e-4 to 2.1e-4 control; factor_gap
# 3.0e-5 to 1.2e-4 sound, 0.057 to 0.070 control; window_loss_gap 5.5e-6
# to 1.7e-5 sound, 1.2e-3 to 1.9e-3 control; window_rmse_gap 1.0e-8 to
# 1.8e-7 sound, 1.5e-4 to 3.1e-4 control; window_factor_gap 1.8e-5 to
# 3.6e-5 sound, 0.025 to 0.033 control; rank_gap 3.8e-16 to 2.7e-8 and
# score_gap 2.4e-7 to 3.4e-7 sound, 7.0e-3 to 8.4e-3 and 6.8e-3 to 8.7e-3
# control
TINY_LIMITS = {"train": {"loss_gap": 6e-5, "rmse_gap": 5e-6,
                         "factor_gap": 2e-3, "window_loss_gap": 1.5e-4,
                         "window_rmse_gap": 5e-6,
                         "window_factor_gap": 1e-3},
               "serve": {"bad_answers": 0, "rank_gap": 1e-4,
                         "score_gap": 1e-4}}
TINY_LIMITS["serve-all"] = TINY_LIMITS["serve"]


def tiny_cell(traffic: str) -> str:
    return f"tiny.{traffic}"


def make_root(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dest`` with the
    tiny configuration and its cells added, as new files and entries."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "als-ml25m-r64.json").read_text())
    cfg.update(TINY)
    cfg_file = "benchmark/configs/tiny.json"
    (dest / cfg_file).write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": cfg_file, "reduced": [], "why": "tests"})
    for traffic in TRAFFICS:
        name = tiny_cell(traffic)
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
        (dest / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps({"limits": TINY_LIMITS[traffic]}))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if any(w.endswith("." + traffic) for w in m.get("workloads", [])):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
