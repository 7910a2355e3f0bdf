"""The port's examples (``examples/torch_port/``) run with ``--platform cpu``
in a subprocess to exit code 0, and the figures they print agree with the
reference example of the same name (``examples/``, JAX on the CPU with 8
forced host devices), within the parity tests' tolerances:

- ``als_quickstart``: train and test RMSE within 1e-3
  (tests/test_torch_quality_parity.py's RMSE), recall@10 and NDCG@10
  within 0.01;
- ``imc_cold_start``: the cold-start RMSE within rtol 1e-3 (the IMC
  cold-start check of ``chip_smoke.py`` phase 7);
- ``serving_quality``: served and exact recall@10 and served NDCG@10
  within 0.01, and served equal to exact in the port;
- ``als_implicit_sharded``: 8 shards each, the per-sweep train RMSE within
  rtol 1e-4 (tests/test_torch_sharded.py's histories), and the resume at
  the last sweep.

Every reference example takes under 60 s on this CPU, so none is marked
slow."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import recommendation_models_tpu  # noqa: F401  (both packages import here)
import recommendation_models_tpu_torch  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "examples", "torch_port")
NAMES = ("als_quickstart", "imc_cold_start", "serving_quality",
         "als_implicit_sharded")
NUM = r"([-+]?\d+\.\d+)"


def _run(path, args, env):
    res = subprocess.run([sys.executable, path, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"{path}\n{res.stdout}\n{res.stderr}"
    return res.stdout


def _both(name):
    """(port stdout, reference stdout) of one example."""
    base = {k: v for k, v in os.environ.items()}
    base["PYTHONPATH"] = REPO
    port_env = dict(base, OMP_NUM_THREADS="2")
    ref_env = dict(base, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port = _run(os.path.join(PORT_DIR, f"{name}.py"),
                ["--platform", "cpu"], port_env)
    ref = _run(os.path.join(REPO, "examples", f"{name}.py"), [], ref_env)
    return port, ref


def _floats(pattern, text):
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in\n{text}"
    return [float(x) for x in m.groups()]


def test_port_examples_are_the_references_four():
    assert sorted(f[:-3] for f in os.listdir(PORT_DIR)
                  if f.endswith(".py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_and_agrees_with_the_reference(name):
    port, ref = _both(name)
    if name == "als_quickstart":
        pat = rf"train RMSE {NUM}\s+test RMSE {NUM}"
        np.testing.assert_allclose(_floats(pat, port), _floats(pat, ref),
                                   atol=1e-3)
        pat = rf"recall@10 {NUM}\s+NDCG@10 {NUM}"
        np.testing.assert_allclose(_floats(pat, port), _floats(pat, ref),
                                   atol=0.01)
    elif name == "imc_cold_start":
        pat = rf"cold-start RMSE {NUM}"
        np.testing.assert_allclose(_floats(pat, port), _floats(pat, ref),
                                   rtol=1e-3)
    elif name == "serving_quality":
        pat = rf"served={NUM} exact={NUM}"
        served, exact = _floats(pat, port)
        assert served == exact
        np.testing.assert_allclose([served, exact], _floats(pat, ref),
                                   atol=0.01)
        pat = rf"ndcg@10:\s+served={NUM}"
        np.testing.assert_allclose(_floats(pat, port), _floats(pat, ref),
                                   atol=0.01)
    else:
        for out in (port, ref):
            assert "fitted on 8 shard(s)" in out
            assert "resumed at sweep 8" in out
        hist = [re.findall(r"train_rmse=(\d+\.\d+)", out)
                for out in (port, ref)]
        assert len(hist[0]) == len(hist[1]) == 8
        np.testing.assert_allclose(np.asarray(hist[0], float),
                                   np.asarray(hist[1], float), rtol=1e-4)
