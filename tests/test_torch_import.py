"""The PyTorch port imports without JAX, the JAX package or triton, and its
entry points run on the CUDA card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import recommendation_models_tpu  # noqa: F401  (both packages import here)
import recommendation_models_tpu_torch as port
from recommendation_models_tpu_torch.device import resolve_device
from tests.conftest import tiny_problem

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib.abc, sys

    class _NoTriton(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name == "triton" or name.startswith("triton."):
                raise ImportError("triton is blocked for this check")
            return None

    sys.meta_path.insert(0, _NoTriton())
    before = set(sys.modules)
    import recommendation_models_tpu_torch
    import recommendation_models_tpu_torch.data.layout_cache
    import recommendation_models_tpu_torch.ops.build
    import recommendation_models_tpu_torch.ops.cholesky
    import recommendation_models_tpu_torch.ops.gather
    import recommendation_models_tpu_torch.ops.solve
    import recommendation_models_tpu_torch.probes.ablate_epoch
    import recommendation_models_tpu_torch.probes.dma_gather
    import recommendation_models_tpu_torch.probes.epoch_profile
    import recommendation_models_tpu_torch.probes.gather_budget
    import recommendation_models_tpu_torch.probes.gather_rates
    import recommendation_models_tpu_torch.probes.solve_latency
    import recommendation_models_tpu_torch.probes.solve_variants
    import recommendation_models_tpu_torch.solver.als_sweep
    new = set(sys.modules) - before
    # exact-key checks: "recommendation_models_tpu" is a prefix of the
    # port's own name, so a substring test would match the port itself
    bad = sorted(m for m in new
                 if m in ("jax", "recommendation_models_tpu", "triton")
                 or m.startswith(("jax.", "jaxlib", "triton.",
                                  "recommendation_models_tpu.")))
    print("BAD", bad)
    print("PORT", "recommendation_models_tpu_torch" in sys.modules)
""")


def test_port_imports_without_jax_reference_or_triton():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "PORT True" in res.stdout


def test_fit_without_platform_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from sklearn.base import clone
    m = port.ALS(rank=4, n_sweeps=1)          # construction needs no card
    assert clone(m).get_params()["platform"] is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.fit(tiny_problem(12, 10, seed=3))
    # the CPU is used only when asked for
    m2 = port.ALS(rank=4, n_sweeps=1, platform="cpu").fit(
        tiny_problem(12, 10, seed=3))
    assert np.isfinite(m2.U_).all()


@pytest.mark.parametrize("platform,expect", [
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), ("tpu", ValueError),
])
def test_resolve_device(platform, expect):
    if expect is ValueError:
        with pytest.raises(ValueError):
            resolve_device(platform)
    else:
        assert resolve_device(platform).type == expect


@pytest.mark.parametrize("kwargs,call", [
    (dict(n_shards=2), "fit"),
    (dict(topology="obs_parallel"), "fit"),
    (dict(checkpoint_dir="ckpt", checkpoint_every=1), "fit"),
    (dict(), "recommend"),
    (dict(), "top_n"),
    (dict(), "resume"),
])
def test_unported_paths_raise_naming_roadmap(kwargs, call):
    m = port.ALS(rank=3, n_sweeps=1, platform="cpu", **kwargs)
    R = tiny_problem(10, 8, seed=2)
    if call != "fit":
        m = port.ALS(rank=3, n_sweeps=1, platform="cpu").fit(R)
    fn = {"fit": lambda: m.fit(R), "recommend": lambda: m.recommend([0]),
          "top_n": lambda: m.top_n(0), "resume": lambda: m.resume("x")}[call]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fn()
