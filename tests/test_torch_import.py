"""The PyTorch port imports without JAX, the JAX package or triton, and its
entry points run on the CUDA card unless asked for the CPU."""

import json
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
    import recommendation_models_tpu_torch.bench
    import recommendation_models_tpu_torch.data.layout_cache
    import recommendation_models_tpu_torch.data.movielens
    import recommendation_models_tpu_torch.data.native
    import recommendation_models_tpu_torch.evaluate
    import recommendation_models_tpu_torch.models.imc
    import recommendation_models_tpu_torch.ops.build
    import recommendation_models_tpu_torch.ops.cholesky
    import recommendation_models_tpu_torch.ops.gather
    import recommendation_models_tpu_torch.ops.solve
    import recommendation_models_tpu_torch.ops.topk
    import recommendation_models_tpu_torch.oracle
    import recommendation_models_tpu_torch.parallel
    import recommendation_models_tpu_torch.parallel.exchange
    import recommendation_models_tpu_torch.parallel.hybrid_als
    import recommendation_models_tpu_torch.parallel.mesh
    import recommendation_models_tpu_torch.parallel.scaling
    import recommendation_models_tpu_torch.parallel.sharded_als
    import recommendation_models_tpu_torch.prng
    import recommendation_models_tpu_torch.probes.ablate_epoch
    import recommendation_models_tpu_torch.probes.dma_gather
    import recommendation_models_tpu_torch.probes.epoch_profile
    import recommendation_models_tpu_torch.probes.gather_budget
    import recommendation_models_tpu_torch.probes.gather_latency
    import recommendation_models_tpu_torch.probes.gather_rates
    import recommendation_models_tpu_torch.probes.imc
    import recommendation_models_tpu_torch.probes.multiprocess
    import recommendation_models_tpu_torch.probes.panel_trace
    import recommendation_models_tpu_torch.probes.exchange
    import recommendation_models_tpu_torch.probes.fuzz_kernel_shapes
    import recommendation_models_tpu_torch.probes.parser
    import recommendation_models_tpu_torch.probes.plan_build
    import recommendation_models_tpu_torch.probes.quality_parity
    import recommendation_models_tpu_torch.probes.quality_parity_imc
    import recommendation_models_tpu_torch.probes.serving
    import recommendation_models_tpu_torch.probes.serving_quality
    import recommendation_models_tpu_torch.probes.sharded_hot
    import recommendation_models_tpu_torch.probes.sharded_scan
    import recommendation_models_tpu_torch.probes.split_gather
    import recommendation_models_tpu_torch.probes.profile_half
    import recommendation_models_tpu_torch.probes.ablate_gram_layout
    import recommendation_models_tpu_torch.probes.solve_latency
    import recommendation_models_tpu_torch.probes.solve_variants
    import recommendation_models_tpu_torch.solver.als_sweep
    import recommendation_models_tpu_torch.train
    import recommendation_models_tpu_torch.utils
    import recommendation_models_tpu_torch.utils.checkpoint
    import recommendation_models_tpu_torch.utils.logging
    import recommendation_models_tpu_torch.utils.profiling
    from recommendation_models_tpu_torch import ALS, IMC
    # EXAMPLE_IMPORTS
    print("EXPORTS", sorted(recommendation_models_tpu_torch.__all__))
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


EXAMPLES = os.path.join(REPO, "examples", "torch_port")


def _example_imports(path):
    """The module-level import lines of one of the port's examples."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    return [ast.unparse(node) for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))]


def _all_example_imports():
    lines = []
    for name in sorted(os.listdir(EXAMPLES)):
        if name.endswith(".py"):
            lines += _example_imports(os.path.join(EXAMPLES, name))
    return "\n".join(dict.fromkeys(lines))


def test_port_imports_without_jax_reference_or_triton():
    """The port's modules, its probes and every import line of its examples
    (``examples/torch_port/``) import neither JAX, the JAX package nor
    triton."""
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = _PROBE.replace("# EXAMPLE_IMPORTS", _all_example_imports())
    assert "from recommendation_models_tpu_torch import IMC" in probe
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "PORT True" in res.stdout
    assert "EXPORTS ['ALS', 'IMC', '__version__']" in res.stdout


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


_EXAMPLE_RUN = textwrap.dedent("""
    import importlib.abc, sys

    class _Block(importlib.abc.MetaPathFinder):
        # JAX, the JAX package and triton
        def find_spec(self, name, path, target=None):
            if (name in ("jax", "jaxlib", "recommendation_models_tpu",
                         "triton")
                    or name.startswith(("jax.", "jaxlib.", "triton.",
                                        "recommendation_models_tpu."))):
                raise ImportError(name + " is blocked for this check")
            return None

    sys.meta_path.insert(0, _Block())
    {imports}
    print("IMPORTED")
""")


@pytest.mark.parametrize("name", ["als_quickstart", "imc_cold_start",
                                  "serving_quality", "als_implicit_sharded"])
def test_example_import_lines_run_without_jax(name):
    """Each of the port's examples imports what it needs with JAX, the JAX
    package and triton blocked from import."""
    lines = _example_imports(os.path.join(EXAMPLES, f"{name}.py"))
    assert any("recommendation_models_tpu_torch" in ln for ln in lines)
    code = _EXAMPLE_RUN.replace("{imports}", "\n".join(lines))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "IMPORTED" in res.stdout


@pytest.mark.parametrize("platform,expect", [
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), ("tpu", ValueError),
])
def test_resolve_device(platform, expect):
    if expect is ValueError:
        with pytest.raises(ValueError):
            resolve_device(platform)
    else:
        assert resolve_device(platform).type == expect


@pytest.mark.parametrize("estimator,kwargs", [
    ("ALS", dict(topology="obs_parallel", n_shards=4, num_slices=2)),
    ("ALS", dict(topology="obs_parallel", n_shards=2)),
    ("IMC", dict(n_shards=8)),
])
def test_unported_paths_raise_naming_roadmap(estimator, kwargs):
    """The paths that raised ``NotImplementedError`` before the 2-D ALS and
    the sharded IMC were ported now take the reference's outcome: the 2-D
    fit and the sharded IMC fit agree with the JAX package, and
    ``obs_parallel`` without ``num_slices`` raises its ``ValueError``."""
    import recommendation_models_tpu as ref
    args = (tiny_problem(10, 8, seed=2),)
    if estimator == "IMC":
        rng = np.random.default_rng(2)      # side features X, Y
        args += (rng.standard_normal((10, 4)), rng.standard_normal((8, 3)))
    m = getattr(port, estimator)(rank=3, n_sweeps=1, platform="cpu",
                                 **kwargs)
    r = getattr(ref, estimator)(rank=3, n_sweeps=1, platform="cpu",
                                **kwargs)
    if "num_slices" not in kwargs and estimator == "ALS":
        with pytest.raises(ValueError) as want:
            r.fit(*args)
        with pytest.raises(ValueError) as got:
            m.fit(*args)
        assert str(got.value) == str(want.value)
        return
    m.fit(*args)
    r.fit(*args)
    # tests/test_mesh_hybrid.py's estimator tolerance, tests/test_imc.py's
    tables, tol = ((("U_", "V_"), dict(rtol=2e-4, atol=2e-5))
                   if estimator == "ALS" else
                   (("W_", "H_"), dict(rtol=5e-3, atol=5e-3)))
    for t in tables:
        np.testing.assert_allclose(getattr(m, t), getattr(r, t), **tol)
    assert m.exchange_bytes_per_sweep_ == r.exchange_bytes_per_sweep_


@pytest.mark.parametrize("topology", ["obs_parallel", "bogus"])
def test_topology_without_shards_raises_like_the_reference(topology):
    """Another topology than "1d" without shards is the caller's error in
    both packages: ``ValueError``, with the reference's message."""
    from recommendation_models_tpu import ALS as RefALS
    R = tiny_problem(10, 8, seed=2)
    with pytest.raises(ValueError) as ref:
        RefALS(rank=3, n_sweeps=1, platform="cpu", topology=topology).fit(R)
    with pytest.raises(ValueError) as got:
        port.ALS(rank=3, n_sweeps=1, platform="cpu",
                 topology=topology).fit(R)
    assert str(got.value) == str(ref.value)
    assert "needs a sharded fit" in str(got.value)


_BENCH_RUN = textwrap.dedent("""
    import importlib.abc, runpy, sys

    class _Block(importlib.abc.MetaPathFinder):
        # JAX, the JAX package and its bench.py
        def find_spec(self, name, path, target=None):
            if (name in ("jax", "jaxlib", "recommendation_models_tpu",
                         "bench")
                    or name.startswith(("jax.", "jaxlib.",
                                        "recommendation_models_tpu."))):
                raise ImportError(name + " is blocked for this check")
            return None

    sys.meta_path.insert(0, _Block())
    sys.argv = ["bench", "--platform", "cpu"]
    runpy.run_module("recommendation_models_tpu_torch.bench",
                     run_name="__main__")
""")


def test_bench_runs_without_jax_or_the_reference():
    """``python -m recommendation_models_tpu_torch.bench --platform cpu``
    runs to its record with JAX, the JAX package and ``bench.py`` blocked
    from import."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=REPO, BENCH_SCALE="tiny", BENCH_SWEEPS="1",
               BENCH_ORACLE_ROWS="200")
    res = subprocess.run([sys.executable, "-c", _BENCH_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip())
    assert rec["metric"] == "als_rows_solved_per_sec_per_chip_rank64_tiny_synth"
    assert np.isfinite(rec["extra"]["train_rmse"])


_BY_PATH = textwrap.dedent("""
    import importlib.util, sys
    for name in ("als_numpy", "imc_numpy"):
        spec = importlib.util.spec_from_file_location(
            name, "recommendation_models_tpu_torch/oracle/" + name + ".py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    print("LOADED", mod.OracleIMC.__name__)
    print("TORCH", "torch" in sys.modules)
    print("JAX", "jax" in sys.modules)
    print("PKG", sorted(m for m in sys.modules
                        if m.startswith("recommendation_models_tpu")))
""")


def test_oracle_loads_by_file_path_without_torch_jax_or_reference():
    res = subprocess.run([sys.executable, "-c", _BY_PATH], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED OracleIMC" in res.stdout
    assert "TORCH False" in res.stdout
    assert "JAX False" in res.stdout
    assert "PKG []" in res.stdout
