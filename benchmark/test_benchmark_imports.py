"""Import isolation: nothing a cell runs loads JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the references load nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.conftest import REPO, TRAFFICS, make_root, tiny_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "recommendation_models_tpu"}


def loaded_after(code, cwd, timeout=600):
    """Top-level names of the modules loaded after ``code`` ran in a fresh
    interpreter (JAX hidden from nothing: it is installed here)."""
    probe = code + ("\nimport sys, json\n"
                    "print(json.dumps(sorted({m.split('.')[0] "
                    "for m in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=str(cwd))
    env.pop("JAX_PLATFORMS", None)
    done = subprocess.run([sys.executable, "-c", probe], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr[-3000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_a_cells_run_loads_no_jax(tmp_path, traffic):
    root = make_root(tmp_path)
    os.symlink(REPO / "recommendation_models_tpu_torch",
               root / "recommendation_models_tpu_torch")
    code = ("import torch; torch.set_num_threads(2)\n"
            "from benchmark import run\n"
            "from benchmark.harness import run_cell\n"
            f"r = run_cell({tiny_cell(traffic)!r}, 3, 0.2, True, 'cpu')\n"
            "assert r['correct'] and not run.forbidden_modules()\n")
    names = loaded_after(code, root)
    assert "recommendation_models_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("name", ["als"])
def test_the_references_load_nothing_of_the_port(name):
    names = loaded_after(f"import benchmark.references.{name}", REPO)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"recommendation_models_tpu_torch"})


def test_the_run_refuses_a_forbidden_module():
    from benchmark import run
    sys.modules.setdefault("jaxlib", type(sys)("jaxlib"))
    try:
        assert "jaxlib" in run.forbidden_modules()
    finally:
        if getattr(sys.modules.get("jaxlib"), "__file__", None) is None:
            sys.modules.pop("jaxlib", None)
    assert "recommendation_models_tpu_torch" not in run.FORBIDDEN
