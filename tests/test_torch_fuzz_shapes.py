"""The port's kernel shape fuzz (``probes/fuzz_kernel_shapes.py``) draws
the trials of ``scripts/fuzz_kernel_shapes.py``: the script itself runs
here with its device check and its solves replaced by recorders (and its
``np.einsum`` by a recorder of the factors it is given), and every trial's
order, batch, two-gram flag, ridge, factors and rhs must equal the port's,
bit for bit, as must the script's ``pallas_supported`` verdict and the
port's copy of it. The grams the port forms (on the CPU here) are held to
the script's at f32 rounding."""

import hashlib
import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch

from recommendation_models_tpu_torch.probes import fuzz_kernel_shapes as fz

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRAMS = 4      # the script's first factors whose grams are compared


def _digest(a):
    return a.dtype.str, a.shape, hashlib.blake2b(
        np.ascontiguousarray(a).tobytes(), digest_size=16).hexdigest()


def _script_trials(monkeypatch, capsys, n_trials, seed):
    """Run the script's ``main`` and return the digests of the factors its
    einsum got, the arguments of its solve_spd_t calls (the grams of the
    first trials only) and its printed tags."""
    import jax
    import recommendation_models_tpu.ops.solve as rsolve
    spec = importlib.util.spec_from_file_location(
        "fuzz_kernel_shapes_script",
        os.path.join(REPO, "scripts", "fuzz_kernel_shapes.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    factors, calls = [], []

    def einsum(spec_, a, b):
        assert spec_ == "bij,bkj->bik" and a is b
        factors.append(_digest(a))
        if len(factors) > N_GRAMS:
            # only the first factors' grams are compared: skip the product
            return np.zeros_like(a)
        return np.matmul(a, a.transpose(0, 2, 1))

    def solve_spd_t(Gt, rt, solver, reg_vec=None, Gt2=None):
        keep = len(factors) <= N_GRAMS
        calls.append(dict(
            solver=solver, rt=np.asarray(rt), reg=np.asarray(reg_vec),
            two_op=Gt2 is not None, Gt=np.asarray(Gt) if keep else None,
            Gt2=np.asarray(Gt2) if keep and Gt2 is not None else None))
        return np.zeros(np.asarray(rt).shape, np.float32)

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform="tpu")])
    monkeypatch.setattr(rsolve, "solve_spd_t", solve_spd_t)
    monkeypatch.setattr(script.np, "einsum", einsum)
    monkeypatch.setattr(script.sys, "argv",
                        ["fuzz_kernel_shapes.py", str(n_trials), str(seed)])
    assert script.main() == 0
    tags = re.findall(r"ok trial (\d+): k=(\d+) b=(\d+) 2op=(\w+) "
                      r"supported=(\w+)", capsys.readouterr().out)
    assert len(tags) == n_trials
    return factors, calls, tags


@pytest.mark.parametrize("seed", [0, 1])
def test_trials_equal_the_scripts(monkeypatch, capsys, seed):
    n = fz.N_TRIALS
    factors, calls, tags = _script_trials(monkeypatch, capsys, n, seed)
    fi, n_got, verdicts = 0, 0, set()
    for trial, tag in zip(fz.trials(n, seed), tags):
        n_got += 1
        pallas, xla = calls[2 * trial.t], calls[2 * trial.t + 1]
        assert (pallas["solver"], xla["solver"]) == ("pallas", "xla")
        assert (int(tag[0]), int(tag[1]), int(tag[2])) == (
            trial.t, trial.k, trial.b)
        assert (tag[3] == "True") == trial.two_op == pallas["two_op"]
        supported = tag[4] == "True"
        assert fz.expected(trial)[0] == supported
        verdicts.add(supported)
        # the factors, bit for bit, in the script's order: A, then B2
        assert factors[fi] == _digest(trial.A)
        fi += 1
        if trial.two_op:
            assert factors[fi] == _digest(trial.B2)
            fi += 1
        np.testing.assert_array_equal(pallas["rt"], trial.rhs.T)
        np.testing.assert_array_equal(
            pallas["reg"], np.full(trial.b, trial.reg, np.float32))
        if pallas["Gt"] is not None:
            # the grams the port forms, against the script's
            Gt, Gt2 = fz.grams(trial, torch.device("cpu"))
            np.testing.assert_allclose(Gt.numpy(), pallas["Gt"],
                                       rtol=1e-6, atol=1e-6)
            if trial.two_op:
                np.testing.assert_allclose(Gt2.numpy(), pallas["Gt2"],
                                           rtol=1e-6, atol=1e-6)
    assert n_got == n and fi == len(factors)
    # the draws reach both sides of the reference's rule
    assert verdicts == {True, False}


def test_expected_counts_follow_the_routing():
    """Which kernel a trial launches, or which wrapper counts it routed."""
    def trial(k, b, two_op):
        return fz.Trial(0, k, b, two_op, 0.1, None, None, None)

    assert fz.expected(trial(64, 599, False)) == (
        True, "cholesky_solve_batched", "cholesky_solve_batched")
    assert fz.expected(trial(160, 599, True)) == (
        True, "cholesky_solve_2g", "cholesky_solve_2g")
    assert fz.expected(trial(168, 120, False)) == (
        True, "cholesky_solve_large", "cholesky_solve_batched")
    assert fz.expected(trial(168, 57, True)) == (
        False, "cholesky_solve_large", "cholesky_solve_2g")
    assert fz.expected(trial(256, 24, True))[0]
    assert not fz.expected(trial(256, 49, False))[0]


def test_probe_refuses_without_a_card(capsys):
    assert fz.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
