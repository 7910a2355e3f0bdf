"""The port's 2-D observation-parallel ALS and sharded IMC across processes
against the JAX package: the cases of tests/test_multihost.py for these two
programs, run as 2 gloo processes x 4 host entries through ``python -m
recommendation_models_tpu_torch.probes.multiprocess`` on the problems of
tests/multihost_worker.py.

The 2-D program runs one slice a process (the sum of the per-row normal
equations along 'dcn' crosses the processes). Each case is held against
the JAX package's program run here on its 8 forced CPU devices, at the
reference's tolerances (U, V, W, H rtol 2e-3 / atol 2e-3, the SSE and the
objective rtol 1e-3), and bit for bit against the port's own one-process
8-entry mesh of the same shape. The 1-D ALS, the CLI and the collectives:
tests/test_torch_multiprocess.py."""

import os

import numpy as np
import pytest
import torch

from recommendation_models_tpu import IMC as RefIMC
from recommendation_models_tpu.config import DataConfig as RefDataConfig
from recommendation_models_tpu.config import SolveConfig as RefSolveConfig
from recommendation_models_tpu.data import layout as ref_layout
from recommendation_models_tpu.parallel.hybrid_als import (
    HybridALSProgram as RefHybrid)
from recommendation_models_tpu.parallel.mesh import (
    get_hybrid_mesh as ref_get_hybrid_mesh)
from recommendation_models_tpu.parallel.mesh import to_host as ref_to_host
from recommendation_models_tpu_torch.parallel.mesh import (
    get_hybrid_mesh, get_mesh)
from recommendation_models_tpu_torch.probes import multiprocess as mp
from tests.test_torch_multiprocess import CPU, run_probe

torch.set_num_threads(2)


def ref_hybrid(scanned=False):
    """The worker's 2-D fit in the JAX package: (D, S) = (2, 4) on its 8
    forced CPU devices."""
    R = mp.tiny_ratings()
    indptr, indices, data, nu, ni = ref_layout.csr_arrays(R)
    rows = np.repeat(np.arange(nu), np.diff(indptr))
    dcfg = RefDataConfig(dense_whales=False, hot_cols=0)
    prog = RefHybrid(
        ref_layout.shard_layout(ref_layout.build_layout(
            indptr, indices, data, nu, ni, config=dcfg), 4),
        ref_layout.shard_layout(ref_layout.layout_from_coo(
            rows, indices, data, nu, ni, transpose=True, config=dcfg), 4),
        ref_get_hybrid_mesh(8, num_slices=2, platform="cpu"),
        RefSolveConfig(rank=5, reg=0.2, solver="xla",
                       compute_dtype="float32"))
    U, V = prog.init_factors(seed=3, init_scale=0.1)
    if scanned:
        U, V, hist, _ = prog.make_fit(4)(U, V)
        sse = float(np.asarray(hist)[-1])
    else:
        for _ in range(4):
            U, V = prog.sweep(U, V)
        sse = float(prog.train_sse(U, V))
    return dict(U=np.asarray(ref_to_host(U))[:nu],
                V=np.asarray(ref_to_host(V))[:ni], sse=sse)


def port_hybrid(scanned=False):
    """The same 2-D fit by the probe's functions in this one process, on a
    (2, 4) host mesh."""
    R = mp.tiny_ratings()
    prog = mp.build_program("hybrid2d", "tiny", R,
                            get_hybrid_mesh(8, num_slices=2, platform="cpu"))
    return mp.run_als(prog, "tiny", R.nnz, CPU, scanned=scanned)


def check(outdir, ref, one, keys):
    res = np.load(os.path.join(outdir, "result.npz"))
    for key in keys[:2]:
        np.testing.assert_allclose(res[key], ref[key], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res[keys[2]], ref[keys[2]], rtol=1e-3)
    for key in keys + ("history",):
        assert res[key].tobytes() == np.asarray(one[key]).tobytes(), key


def test_hybrid2d_two_process_fit_matches_single(tmp_path):
    """2 processes = 2 slices of 4 shards."""
    lines = run_probe(tmp_path, "--model", "hybrid2d")
    assert all(ln["shards"] == 8 for ln in lines)
    check(tmp_path, ref_hybrid(), port_hybrid(), ("U", "V", "sse"))


def test_hybrid2d_scanned_crash_resume(tmp_path):
    """The 2-D program's ``make_fit`` with a hard exit after a 2-sweep fit
    and its checkpoint; the resume across the process boundary finishes
    the fit as the uninterrupted one."""
    extra = ("--model", "hybrid2d", "--scanned")
    run_probe(tmp_path, *extra, "--crash-after-sweep", "2", expect=17)
    assert os.path.isdir(tmp_path / "ckpt")
    assert not (tmp_path / "result.npz").exists()
    run_probe(tmp_path, *extra, "--resume")
    check(tmp_path, ref_hybrid(scanned=True), port_hybrid(scanned=True),
          ("U", "V", "sse"))


@pytest.fixture(scope="module")
def imc_reference():
    """The worker's IMC fit: the JAX package's on its 8 forced CPU devices,
    and the port's in this one process on an 8-entry host mesh."""
    R, X, Y, W0, H0 = mp.tiny_imc_problem()
    m = RefIMC(rank=4, reg=0.1, cg_iters=20, n_shards=8, n_sweeps=4,
               platform="cpu").fit(R, X, Y, W0=W0, H0=H0)
    ref = dict(W=np.asarray(m.W_), H=np.asarray(m.H_), obj=m.history_[-1])
    return ref, mp.run_imc("tiny", get_mesh(8, platform="cpu"), CPU)


def test_imc_two_process_fit_matches_single(tmp_path, imc_reference):
    run_probe(tmp_path, "--model", "imc")
    check(tmp_path, *imc_reference, ("W", "H", "obj"))


def test_imc_fault_injection_restart_resume(tmp_path, imc_reference):
    """A 2-process IMC fit exits 17 after sweep 2 (process 0 writes the
    replicated W and H); the restart with ``--resume`` reproduces the
    uninterrupted fit."""
    run_probe(tmp_path, "--model", "imc", "--crash-after-sweep", "2",
              expect=17)
    assert os.path.isdir(tmp_path / "ckpt")
    assert not (tmp_path / "result.npz").exists()
    run_probe(tmp_path, "--model", "imc", "--resume")
    check(tmp_path, *imc_reference, ("W", "H", "obj"))
