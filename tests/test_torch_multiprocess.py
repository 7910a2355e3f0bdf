"""The port's multi-process runtime (``parallel/mesh.py``:
``initialize_distributed`` and the gloo collectives; the 1-D sharded ALS
across processes; the CLI's ``--coordinator``) against the JAX package.

The cases of tests/test_multihost.py for the 1-D ALS run as 2 gloo
processes x 4 host entries through ``python -m
recommendation_models_tpu_torch.probes.multiprocess`` on the worker's
problem (tests/multihost_worker.py), and are held

- against the JAX package's ``ShardedALSProgram`` run here on its 8 forced
  CPU devices, at the reference's tolerances (U, V rtol 2e-3 / atol 2e-3,
  the SSE rtol 1e-3);
- bit for bit against the port's own one-process 8-entry mesh (the same
  probe functions, in this process): the gathers and the sums in shard
  order make the process count invisible.

Then the 2-process CLI against the JAX CLI's in-process summary, the mesh's
collectives across 2 processes, a peer that dies, and a run without a
card. Crash and resume: tests/test_torch_multiprocess_resume.py; the 2-D
program and the sharded IMC: tests/test_torch_multiprocess_2d_imc.py.
"""

import json
import os
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from recommendation_models_tpu import train as ref_train
from recommendation_models_tpu.config import DataConfig as RefDataConfig
from recommendation_models_tpu.config import SolveConfig as RefSolveConfig
from recommendation_models_tpu.data import layout as ref_layout
from recommendation_models_tpu.parallel.mesh import get_mesh as ref_get_mesh
from recommendation_models_tpu.parallel.mesh import to_host as ref_to_host
from recommendation_models_tpu.parallel.sharded_als import (
    ShardedALSProgram as RefProgram)
from recommendation_models_tpu_torch import train
from recommendation_models_tpu_torch.parallel.mesh import get_mesh
from recommendation_models_tpu_torch.probes import multiprocess as mp

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the processes run torch on 2 threads, as this one does: the same products
# in the same order, bit for bit
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
TIMEOUT = 240
CPU = torch.device("cpu")
PROBE = "recommendation_models_tpu_torch.probes.multiprocess"


def run_probe(outdir, *extra, n=2, devices=8, expect=0):
    """The probe in ``n`` processes over ``devices`` host entries: each
    process's JSON line, after each exit code is checked."""
    res = mp.launch(lambda rank, coord: [
        sys.executable, "-m", PROBE, coord, str(n), str(rank), str(outdir),
        "--platform", "cpu", "--global-devices", str(devices), *extra],
        n, TIMEOUT, env=ENV, cwd=REPO)
    for rc, out, err in res:
        assert rc == expect, f"rc={rc}\n{out}\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in res]


def ref_als(exchange="allgather", scanned=False):
    """The worker's fit in the JAX package on its 8 forced CPU devices."""
    R = mp.tiny_ratings()
    indptr, indices, data, nu, ni = ref_layout.csr_arrays(R)
    rows = np.repeat(np.arange(nu), np.diff(indptr))
    dcfg = (RefDataConfig(dense_whales=False, hot_cols=0)
            if exchange != "allgather" else None)
    prog = RefProgram(
        ref_layout.shard_layout(ref_layout.build_layout(
            indptr, indices, data, nu, ni, config=dcfg), 8),
        ref_layout.shard_layout(ref_layout.layout_from_coo(
            rows, indices, data, nu, ni, transpose=True, config=dcfg), 8),
        ref_get_mesh(8, platform="cpu"),
        RefSolveConfig(rank=5, reg=0.2, solver="xla"), exchange=exchange,
        head=8 if exchange == "hybrid" else 0)
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


def port_one(exchange="allgather", scanned=False, mesh=None, **kw):
    """The same fit by the probe's functions in this one process, on an
    8-entry host mesh."""
    R = mp.tiny_ratings()
    prog = mp.build_program("als", "tiny", R,
                            mesh or get_mesh(8, platform="cpu"), exchange)
    return mp.run_als(prog, "tiny", R.nnz, CPU, scanned=scanned, **kw)


def check(outdir, ref, one, name="result"):
    """``<name>.npz`` against the JAX package's fit (its tolerances) and the
    port's one-process fit (bit for bit)."""
    res = np.load(os.path.join(outdir, name + ".npz"))
    np.testing.assert_allclose(res["U"], ref["U"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res["V"], ref["V"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res["sse"], ref["sse"], rtol=1e-3)
    for key in ("U", "V", "sse", "history"):
        assert res[key].tobytes() == np.asarray(one[key]).tobytes(), key


@pytest.fixture(scope="module")
def reference():
    """The stepwise allgather fit: the JAX package's and the port's in one
    process."""
    return ref_als(), port_one()


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """One 2-process launch of the three exchanges in turn: (its output
    directory, each process's JSON line)."""
    out = tmp_path_factory.mktemp("fits")
    return out, run_probe(out, "--exchange", "allgather,all_to_all,hybrid")


def test_two_process_fit_matches_single(fits, reference):
    out, lines = fits
    assert [ln["process"] for ln in lines] == [0, 1]
    assert all(ln["processes"] == 2 and ln["shards"] == 8 for ln in lines)
    assert lines[0]["runs"][0]["history"] == lines[1]["runs"][0]["history"]
    check(out, *reference, name="result_allgather")


def test_two_process_scanned_fit_matches_single(tmp_path, reference):
    """``make_fit`` across processes: the JAX package's stepwise reference
    (as tests/test_multihost.py holds it), and the port's own one-process
    scanned fit bit for bit."""
    run_probe(tmp_path, "--scanned")
    check(tmp_path, reference[0], port_one(scanned=True))


@pytest.mark.parametrize("exchange", ["all_to_all", "hybrid"])
def test_two_process_compact_exchange(fits, exchange):
    """The rotation exchange (``ppermute`` round trips across processes)
    and the hybrid head sum."""
    check(fits[0], ref_als(exchange), port_one(exchange),
          name=f"result_{exchange}")


def test_two_process_cli_matches_jax_cli(tmp_path):
    """``--synthetic tiny --n-shards 8 --platform cpu`` in 2 processes
    against the JAX CLI in this process: the same summary keys beside the
    port's spans and counters, ``train_rmse`` within 5e-3, the collective
    bytes equal; bit for bit the port's CLI in one process. Only process 0
    writes the JSONL and prints the summary."""
    args = ["--synthetic", "tiny", "--rank", "4", "--n-sweeps", "2",
            "--n-shards", "8", "--platform", "cpu", "--sse-mode",
            "separate"]
    two = tmp_path / "two.jsonl"
    res = mp.launch(lambda rank, coord: [
        sys.executable, "-m", "recommendation_models_tpu_torch.train",
        *args, "--metrics-jsonl", str(two), "--coordinator", coord,
        "--num-processes", "2", "--process-id", str(rank)],
        2, TIMEOUT, env=ENV, cwd=REPO)
    for rc, out, err in res:
        assert rc == 0, f"rc={rc}\n{out}\n{err[-3000:]}"
    assert "[train] train_rmse=" in res[0][1]
    assert "[train]" not in res[1][1]
    got = [json.loads(line) for line in open(two)]
    assert len(got) == 2 + 1
    want_path, one_path = tmp_path / "ref.jsonl", tmp_path / "one.jsonl"
    assert ref_train.main(args + ["--metrics-jsonl", str(want_path)]) == 0
    assert train.main(args + ["--metrics-jsonl", str(one_path)]) == 0
    want = [json.loads(line) for line in open(want_path)]
    one = [json.loads(line) for line in open(one_path)]
    # the port's summary also carries its spans and counters
    for rec in (got[-1], one[-1]):
        assert isinstance(rec.pop("spans"), dict)
        assert isinstance(rec.pop("counters"), dict)
    assert sorted(got[-1]) == sorted(want[-1])
    assert got[-1]["train_rmse"] == pytest.approx(want[-1]["train_rmse"],
                                                  rel=5e-3)
    assert (got[-1]["collective_bytes_per_sweep"]
            == want[-1]["collective_bytes_per_sweep"])
    assert ([r["train_rmse"] for r in got]
            == [r["train_rmse"] for r in one])


_COLLECTIVES = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from recommendation_models_tpu_torch.parallel import mesh as pm
    coord, rank = sys.argv[1], int(sys.argv[2])
    pm.initialize_distributed(coord, 2, rank)
    pm.initialize_distributed(coord, 2, rank)          # the second: nothing
    out = dict(rank=pm.process_index(), count=pm.process_count())
    mesh = pm.get_mesh(8, platform="cpu")
    out.update(local=list(mesh.local), owners=list(mesh.owners))
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    blocks = pm.shard_put(mesh, "data", x)
    out["held"] = [b is not None for b in blocks]
    out["to_host"] = pm.to_host(blocks).tolist()
    g = pm.all_gather(mesh, blocks)
    out["all_gather"] = [g[s].tolist() for s in mesh.local]
    p = pm.psum(mesh, blocks)
    out["psum"] = [p[s].tolist() for s in mesh.local]
    r = pm.ppermute(mesh, blocks, 3)
    out["ppermute"] = [r[s].tolist() for s in mesh.local]
    out["take_rows"] = pm.take_rows(
        blocks, [15, 0, 9, 3, 3], torch.device("cpu")).tolist()
    hm = pm.get_hybrid_mesh(8, num_slices=2, platform="cpu")
    out["grid_local"] = [list(t) for t in hm.local]
    parts = tuple(tuple(torch.full((2,), float(10 * d + s))
                        if (d, s) in hm.local else None for s in range(4))
                  for d in range(2))
    for name, fn in (("psum_along", pm.psum_along),
                     ("all_gather_along", pm.all_gather_along)):
        for axis in ("dcn", "data"):
            res = fn(hm, parts, axis)
            out[f"{name}_{axis}"] = [res[d][s].tolist() for d, s in hm.local]
    out["grid_to_host"] = pm.to_host(parts).tolist()
    errors = []
    for call in (lambda: pm.get_mesh(3, platform="cpu"),
                 lambda: pm.get_mesh(1, platform="cpu"),
                 lambda: pm.get_hybrid_mesh(8, num_slices=4,
                                            platform="cpu")):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    pm.barrier()
    print(json.dumps(out))
""")


def test_collectives_across_two_processes():
    """``get_mesh(8, platform='cpu')`` spans both processes, 4 local
    entries each; each collective gives every position what one process
    gives it, and each position gets its own group's result along either
    axis of the 2-D mesh (each process one slice)."""
    res = mp.launch(lambda rank, coord: [
        sys.executable, "-c", _COLLECTIVES, coord, str(rank)],
        2, TIMEOUT, env=ENV, cwd=REPO)
    for rc, out, err in res:
        assert rc == 0, f"rc={rc}\n{out}\n{err[-3000:]}"
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    blocks = x.reshape(8, 2, 2)
    for rank, (_, out, _) in enumerate(res):
        got = json.loads(out.strip().splitlines()[-1])
        local = list(range(4 * rank, 4 * rank + 4))
        assert got["rank"] == rank and got["count"] == 2
        assert got["local"] == local
        assert got["owners"] == [0] * 4 + [1] * 4
        assert got["held"] == [s in local for s in range(8)]
        np.testing.assert_array_equal(got["to_host"], x)
        for g in got["all_gather"]:
            np.testing.assert_array_equal(g, x)
        for p in got["psum"]:
            np.testing.assert_array_equal(p, blocks.sum(0))
        for s, r in zip(local, got["ppermute"]):
            np.testing.assert_array_equal(r, blocks[(s - 3) % 8])
        np.testing.assert_array_equal(got["take_rows"], x[[15, 0, 9, 3, 3]])
        assert got["grid_local"] == [[rank, s] for s in range(4)]
        parts = np.array([[10 * d + s for s in range(4)] for d in range(2)],
                         np.float32)
        for (d, s), dcn, data, gd, gs in zip(
                got["grid_local"], got["psum_along_dcn"],
                got["psum_along_data"], got["all_gather_along_dcn"],
                got["all_gather_along_data"]):
            assert dcn == [parts[:, s].sum()] * 2
            assert data == [parts[d].sum()] * 2
            np.testing.assert_array_equal(gd, np.repeat(parts[:, s], 2))
            np.testing.assert_array_equal(gs, np.repeat(parts[d], 2))
        np.testing.assert_array_equal(got["grid_to_host"],
                                      np.repeat(parts[rank], 2))
        e3, e1, eh = got["errors"]
        assert "n_shards=3 over 2 processes" in e3
        assert "n_shards=1 over 2 processes" in e1
        assert eh == "2 real slices found but num_slices=4"


_PEER_DIES = textwrap.dedent("""
    import os, sys, torch
    from recommendation_models_tpu_torch.parallel import mesh as pm
    coord, rank = sys.argv[1], int(sys.argv[2])
    pm.initialize_distributed(coord, 2, rank)
    mesh = pm.get_mesh(2, platform="cpu")
    if rank == 1:
        os._exit(3)
    pm.all_gather(mesh, pm.shard_put(mesh, "data", torch.ones(2, 1).numpy()))
""")


def test_a_peer_that_dies_fails_the_survivor():
    """Process 1 exits after the bootstrap; process 0's next collective
    raises at once, well inside the group's timeout, rather than hang."""
    t0 = time.monotonic()
    res = mp.launch(lambda rank, coord: [
        sys.executable, "-c", _PEER_DIES, coord, str(rank)],
        2, TIMEOUT, env=ENV, cwd=REPO)
    assert res[1][0] == 3
    assert res[0][0] == 1, res[0]
    assert "Error" in res[0][2]
    assert time.monotonic() - t0 < 60


def test_a_multi_process_run_without_a_card_raises():
    """No ``--platform``: every process raises the port's no-card error;
    nothing falls back to the host."""
    res = mp.launch(lambda rank, coord: [
        sys.executable, "-m", PROBE, coord, "2", str(rank), "unused"],
        2, TIMEOUT, env=ENV, cwd=REPO)
    for rc, _, err in res:
        assert rc == 1 and "no CUDA device is available" in err, err[-2000:]
