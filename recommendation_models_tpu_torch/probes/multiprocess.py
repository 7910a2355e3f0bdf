"""A sharded fit as one of several cooperating processes: the counterpart of
the JAX package's ``tests/multihost_worker.py``, as a module.

    python -m recommendation_models_tpu_torch.probes.multiprocess \\
        <coordinator> <P> <rank> <outdir> [--model als|hybrid2d|imc] \\
        [--exchange allgather[,all_to_all,hybrid]] [--alpha A] [--scanned] \\
        [--crash-after-sweep N] [--resume] [--global-devices N] \\
        [--platform cpu] [--scale tiny|ml1m|ml25m]

Run it in each of P processes (ranks 0 .. P-1) with one coordinator
``host:port`` (``parallel.mesh.initialize_distributed``, gloo); P = 1 runs
the same code in one process. The mesh is ``get_mesh(N)`` (``--model
hybrid2d``: ``get_hybrid_mesh(N, num_slices=P)``, one slice a process) over
``--global-devices N`` (default: one host entry a process with
``--platform cpu``, else every process's cards). On a host with one card
every process contributes ``cuda:0``, so two processes run two shards
there, and each launches the solve kernels for its own.

The problems:

- ``--scale tiny``: the worker's deterministic problem (48 x 40 ratings,
  rank 5, 4 sweeps, ``reg=0.2``, the library solve, the init of
  ``init_factors(3, 0.1)``; IMC on 48 x 40 with 10 and 8 side features,
  rank 4, 4 sweeps, its warm start from ``default_rng(7)``);
- ``--scale ml1m`` / ``ml25m``: ``synthetic_ratings`` at that scale (rank
  16, seed 0), the program ``ALS(rank=64, reg=0.1, alpha=A, n_shards=N,
  exchange=...)`` builds (``probes.exchange.program_for``; ``hybrid2d``:
  ``topology='obs_parallel'``), from ``init_factors(0, 0.01)`` for 10 (ML-1M)
  or 5 (ML-25M) sweeps; IMC: ``probes.imc``'s ML-1M config.

``--exchange`` takes a comma list: each mode runs in turn in the same
processes. ``--scanned`` fits through ``make_fit``, else a sweep at a
time. ``--crash-after-sweep N`` checkpoints under ``<outdir>/ckpt`` (every
sweep; scanned: once, after an N-sweep fit; IMC: ``checkpoint_every=1``)
and exits with code 17 after sweep N; ``--resume`` continues from the
newest checkpoint to the full count, on this run's mesh, which may differ
from the one that wrote it.

Process 0 writes ``<outdir>/result.npz`` (U, V, the final SSE and the
history; IMC: W, H, the final objective and the history), or with several
modes one ``result_<mode>.npz`` each. As its last
line, each process prints one JSON line: its rank, the device, and per
run the history (train RMSE a sweep; IMC: the objective), the set-up and
per-sweep seconds (host clock, synchronised; the sweeps' clock starts at a
barrier of every process), this process's launches of
B1 and B2 and its routed calls; and its peak device memory (the
process's, from its start).

``launch`` starts a command in P processes at once, each told its rank and
a fresh coordinator, and kills any still running at its time limit by PID;
the tests and ``chip_smoke.py`` drive this module and the training CLI
with it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SWEEPS = {"tiny": 4, "ml1m": 10, "ml25m": 5}
CRASH_EXIT = 17
KERNELS = ("cholesky_solve_batched", "cholesky_solve_hot")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free_port() -> int:
    """A free TCP port of this host (for a coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_for, n_processes: int, timeout: float, env=None,
           cwd=None) -> list:
    """Run ``argv_for(rank, coordinator)`` (a command line) in
    ``n_processes`` processes at once, with a fresh ``127.0.0.1:<port>``
    coordinator: [(exit code, stdout, stderr)] in rank order. Any process
    still running after ``timeout`` seconds is killed by its PID (its exit
    code is then negative), and so is every process this call started
    before it returns."""
    coordinator = f"127.0.0.1:{_free_port()}"
    files, procs = [], []
    try:
        for rank in range(n_processes):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                argv_for(rank, coordinator), stdout=out, stderr=err,
                env=env, cwd=cwd))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read().decode(errors="replace"),
                        err.read().decode(errors="replace")))
        out.close()
        err.close()
    return results


def tiny_ratings():
    """The worker's deterministic 48 x 40 ratings (CSR)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    mask = rng.random((48, 40)) < 0.3
    return sp.csr_matrix(np.where(mask, rng.uniform(1, 5, mask.shape), 0.0
                                  ).astype(np.float32))


def ratings(scale: str):
    """The ratings of ``scale`` as CSR."""
    if scale == "tiny":
        return tiny_ratings()
    import scipy.sparse as sp
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.probes import SCALES
    n_users, n_items, n_obs = SCALES[scale]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    return sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))


def build_program(model: str, scale: str, R, mesh, exchange="allgather",
                  alpha=None):
    """The sharded ALS program of ``model`` ('als': 1-D, 'hybrid2d': the
    observation-parallel 2-D program) on ``mesh`` for ``R``."""
    from recommendation_models_tpu_torch.data.layout import csr_arrays
    if scale != "tiny":
        from recommendation_models_tpu_torch import ALS
        from recommendation_models_tpu_torch.probes.exchange import (
            program_for)
        kw = dict(rank=64, reg=0.1, alpha=alpha, n_shards=mesh.size)
        if model == "hybrid2d":
            kw.update(num_slices=mesh.shape[mesh.axis_names[0]],
                      topology="obs_parallel")
        else:
            kw["exchange"] = exchange
        return program_for(ALS(**kw), R, mesh)
    from recommendation_models_tpu_torch.config import DataConfig, SolveConfig
    from recommendation_models_tpu_torch.data.layout import (
        build_layout, layout_from_coo, shard_layout)
    indptr, indices, data, n_users, n_items = csr_arrays(R)
    rows = np.repeat(np.arange(n_users), np.diff(indptr))
    plain = DataConfig(dense_whales=False, hot_cols=0)

    def layouts(dcfg, S):
        return (shard_layout(build_layout(indptr, indices, data, n_users,
                                          n_items, dcfg), S),
                shard_layout(layout_from_coo(rows, indices, data, n_users,
                                             n_items, dcfg, transpose=True),
                             S))
    if model == "hybrid2d":
        from recommendation_models_tpu_torch.parallel.hybrid_als import (
            HybridALSProgram)
        S = mesh.shape[mesh.axis_names[1]]
        cfg = SolveConfig(rank=5, reg=0.2, alpha=alpha, solver="xla",
                          compute_dtype="float32")
        return HybridALSProgram(*layouts(plain, S), mesh, cfg)
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        ShardedALSProgram)
    cfg = SolveConfig(rank=5, reg=0.2, alpha=alpha, solver="xla")
    dcfg = plain if exchange != "allgather" else None
    return ShardedALSProgram(*layouts(dcfg, mesh.size), mesh, cfg,
                             exchange=exchange,
                             head=8 if exchange == "hybrid" else 0)


def _rmse(sse_values, nnz: int) -> list:
    return [float(np.sqrt(max(float(x), 0.0) / nnz)) for x in sse_values]


def run_als(prog, scale: str, nnz: int, device, scanned: bool = False,
            crash_after=None, resume: bool = False, ckpt_dir=None) -> dict:
    """One fit of a sharded ALS program: {"history" (train RMSE a sweep),
    "sse" (stepwise: ``train_sse`` after the fit; scanned: the last
    sweep's), "U", "V" (host, true sizes), "sweep_s", "crashed"}. Its
    collectives (``to_host`` among them) run in every process."""
    from recommendation_models_tpu_torch.parallel.mesh import (
        barrier, to_host)
    from recommendation_models_tpu_torch.utils.checkpoint import (
        load_latest, save_checkpoint)
    n = SWEEPS[scale]
    nu, ni = prog.n_users, prog.n_items
    hist, start = [], 0
    if resume:
        start, state = load_latest(ckpt_dir)
        U, V = prog.place_factors(state["U"][:nu], state["V"][:ni])
        hist = [float(h) for h in state["history"]]
    elif scale == "tiny":
        U, V = prog.init_factors(seed=3, init_scale=0.1)
    else:
        U, V = prog.init_factors(seed=0, init_scale=0.01)

    def save(step):
        save_checkpoint(ckpt_dir, step=step, state=dict(
            U=to_host(U)[:nu], V=to_host(V)[:ni],
            history=np.asarray(hist, np.float64)))

    _sync(device)
    barrier()       # the clock starts when every process is ready
    t0 = time.perf_counter()
    crashed = False
    if scanned:
        stop = n if crash_after is None or resume else crash_after
        U, V, sse, n_done = prog.make_fit(stop - start, nnz=nnz)(U, V)
        sse_h = sse.cpu().numpy()[:n_done]
        hist += _rmse(sse_h, nnz)
        final = float(sse_h[-1])
        if crash_after is not None and not resume:
            save(crash_after)
            crashed = True
    else:
        for s in range(start, n):
            U, V, sse = prog.sweep_with_sse(U, V)
            hist += _rmse([sse], nnz)
            if crash_after is not None:
                save(s + 1)
                if s + 1 >= crash_after:
                    crashed = True
                    break
        final = None if crashed else float(prog.train_sse(U, V))
    _sync(device)
    secs = time.perf_counter() - t0
    out = dict(history=hist, sse=final, crashed=crashed,
               sweep_s=secs / max(len(hist) - start, 1))
    if not crashed:
        out["U"], out["V"] = to_host(U)[:nu], to_host(V)[:ni]
    return out


def tiny_imc_problem():
    """The worker's IMC problem: (R triplets, X, Y, W0, H0)."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_imc_ratings, synthetic_side_features)
    X, Y = synthetic_side_features(48, 40, d_user=10, d_item=8, seed=1)
    iu, ii, ir, _, _ = synthetic_imc_ratings(X, Y, n_obs=1200, rank=4,
                                             noise=0.02, seed=2)
    rng = np.random.default_rng(7)
    W0 = 0.1 * rng.standard_normal((10, 4)).astype(np.float32)
    H0 = 0.1 * rng.standard_normal((8, 4)).astype(np.float32)
    return (iu, ii, ir), X, Y, W0, H0


def run_imc(scale: str, mesh, device, crash_after=None, resume=False,
            ckpt_dir=None) -> dict:
    """One sharded IMC fit on ``mesh``: {"history" (the objective a
    sweep), "obj" (the last), "W", "H", "sweep_s", "crashed"}."""
    from recommendation_models_tpu_torch import IMC
    from recommendation_models_tpu_torch.parallel.mesh import barrier
    if scale == "tiny":
        R, X, Y, W0, H0 = tiny_imc_problem()
        total, kw = 4, dict(rank=4, reg=0.1, cg_iters=20)
    else:
        from recommendation_models_tpu_torch.probes import imc as pi
        X, Y, users, items, r, cold = pi.imc_data(scale)
        tr = ~cold
        R, W0, H0 = (users[tr], items[tr], r[tr]), None, None
        total = pi.SWEEPS
        kw = dict(rank=pi.RANK, reg=pi.REG, cg_iters=pi.CG_ITERS, seed=0)
    kw["n_shards"] = mesh.size
    ckpt = dict(checkpoint_dir=ckpt_dir, checkpoint_every=1)
    prev = []
    if resume:
        m = IMC(**kw, n_sweeps=total, **ckpt)
        step = m.resume()
        prev = [float(h) for h in m.history_]
        m.n_sweeps = total - step
        W0, H0 = m.W_, m.H_
    elif crash_after is not None:
        m = IMC(**kw, n_sweeps=crash_after, **ckpt)
    else:
        m = IMC(**kw, n_sweeps=total)
    _sync(device)
    barrier()
    t0 = time.perf_counter()
    m._fit(R, X, Y, W0, H0, mesh)
    _sync(device)
    secs = time.perf_counter() - t0
    new = [float(h) for h in m.history_]
    return dict(history=prev + new, obj=new[-1], W=m.W_, H=m.H_,
                sweep_s=secs / len(new),
                crashed=crash_after is not None and not resume)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="recommendation_models_tpu_torch.probes.multiprocess",
        description=__doc__.splitlines()[0])
    ap.add_argument("coordinator", help="host:port of the process group")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--model", default="als",
                    choices=["als", "hybrid2d", "imc"])
    ap.add_argument("--exchange", default="allgather",
                    help="comma list of 'allgather', 'all_to_all', 'hybrid'")
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--scanned", action="store_true")
    ap.add_argument("--crash-after-sweep", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--global-devices", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="None = the CUDA card, 'cpu' = the host")
    ap.add_argument("--scale", default="tiny", choices=sorted(SWEEPS))
    return ap


def main(argv=None) -> int:
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.gram import full_f32
    from recommendation_models_tpu_torch.parallel.mesh import (
        barrier, get_hybrid_mesh, get_mesh, initialize_distributed,
        process_count, process_index)
    args = build_parser().parse_args(argv)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    rank, P = process_index(), process_count()
    if args.model == "hybrid2d":
        mesh = get_hybrid_mesh(args.global_devices, num_slices=P,
                               platform=args.platform)
        device = mesh.grid[mesh.local[0][0]][mesh.local[0][1]]
    else:
        mesh = get_mesh(args.global_devices, platform=args.platform)
        device = mesh.devices[mesh.local[0]]
    if device.type == "cuda":
        full_f32()
    ckpt_dir = os.path.join(args.outdir, "ckpt")
    crash = dict(crash_after=args.crash_after_sweep, resume=args.resume,
                 ckpt_dir=ckpt_dir)
    runs = []
    if args.model == "imc":
        ch.reset_counts()
        res = run_imc(args.scale, mesh, device, **crash)
        runs.append(dict(model="imc", history=res["history"],
                         sweep_s=res["sweep_s"], setup_s=None,
                         launches={n: ch.LAUNCHES[n] for n in KERNELS},
                         routed=dict(ch.ROUTED)))
        tables = {"result": dict(W=res["W"], H=res["H"], obj=res["obj"],
                                 history=res["history"])}
    else:
        t0 = time.perf_counter()
        R = ratings(args.scale)
        data_s = time.perf_counter() - t0
        modes = args.exchange.split(",")
        tables = {}
        for exchange in modes:
            t0 = time.perf_counter()
            prog = build_program(args.model, args.scale, R, mesh, exchange,
                                 args.alpha)
            _sync(device)
            setup = time.perf_counter() - t0
            ch.reset_counts()
            res = run_als(prog, args.scale, R.nnz, device,
                          scanned=args.scanned, **crash)
            runs.append(dict(
                model=args.model, exchange=exchange, alpha=args.alpha,
                history=res["history"], sweep_s=res["sweep_s"],
                setup_s=setup, data_s=data_s,
                launches={n: ch.LAUNCHES[n] for n in KERNELS},
                routed=dict(ch.ROUTED),
                bytes_per_sweep=prog.collective_bytes_per_sweep()))
            del prog
            if res["crashed"]:
                break
            name = "result" if len(modes) == 1 else f"result_{exchange}"
            tables[name] = dict(U=res["U"], V=res["V"], sse=res["sse"],
                                history=res["history"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    line = dict(process=rank, processes=P, scale=args.scale,
                device=(torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
                shards=mesh.size, runs=runs, peak_bytes=peak,
                crashed=res["crashed"])
    if rank == 0 and not res["crashed"]:
        os.makedirs(args.outdir, exist_ok=True)
        for name, table in tables.items():
            np.savez(os.path.join(args.outdir, name + ".npz"), **table)
    print(json.dumps(line), flush=True)
    if res["crashed"]:
        # fault injection: a hard exit after the checkpoint, no clean-up
        os._exit(CRASH_EXIT)
    barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
