"""The sharded fit's one-loop program against its per-sweep host loop.

    python -m recommendation_models_tpu_torch.probes.sharded_scan \
        [--platform cpu]
    SCALE=ml25m RANK=64 SWEEPS=10 FASTPATHS=1 python -m \
        recommendation_models_tpu_torch.probes.sharded_scan

The port's counterpart of the JAX package's
``scripts/measure_sharded_scan.py``. On the synthetic ratings of ``SCALE``
(``SCALES``, ``synthetic_ratings(..., rank=16, seed=0)``) it builds a
``ShardedALSProgram`` of ``SHARDS`` shards on ``get_mesh(SHARDS)``, each
layout padded to ``block_batch(RANK)`` rows a shard, and times for the
same sweep count:

(a) stepwise: ``prog.sweep`` + ``prog.train_sse`` + a readback per sweep
    (one host round trip and one more user-half exchange a sweep);
(b) scanned: ``prog.make_fit(SWEEPS)``, one readback for the whole fit.

Both programs are warmed first, and every timed run starts from
``init_factors(0, 0.01)`` with the placement fenced by a readback; each
timed region ends in a dependent readback (``.item()`` / ``.cpu()``). The
script times one window a side; ``WINDOWS`` > 1 times that many,
alternating the two, and reports each window and the median (a host
clock spreads by several ms a sweep from one window to the next). The
histories must agree within rtol 5e-4 (2e-3 with ``FASTPATHS``: the dense
block's and hot columns' partial SSEs sum in another order in the two
programs), the script's own check.

The probe also counts, in one run of each loop under
``torch.profiler`` (``probes.profile_half.profiled``), the host's kernel
launches (the runtime's ``*LaunchKernel*`` calls), the kernels the device
recorded and the host's synchronisations (``*Synchronize*`` calls), each
per sweep: what the two loops ask of the host (all 0 on the CPU).

On the card (b) is not one device program: ``make_fit`` is the host loop
``solver.als_sweep.make_scanned_program_fit`` with one synchronisation at
its end, where the JAX package compiles a ``lax.scan``. So the difference
measured here is, per sweep, one host readback plus the stepwise loop's
standalone SSE pass over the user half (``train_sse``, one more user-half
exchange) against the scanned fit's SSE taken in the item half.

Layouts (the script's): by default no dense block, no hot columns and the
rank's bucket growth (the layout every exchange can run); ``FASTPATHS=1``
takes the allgather production layout, ``hot_cols_auto(RANK)``,
``dense_min_degree_for_rank(RANK)`` and ``bucket_growth_for_rank(RANK)``,
with a note on stderr where ``hot_cols_auto`` turns the hot columns off.

Env (the script's): SCALE (ml1m), RANK (64), SWEEPS (10), SHARDS (1),
FASTPATHS (0); and WINDOWS (1). A host with one card runs only ``SHARDS=1``: ``get_mesh``
raises for more shards than cards. With ``--platform cpu`` the shards are
entries of the host and nothing is timed (SCALE defaults to ``tiny``).
Prints the script's three lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import SCALES


def sharded_layouts(scale: str, rank: int, n_shards: int, fastpaths: bool,
                    coo=None):
    """(nnz, user layout, item layout) of the script: both orientations of
    the synthetic ratings (``coo`` = (u, i, r) reuses them) under its
    ``DataConfig``, sharded ``n_shards`` ways with ``block_batch(rank)``
    rows a shard's multiple."""
    from recommendation_models_tpu_torch.config import (
        DataConfig, bucket_growth_for_rank, dense_min_degree_for_rank)
    from recommendation_models_tpu_torch.data.layout import (
        layout_from_coo, shard_layout)
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops.cholesky import (
        block_batch, hot_cols_auto)
    n_users, n_items, n_obs = SCALES[scale]
    if coo is None:
        coo = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    users, items, ratings = coo
    if fastpaths:
        hot = hot_cols_auto(rank)
        if hot == 0:
            print(f"# FASTPATHS note: hot_cols_auto({rank}) == 0 - the "
                  "production config at this rank runs WITHOUT the "
                  "hot-column path", file=sys.stderr)
        dcfg = DataConfig(bucket_growth=bucket_growth_for_rank(rank),
                          hot_cols=hot,
                          dense_min_degree=dense_min_degree_for_rank(rank))
    else:
        dcfg = DataConfig(dense_whales=False, hot_cols=0,
                          bucket_growth=bucket_growth_for_rank(rank))
    mult = block_batch(rank)
    ul = shard_layout(layout_from_coo(users, items, ratings, n_users,
                                      n_items, config=dcfg), n_shards,
                      row_multiple=mult)
    il = shard_layout(layout_from_coo(users, items, ratings, n_users,
                                      n_items, config=dcfg, transpose=True),
                      n_shards, row_multiple=mult)
    return int(ratings.shape[0]), ul, il


def _fence(U, V) -> None:
    """A dependent readback of both tables' first blocks."""
    U[0][0, 0].item()
    V[0][0, 0].item()


def host_counts(prof, n_sweeps: int) -> dict:
    """Per sweep, from a profile with host and device activity: the
    runtime's kernel launches, the kernels the device recorded and the
    host's synchronisations."""
    launches = kernels = syncs = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
        elif "LaunchKernel" in ev.name:
            launches += 1
        elif "Synchronize" in ev.name:
            syncs += 1
    return {"launches": launches / n_sweeps, "kernels": kernels / n_sweeps,
            "syncs": syncs / n_sweeps}


def measure(prog, n_sweeps: int, device, windows: int = 1,
            counts: bool = True) -> dict:
    """The script's two runs of ``prog`` for ``n_sweeps`` sweeps, each
    warmed first, then ``windows`` timed runs of each, alternating, all
    started from ``init_factors(0, 0.01)``: the stepwise and scanned SSE
    histories, with ``counts`` each loop's ``host_counts`` (zero on the
    host, which launches nothing; profiling takes seconds a loop at ML-1M)
    and on the card each window's host seconds (else None)."""
    from recommendation_models_tpu_torch.probes.profile_half import profiled
    timed = device.type == "cuda"
    fit = prog.make_fit(n_sweeps)

    def stepwise(U, V):
        hist = []
        for _ in range(n_sweeps):
            U, V = prog.sweep(U, V)
            hist.append(prog.train_sse(U, V).item())  # per-sweep readback
        return np.asarray(hist, np.float64)

    def scanned(U, V):
        _, _, sse, _ = fit(U, V)
        return sse.cpu().numpy().astype(np.float64)  # one readback

    def timed_run(loop):
        U, V = prog.init_factors(seed=0, init_scale=0.01)
        _fence(U, V)
        t0 = time.perf_counter()
        hist = loop(U, V)
        return hist, time.perf_counter() - t0

    timed_run(stepwise)                           # warm both programs
    timed_run(scanned)
    secs = {"stepwise": [], "scanned": []}
    hist = {}
    for _ in range(windows):
        for name, loop in (("stepwise", stepwise), ("scanned", scanned)):
            hist[name], s = timed_run(loop)
            secs[name].append(s)
    by_loop = None
    if counts:
        by_loop = {}
        for name, loop in (("stepwise", stepwise), ("scanned", scanned)):
            U, V = prog.init_factors(seed=0, init_scale=0.01)
            _fence(U, V)
            prof, _ = profiled(lambda: loop(U, V), device, host_ops=True)
            by_loop[name] = host_counts(prof, n_sweeps)
    return dict(hist, windows_s=secs if timed else None, counts=by_loop)


def run(scale: str = "ml1m", rank: int = 64, n_sweeps: int = 10,
        n_shards: int = 1, fastpaths: bool = False, platform=None,
        coo=None, windows: int = 1, counts: bool = True) -> dict:
    """The script on the port: prints its three lines and returns the JSON
    record (histories; seconds, each window's and the median, ms a sweep
    and the gap a sweep; the host counts); raises ``AssertionError`` where
    the two histories disagree. ``counts=False`` skips the profiled runs
    (``host_counts_per_sweep`` None)."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.gram import full_f32
    from recommendation_models_tpu_torch.parallel.mesh import get_mesh
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        ShardedALSProgram)
    device = resolve_device(platform)
    on_card = device.type == "cuda"
    if on_card:
        full_f32()
    nnz, ul, il = sharded_layouts(scale, rank, n_shards, fastpaths, coo)
    mesh = get_mesh(n_shards, platform=None if on_card else "cpu")
    prog = ShardedALSProgram(ul, il, mesh, SolveConfig(rank=rank, reg=0.1))
    res = measure(prog, n_sweeps, device, windows, counts)
    rtol = 2e-3 if fastpaths else 5e-4
    np.testing.assert_allclose(res["stepwise"], res["scanned"], rtol=rtol)
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"{scale} rank={rank} sweeps={n_sweeps} shards={n_shards} "
          f"device={name}")
    rec = {"scale": scale, "rank": rank, "sweeps": n_sweeps,
           "shards": n_shards, "fastpaths": fastpaths, "nnz": nnz,
           "device": name, "platform": device.type, "rtol": rtol,
           "max_rel_diff": float(np.max(np.abs(res["stepwise"]
                                               - res["scanned"])
                                        / np.abs(res["scanned"]))),
           "history_stepwise": res["stepwise"].tolist(),
           "history_scanned": res["scanned"].tolist(),
           "windows": windows, "windows_s": res["windows_s"],
           "stepwise_s": None, "scanned_s": None,
           "stepwise_ms_per_sweep": None, "scanned_ms_per_sweep": None,
           "gap_ms_per_sweep": None, "gap_ms_per_sweep_by_window": None,
           "host_counts_per_sweep": res["counts"]}
    if not on_card:
        print("stepwise: (cpu, untimed)")
        print("scanned:  (cpu, untimed)")
        return rec
    win = res["windows_s"]
    step_s = float(np.median(win["stepwise"]))
    scan_s = float(np.median(win["scanned"]))
    a = step_s / n_sweeps * 1e3
    b = scan_s / n_sweeps * 1e3
    rec.update(stepwise_s=step_s, scanned_s=scan_s,
               stepwise_ms_per_sweep=a, scanned_ms_per_sweep=b,
               gap_ms_per_sweep=a - b,
               gap_ms_per_sweep_by_window=[
                   (x - y) / n_sweeps * 1e3
                   for x, y in zip(win["stepwise"], win["scanned"])])
    print(f"stepwise: {step_s:.4f} s total, {a:.1f} ms/sweep")
    print(f"scanned:  {scan_s:.4f} s total, {b:.1f} ms/sweep  "
          f"({a - b:+.1f} ms/sweep)")
    return rec


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    on_cpu = args.platform == "cpu"
    rec = run(scale=env.get("SCALE", "tiny" if on_cpu else "ml1m"),
              rank=int(env.get("RANK", "64")),
              n_sweeps=int(env.get("SWEEPS", "10")),
              n_shards=int(env.get("SHARDS", "1")),
              fastpaths=env.get("FASTPATHS", "0") == "1",
              platform=args.platform,
              windows=int(env.get("WINDOWS", "1")))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
