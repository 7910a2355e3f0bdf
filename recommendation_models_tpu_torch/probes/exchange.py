"""The sharded exchange modes compared: the bytes each moves, and the
sweep time of each on one card.

    python -m recommendation_models_tpu_torch.probes.exchange --bytes-only \
        [--scale ml1m] [--rank 32] [--shards 8,32,128] [--heads 1024,4096]
    python -m recommendation_models_tpu_torch.probes.exchange \
        [--scale ml1m] [--rank 32] [--shards 8] [--sweeps 4] [--platform cpu]

The counterpart of the JAX package's ``scripts/compare_exchange.py``, on
the synthetic ratings of ``--scale`` with the plain layout (no dense block,
no hot columns, the layout every mode can run). ``--bytes-only`` builds no
program: one JSON line per shard count with the per-shard MiB of a
half-sweep (the user half, which receives the item table) of 'allgather',
'all_to_all' and 'hybrid' at each head, and each plan's padding
efficiency. These counts are exact for any mesh: they are the numbers to
decide by.

Without it, each mode runs on ``Mesh((cuda:0,) * S)`` (one card; S
entries of the host with ``--platform cpu``, untimed): one JSON line a mode
with the set-up seconds (layout, plan, placement), the ms of a sweep (host
clock over ``--sweeps`` sweeps after a warm-up sweep, to a
synchronisation) and the per-shard MiB a sweep. One card carries no
interconnect traffic, so these times are indicative only.

``program_for`` gives the sharded program ``ALS(n_shards=S, ...).fit``
would build, on any mesh; ``chip_smoke.py`` runs S shards on one card with
it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import SCALES
from recommendation_models_tpu_torch.probes.gather_latency import card


def program_for(estimator, R, mesh):
    """The program that ``estimator.fit(R)`` builds, on ``mesh`` instead of
    its own mesh: the ``ShardedALSProgram`` of its ``exchange`` (layout
    rules and head included) on a 1-D mesh, or with
    ``topology='obs_parallel'`` the ``HybridALSProgram`` on a 2-D one."""
    from recommendation_models_tpu_torch.data.layout import csr_arrays
    indptr, indices, data, n_users, n_items = csr_arrays(R)
    build = (estimator._hybrid_program_on
             if estimator.topology == "obs_parallel"
             else estimator._sharded_program_on)
    return build(mesh, indptr, indices, data, n_users, n_items,
                 estimator._data_config(), estimator._solve_config())


def fit_history(prog, U0, V0, n_sweeps: int, nnz: int):
    """``prog.make_fit`` from the warm start (U0, V0): (U, V blocks, the
    train-RMSE history)."""
    U, V = prog.place_factors(U0, V0)
    U, V, sse, n_done = prog.make_fit(n_sweeps, nnz=nnz)(U, V)
    sse = np.maximum(sse.cpu().numpy()[:n_done], 0.0)
    return U, V, [float(h) for h in np.sqrt(sse / nnz)]


def _plain_layouts(scale):
    from recommendation_models_tpu_torch.config import DataConfig
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_users, n_items, n_obs = SCALES[scale]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    plain = DataConfig(dense_whales=False, hot_cols=0)
    return (r.shape[0],
            layout_from_coo(u, i, r, n_users, n_items, config=plain),
            layout_from_coo(u, i, r, n_users, n_items, config=plain,
                            transpose=True))


def bytes_rows(scale: str, rank: int, shard_counts, heads):
    """Per shard count: the per-shard MiB of the user half-sweep of each
    mode, and each plan's padding efficiency."""
    from recommendation_models_tpu_torch.data.layout import shard_layout
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.parallel.exchange import (
        build_exchange_plan)
    nnz, ul0, il0 = _plain_layouts(scale)
    rows = []
    for S in shard_counts:
        ul = shard_layout(ul0, S, row_multiple=block_batch(rank))
        il = shard_layout(il0, S, row_multiple=block_batch(rank))
        row = {"scale": scale, "rank": rank, "nnz": nnz, "S": S,
               "allgather_mib": (S - 1) * il.rows_per_shard * rank * 4
               / 2**20}
        for head in [0] + list(heads):
            p = build_exchange_plan(ul, il.rows_per_shard, head=head)
            key = "all_to_all" if head == 0 else f"hybrid_h{head}"
            row[f"{key}_mib"] = p.recv_bytes_per_half_sweep(rank) / 2**20
            row[f"{key}_padding_efficiency"] = p.padding_efficiency()
        rows.append(row)
    return rows


def timed_rows(scale: str, rank: int, S: int, sweeps: int, heads, device):
    """Each mode's set-up seconds, ms a sweep and per-shard MiB a sweep on
    ``Mesh((device,) * S)`` (untimed on the CPU)."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.data.layout import shard_layout
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.parallel.mesh import Mesh
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        ShardedALSProgram)
    nnz, ul0, il0 = _plain_layouts(scale)
    mesh = Mesh([device] * S)
    cfg = SolveConfig(rank=rank, reg=0.1)
    rows = []
    for mode, head in ([("allgather", 0), ("all_to_all", 0)]
                       + [("hybrid", h) for h in heads]):
        t0 = time.perf_counter()
        prog = ShardedALSProgram(
            shard_layout(ul0, S, row_multiple=block_batch(rank)),
            shard_layout(il0, S, row_multiple=block_batch(rank)),
            mesh, cfg, exchange=mode, head=head)
        U, V = prog.init_factors(0, 0.01)
        build_s = time.perf_counter() - t0
        U, V = prog.sweep(U, V)                   # warm-up
        ms = None
        if device.type == "cuda":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(sweeps):
                U, V = prog.sweep(U, V)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / sweeps * 1e3
        b = prog.collective_bytes_per_sweep()
        row = {"scale": scale, "rank": rank, "nnz": nnz, "S": S,
               "mode": mode, "head": head, "setup_s": build_s,
               "ms_per_sweep": ms,
               "mib_per_shard_per_sweep": b["per_sweep_total"] / 2**20,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "indicative": True}
        if prog._uplan_host is not None:
            row["padding_efficiency"] = [
                prog._uplan_host.padding_efficiency(),
                prog._iplan_host.padding_efficiency()]
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.gram import full_f32
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="ml1m", choices=sorted(SCALES))
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--shards", default=None,
                    help="comma list (default 8,32,128 with --bytes-only, "
                         "else 8)")
    ap.add_argument("--heads", default="1024,4096")
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--bytes-only", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="None = the CUDA card, 'cpu' = the host")
    args = ap.parse_args(argv)
    heads = [int(h) for h in args.heads.split(",") if h]
    if args.bytes_only:
        shards = [int(s) for s in (args.shards or "8,32,128").split(",")]
        for row in bytes_rows(args.scale, args.rank, shards, heads):
            print(json.dumps(row), flush=True)
        return 0
    device = resolve_device(args.platform)
    if device.type == "cuda":
        full_f32()
        print(card(), file=sys.stderr, flush=True)
    for S in (int(s) for s in (args.shards or "8").split(",")):
        for row in timed_rows(args.scale, args.rank, S, args.sweeps, heads,
                              device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
