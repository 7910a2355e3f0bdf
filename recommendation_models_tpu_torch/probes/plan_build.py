"""Host seconds of the sharded fit's one-time plan: ``shard_layout`` of
both orientations, then ``build_exchange_plan`` tail-only and with a
1,024-column head, at each shard count, and the bytes each plan moves.

    python -m recommendation_models_tpu_torch.probes.plan_build \
        [--scale ml25m] [--shards 8,32,128,256] [--rank 64]

The counterpart of the JAX package's ``scripts/bench_plan_build.py``: the
synthetic ratings of ``--scale`` with the plain layout (no dense block, no
hot columns, as the exchange modes build it), one JSON line per shard
count: ``shard_layout_s``, ``plan_tail_only_s``, ``plan_hybrid_h1024_s``
(both orientations) and the MiB per shard per sweep of each plan at
``--rank``. Host NumPy work only; the line names the host's CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from recommendation_models_tpu_torch.probes import SCALES
from recommendation_models_tpu_torch.probes.parser import cpu_model


def main(argv=None) -> int:
    from recommendation_models_tpu_torch.config import DataConfig
    from recommendation_models_tpu_torch.data.layout import (
        layout_from_coo, shard_layout)
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.parallel.exchange import (
        build_exchange_plan)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="ml25m", choices=sorted(SCALES))
    ap.add_argument("--shards", default="8,32,128,256")
    ap.add_argument("--rank", type=int, default=64)
    args = ap.parse_args(argv)
    n_users, n_items, n_obs = SCALES[args.scale]
    dcfg = DataConfig(dense_whales=False, hot_cols=0)
    t0 = time.perf_counter()
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    ul = layout_from_coo(u, i, r, n_users, n_items, config=dcfg)
    il = layout_from_coo(u, i, r, n_users, n_items, config=dcfg,
                         transpose=True)
    print(f"# {args.scale}: {r.shape[0]} obs, layouts in "
          f"{time.perf_counter() - t0:.1f}s on {cpu_model()}",
          file=sys.stderr, flush=True)
    for S in (int(s) for s in args.shards.split(",")):
        t0 = time.perf_counter()
        uls = shard_layout(ul, S)
        ils = shard_layout(il, S)
        row = {"scale": args.scale, "S": S, "device": "host",
               "shard_layout_s": time.perf_counter() - t0}
        for name, head in (("tail_only", 0), ("hybrid_h1024", 1024)):
            t0 = time.perf_counter()
            up = build_exchange_plan(uls, col_shard_size=ils.rows_per_shard,
                                     head=head)
            ip = build_exchange_plan(ils, col_shard_size=uls.rows_per_shard,
                                     head=head)
            row[f"plan_{name}_s"] = time.perf_counter() - t0
            row[f"bytes_{name}_mib"] = (
                up.recv_bytes_per_half_sweep(args.rank)
                + ip.recv_bytes_per_half_sweep(args.rank)) / 2**20
        row["cpu"] = cpu_model()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
