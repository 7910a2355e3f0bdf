"""A sharded, hot-column fit on the solve kernels, held against the plain
single-device fit.

    python -m recommendation_models_tpu_torch.probes.sharded_hot \
        [--platform cpu]

The port's counterpart of the JAX package's
``scripts/smoke_sharded_hot_tpu.py``. On 4,000 x 3,000 synthetic ratings
(200,000 drawn, ``synthetic_ratings(..., rank=8, seed=0)``) with
``DataConfig(dense_whales=False, hot_cols=16)`` (the user layout must carry
a hot block, else the probe is vacuous), it builds a ``ShardedALSProgram``
directly on a 1-device mesh with ``SolveConfig(rank=16, reg=0.1,
solver="pallas")``: ``ALS(n_shards=1)`` would take the single-device path.
``hot_cols_cap(16)`` is 1,024, and every bucket of both layouts carries
hot columns here, so every solve takes B2 with C = 16 and B1 launches no
time. Then:

- one ``sweep_with_sse`` from ``init_factors(seed=1, init_scale=0.1)``:
  the user table and the SSE must be finite;
- ``make_fit(2)`` from ``place_factors(U0, V0)`` (``default_rng(1)``,
  0.1 N(0, 1)): its train-RMSE history within rtol 1e-3 of
  ``ALS(rank=16, reg=0.1, n_sweeps=2, solver="xla", hot_cols=0,
  dense_min_degree=10_000).fit(R, U0=U0, V0=V0).history_``, the torch
  solve with no hot block and no dense block.

The script guarded a JAX ``shard_map`` fault (the fused hot solve's
unvarying operands lacked their varying-axes cast); torch has no such
typing. In its place the probe counts the solve kernels' launches over
the program's two runs (``ops.cholesky.LAUNCHES``, set to 0 just before)
and the calls routed to the torch anchor (``ROUTED``): on the card B2
must have launched and nothing may be routed. With ``--platform cpu`` the
wrappers take their plain versions and launch nothing.

Prints the script's line, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import scipy.sparse as sp

N_USERS, N_ITEMS, N_OBS = 4_000, 3_000, 200_000
RANK = 16
HOT_COLS = 16
SWEEPS = 2
RTOL = 1e-3
COUNTED = ("cholesky_solve_batched", "cholesky_solve_hot")


def problem():
    """(users, items, ratings) of the script."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    return synthetic_ratings(N_USERS, N_ITEMS, N_OBS, rank=8, seed=0)


def warm_start():
    """The script's (U0, V0): 0.1 N(0, 1) from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    U0 = 0.1 * rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V0 = 0.1 * rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    return U0, V0


def run(platform=None, coo=None) -> dict:
    """The script on the port. Returns the record: the smoke sweep's SSE,
    the program's and the anchor's histories, the solve launches and
    routed calls of the program's runs; raises ``AssertionError`` where a
    check fails."""
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.config import (
        DataConfig, SolveConfig)
    from recommendation_models_tpu_torch.data.layout import (
        layout_from_coo, shard_layout)
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.parallel.mesh import (
        get_mesh, to_host)
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        ShardedALSProgram)
    device = resolve_device(platform)
    users, items, ratings = problem() if coo is None else coo
    dcfg = DataConfig(dense_whales=False, hot_cols=HOT_COLS)
    ul = layout_from_coo(users, items, ratings, N_USERS, N_ITEMS,
                         config=dcfg)
    if ul.hot_ids is None:
        raise AssertionError("hot block not built - smoke is vacuous")
    il = layout_from_coo(users, items, ratings, N_USERS, N_ITEMS,
                         config=dcfg, transpose=True)
    mesh = get_mesh(1, platform=device.type)
    cfg = SolveConfig(rank=RANK, reg=0.1, solver="pallas")
    prog = ShardedALSProgram(shard_layout(ul, 1), shard_layout(il, 1),
                             mesh, cfg)
    U0, V0 = warm_start()
    ch.reset_counts()
    U, V = prog.init_factors(seed=1, init_scale=0.1)
    U, V, sse = prog.sweep_with_sse(U, V)
    sse = sse.item()
    Uh = to_host(U)[:N_USERS]
    Up, Vp = prog.place_factors(U0, V0)
    _, _, hist, _ = prog.make_fit(SWEEPS)(Up, Vp)
    hist = hist.cpu().numpy()
    launches = {n: ch.LAUNCHES[n] for n in COUNTED}
    routed = {n: v for n, v in ch.ROUTED.items() if v}
    if not (np.isfinite(Uh).all() and np.isfinite(sse)):
        raise AssertionError(f"the sharded hot sweep is not finite: sse "
                             f"{sse}")
    R = sp.csr_matrix((ratings, (users, items)), shape=(N_USERS, N_ITEMS))
    ref = ALS(rank=RANK, reg=0.1, n_sweeps=SWEEPS, solver="xla",
              hot_cols=0, dense_min_degree=10_000,
              platform=device.type).fit(R, U0=U0, V0=V0)
    got = np.sqrt(np.maximum(hist, 0) / ratings.shape[0])
    np.testing.assert_allclose(got, ref.history_, rtol=RTOL)
    if device.type == "cuda":
        if not launches["cholesky_solve_hot"] or routed:
            raise AssertionError(f"the sharded hot fit did not take B2 on "
                                 f"the card: launches {launches}, routed "
                                 f"{routed}")
    print(f"sharded+hot+pallas smoke OK: sse {sse:.3f}, history parity "
          f"vs the torch anchor within {RTOL:g}")
    return {"platform": device.type, "rank": RANK,
            "hot_cols": int(ul.hot_ids.shape[0]), "sse": sse,
            "history": got.tolist(),
            "anchor_history": [float(h) for h in ref.history_],
            "launches": launches, "routed": routed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.platform)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
