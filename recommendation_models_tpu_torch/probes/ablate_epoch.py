"""Where the ALS epoch's time goes on the card: the port of the reference's
``scripts/ablate_epoch.py``.

    python -m recommendation_models_tpu_torch.probes.ablate_epoch \
        [--platform cpu]

Lines, each the mean device time of ``ABL_ITERS`` calls between CUDA
events after one warm-up call (the events are on the stream, so a
half-sweep's time includes the device's idle gaps while the host enqueues
its launches):

- the half-sweeps: user and item without SSE, user with the riding SSE,
  and the item half without its dense block;
- gram only (gather and weighted products, no solve or scatter): user,
  item, and the item side's narrow (P <= chunk) and wide buckets;
- gather only, the sum of every gathered row: through the port's
  gather-and-sum kernel P1 (``ops.gather.gather_rows_sum``) on each row
  block's flattened ids, and the same sums through ``index_select`` +
  ``sum``; the two are held against each other per column within
  ``2e-6 · Σ|rows| + 1e-6`` (the run fails above);
- the dense-block grams;
- solve only: the batched kernel solve and the torch anchor on the same
  systems (the user side's system count, at most 65,536);
- the item side's per-bucket solves and per-bucket scatters.

The row blocks are the sweep's (``solver/als_sweep.py``): the port's
``resolve_gather_budget`` over the port's compute dtype (f32,
``ops/solve.py::resolve_compute_dtype``). The reference hard-codes bf16 for
its gram-only and gather-only blocks and gathers (its lines 154, 189 and
199), so its blocks hold twice the rows. The gather-only sums cover every
padded slot of the device buckets; the reference also pads its last row
block with id 0 and sums those rows.

Env (the reference's): ABL_SCALE (ml25m), ABL_RANK (64), ABL_ITERS (5),
ABL_HOT and ABL_DMD (the rank-aware auto hot width and dense threshold),
ABL_CACHE_DIR (``build/layout_cache`` at the checkout's root),
ABL_GATHER_MB (the auto budget), ABL_ONLY=gram (stop after the gram
lines). The layouts are built as the reference builds them (its
``DataConfig(hot_cols, dense_min_degree)``) and cached by
``data/layout_cache.py`` as ``<scale>.hot<hot>.dmd<dmd>.{user,item}.npz``,
the reference's naming and file format. ``run(user_layout, item_layout,
cfg, n_iters)`` runs the lines on layouts the caller has built.

Runs on the CUDA card, and raises when there is none, unless
``--platform cpu`` is given; on the CPU every line runs once, untimed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from recommendation_models_tpu_torch.config import (
    DataConfig, SolveConfig, dense_min_degree_for_rank)
from recommendation_models_tpu_torch.data.layout import layout_from_coo
from recommendation_models_tpu_torch.data.layout_cache import cached_layout
from recommendation_models_tpu_torch.data.synthetic import synthetic_ratings
from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops.cholesky import (
    block_batch, hot_cols_auto)
from recommendation_models_tpu_torch.ops.gather import (
    gather_rows_sum, gather_rows_sum_plain)
from recommendation_models_tpu_torch.ops.gram import (
    full_f32, gram_rhs, objective_weights)
from recommendation_models_tpu_torch.ops.solve import (
    resolve_compute_dtype, solve_spd_batched, torch_dtype)
from recommendation_models_tpu_torch.probes import (
    LAYOUT_CACHE_DIR, SCALES, timed)
from recommendation_models_tpu_torch.solver.als_sweep import (
    dense_gram_rhs, device_buckets, half_sweep, resolve_gather_budget,
    widen_chunk)

MAX_SOLVE_SYSTEMS = 64 * 1024


def row_blocks(bs, cfg: SolveConfig, k: int, p_lo: int = 0,
               p_hi: int = 1 << 30):
    """(bucket, start, end) of every row block the sweep gathers, for the
    gathered buckets of degree p_lo <= P < p_hi: the sweep's split under
    the resolved gather budget at the compute dtype's width."""
    itemsize = torch_dtype(resolve_compute_dtype(cfg.compute_dtype)).itemsize
    budget = resolve_gather_budget(cfg.gather_budget_mb, k, bs)
    block = block_batch(k)
    for b in bs:
        if "indices" not in b:
            continue
        bsz, p = b["indices"].shape
        if not p_lo <= p < p_hi:
            continue
        bb = max(block, (budget * (1 << 20)) // (p * k * itemsize)
                 // block * block)
        for s in range(0, bsz, bb):
            yield b, s, min(s + bb, bsz)


def warm_factors(n_users: int, n_items: int, rank: int, device):
    """U, V = 0.01 N(0, 1) from ``default_rng(0)``, the reference's."""
    rng = np.random.default_rng(0)
    U = 0.01 * rng.standard_normal((n_users, rank))
    V = 0.01 * rng.standard_normal((n_items, rank))
    return (torch.from_numpy(a.astype(np.float32)).to(device) for a in (U, V))


def run(user_layout, item_layout, cfg: SolveConfig, n_iters: int,
        device=None, only=None) -> dict:
    """Every line on the given layouts. Returns ``lines`` (label -> ms, None
    on the CPU), ``gather`` (side -> the P1 gather-only sum, (1, k)) and
    ``ok`` (P1 agrees with ``index_select`` + ``sum``)."""
    dev = resolve_device(device)
    full_f32()
    rank = cfg.rank
    dtype = torch_dtype(resolve_compute_dtype(cfg.compute_dtype))
    n_users, n_items = user_layout.n_rows, item_layout.n_rows
    ub = device_buckets(user_layout, block_batch(rank), dev)
    ib = device_buckets(item_layout, block_batch(rank), dev)
    lines = {}

    def line(label, fn):
        lines[label] = timed(fn, n_iters, dev, label)

    for tag, bs in (("user", ub), ("item", ib)):
        gathered = [b for b in bs if "indices" in b]
        dense = [b for b in bs if "dense_vals" in b]
        tot = sum(int(b["indices"].numel()) for b in gathered)
        print(f"# {tag}: {len(gathered)} buckets, padded slots {tot:,}"
              + (f", dense block {tuple(dense[0]['dense_vals'].shape)}"
                 if dense else ""), flush=True)
        print("#   " + " ".join(str(tuple(b["indices"].shape))
                                for b in gathered), flush=True)
    U, V = warm_factors(n_users, n_items, rank, dev)

    # --- full halves ------------------------------------------------------
    if only != "gram":
        line("user half-sweep (no sse)",
             lambda: half_sweep(V, ub, n_users, cfg))
        line("item half-sweep (no sse)",
             lambda: half_sweep(U, ib, n_items, cfg))
        line("user half-sweep (sse)",
             lambda: half_sweep(V, ub, n_users, cfg, with_sse=True))
        ib_no_dense = tuple(x for x in ib if "dense_vals" not in x)
        if len(ib_no_dense) != len(ib):
            line("item half-sweep (no dense block)",
                 lambda: half_sweep(U, ib_no_dense, n_items, cfg))

    # --- gram only --------------------------------------------------------
    def gram_only(v, bs, p_lo=0, p_hi=1 << 30):
        # consume the full gram, as the reference does, so that every entry
        # is computed
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for b, s, e in row_blocks(bs, cfg, rank, p_lo, p_hi):
            bsz, p = b["indices"].shape
            wg, wr = objective_weights(b["values"][s:e], b["mask"][s:e],
                                       None)
            G, r = gram_rhs(v, b["indices"][s:e], wg, wr,
                            chunk=widen_chunk(cfg.chunk, bsz, p),
                            compute_dtype=dtype)
            acc = acc + G.sum() + r.sum()
        return acc

    line("user gram only (gather+products)", lambda: gram_only(V, ub))
    line("item gram only (gather+products)", lambda: gram_only(U, ib))
    line("item gram, narrow buckets (p<=chunk)",
         lambda: gram_only(U, ib, 0, cfg.chunk + 1))
    line("item gram, wide buckets (p>chunk)",
         lambda: gram_only(U, ib, cfg.chunk + 1))
    if only == "gram":
        return dict(lines=lines, gather={}, ok=True)

    # --- gather only: the sum of the gathered rows ------------------------
    def gather_only(v, bs, fn):
        acc = torch.zeros((1, rank), dtype=torch.float32, device=dev)
        vc = v.to(dtype).float()
        for b, s, e in row_blocks(bs, cfg, rank):
            acc = acc + fn(vc, b["indices"][s:e].reshape(-1))
        return acc

    sums, ok = {}, True
    for tag, tbl, bs in (("user", V, ub), ("item", U, ib)):
        line(f"{tag} gather only (P1 gather_rows_sum)",
             lambda: gather_only(tbl, bs, gather_rows_sum))
        line(f"{tag} gather only (index_select + sum)",
             lambda: gather_only(tbl, bs, gather_rows_sum_plain))
        got = gather_only(tbl, bs, gather_rows_sum)
        ref = gather_only(tbl, bs, gather_rows_sum_plain)
        tol = 2e-6 * gather_only(tbl.abs(), bs, gather_rows_sum_plain) + 1e-6
        err = (got - ref).abs()
        side_ok = bool((err <= tol).all())
        print(f"# {tag} gather only: P1 against index_select + sum "
              f"max_abs_err={float(err.max()):.2e} "
              f"{'ok' if side_ok else 'DISAGREES'}", flush=True)
        sums[tag] = got
        ok = ok and side_ok

    # --- dense-block grams (no gathers) -----------------------------------
    for tag, bs, tbl in (("user", ub, V), ("item", ib, U)):
        d = [b for b in bs if "dense_vals" in b]
        if d:
            dv = d[0]["dense_vals"]
            line(f"{tag} dense-block gram ({dv.shape[0]} rows)",
                 lambda: dense_gram_rhs(tbl, dv, cfg.alpha, dtype))

    # --- solve only -------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk_systems(n):
        A = torch.randn((n, rank, rank), generator=gen, device=dev)
        G = torch.bmm(A, A.transpose(1, 2))
        G.diagonal(dim1=1, dim2=2).add_(0.1)
        return G, torch.randn((n, rank), generator=gen, device=dev)

    block = block_batch(rank)
    n_sys = sum(int(b["indices"].shape[0]) for b in ub if "indices" in b)
    n_sys = min(-(-n_sys // block) * block, MAX_SOLVE_SYSTEMS)
    Gu, ru = mk_systems(n_sys)
    reg = torch.full((n_sys,), 0.1, dtype=torch.float32, device=dev)
    line(f"solve only kernel ({n_sys} sys)",
         lambda: solve_spd_batched(Gu, ru, "pallas", reg_vec=reg))
    line(f"solve only torch anchor ({n_sys} sys)",
         lambda: solve_spd_batched(Gu, ru, "xla", reg_vec=reg))
    del Gu, ru, reg

    # per-bucket solve structure: one solve per item bucket
    sizes = [int(b["indices"].shape[0]) for b in ib if "indices" in b]
    Gb, rb = mk_systems(max(sizes, default=0))
    regb = torch.full((max(sizes, default=0),), 0.1, dtype=torch.float32, device=dev)

    def per_bucket_solve():
        acc = torch.zeros((rank,), dtype=torch.float32, device=dev)
        for n in sizes:
            acc = acc + solve_spd_batched(Gb[:n], rb[:n], "pallas",
                                          reg_vec=regb[:n])[0]
        return acc

    line(f"item per-bucket solves ({len(sizes)} buckets, {sum(sizes)} sys)",
         per_bucket_solve)
    del Gb, rb, regb

    # scatter structure: one scatter-set per item bucket into a fresh table
    # (the sweep's, whose extra row takes the sentinel ids)
    rids = [b["row_ids"] for b in ib if "indices" in b]
    xs = [torch.ones((int(r.shape[0]), rank), device=dev) for r in rids]

    def per_bucket_scatter():
        u = torch.zeros((n_items + 1, rank), dtype=torch.float32, device=dev)
        for r, x in zip(rids, xs):
            u[r] = x
        return u

    line(f"item per-bucket scatters ({len(rids)})", per_bucket_scatter)
    return dict(lines=lines, gather=sums, ok=ok)


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    scale = env.get("ABL_SCALE", "ml25m")
    rank = int(env.get("ABL_RANK", "64"))
    n_iters = int(env.get("ABL_ITERS", "5"))
    n_users, n_items, n_obs = SCALES[scale]
    device = resolve_device(args.platform)

    hot = int(env.get("ABL_HOT", hot_cols_auto(rank)))
    dmd = int(env.get("ABL_DMD", dense_min_degree_for_rank(rank)))
    dcfg = DataConfig(hot_cols=hot, dense_min_degree=dmd)
    cache = env.get("ABL_CACHE_DIR", str(LAYOUT_CACHE_DIR))
    os.makedirs(cache, exist_ok=True)
    coo = []

    def ratings():
        if not coo:
            coo.extend(synthetic_ratings(n_users, n_items, n_obs, rank=16,
                                         seed=0))
        return coo

    stem = os.path.join(cache, f"{scale}.hot{hot}.dmd{dmd}")
    ul = cached_layout(f"{stem}.user.npz", lambda: layout_from_coo(
        *ratings(), n_users, n_items, config=dcfg))
    il = cached_layout(f"{stem}.item.npz", lambda: layout_from_coo(
        *ratings(), n_users, n_items, config=dcfg, transpose=True))
    gmb = env.get("ABL_GATHER_MB")
    cfg = SolveConfig(rank=rank, reg=0.1, solver="auto",
                      compute_dtype="auto",
                      **({"gather_budget_mb": int(gmb)} if gmb else {}))
    res = run(ul, il, cfg, n_iters, device, only=env.get("ABL_ONLY"))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
