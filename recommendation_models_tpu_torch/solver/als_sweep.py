"""ALS sweeps on the device.

One half-sweep solves every row of one orientation given the opposite
factor table: for each degree bucket, a batched gram accumulation
(ops.gram) and a batched ridge-Cholesky solve (ops.solve, the CUDA kernels
on a card), then a scatter-set of the solutions into the table. The
dense-whale block takes its grams from one dense matrix product instead of
gathers, and the hot columns' terms are added inside the fused solve
kernel. The implicit objective adds the global gramian ``V^T V`` to every
system.

The sweeps run eagerly: a Python loop over sweeps, buckets and row blocks
that only enqueues device work. The training SSE of each sweep stays a
device tensor; a fit with ``tol == 0`` reads the history back once.

Spans (``utils.profiling``): ``als.fit`` (a call of the whole-fit
function), ``als.sweep``, ``als.half_sweep``, ``als.dense`` (the dense
block's grams, solve and scatter) and ``als.sse`` (the separate SSE pass);
marks, written only under a profiler, around each row block's grams
(``als.grams``) and its solve and scatter (``als.solves``); counters of
the gather slots each half-sweep walks (``als.gather_slots``, padded rows
times P) and the real ratings among them (``als.gather_ratings``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.config import (
    SolveConfig, gather_budget_for_rank, sse_separate_for,
)
from recommendation_models_tpu_torch.data.layout import (
    PaddedLayout, bucket_row_multiple,
)
from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops.cholesky import block_batch
from recommendation_models_tpu_torch.ops.gram import (
    check_full_f32, full_f32, gram_rhs, objective_weights,
)
from recommendation_models_tpu_torch.ops.solve import (
    resolve_compute_dtype, solve_spd_batched, solve_spd_batched_hot,
    solve_spd_flat, torch_dtype,
)
from recommendation_models_tpu_torch.utils.profiling import count, mark, span

# A device bucket is a dict: row_ids (B,) int64, indices (B, P) int32,
# values (B, P) f32, mask (B, P) f32, optionally hot_vals (B, C) bf16, and
# from device_buckets n_ratings, the int count of its real (mask 1) slots.
# The dense block is {dense_ids, dense_vals}, the hot ids {hot_ids}.
DeviceBuckets = Tuple[Dict[str, torch.Tensor], ...]


def device_buckets(layout: PaddedLayout, row_multiple: int = 1,
                   device=None) -> DeviceBuckets:
    """Move a host PaddedLayout's buckets to the device.

    ``row_multiple`` rounds each bucket's row count up (host-side): the
    extra rows carry the ``n_rows`` sentinel id and zero mask, solve to 0
    and are dropped by the scatter. Buckets smaller than ``row_multiple``
    round to 8 only (bucket_row_multiple). ``device`` None = the CUDA card.
    """
    dev = resolve_device(device)

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = []
    for b in layout.buckets:
        rid, idx, val, msk = b.row_ids, b.indices, b.values, b.mask
        hv = b.hot_vals
        n, p = idx.shape
        mult = bucket_row_multiple(n, row_multiple)
        np_rows = -(-n // mult) * mult
        if np_rows != n:
            pad = np_rows - n
            rid = np.concatenate(
                [rid, np.full(pad, layout.n_rows, rid.dtype)])
            idx = np.concatenate([idx, np.zeros((pad, p), idx.dtype)])
            val = np.concatenate([val, np.zeros((pad, p), val.dtype)])
            msk = np.concatenate([msk, np.zeros((pad, p), msk.dtype)])
            if hv is not None:
                hv = np.concatenate(
                    [hv, np.zeros((pad, hv.shape[1]), hv.dtype)])
        d = dict(row_ids=put(rid, torch.int64), indices=put(idx),
                 values=put(val), mask=put(msk),
                 n_ratings=int(np.count_nonzero(b.mask)))
        if hv is not None:
            # (B, C) batch-major, bf16 on the device like the reference
            # (the host slab is f16; both are exact for half-star ratings)
            d["hot_vals"] = put(hv).to(torch.bfloat16)
        out.append(d)
    if layout.dense_ids is not None:
        out.append(dict(dense_ids=put(layout.dense_ids, torch.int64),
                        dense_vals=put(layout.dense_vals)))
    if layout.hot_ids is not None:
        out.append(dict(hot_ids=put(layout.hot_ids, torch.int64)))
    return tuple(out)


def widen_chunk(chunk: int, b: int, p: int) -> int:
    """Degree-axis chunk for one bucket: few-row wide (whale) buckets widen
    the chunk so every step gathers ~32k rows."""
    return min(p, max(chunk, (32_768 // max(b, 1)) // 8 * 8))


def resolve_gather_budget(budget_mb: int, k: int, buckets,
                          for_sse: bool = False) -> int:
    """The one resolution point of the auto (0) gather budget: the
    reference's rank- and size-aware policy over this consumer's padded
    bucket volume; the standalone SSE pass floors it at 8 MB."""
    if budget_mb:
        return budget_mb
    total = sum(int(b["indices"].numel()) for b in buckets if "indices" in b)
    budget = gather_budget_for_rank(k, total)
    if for_sse:
        budget = max(budget, 8)
    return budget


def _split_special(buckets):
    """Separate the dense-whale block and the hot-column ids (if any) from
    the gather buckets."""
    dense = [b for b in buckets if "dense_vals" in b]
    hot = [b for b in buckets if "hot_ids" in b]
    gathered = tuple(b for b in buckets
                     if "dense_vals" not in b and "hot_ids" not in b)
    return (gathered, dense[0] if dense else None,
            hot[0]["hot_ids"] if hot else None)


def dense_gram_rhs(V, vals, alpha, compute_dtype, col_chunk: int = 32_768):
    """Normal equations of the dense block: ``G_w = Σ_n wg[w,n] vec(v_n v_nᵀ)``
    as one (W, n) x (n, k²) matrix product per column chunk, with the
    observation mask (value != 0) and weights derived per chunk.

    ``vals`` (W, n) float16, 0 = unobserved. Returns (G (W, k²), rhs (W, k),
    deg (W,), r2 scalar = Σ mask vals²)."""
    check_full_f32(V)
    k = V.shape[-1]
    w, n = vals.shape
    dev = V.device
    Vc = V.to(compute_dtype)
    G = torch.zeros((w, k * k), dtype=torch.float32, device=dev)
    rhs = torch.zeros((w, k), dtype=torch.float32, device=dev)
    deg = torch.zeros((w,), dtype=torch.float32, device=dev)
    r2 = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, n, col_chunk):
        e = min(s + col_chunk, n)
        v_c = vals[:, s:e].float()
        m_c = (v_c != 0).float()
        wg, wr = objective_weights(v_c, m_c, alpha)
        Vs = Vc[s:e]
        # outer products rounded in compute_dtype, as in the reference
        P = (Vs[:, :, None] * Vs[:, None, :]).reshape(e - s, k * k)
        G.addmm_(wg.to(compute_dtype).float(), P.float())
        rhs.addmm_(wr.to(compute_dtype).float(), Vs.float())
        deg += m_c.sum(-1)
        r2 += (m_c * v_c * v_c).sum()
    return G, rhs, deg, r2


def solve_all_buckets(V, buckets, n_rows: int, cfg: SolveConfig, g0,
                      with_sse=False):
    """Solve every bucket's normal equations independently and scatter-set
    the solutions into a fresh (n_rows, k) table.

    Row ids are unique across buckets, so each bucket's gram is the row's
    full system. Zero-degree rows solve to exactly 0. Returns (x, sse or
    None): with ``with_sse`` the explicit-objective residual of the
    post-solve state, from the identity
    ``sse = Σ w r² - x·rhs - reg ||x||²``.
    """
    k = V.shape[-1]
    dev = V.device
    dtype = torch_dtype(resolve_compute_dtype(cfg.compute_dtype))
    block = block_batch(k)
    buckets, dense, hot_ids = _split_special(buckets)
    budget_mb = resolve_gather_budget(cfg.gather_budget_mb, k, buckets)
    hot_vh = None
    if hot_ids is not None:
        # f32 rows holding compute-dtype-rounded values (C, k)
        hot_vh = V.index_select(0, hot_ids).to(dtype).float()
    # one extra row takes the writes of the sentinel id n_rows (the
    # reference's scatter mode='drop'); it is sliced off at the end
    U = torch.zeros((n_rows + 1, k), dtype=torch.float32, device=dev)
    r2 = torch.zeros((), dtype=torch.float32, device=dev)
    xr = torch.zeros((), dtype=torch.float32, device=dev)
    xx = torch.zeros((), dtype=torch.float32, device=dev)
    if dense is not None:
        with span("als.dense"):
            G, rhs, ddeg, dr2 = dense_gram_rhs(V, dense["dense_vals"],
                                               cfg.alpha, dtype)
            if g0 is not None:
                G += g0.reshape(-1).float()
            if cfg.reg_by_degree:
                reg_vec = cfg.reg * torch.clamp_min(ddeg, 1.0)
            else:
                reg_vec = torch.full((G.shape[0],), cfg.reg,
                                     dtype=torch.float32, device=dev)
            x = solve_spd_flat(G, rhs, k, cfg.solver, reg_vec=reg_vec)
            if dtype != torch.float32:
                # bf16 outer products inside dense_gram_rhs are not an
                # exact gram, so a near-degenerate whale gram can dip below
                # the ridge: re-solve NaN rows (and the huge-but-finite rows
                # the pivot clamp can produce) with a trace-proportional
                # jitter
                diag_ix = torch.arange(k, device=dev) * (k + 1)
                tr = torch.clamp_min(G[:, diag_ix].mean(-1), 0.0)
                x_safe = solve_spd_flat(G, rhs, k, cfg.solver,
                                        reg_vec=reg_vec + 0.02 * tr)
                bad = (torch.isnan(x) | (x.abs() > 1e12)).any(-1,
                                                              keepdim=True)
                x = torch.where(bad, x_safe, x)
            U[dense["dense_ids"]] = x
            if with_sse:
                r2 = r2 + dr2
                xr = xr + (x * rhs).sum()
                xx = xx + (reg_vec[:, None] * x * x).sum()
    g0_b = None if g0 is None else g0.float()[None]
    for bucket in buckets:
        values, mask = bucket["values"], bucket["mask"]
        wg, wr = objective_weights(values, mask, cfg.alpha)
        rid = bucket["row_ids"]
        idx = bucket["indices"]
        hv = bucket.get("hot_vals") if hot_vh is not None else None  # (B, C)
        b, p = idx.shape
        if "n_ratings" in bucket:
            count("als.gather_slots", b * p)
            count("als.gather_ratings", bucket["n_ratings"])
        chunk = widen_chunk(cfg.chunk, b, p)
        hot_deg = None
        if hv is not None and (cfg.reg_by_degree or cfg.reg == 0):
            hot_deg = (hv != 0).float().sum(1)
        if cfg.reg_by_degree:
            deg_row = mask.sum(-1)
            if hot_deg is not None:
                deg_row = deg_row + hot_deg
            reg_row = cfg.reg * torch.clamp_min(deg_row, 1.0)
        else:
            reg_row = torch.full((b,), cfg.reg, dtype=torch.float32,
                                 device=dev)
        if cfg.reg == 0 and g0 is None:
            # reg=0: zero-degree rows (padding sentinels and empty rows)
            # have G=0, rhs=0; any positive ridge solves them to exactly 0
            deg0 = mask.sum(-1)
            if hot_deg is not None:
                deg0 = deg0 + hot_deg
            reg_row = torch.where(deg0 > 0, reg_row,
                                  torch.ones_like(reg_row))
        # row blocks keep the gathered (rows, P, k) temporary under budget
        bb = max(block, (budget_mb * (1 << 20))
                 // (p * k * dtype.itemsize) // block * block)
        for s in range(0, b, bb):
            e = min(s + bb, b)
            with mark("als.grams"):
                G, rt = gram_rhs(V, idx[s:e], wg[s:e], wr[s:e], chunk=chunk,
                                 compute_dtype=dtype)
                if g0_b is not None:
                    G += g0_b
            reg_b = reg_row[s:e]
            with mark("als.solves"):
                if hv is not None:
                    x = solve_spd_batched_hot(G, rt, hv[s:e], hot_vh,
                                              alpha=cfg.alpha,
                                              solver=cfg.solver,
                                              reg_vec=reg_b)
                else:
                    x = solve_spd_batched(G, rt, cfg.solver, reg_vec=reg_b)
                U[rid[s:e]] = x
            if with_sse:
                if hv is not None:
                    # the identity needs x · rhs_total: add the hot rhs term
                    hv_f = hv[s:e].float()
                    _, hwr = objective_weights(hv_f, (hv_f != 0).float(),
                                               cfg.alpha)
                    rt = rt + hwr @ hot_vh
                xr = xr + (x * rt).sum()
                xx = xx + (reg_b[:, None] * x * x).sum()
        if with_sse:
            r2 = r2 + (mask * values * values).sum()
            if hv is not None:
                hv_f = hv.float()
                r2 = r2 + (hv_f * hv_f).sum()
    U = U[:n_rows]
    if not with_sse:
        return U, None
    return U, r2 - xr - xx


def half_sweep(V: torch.Tensor, buckets: DeviceBuckets, n_rows: int,
               cfg: SolveConfig, with_sse: bool = False):
    """Solve every row of this orientation given the opposite table V.

    Returns the new (n_rows, k) table, plus (with ``with_sse``) the total
    explicit-objective residual SSE at the post-solve state."""
    with span("als.half_sweep"):
        full_f32()
        g0 = None
        if cfg.alpha is not None:
            g0 = V.t() @ V
        U, sse = solve_all_buckets(V, buckets, n_rows, cfg, g0,
                                   with_sse=with_sse)
    if with_sse:
        return U, sse
    return U


def _block_sse(Uz, V, hot_V, rid, idx, val, msk, chunk, hv=None):
    """SSE of one (bb, P) row block, degree-chunked; hv is (bb, C)."""
    Ug = Uz[rid]
    part = torch.zeros((), dtype=torch.float32, device=V.device)
    if hv is not None:
        hv_f = hv.float()
        pred_h = Ug @ hot_V.t()
        part = part + torch.where(hv_f != 0, (hv_f - pred_h) ** 2,
                                  torch.zeros_like(hv_f)).sum()
    bb, p = idx.shape
    k = V.shape[-1]
    for s in range(0, p, chunk):
        e = min(s + chunk, p)
        Vg = V.index_select(0, idx[:, s:e].reshape(-1)).view(bb, e - s, k)
        pred = torch.bmm(Vg, Ug[:, :, None])[:, :, 0]
        part = part + (msk[:, s:e] * (val[:, s:e] - pred) ** 2).sum()
    return part


def masked_sse(U: torch.Tensor, V: torch.Tensor, buckets: DeviceBuckets,
               chunk: int = 512, gather_budget_mb: int = 0) -> torch.Tensor:
    """Sum of squared residuals over observed entries, Σ mask (r - u·v)².

    Big buckets go in row blocks (then degree chunks) so the gathered
    temporary stays bounded; ``gather_budget_mb=0`` is the auto policy."""
    with span("als.sse"):
        full_f32()
        check_full_f32(V)
        k = V.shape[-1]
        dev = V.device
        buckets, dense, hot_ids = _split_special(buckets)
        gather_budget_mb = resolve_gather_budget(gather_budget_mb, k, buckets,
                                                 for_sse=True)
        hot_V = None if hot_ids is None else V.index_select(0, hot_ids)
        # the sentinel id U.shape[0] reads a zero row (the reference's fill
        # mode)
        Uz = torch.cat([U, torch.zeros((1, k), dtype=U.dtype, device=dev)])
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if dense is not None:
            vals = dense["dense_vals"]
            Ud = Uz[dense["dense_ids"]]
            n = vals.shape[1]
            for s in range(0, n, 16_384):
                e = min(s + 16_384, n)
                pred = Ud @ V[s:e].t()
                v = vals[:, s:e].float()
                total = total + torch.where(v != 0, (v - pred) ** 2,
                                            torch.zeros_like(v)).sum()
        for b in buckets:
            idx, val, msk, rid = (b["indices"], b["values"], b["mask"],
                                  b["row_ids"])
            hv = b.get("hot_vals") if hot_V is not None else None
            bsz, p = idx.shape
            chunk_b = widen_chunk(chunk, bsz, p)
            bb = max(8, (gather_budget_mb * (1 << 20))
                     // (min(p, chunk_b) * k * 4) // 8 * 8)
            for s in range(0, bsz, bb):
                e = min(s + bb, bsz)
                total = total + _block_sse(
                    Uz, V, hot_V, rid[s:e], idx[s:e], val[s:e], msk[s:e],
                    chunk_b, None if hv is None else hv[s:e])
    return total


def make_sweep_fns(user_buckets: DeviceBuckets, item_buckets: DeviceBuckets,
                   n_users: int, n_items: int, cfg: SolveConfig):
    """(sweep, train_sse) for one layout: sweep(U, V) -> (U', V') solves the
    users given V, then the items given the new U."""

    def sweep(U, V):
        U = half_sweep(V, user_buckets, n_users, cfg)
        V = half_sweep(U, item_buckets, n_items, cfg)
        return U, V

    def train_sse(U, V):
        return masked_sse(U, V, user_buckets, chunk=cfg.chunk,
                          gather_budget_mb=cfg.gather_budget_mb)

    return sweep, train_sse


def make_scanned_fit(user_buckets: DeviceBuckets, item_buckets: DeviceBuckets,
                     n_users: int, n_items: int, cfg: SolveConfig,
                     n_sweeps: int, tol: float = 0.0, nnz: int = 1):
    """The whole fit: fit(U, V) -> (U, V, sse_history (n_sweeps,), n_done).

    The per-sweep SSE rides the item half's solves or comes from a separate
    masked_sse pass, as ``sse_separate_for`` picks (the two agree)."""
    separate = sse_separate_for(cfg, nnz)

    def one_sweep(U, V, ub, ib):
        U = half_sweep(V, ub, n_users, cfg)
        if separate:
            V = half_sweep(U, ib, n_items, cfg)
            sse = masked_sse(U, V, ub, chunk=cfg.chunk,
                             gather_budget_mb=cfg.gather_budget_mb)
        else:
            V, sse = half_sweep(U, ib, n_items, cfg, with_sse=True)
        return U, V, sse

    return make_scanned_program_fit(one_sweep, n_sweeps, tol, nnz,
                                    (user_buckets, item_buckets))


def make_scanned_program_fit(sweep_sse, n_sweeps: int, tol: float, nnz: int,
                             extra: tuple):
    """Generic whole-fit loop around ``sweep_sse(U, V, *extra) -> (U, V,
    sse)``.

    Returns ``fit(U, V) -> (U, V, hist, n_done)``: ``hist`` is a tensor
    of per-sweep SSE on the SSE's device, with -1 for sweeps that never
    ran. U and V are whatever ``sweep_sse`` takes (tensors, or a sharded
    program's per-shard blocks). With ``tol == 0`` no value is read back
    during the fit; with ``tol > 0`` one scalar per sweep is, for the
    stopping rule (stop once the train RMSE of two consecutive sweeps
    differs by less than ``tol``)."""

    def fit(U, V):
        with span("als.fit", call=True):
            sses = []
            prev = None
            for _ in range(n_sweeps):
                with span("als.sweep"):
                    U, V, sse = sweep_sse(U, V, *extra)
                sses.append(sse)
                if tol > 0:
                    cur = math.sqrt(max(float(sse), 0.0) / nnz)
                    if prev is not None and abs(prev - cur) < tol:
                        break
                    prev = cur
            n_done = len(sses)
            hist = torch.full((n_sweeps,), -1.0, dtype=torch.float32,
                              device=sses[0].device)
            hist[:n_done] = torch.stack(sses)
        return U, V, hist, n_done

    return fit


__all__ = ["DeviceBuckets", "device_buckets", "half_sweep", "masked_sse",
           "make_sweep_fns", "make_scanned_fit", "make_scanned_program_fit",
           "resolve_gather_budget", "solve_all_buckets", "widen_chunk",
           "dense_gram_rhs"]
