"""Observation-parallel ALS on the 2-D (dcn x data) mesh: the JAX package's
``parallel/hybrid_als.py`` on the port's single-process ``HybridMesh``
(``parallel/mesh.py``).

The layout of the program on a ``(D, S)`` mesh:

  U, V            row-sharded over 'data' (block s at every position
                  ``(d, s)``), replicated across 'dcn'
  observations    split across 'dcn': each slice holds about 1/D of every
                  row shard's bucket rows (``split_layout_slices``; row ids
                  may repeat across slices, and the grams scatter-add)
  a half-sweep    the opposite table gathered along 'data'; each position
                  accumulates the per-row gram, rhs and degree of its own
                  observations; they are summed along 'dcn' (the one
                  cross-slice collective), and every position solves its
                  row shard's summed systems (``solve_spd_flat``: the
                  batched solve kernel B1 on a card)

Per-position bytes received a half-sweep across slices are 2 (D-1)/D ·
rows_local · (k² + k) · 4 (``collective_bytes_per_sweep``, the reference's
analytic count). Neither the dense-whale block nor the hot columns run
here: their values span every global column of a row, so the layouts are
built with ``DataConfig(dense_whales=False, hot_cols=0)``.

The positions run one after another in this process, each solving its own
replicated systems, as the reference's does; on one card a
``HybridMesh([[cuda:0] * S] * D)`` runs them there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.config import SolveConfig
from recommendation_models_tpu_torch.data.layout import ShardedLayout
from recommendation_models_tpu_torch.ops.gram import (
    full_f32, gram_rhs, objective_weights,
)
from recommendation_models_tpu_torch.ops.solve import (
    resolve_compute_dtype, solve_spd_flat, torch_dtype,
)
from recommendation_models_tpu_torch.parallel.mesh import (
    HybridMesh, all_gather_along, psum_along,
)
from recommendation_models_tpu_torch.solver.als_sweep import (
    make_scanned_program_fit, masked_sse, resolve_gather_budget, widen_chunk,
)

Grid = Tuple[Tuple[torch.Tensor, ...], ...]


def split_layout_slices(layout: ShardedLayout, n_slices: int):
    """Split each bucket's rows across ``n_slices`` slices.

    Returns per-bucket dicts of (D, S, Bd, ...) arrays (row_ids keep the
    ``rows_per_shard`` sentinel on padding rows). Row blocks are dealt
    round-robin so Zipf-ordered buckets spread whales evenly; ``Bd`` is
    rounded up to a multiple of 8."""
    if layout.dense_ids is not None or layout.hot_ids is not None:
        raise ValueError(
            "hybrid 2-D ALS: dense-whale / hot-column blocks need the full "
            "opposite table per device — build the layout with "
            "DataConfig(dense_whales=False, hot_cols=0)")
    D = n_slices
    out = []
    for rid, idx, val, msk in zip(layout.row_ids, layout.indices,
                                  layout.values, layout.mask):
        S, B, pad = idx.shape
        bd = max(1, -(-B // D))
        bd = -(-bd // 8) * 8

        def sp(a, fill=0):
            a4 = np.full((D, S) + (bd,) + a.shape[2:], fill, a.dtype)
            flat = np.arange(B)
            d_of, pos = flat % D, flat // D          # round-robin deal
            a4[d_of, :, pos] = np.swapaxes(a, 0, 1)[flat]
            return a4

        out.append(dict(
            row_ids=sp(rid, fill=layout.rows_per_shard),
            indices=sp(idx), values=sp(val), mask=sp(msk)))
    return tuple(out)


def _put_positions(mesh: HybridMesh, split) -> tuple:
    """The split buckets as device buckets (``device_buckets``' format) of
    each position: ``out[d][s]`` is a tuple of bucket dicts on
    ``mesh.grid[d][s]``."""
    out = []
    for d, row in enumerate(mesh.grid):
        out.append(tuple(
            tuple(dict(
                row_ids=torch.from_numpy(
                    b["row_ids"][d, s].astype(np.int64)).to(dev),
                indices=torch.from_numpy(
                    np.ascontiguousarray(b["indices"][d, s])).to(dev),
                values=torch.from_numpy(
                    np.ascontiguousarray(b["values"][d, s])).to(dev),
                mask=torch.from_numpy(
                    np.ascontiguousarray(b["mask"][d, s])).to(dev))
                for b in split)
            for s, dev in enumerate(row)))
    return tuple(out)


class HybridALSProgram:
    """Observation-parallel ALS for one (layouts, 2-D mesh, config)."""

    def __init__(self, user_layout: ShardedLayout,
                 item_layout: ShardedLayout, mesh: HybridMesh,
                 cfg: SolveConfig):
        if len(mesh.axis_names) != 2:
            raise ValueError(f"need a 2-D (dcn, data) mesh, got "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.dcn_axis, self.axis = mesh.axis_names
        D = mesh.shape[self.dcn_axis]
        S = mesh.shape[self.axis]
        if user_layout.n_shards != S or item_layout.n_shards != S:
            raise ValueError("layout shard count must equal the mesh's "
                             "'data' axis size")
        # 'auto' solver and compute dtype resolve at the solve: the kernel
        # on a card, f32 (ops/solve.py)
        self.cfg = cfg
        self.n_slices = D
        self.n_shards = S
        self.n_users = user_layout.n_rows
        self.n_items = item_layout.n_rows
        self.upr = user_layout.rows_per_shard
        self.ipr = item_layout.rows_per_shard
        self._ub = _put_positions(mesh, split_layout_slices(user_layout, D))
        self._ib = _put_positions(mesh, split_layout_slices(item_layout, D))

    # ------------------------------------------------------------------
    def _local_normal_equations(self, V_full, buckets, rows_local: int):
        """One position's (G (rows_local + 1, k²), rhs, deg) from its own
        observations; row id ``rows_local`` (padding) lands in the extra
        row. Row blocks keep the gathered temporary under the gather
        budget."""
        cfg = self.cfg
        k = V_full.shape[-1]
        dev = V_full.device
        dtype = torch_dtype(resolve_compute_dtype(cfg.compute_dtype))
        G = torch.zeros((rows_local + 1, k * k), dtype=torch.float32,
                        device=dev)
        rhs = torch.zeros((rows_local + 1, k), dtype=torch.float32,
                          device=dev)
        deg = torch.zeros((rows_local + 1,), dtype=torch.float32, device=dev)
        budget_mb = resolve_gather_budget(cfg.gather_budget_mb, k, buckets)
        for b in buckets:
            wg, wr = objective_weights(b["values"], b["mask"], cfg.alpha)
            rid, idx = b["row_ids"], b["indices"]
            bsz, p = idx.shape
            bb = max(8, budget_mb * (1 << 20)
                     // (min(p, cfg.chunk) * k * dtype.itemsize) // 8 * 8)
            for s in range(0, bsz, bb):
                e = min(s + bb, bsz)
                g, r = gram_rhs(V_full, idx[s:e], wg[s:e], wr[s:e],
                                chunk=widen_chunk(cfg.chunk, e - s, p),
                                compute_dtype=dtype)
                G.index_add_(0, rid[s:e], g.reshape(e - s, k * k))
                rhs.index_add_(0, rid[s:e], r)
                deg.index_add_(0, rid[s:e], b["mask"][s:e].sum(-1))
        return G, rhs, deg

    def _half(self, V: Grid, buckets, rows_local: int):
        """One orientation's half-sweep at every position: (the new row
        blocks ``x[d][s]``, the opposite table gathered along 'data')."""
        cfg, mesh = self.cfg, self.mesh
        dcn, data = self.dcn_axis, self.axis
        k = V[0][0].shape[-1]
        V_full = all_gather_along(mesh, V, data)
        D, S = self.n_slices, self.n_shards
        local = [[self._local_normal_equations(V_full[d][s], buckets[d][s],
                                               rows_local)
                  for s in range(S)] for d in range(D)]
        # the one cross-slice collective: per-row normal equations
        G = psum_along(mesh, [[x[0] for x in row] for row in local], dcn)
        rhs = psum_along(mesh, [[x[1] for x in row] for row in local], dcn)
        deg_local = [[x[2] for x in row] for row in local]
        del local
        deg = None
        if cfg.reg_by_degree or (cfg.reg == 0 and cfg.alpha is None):
            deg = psum_along(mesh, deg_local, dcn)
        g0 = None
        if cfg.alpha is not None:
            # the global gramian: V is replicated across 'dcn', so the sum
            # along 'data' alone completes VᵀV
            g0 = psum_along(mesh, [[b.t() @ b for b in row] for row in V],
                            data)
        out = []
        for d in range(D):
            row = []
            for s in range(S):
                dev = mesh.grid[d][s]
                if cfg.reg_by_degree:
                    reg_vec = cfg.reg * torch.clamp_min(deg[d][s], 1.0)
                else:
                    reg_vec = torch.full((rows_local + 1,), cfg.reg,
                                         dtype=torch.float32, device=dev)
                if cfg.reg == 0 and cfg.alpha is None:
                    # reg=0: zero-degree (padded or empty) rows have G=0,
                    # rhs=0; any positive ridge solves them to exactly 0
                    reg_vec = torch.where(deg[d][s] > 0, reg_vec,
                                          torch.ones_like(reg_vec))
                Gp = G[d][s]
                if g0 is not None:
                    Gp = Gp + g0[d][s].reshape(1, -1)
                row.append(solve_spd_flat(Gp[:rows_local],
                                          rhs[d][s][:rows_local], k,
                                          cfg.solver,
                                          reg_vec=reg_vec[:rows_local]))
            out.append(tuple(row))
        return tuple(out), V_full

    def _sse(self, U: Grid, V_full: Grid, buckets) -> torch.Tensor:
        """The SSE of each position's observations, summed along 'data'
        then 'dcn' (the observations partition over the positions); the
        scalar on the first position's device."""
        cfg = self.cfg
        parts = [[masked_sse(U[d][s], V_full[d][s], buckets[d][s],
                             chunk=cfg.chunk,
                             gather_budget_mb=cfg.gather_budget_mb)
                  for s in range(self.n_shards)]
                 for d in range(self.n_slices)]
        total = psum_along(self.mesh,
                           psum_along(self.mesh, parts, self.axis),
                           self.dcn_axis)
        return total[0][0]

    # ------------------------------------------------------------------
    def _place(self, U: np.ndarray, V: np.ndarray):
        def put(x, per):
            blocks = [np.ascontiguousarray(x[s * per:(s + 1) * per])
                      for s in range(self.n_shards)]
            return tuple(tuple(torch.from_numpy(blocks[s]).to(dev)
                               for s, dev in enumerate(row))
                         for row in self.mesh.grid)
        return put(U, self.upr), put(V, self.ipr)

    def init_factors(self, seed: int, init_scale: float):
        """The reference's init of the padded tables: ``default_rng(seed)``,
        U then V, scaled f32 normals, the rows past the true sizes zeroed.
        Returns (U, V) as ``blocks[d][s]``."""
        rng = np.random.default_rng(seed)
        k = self.cfg.rank
        U = init_scale * rng.standard_normal(
            (self.upr * self.n_shards, k)).astype(np.float32)
        V = init_scale * rng.standard_normal(
            (self.ipr * self.n_shards, k)).astype(np.float32)
        U[self.n_users:] = 0.0
        V[self.n_items:] = 0.0
        return self._place(U, V)

    def place_factors(self, U0, V0):
        """Warm-start host factors (n_users / n_items rows) placed on the
        padded tables."""
        k = self.cfg.rank
        U = np.zeros((self.upr * self.n_shards, k), np.float32)
        V = np.zeros((self.ipr * self.n_shards, k), np.float32)
        U[: self.n_users] = np.asarray(U0, np.float32)
        V[: self.n_items] = np.asarray(V0, np.float32)
        return self._place(U, V)

    def sweep(self, U: Grid, V: Grid):
        full_f32()
        U, _ = self._half(V, self._ub, self.upr)
        V, _ = self._half(U, self._ib, self.ipr)
        return U, V

    def sweep_with_sse(self, U: Grid, V: Grid):
        """One sweep and the post-sweep SSE over the item orientation's
        observations, against the item half's own gathered U (no extra
        gather; only the scalar sums)."""
        full_f32()
        U, _ = self._half(V, self._ub, self.upr)
        V, U_full = self._half(U, self._ib, self.ipr)
        return U, V, self._sse(V, U_full, self._ib)

    def train_sse(self, U: Grid, V: Grid) -> torch.Tensor:
        """The SSE of (U, V) over the user orientation (one more gather of
        V along 'data')."""
        full_f32()
        V_full = all_gather_along(self.mesh, V, self.axis)
        return self._sse(U, V_full, self._ub)

    def make_fit(self, n_sweeps: int, tol: float = 0.0, nnz: int = 1):
        """The whole fit, as ``ShardedALSProgram.make_fit``: ``fit(U, V) ->
        (U, V, sse_history (n_sweeps,), n_done)``."""
        return make_scanned_program_fit(self.sweep_with_sse, n_sweeps, tol,
                                        nnz, ())

    def collective_bytes_per_sweep(self) -> dict:
        """Analytic per-position bytes per sweep, split by fabric (the
        reference's count): the gathers along 'data' (ICI) and the gram sum
        along 'dcn' (the only DCN traffic)."""
        k = self.cfg.rank
        S, D = self.n_shards, self.n_slices
        ici = (S - 1) * (self.ipr + self.upr) * k * 4   # both halves' gathers
        dcn = 0
        if D > 1:
            rows = self.upr + self.ipr
            # G (k²) + rhs (k) per row; the degree vector (+1) is summed
            # only under reg_by_degree
            per_row = k * k + k + (1 if self.cfg.reg_by_degree else 0)
            dcn = int(2 * (D - 1) / D * rows * per_row * 4)
        out = dict(ici=ici, dcn=dcn, per_sweep_total=ici + dcn)
        out["sse_extra"] = (S - 1) * self.ipr * k * 4
        out["per_sweep_with_sse"] = out["per_sweep_total"] + out["sse_extra"]
        return out


__all__ = ["HybridALSProgram", "split_layout_slices"]
