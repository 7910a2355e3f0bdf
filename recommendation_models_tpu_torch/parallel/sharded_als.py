"""Sharded ALS sweeps over a 1-D mesh: the JAX package's
``parallel/sharded_als.py`` on the port's single-process mesh
(``parallel/mesh.py``).

The user and item tables are row-sharded: a table is a tuple of per-shard
blocks of ``rows_per_shard`` rows, block ``s`` on ``mesh.devices[s]``, with
the rows past the true table size zero. Each shard solves the rows it owns
with the single-device ``solve_all_buckets`` (B1 for the plain buckets and
the dense block, B2 for buckets with hot columns, on a card), against its
view of the opposite table, which comes per half-sweep from

* ``'allgather'``: the whole table gathered onto every shard; keeps the
  dense-whale block and the hot columns;
* ``'all_to_all'``: the rotation exchange of ``parallel.exchange`` (each
  shard receives only the rows its observations touch, one padded block a
  rotation); neither dense block nor hot columns;
* ``'hybrid'``: the rotation exchange for the tail and the Zipf head
  replicated by a scatter and a sum; keeps the hot columns, remapped into
  the head block.

The implicit objective's global gramian ``VᵀV`` is the sum over shards of
the per-shard grams, in full f32. The per-sweep SSE rides the item half
(the riding identity or a separate pass over the same exchanged table, as
``sse_separate_for`` picks), summed over shards.

The shards run one after the other in this process; on one card
``Mesh((cuda:0,) * S)`` runs S shards there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.config import (
    SolveConfig, sse_separate_for,
)
from recommendation_models_tpu_torch.data.layout import ShardedLayout
from recommendation_models_tpu_torch.ops.gram import full_f32
from recommendation_models_tpu_torch.parallel.exchange import (
    ExchangePlan, build_exchange_plan,
)
from recommendation_models_tpu_torch.parallel.mesh import (
    Mesh, all_gather, ppermute, psum, replicate_put, shard_put,
)
from recommendation_models_tpu_torch.solver.als_sweep import (
    make_scanned_program_fit, masked_sse, solve_all_buckets,
)

Blocks = Tuple[torch.Tensor, ...]


def exchange_layout(dcfg, exchange: str, exchange_head: Optional[int]):
    """(layout config, head) of a sharded fit under ``exchange``, the JAX
    estimator's rules: 'all_to_all' serves a compact remapped table, so
    neither the dense block nor the hot columns (both use global column
    ids) can run; 'hybrid' replicates a head of ``exchange_head`` columns
    (default ``max(1024, 8 * hot_cols)``), which carries the hot columns,
    but not the dense block, which needs the whole opposite table;
    'allgather' keeps both."""
    if exchange == "all_to_all":
        return dataclasses.replace(dcfg, dense_whales=False, hot_cols=0), 0
    if exchange == "hybrid":
        dcfg = dataclasses.replace(dcfg, dense_whales=False)
        head = (exchange_head if exchange_head is not None
                else max(1024, 8 * dcfg.hot_cols))
        return dcfg, head
    return dcfg, 0


def _with_zero_row(V: torch.Tensor) -> torch.Tensor:
    """V with one zero row appended: the sentinel id ``V.shape[0]`` of a
    request reads zeros (the reference's ``take(mode='fill')``)."""
    return torch.cat([V, V.new_zeros((1, V.shape[1]))])


def _exchange_source(mesh: Mesh, V: Blocks, plan) -> Blocks:
    """Each shard's view of the opposite table: the whole table (no plan),
    or ``E = concat(head, local block, rotation blocks)`` of the plan."""
    if plan is None:
        return all_gather(mesh, V)
    S = mesh.size
    Vz = [_with_zero_row(b) for b in V]
    parts = [[] for _ in range(S)]
    H = plan["head_size"]
    if H:
        # each owner scatters its head rows into a zero (H, k) table (the
        # sentinel slot H is dropped); the sum over shards replicates it
        heads = []
        for s in range(S):
            head = Vz[s].new_zeros((H + 1, Vz[s].shape[1]))
            head[plan["head_pos"][s]] = Vz[s].index_select(
                0, plan["head_local"][s])
            heads.append(head[:H])
        for s, head in enumerate(psum(mesh, heads)):
            parts[s].append(head)
    # rotation 0: the rows this shard owns, no exchange
    for s in range(S):
        parts[s].append(Vz[s].index_select(0, plan["req_rot"][0][s]))
    for d in range(1, S):
        # requester s sends its ids to owner (s + d) % S, which answers
        recv = ppermute(mesh, plan["req_rot"][d], d)
        resp = [Vz[o].index_select(0, recv[o]) for o in range(S)]
        for s, block in enumerate(ppermute(mesh, resp, -d)):
            parts[s].append(block)
    return tuple(torch.cat(p) for p in parts)


def _half_sweep(mesh: Mesh, V: Blocks, buckets, plan, n_local_rows: int,
                cfg: SolveConfig, with_sse: bool = False,
                sse_separate: bool = True):
    """Solve every shard's rows given the opposite table V: the new row
    blocks, and with ``with_sse`` the SSE summed over shards."""
    V_src = _exchange_source(mesh, V, plan)
    g0 = None
    if cfg.alpha is not None:
        g0 = psum(mesh, [b.t() @ b for b in V])
    new, sse = [], []
    for s in range(mesh.size):
        U_s, e = solve_all_buckets(
            V_src[s], buckets[s], n_local_rows, cfg,
            None if g0 is None else g0[s],
            with_sse=with_sse and not sse_separate)
        if with_sse and sse_separate:
            # the direct residual against the same exchanged table
            e = masked_sse(U_s, V_src[s], buckets[s], chunk=cfg.chunk,
                           gather_budget_mb=cfg.gather_budget_mb)
        new.append(U_s)
        sse.append(e)
    if not with_sse:
        return tuple(new)
    return tuple(new), psum(mesh, sse)[0]


def put_buckets(mesh: Mesh, axis: str, layout: ShardedLayout,
                plan: Optional[ExchangePlan] = None):
    """Per-shard device buckets in ``solver.als_sweep.device_buckets``'s
    format: for each shard, a tuple of bucket dicts (then the dense block
    and the hot ids, if any) on that shard's device. Under a plan the
    indices are the remapped slots of the exchanged table, and the hot ids
    the head slots of the hot columns."""
    S = mesh.size
    out = [[] for _ in range(S)]

    def put(a):
        return shard_put(mesh, axis, a)

    for i in range(len(layout.pads)):
        idx = plan.remapped[i] if plan is not None else layout.indices[i]
        fields = dict(row_ids=put(layout.row_ids[i].astype(np.int64)),
                      indices=put(idx), values=put(layout.values[i]),
                      mask=put(layout.mask[i]))
        if layout.hot_vals is not None:
            # (B, C) batch-major, bf16 on the device like device_buckets
            fields["hot_vals"] = put(layout.hot_vals[i])
        for s in range(S):
            d = {key: blocks[s][0] for key, blocks in fields.items()}
            if "hot_vals" in d:
                d["hot_vals"] = d["hot_vals"].to(torch.bfloat16)
            out[s].append(d)
    if layout.dense_ids is not None:
        ids = put(layout.dense_ids.astype(np.int64))
        vals = put(layout.dense_vals)
        for s in range(S):
            out[s].append(dict(dense_ids=ids[s][0], dense_vals=vals[s][0]))
    if layout.hot_ids is not None:
        hot = plan.remapped_hot if plan is not None else layout.hot_ids
        ids = replicate_put(mesh, np.asarray(hot, np.int64))
        for s in range(S):
            out[s].append(dict(hot_ids=ids[s]))
    return tuple(tuple(b) for b in out)


def _put_plan(mesh: Mesh, axis: str, plan: Optional[ExchangePlan]):
    """A plan's request ids and head maps as per-shard device tensors."""
    if plan is None:
        return None

    def rows(a):
        return tuple(b[0] for b in shard_put(mesh, axis, a.astype(np.int64)))

    d = dict(req_rot=tuple(rows(r) for r in plan.req_rot),
             head_size=plan.head_size)
    if plan.head_size:
        d["head_local"] = rows(plan.head_local)
        d["head_pos"] = rows(plan.head_pos)
    return d


class ShardedALSProgram:
    """Sharded ALS for one (layouts, mesh, config) triple."""

    def __init__(
        self,
        user_layout: ShardedLayout,
        item_layout: ShardedLayout,
        mesh: Mesh,
        cfg: SolveConfig,
        exchange: str = "allgather",
        head: int = 0,
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.shape[self.axis]
        if (user_layout.n_shards != self.n_shards
                or item_layout.n_shards != self.n_shards):
            raise ValueError(
                f"layouts sharded {user_layout.n_shards} / "
                f"{item_layout.n_shards} ways for a mesh of "
                f"{self.n_shards} shards")
        self.n_users = user_layout.n_rows
        self.n_items = item_layout.n_rows
        self.upr = user_layout.rows_per_shard
        self.ipr = item_layout.rows_per_shard
        self.exchange = exchange

        if exchange in ("all_to_all", "hybrid"):
            h = head if exchange == "hybrid" else 0
            u_plan = build_exchange_plan(user_layout, col_shard_size=self.ipr,
                                         head=h)
            i_plan = build_exchange_plan(item_layout, col_shard_size=self.upr,
                                         head=h)
        elif exchange == "allgather":
            u_plan = i_plan = None
        else:
            raise ValueError(f"unknown exchange mode {exchange!r}")
        self._uplan_host, self._iplan_host = u_plan, i_plan
        self._ub = put_buckets(mesh, self.axis, user_layout, u_plan)
        self._ib = put_buckets(mesh, self.axis, item_layout, i_plan)
        self._uplan = _put_plan(mesh, self.axis, u_plan)
        self._iplan = _put_plan(mesh, self.axis, i_plan)
        self._sse_separate = sse_separate_for(cfg, user_layout.nnz)

    # ------------------------------------------------------------------
    def _place(self, U: np.ndarray, V: np.ndarray):
        return (shard_put(self.mesh, self.axis, U),
                shard_put(self.mesh, self.axis, V))

    def init_factors(self, seed: int, init_scale: float):
        """The reference's sharded init: the padded tables from
        ``default_rng(seed)``, U then V, scaled f32 normals, with the rows
        past the true sizes zeroed (they must not enter the implicit
        gramian). Returns the row-sharded (U, V)."""
        rng = np.random.default_rng(seed)
        k = self.cfg.rank
        nup, nip = self.upr * self.n_shards, self.ipr * self.n_shards
        U = init_scale * rng.standard_normal((nup, k)).astype(np.float32)
        V = init_scale * rng.standard_normal((nip, k)).astype(np.float32)
        U[self.n_users:] = 0.0
        V[self.n_items:] = 0.0
        return self._place(U, V)

    def place_factors(self, U0, V0):
        """Warm-start host factors (n_users / n_items rows) placed on the
        padded row-sharded tables."""
        k = self.cfg.rank
        U = np.zeros((self.upr * self.n_shards, k), np.float32)
        V = np.zeros((self.ipr * self.n_shards, k), np.float32)
        U[: self.n_users] = np.asarray(U0, np.float32)
        V[: self.n_items] = np.asarray(V0, np.float32)
        return self._place(U, V)

    def sweep(self, U: Blocks, V: Blocks):
        full_f32()
        U = _half_sweep(self.mesh, V, self._ub, self._uplan, self.upr,
                        self.cfg)
        V = _half_sweep(self.mesh, U, self._ib, self._iplan, self.ipr,
                        self.cfg)
        return U, V

    def sweep_with_sse(self, U: Blocks, V: Blocks):
        """One sweep and the post-sweep SSE, taken in the item half over
        its own exchanged table (no extra exchange)."""
        full_f32()
        U = _half_sweep(self.mesh, V, self._ub, self._uplan, self.upr,
                        self.cfg)
        V, sse = _half_sweep(self.mesh, U, self._ib, self._iplan, self.ipr,
                             self.cfg, with_sse=True,
                             sse_separate=self._sse_separate)
        return U, V, sse

    def train_sse(self, U: Blocks, V: Blocks) -> torch.Tensor:
        """The SSE of (U, V) over the user half (one more user-half
        exchange)."""
        full_f32()
        V_src = _exchange_source(self.mesh, V, self._uplan)
        parts = [masked_sse(U[s], V_src[s], self._ub[s], chunk=self.cfg.chunk,
                            gather_budget_mb=self.cfg.gather_budget_mb)
                 for s in range(self.n_shards)]
        return psum(self.mesh, parts)[0]

    def make_fit(self, n_sweeps: int, tol: float = 0.0, nnz: int = 1):
        """The whole fit, as ``solver.als_sweep.make_scanned_fit``:
        ``fit(U, V) -> (U, V, sse_history (n_sweeps,), n_done)``, the SSE
        riding the item half of each sweep."""
        return make_scanned_program_fit(self.sweep_with_sse, n_sweeps, tol,
                                        nnz, ())

    def collective_bytes_per_sweep(self) -> dict:
        """Per-shard bytes received per sweep by the exchange mode (the
        reference's analytic count): a tiled all-gather of the opposite
        table per half, or the plan's ids, rows and head; the implicit
        gramian's sum counts as a ring all-reduce, 2(S-1)/S of its bytes.
        ``sse_extra`` prices a standalone ``train_sse`` call."""
        k = self.cfg.rank
        S = self.n_shards
        out = {}
        for name, plan, css in (("user_half", self._uplan_host, self.ipr),
                                ("item_half", self._iplan_host, self.upr)):
            if plan is None:
                out[name] = (S - 1) * css * k * 4
            else:
                out[name] = plan.recv_bytes_per_half_sweep(k)
        if self.cfg.alpha is not None:
            out["psum_gram"] = int(2 * 2 * (S - 1) * k * k * 4 / S)
        out["per_sweep_total"] = sum(out.values())
        out["sse_extra"] = out["user_half"]
        out["per_sweep_with_sse"] = out["per_sweep_total"] + out["sse_extra"]
        return out


__all__ = ["ShardedALSProgram", "exchange_layout", "put_buckets"]
