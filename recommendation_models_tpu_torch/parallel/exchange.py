"""Embedding-exchange plans of the sharded ALS: the JAX package's
``parallel/exchange.py``, array for array.

Under ``exchange='all_to_all'`` or ``'hybrid'`` each shard receives only
the opposite-table rows its local observations touch, instead of the whole
gathered table:

* **Rotation schedule.** The request / response round trip runs as S-1
  rotations: at distance ``d`` requester ``s`` exchanges with owner
  ``(s+d) % S``. Each rotation's block is padded only to that rotation's
  largest request count.
* **Zipf head (the 'hybrid' mode).** The ``head`` most-observed columns are
  served from a replicated head table, assembled each half-sweep by a
  scatter of each owner's head rows into a zero (H, k) table and a sum over
  shards; only the tail rides the rotations. The layout's hot columns map
  into the head block (``remapped_hot``).

The served table of a shard is ``E = concat(head (H, k), local block (w_0,
k), rotation blocks (w_d, k) ...)``; observation indices are remapped once,
on the host, to slots of E. Padding request slots carry the sentinel
``col_shard_size``, which reads a zero row; padded observations remap to
slot 0 (their weight is 0).

The plan also gives the exact bytes each shard receives per half-sweep
(``recv_bytes_per_half_sweep``). Host-side NumPy only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from recommendation_models_tpu_torch.data.layout import ShardedLayout


def _pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


# eq/repr off: the auto __eq__ raises on ndarray fields and the auto
# __repr__ would print whole (S, w_d) request tables
@dataclasses.dataclass(eq=False, repr=False)
class ExchangePlan:
    n_shards: int
    col_shard_size: int             # rows of the opposite table per shard
    head_size: int                  # H replicated head rows (0 = none)
    widths: Tuple[int, ...]         # per-rotation padded width w_d (d=0 local)
    req_rot: Tuple[np.ndarray, ...]  # per rotation (S, w_d) int32 OWNER-local
                                     # ids; sentinel = col_shard_size
    remapped: Tuple[np.ndarray, ...]  # per bucket (S, B, P) int32 slots in E
    head_local: Optional[np.ndarray]  # (S, Hmax) int32 owner-local head ids;
                                      # sentinel = col_shard_size
    head_pos: Optional[np.ndarray]    # (S, Hmax) int32 target slots in the
                                      # (H, k) head table; sentinel = H (drop)
    remapped_hot: Optional[np.ndarray]  # (C,) int32 E-slots for layout.hot_ids
    n_tail_unique: int              # real (unpadded) tail request slots, total

    # -- observability ---------------------------------------------------
    def e_rows(self) -> int:
        return self.head_size + int(sum(self.widths))

    def recv_bytes_per_half_sweep(self, k: int, itemsize: int = 4) -> int:
        """Bytes RECEIVED per shard per half-sweep (ids + embedding rows +
        head scatter and sum), the traffic this plan implies."""
        S = self.n_shards
        tail = int(sum(self.widths[1:]))
        ids_in = tail * 4                      # request ids from requesters
        rows_in = tail * k * itemsize          # responses from owners
        head_in = 0
        if self.head_size:
            # ring all-reduce of the (H, k) head table
            head_in = int(2 * (S - 1) * self.head_size * k * itemsize / S)
        return ids_in + rows_in + head_in

    def padding_efficiency(self) -> float:
        """Real tail requests / padded tail slots (over all shards)."""
        padded = self.n_shards * int(sum(self.widths))
        return self.n_tail_unique / max(padded, 1)


def build_exchange_plan(
    layout: ShardedLayout,
    col_shard_size: int,
    head: int = 0,
) -> ExchangePlan:
    """Precompute the exchange for one orientation's sharded layout.

    ``col_shard_size`` is the opposite table's rows_per_shard (its padded
    global size is S * col_shard_size), defining ownership:
    ``owner(col) = col // col_shard_size``. ``head > 0`` replicates the
    ``head`` most-observed columns (always a superset of ``layout.hot_ids``
    when the layout carries a hot-column block).
    """
    if layout.dense_ids is not None:
        raise ValueError(
            "build_exchange_plan: the dense-whale block holds value rows "
            "over ALL global columns and needs the full opposite table — "
            "use 'allgather' exchange, or build the layout with "
            "DataConfig(dense_whales=False)")
    if layout.hot_ids is not None and head <= 0:
        raise ValueError(
            "build_exchange_plan: a hot-column block needs its columns "
            "replicated — use exchange='hybrid' (head>0) or 'allgather', "
            "or build the layout with DataConfig(hot_cols=0)")
    S = layout.n_shards
    css = col_shard_size

    # Whale buckets hold few global rows but shard_layout pads every shard
    # to the same (small) row count, so at large S most of their blocks
    # are padding. All three passes below subset to real rows first
    # (row_ids sentinel = rows_per_shard) and only then touch the (rows, P)
    # blocks.
    def real_rows(bucket_i, s=None):
        rid = layout.row_ids[bucket_i]
        if s is None:
            return rid < layout.rows_per_shard          # (S, B) bool
        return np.flatnonzero(rid[s] < layout.rows_per_shard)

    # ---- head selection: top-`head` columns by observation count --------
    head_sorted = np.empty(0, np.int64)
    if head > 0:
        counts = np.zeros(layout.n_cols, np.float64)
        for bi, (idx, msk) in enumerate(zip(layout.indices, layout.mask)):
            rr = real_rows(bi)
            sub_i, sub_m = idx[rr], msk[rr] > 0
            counts += np.bincount(
                sub_i[sub_m].astype(np.int64),
                minlength=layout.n_cols)[: layout.n_cols]
        head = min(head, layout.n_cols)
        top = np.argpartition(-counts, head - 1)[:head]
        if layout.hot_ids is not None:
            top = np.union1d(top, np.asarray(layout.hot_ids, np.int64))
        head_sorted = np.sort(top.astype(np.int64))
    H = int(head_sorted.shape[0])

    def split_head(ids):
        """Boolean head membership + head slots for an int64 id array."""
        if H == 0:
            return np.zeros(ids.shape, bool), None
        pos = np.searchsorted(head_sorted, ids)
        pos_c = np.minimum(pos, H - 1)
        return head_sorted[pos_c] == ids, pos_c

    # ---- unique needed tail ids per (requester shard, owner shard) ------
    # Kept as ONE sorted array per requester shard: sorted ids group by
    # owner contiguously, so owner splits are searchsorted boundaries, and
    # no per-(requester, owner) boolean masks (S^2 of them) are built.
    req_ids = []      # per shard: sorted unique tail ids, all owners
    req_bounds = []   # per shard: (S+1,) owner-group boundaries
    n_tail_unique = 0
    owner_edges = np.arange(S + 1, dtype=np.int64) * css
    # (rows, mask, masked ids) per (bucket, shard), computed once here and
    # reused by the remap pass below
    subsets = {}
    for s in range(S):
        parts = []
        for bi, (idx, msk) in enumerate(zip(layout.indices, layout.mask)):
            rows = real_rows(bi, s)
            m = msk[s][rows] > 0
            ids_bs = idx[s][rows][m].ravel().astype(np.int64)
            subsets[bi, s] = (rows, m, ids_bs)
            parts.append(ids_bs)
        ids = (np.unique(np.concatenate(parts)) if parts
               else np.empty(0, np.int64))
        in_head, _ = split_head(ids)
        ids = ids[~in_head]
        n_tail_unique += int(ids.shape[0])
        req_ids.append(ids)
        req_bounds.append(np.searchsorted(ids, owner_edges))
    # counts[s, o] = unique tail ids shard s requests from owner o
    counts = np.stack([np.diff(b) for b in req_bounds])

    # ---- per-rotation padded request blocks -----------------------------
    # rotation d: requester s <-> owner (s+d) % S
    s_idx = np.arange(S)
    widths = tuple(
        _pad8(int(counts[s_idx, (s_idx + d) % S].max()))
        for d in range(S))
    req_rot = []
    for d in range(S):
        block = np.full((S, widths[d]), css, dtype=np.int32)
        for s in range(S):
            o = (s + d) % S
            lo, hi = req_bounds[s][o], req_bounds[s][o + 1]
            block[s, : hi - lo] = (req_ids[s][lo:hi] - o * css).astype(
                np.int32)
        req_rot.append(block)
    offsets = H + np.concatenate([[0], np.cumsum(widths)[:-1]])

    # ---- remap observation indices -> slots into E ----------------------
    # slot(id) = offsets[rotation(owner)] + rank of id within its owner
    # group = one searchsorted over the shard's full sorted request list
    # minus the group start, with no inner owner loop. Only real (masked)
    # entries are processed, since shard_layout's per-shard row padding
    # inflates the whale buckets' blocks (padding slots stay 0, whose
    # served row has weight 0).
    remapped = []
    for bi, (idx, msk) in enumerate(zip(layout.indices, layout.mask)):
        out = np.zeros_like(idx)
        for s in range(S):
            rows, m, ids = subsets[bi, s]
            if not rows.size or not ids.size:
                continue
            in_head, head_pos = split_head(ids)
            owners = np.minimum(ids // css, S - 1)
            d = (owners - s) % S
            pos = (np.searchsorted(req_ids[s], ids)
                   - req_bounds[s][owners])
            slots = offsets[d] + pos
            if H:
                slots = np.where(in_head, head_pos, slots)
            blk = np.zeros((rows.shape[0], idx.shape[2]), idx.dtype)
            blk[m] = slots.astype(np.int32)
            out[s][rows] = blk
        remapped.append(out)

    # ---- head assembly maps ---------------------------------------------
    head_local = head_pos = None
    if H:
        owners = head_sorted // css            # monotone: owner groups are
        h_cnt = np.bincount(owners, minlength=S)  # contiguous in head order
        h_max = _pad8(int(h_cnt.max()))
        head_local = np.full((S, h_max), css, np.int32)
        head_pos = np.full((S, h_max), H, np.int32)   # sentinel H -> drop
        start = 0
        for o in range(S):
            c = int(h_cnt[o])
            head_local[o, :c] = (head_sorted[start:start + c]
                                 - o * css).astype(np.int32)
            head_pos[o, :c] = np.arange(start, start + c)
            start += c

    remapped_hot = None
    if layout.hot_ids is not None:
        pos = np.searchsorted(head_sorted, np.asarray(layout.hot_ids,
                                                      np.int64))
        remapped_hot = pos.astype(np.int32)

    return ExchangePlan(
        n_shards=S, col_shard_size=css, head_size=H, widths=widths,
        req_rot=tuple(req_rot), remapped=tuple(remapped),
        head_local=head_local, head_pos=head_pos,
        remapped_hot=remapped_hot, n_tail_unique=n_tail_unique)


__all__ = ["ExchangePlan", "build_exchange_plan"]
