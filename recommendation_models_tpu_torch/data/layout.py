"""CSR ratings -> degree-bucketed padded layout (host-side numpy).

The same layout as the JAX package's ``data/layout.py``, array for array:
rows are grouped by padded degree into dense ``(B, P)`` blocks of column
ids / values / mask, the densest rows may move to a dense-whale block, and
the most popular columns may move to per-bucket hot slabs. Padding rows
carry the sentinel row id ``n_rows`` and mask 0, and every real row
appears in exactly one bucket (or the dense block), so each bucket solves
and scatter-sets independently.

``shard_layout`` re-stacks a layout into per-shard blocks of identical
shape for the sharded program (``parallel/sharded_als.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from recommendation_models_tpu_torch.config import DataConfig
from recommendation_models_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Bucket:
    """One degree bucket: ``B`` rows padded to degree ``P``."""

    pad: int                 # P
    row_ids: np.ndarray      # (B,) int32, n_rows = padding sentinel
    indices: np.ndarray      # (B, P) int32, 0 where padded
    values: np.ndarray       # (B, P) float32, 0 where padded
    mask: np.ndarray         # (B, P) float32, 1 real / 0 pad
    # (B, C) float16 ratings against the layout's hot columns, 0 =
    # unobserved; None when the layout has no hot block.
    hot_vals: Optional[np.ndarray] = None

    @property
    def n_rows(self) -> int:
        return self.row_ids.shape[0]


@dataclasses.dataclass
class PaddedLayout:
    """Bucketed padded layout of one orientation.

    ``dense_ids``/``dense_vals``: the dense-whale block, ids (W,) and a
    dense (W, n_cols) float16 value matrix (0 = unobserved); these rows
    appear in no bucket. ``hot_ids``: the C hot columns, whose observations
    live in ``Bucket.hot_vals`` instead of the index/value blocks.
    """

    n_rows: int
    n_cols: int
    nnz: int
    buckets: Tuple[Bucket, ...]
    dense_ids: Optional[np.ndarray] = None
    dense_vals: Optional[np.ndarray] = None
    hot_ids: Optional[np.ndarray] = None

    @property
    def padded_slots(self) -> int:
        return sum(b.n_rows * b.pad for b in self.buckets)

    def padding_waste(self) -> float:
        """Fraction of bucketed padded slots that are padding."""
        tot = self.padded_slots
        if not tot:
            return 0.0
        dense_nnz = (np.count_nonzero(self.dense_vals)
                     if self.dense_vals is not None else 0)
        hot_nnz = sum(int(np.count_nonzero(b.hot_vals))
                      for b in self.buckets if b.hot_vals is not None)
        return 1.0 - (self.nnz - dense_nnz - hot_nnz) / tot


@dataclasses.dataclass
class ShardedLayout:
    """Per-shard stacked buckets of one orientation.

    Rows are assigned to ``n_shards`` contiguous blocks of
    ``rows_per_shard``. Each bucket is stacked into ``(S, B, P)`` arrays
    with the same ``(B, P)`` on every shard (padded to the maximum over
    shards); ``row_ids`` are local to the shard (sentinel =
    ``rows_per_shard``).
    """

    n_rows: int
    n_cols: int
    nnz: int
    n_shards: int
    rows_per_shard: int
    pads: Tuple[int, ...]            # P per bucket
    row_ids: Tuple[np.ndarray, ...]  # each (S, B) int32, local ids
    indices: Tuple[np.ndarray, ...]  # each (S, B, P) int32, global col ids
    values: Tuple[np.ndarray, ...]   # each (S, B, P) float32
    mask: Tuple[np.ndarray, ...]     # each (S, B, P) float32
    # Dense-whale block, row-sharded like the buckets: local ids (sentinel
    # rows_per_shard), values in global column order (only an 'allgather'
    # exchange, which sees the whole opposite table, can use them).
    dense_ids: Optional[np.ndarray] = None   # (S, Wmax) int32 local ids
    dense_vals: Optional[np.ndarray] = None  # (S, Wmax, n_cols) float16
    # Hot-column block: the C global column ids (the same on every shard)
    # and per-bucket (S, B, C) f16 value slabs aligned with row_ids.
    hot_ids: Optional[np.ndarray] = None
    hot_vals: Optional[Tuple[np.ndarray, ...]] = None


def build_layout(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n_rows: int,
    n_cols: int,
    config: Optional[DataConfig] = None,
) -> PaddedLayout:
    """Build the bucketed padded layout from CSR arrays (O(nnz) vectorized,
    one Python iteration per dense-whale row)."""
    cfg = config or DataConfig()
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    data = np.asarray(data, dtype=np.float32)
    degrees = np.diff(indptr).astype(np.int64)
    nnz = int(degrees.sum())
    # loud bounds validation: an out-of-range column id would otherwise
    # gather a wrong factor row on the device
    if degrees.shape[0] != n_rows:
        raise ValueError(f"indptr describes {degrees.shape[0]} rows but "
                         f"n_rows={n_rows}")
    if indices.size and (int(indices.max()) >= n_cols or int(indices.min()) < 0):
        raise ValueError(
            f"column ids must be in [0, {n_cols}); got "
            f"[{int(indices.min())}, {int(indices.max())}]")
    S = int(cfg.max_bucket)

    dense_ids = dense_vals = None
    is_dense = np.zeros(n_rows, bool)
    # the dense and hot blocks encode "unobserved" as value 0, so an
    # explicit zero rating routed into them must raise, not vanish
    has_zero_obs = bool(
        (getattr(cfg, "dense_whales", False) or getattr(cfg, "hot_cols", 0))
        and data.size and np.any(data == 0))
    if getattr(cfg, "dense_whales", False):
        # float16 values (exact for half-star ratings): 2 bytes per entry
        cap = max((cfg.dense_budget_mb * (1 << 20)) // (max(n_cols, 1) * 2), 0)
        thr = getattr(cfg, "dense_min_degree", None)
        thr = 512 if thr is None else int(thr)
        thr = min(thr, S)
        cand = np.flatnonzero(degrees > thr)
        if cand.size and cap > 0:
            cand = cand[np.argsort(-degrees[cand], kind="stable")][:cap]
            dense_ids = np.sort(cand).astype(np.int32)
            is_dense[dense_ids] = True
            dense_vals = np.zeros((dense_ids.shape[0], n_cols), np.float16)
            for w, r in enumerate(dense_ids):
                lo, hi = indptr[r], indptr[r + 1]
                if np.unique(indices[lo:hi]).size != hi - lo:
                    raise ValueError(
                        f"row {r} has duplicate (row, col) observations "
                        "and is routed to the dense-whale block, whose "
                        "scatter is last-wins (the bucket path would sum "
                        "them) — canonicalize first (scipy "
                        "sum_duplicates(), or pre-sum the COO triplets)")
                if has_zero_obs and np.any(data[lo:hi] == 0):
                    raise ValueError(
                        f"row {r} has explicit zero-valued ratings and "
                        "would be routed to the dense-whale block, whose "
                        "value matrix encodes 0 = unobserved — the zeros "
                        "would silently be dropped. Shift ratings away "
                        "from exact 0, or build the layout with "
                        "DataConfig(dense_whales=False) / "
                        "ALS(dense_min_degree=<huge>) to disable the "
                        "dense block.")
                dense_vals[w, indices[lo:hi]] = data[lo:hi]

    hot_ids = None
    hot_slab = None
    row_of_obs = None
    if getattr(cfg, "hot_cols", 0):
        row_of_obs = np.repeat(np.arange(n_rows, dtype=np.int64), degrees)
        nd_obs = ~is_dense[row_of_obs] if is_dense.any() else slice(None)
        counts = np.bincount(indices[nd_obs], minlength=n_cols)
        thr = getattr(cfg, "hot_min_count", None)
        thr = max(n_rows // 64, 32) if thr is None else int(thr)
        cand = np.flatnonzero(counts >= thr)
        # hot_cols in 1..7 rounds C to 0: no hot block at all then
        if cand.size >= 8 and int(cfg.hot_cols) >= 8:
            cand = cand[np.argsort(-counts[cand], kind="stable")]
            C = min(int(cfg.hot_cols), cand.size) // 8 * 8
            hot_ids = np.sort(cand[:C]).astype(np.int32)
            hot_rank = np.full(n_cols, -1, np.int64)
            hot_rank[hot_ids] = np.arange(C)
            obs_rank = hot_rank[indices]
            is_hot_obs = (obs_rank >= 0) & ~is_dense[row_of_obs]
            if has_zero_obs and np.any(data[is_hot_obs] == 0):
                bad = int(np.count_nonzero(data[is_hot_obs] == 0))
                raise ValueError(
                    f"{bad} explicit zero-valued rating(s) fall in hot "
                    "columns, whose slab encodes 0 = unobserved — they "
                    "would silently be dropped. Shift ratings away from "
                    "exact 0, or build with DataConfig(hot_cols=0) / "
                    "ALS(hot_cols=0) to disable the hot-column block.")
            hot_keys = (row_of_obs[is_hot_obs] * np.int64(C)
                        + obs_rank[is_hot_obs])
            if np.unique(hot_keys).size != hot_keys.size:
                raise ValueError(
                    "duplicate (row, col) observations fall in hot "
                    "columns, whose slab scatter is last-wins (the "
                    "bucket path would sum them) — canonicalize first "
                    "(scipy sum_duplicates(), or pre-sum the COO "
                    "triplets), or build with DataConfig(hot_cols=0)")
            # (n_rows+1, C): the extra zero row backs sentinel row ids
            hot_slab = np.zeros((n_rows + 1, C), np.float16)
            hot_slab[row_of_obs[is_hot_obs], obs_rank[is_hot_obs]] = \
                data[is_hot_obs]
            # residual CSR: everything except hot obs of non-dense rows
            keep = ~is_hot_obs
            indices = indices[keep]
            data = data[keep]
            degrees = np.bincount(row_of_obs[keep], minlength=n_rows
                                  ).astype(np.int64)
            indptr = np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(degrees)])

    # Bucket widths: a geometric grid (ratio bucket_growth, 8-aligned) up
    # to S, continued past S on a coarser alignment so whale rows stay
    # whole in a few wide bucket classes.
    growth = max(float(getattr(cfg, "bucket_growth", None) or 1.25), 1.05)
    grid = [int(cfg.min_bucket)]
    while grid[-1] < S:
        nxt = max(int(np.ceil(grid[-1] * growth / 8.0)) * 8, grid[-1] + 8)
        grid.append(min(nxt, S))
    bucketed_deg = degrees[~is_dense]
    max_deg = int(bucketed_deg.max()) if bucketed_deg.size else 0
    align = max(8, min(S, 1024))
    while grid[-1] < max_deg:
        nxt = max(int(np.ceil(grid[-1] * growth / align)) * align,
                  grid[-1] + align)
        grid.append(nxt)
    grid = np.asarray(grid, dtype=np.int64)
    # dense rows can exceed the grid top; clip keeps the index in range
    pads = grid[np.minimum(np.searchsorted(grid, degrees), grid.size - 1)]

    # opt-in greedy bucket merging: lift a bucket into the next wider pad
    # while the extra padded slots stay under bucket_merge_slack
    slack = int(getattr(cfg, "bucket_merge_slack", 0))
    if slack > 0:
        nd = ~is_dense if is_dense.any() else np.ones(n_rows, bool)
        uniq, cnts = np.unique(pads[nd], return_counts=True)
        remap = {}
        g_rows, g_pad, g_members = 0, -1, []
        for p, c in zip(uniq.tolist(), cnts.tolist()):
            lift = g_rows * (p - g_pad) if g_pad >= 0 else 0
            if g_pad >= 0 and lift <= slack:
                g_members.append(p)
                g_rows += c
            else:
                g_members, g_rows = [p], c
            g_pad = p
            for q in g_members:
                remap[q] = p
        if any(remap[q] != q for q in remap):
            tgt = np.asarray([remap[int(q)] for q in uniq], dtype=np.int64)
            pos = np.clip(np.searchsorted(uniq, pads), 0, uniq.size - 1)
            pads = np.where(uniq[pos] == pads, tgt[pos], pads)

    buckets = []
    for pad in np.unique(pads[~is_dense]) if is_dense.any() else np.unique(pads):
        pad = int(pad)
        sel = np.flatnonzero((pads == pad) & ~is_dense)
        deg = degrees[sel]
        b_real = sel.shape[0]
        b = int(-(-b_real // cfg.row_multiple) * cfg.row_multiple)

        row_ids = np.full(b, n_rows, dtype=np.int32)
        row_ids[:b_real] = sel.astype(np.int32)
        idx = np.zeros((b, pad), dtype=np.int32)
        val = np.zeros((b, pad), dtype=np.float32)
        msk = np.zeros((b, pad), dtype=np.float32)

        total = int(deg.sum())
        if total:
            cum = np.cumsum(deg)
            within = np.arange(total, dtype=np.int64) - np.repeat(cum - deg, deg)
            src = np.repeat(indptr[sel], deg) + within
            rowpos = np.repeat(np.arange(b_real, dtype=np.int64), deg)
            idx[rowpos, within] = indices[src]
            val[rowpos, within] = data[src]
            msk[rowpos, within] = 1.0

        buckets.append(Bucket(
            pad=pad, row_ids=row_ids, indices=idx, values=val, mask=msk,
            hot_vals=None if hot_slab is None else hot_slab[row_ids]))

    return PaddedLayout(n_rows=n_rows, n_cols=n_cols, nnz=nnz,
                        buckets=tuple(buckets),
                        dense_ids=dense_ids, dense_vals=dense_vals,
                        hot_ids=hot_ids)


def layout_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    config: Optional[DataConfig] = None,
    transpose: bool = False,
) -> PaddedLayout:
    """Build a layout from COO triplets (optionally of the transpose, for
    the item half-sweep). Sorts into CSR internally. One ``layout.build``
    span (``utils.profiling``)."""
    with span("layout.build"):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float32)
        if transpose:
            rows, cols = cols, rows
            n_rows, n_cols = n_cols, n_rows
        order = np.argsort(rows, kind="stable")
        rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
        counts = np.bincount(rows_s, minlength=n_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return build_layout(indptr, cols_s, vals_s, n_rows, n_cols, config)


def csr_arrays(R) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Accept scipy.sparse (any format) or a dense 2-D array; return CSR
    arrays ``(indptr, indices, data, n_rows, n_cols)``. Duplicate entries
    of a non-canonical sparse input are summed (without mutating it)."""
    import scipy.sparse as sp
    if sp.issparse(R):
        R = R.tocsr()
        if not R.has_canonical_format:
            R = R.copy()
            R.sum_duplicates()
        return (np.asarray(R.indptr), np.asarray(R.indices),
                np.asarray(R.data, dtype=np.float32), R.shape[0], R.shape[1])
    R = np.asarray(R)
    if R.ndim != 2:
        raise ValueError(f"ratings must be 2-D, got shape {R.shape}")
    rows, cols = np.nonzero(R)
    vals = R[rows, cols].astype(np.float32)
    counts = np.bincount(rows, minlength=R.shape[0])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, cols.astype(np.int32), vals, R.shape[0], R.shape[1]


def bucket_row_multiple(n_bucket_rows: int, row_multiple: int) -> int:
    """Row-count rounding multiple for one bucket: ``row_multiple`` when
    the bucket is at least that big, else 8 (padding a handful of wide
    whale rows to a large multiple would multiply their gather volume)."""
    return row_multiple if n_bucket_rows >= row_multiple else 8


def shard_layout(layout: PaddedLayout, n_shards: int,
                 row_multiple: int = 8) -> ShardedLayout:
    """Re-stack a PaddedLayout into per-shard blocks of identical shapes.

    Row ``r`` lives on shard ``r // rows_per_shard``. Each bucket's row
    count is padded to its maximum over shards, rounded by
    ``bucket_row_multiple`` (pass the solve block). The dense-whale and
    hot-column blocks shard by row owner like the buckets, and their column
    ids stay global, so a layout carrying them serves only the 'allgather'
    exchange (``parallel.exchange.build_exchange_plan`` refuses it).
    """
    rows_per_shard = -(-layout.n_rows // n_shards)
    has_hot = layout.hot_ids is not None
    pads, all_rid, all_idx, all_val, all_msk = [], [], [], [], []
    all_hv = [] if has_hot else None
    for b in layout.buckets:
        real = b.row_ids < layout.n_rows
        shard_of = np.where(real, b.row_ids // rows_per_shard, -1)
        counts = np.bincount(shard_of[shard_of >= 0], minlength=n_shards)
        bmax = max(int(counts.max()) if counts.size else 0, 1)
        mult = bucket_row_multiple(bmax, row_multiple)
        bmax = -(-bmax // mult) * mult
        rid = np.full((n_shards, bmax), rows_per_shard, dtype=np.int32)
        idx = np.zeros((n_shards, bmax, b.pad), dtype=np.int32)
        val = np.zeros((n_shards, bmax, b.pad), dtype=np.float32)
        msk = np.zeros((n_shards, bmax, b.pad), dtype=np.float32)
        hv = (np.zeros((n_shards, bmax, b.hot_vals.shape[1]), np.float16)
              if has_hot else None)
        for s in range(n_shards):
            take = np.flatnonzero(shard_of == s)
            k = take.shape[0]
            rid[s, :k] = b.row_ids[take] - s * rows_per_shard
            idx[s, :k] = b.indices[take]
            val[s, :k] = b.values[take]
            msk[s, :k] = b.mask[take]
            if has_hot:
                hv[s, :k] = b.hot_vals[take]
        pads.append(b.pad)
        all_rid.append(rid)
        all_idx.append(idx)
        all_val.append(val)
        all_msk.append(msk)
        if has_hot:
            all_hv.append(hv)
    dense_ids = dense_vals = None
    if layout.dense_ids is not None:
        shard_of = layout.dense_ids // rows_per_shard
        counts = np.bincount(shard_of, minlength=n_shards)
        wmax = -(-max(int(counts.max()), 1) // 8) * 8
        dense_ids = np.full((n_shards, wmax), rows_per_shard, np.int32)
        dense_vals = np.zeros((n_shards, wmax, layout.n_cols), np.float16)
        for s in range(n_shards):
            take = np.flatnonzero(shard_of == s)
            k = take.shape[0]
            dense_ids[s, :k] = layout.dense_ids[take] - s * rows_per_shard
            dense_vals[s, :k] = layout.dense_vals[take]
    return ShardedLayout(
        n_rows=layout.n_rows, n_cols=layout.n_cols, nnz=layout.nnz,
        n_shards=n_shards, rows_per_shard=rows_per_shard,
        pads=tuple(pads), row_ids=tuple(all_rid), indices=tuple(all_idx),
        values=tuple(all_val), mask=tuple(all_msk),
        dense_ids=dense_ids, dense_vals=dense_vals,
        hot_ids=(np.asarray(layout.hot_ids) if has_hot else None),
        hot_vals=(tuple(all_hv) if has_hot else None),
    )


__all__ = ["Bucket", "PaddedLayout", "ShardedLayout", "build_layout",
           "layout_from_coo", "csr_arrays", "bucket_row_multiple",
           "shard_layout"]
