"""Top-k dot-product retrieval: the serving path of ``ALS.recommend``.

The JAX package's ``ops/topk.py`` on torch tensors, with the same names and
constants. Scores are an f32 product ``u @ vᵀ`` (never TF32); selection is
exact:

- ``n_items <= _SMALL_N``: one product and one selection over the row;
- wider catalogs: a loop over ``_EXACT_BLOCK``-item blocks of the catalog,
  each block's top ``min(k, block)`` merged into a running top-k, so that
  the score matrix is never more than one block wide.

``method='auto' | 'exact' | 'approx'`` is accepted for the JAX package's
signature. torch has no ``approx_max_k``, and the card is not a TPU, so
every method runs the exact selection (as the JAX package does on a CPU).

Selection keeps ``lax.top_k``'s contract: values in descending order, and
among equal values the lower index first (``_top_k``). ``torch.topk``
promises no order among ties, so its picks are re-sorted and a row whose
k-th and (k+1)-th values tie is selected again by a stable sort.

``sharded_topk`` serves a catalog row-sharded over a mesh
(``parallel.mesh``): a top-k on each shard, then one merge of the
candidates.

Exclusion of seen items overfetches ``k + E`` candidates and filters them
(``_filter_seen``): the top-k unseen items are always among the top
``k + E``. The filter sorts each exclusion row and looks every candidate up
with ``searchsorted``, so its memory is O(B·(overfetch + E)), never the
(B, overfetch, E) comparison.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.ops.gram import check_full_f32

# Item-axis block of the chunked exact selection.
_EXACT_BLOCK = 16_384
# Up to this catalog size one product and one selection serve a query.
_SMALL_N = 8_192
# Up to this width a selection is one stable sort of the row.
_SORT_W = 2_048


def _resolve_method(method: str, n_items: int, k: int) -> str:
    """``method`` after validation: 'auto' is 'exact' (the card is not a
    TPU); 'approx' is kept as asked and runs the exact selection."""
    if method not in ("auto", "exact", "approx"):
        raise ValueError(f"unknown top-k method {method!r}")
    return "exact" if method == "auto" else method


def _scores(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # f32 product with TF32 off: a TF32 product rounds the factors to 10
    # mantissa bits, which reorders near-ties
    check_full_f32(v)
    return torch.matmul(u, v.T)


def _stable_top_k(s: torch.Tensor, k: int):
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _top_k(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(s, k)`` along dim 1: the k largest in descending order,
    the lower index first among equal values (indices int64)."""
    w = s.shape[1]
    if k >= w or w <= _SORT_W:
        return _stable_top_k(s, k)
    v, i = torch.topk(s, k + 1, dim=1, sorted=False)
    # order the k + 1 picks by (value descending, index ascending)
    i, o = torch.sort(i, dim=1)
    v = torch.gather(v, 1, o)
    v, o = torch.sort(v, dim=1, descending=True, stable=True)
    i = torch.gather(i, 1, o)
    # where the k-th value ties the (k+1)-th, which of the tied entries
    # belong to the top k is open: those rows take a stable sort
    tied = (v[:, k - 1] == v[:, k]).nonzero().squeeze(1)
    v, i = v[:, :k], i[:, :k]
    if tied.numel():
        v[tied], i[tied] = _stable_top_k(s[tied], k)
    return v, i


def _topk_exact_small(u, v, k):
    return _top_k(_scores(u, v), k)


def _topk_exact_chunked(u, v, k, block=_EXACT_BLOCK, n_valid=None):
    """Exact top-k by a loop over item blocks with a running merge.

    ``n_valid``: candidate rows at or past it score -inf (defaults to v's
    row count). The last block is taken as if padded to ``block`` rows
    whose ids continue past the catalog, as the JAX package pads it."""
    n = v.shape[0]
    b = u.shape[0]
    if n_valid is None:
        n_valid = n
    kb = min(k, block)  # a block holds only `block` candidates: taking all
    # of them keeps the running merge exact even when k > block
    c_sc = torch.full((b, k), -torch.inf, dtype=torch.float32,
                      device=u.device)
    c_ix = torch.zeros((b, k), dtype=torch.int64, device=u.device)
    for base in range(0, n, block):
        s = _scores(u, v[base:base + block])
        w = s.shape[1]
        if n_valid < base + w:
            s[:, max(n_valid - base, 0):] = -torch.inf
        if w < kb:      # the padding rows this selection would reach
            s = torch.nn.functional.pad(s, (0, kb - w), value=-torch.inf)
        sc, ix = _top_k(s, kb)
        m_sc = torch.cat([c_sc, sc], dim=1)
        m_ix = torch.cat([c_ix, ix + base], dim=1)
        c_sc, pos = _top_k(m_sc, k)
        c_ix = torch.gather(m_ix, 1, pos)
    return c_sc, c_ix


def _filter_seen(sc, ix, exclude, k):
    """Drop excluded candidates and select the top k again.

    Each exclusion row is sorted (its -1 padding first, and no candidate id
    is negative) and every candidate looked up in it with ``searchsorted``:
    O(B·(overfetch + E)) memory."""
    if exclude.shape[1]:
        ex, _ = torch.sort(exclude.to(ix.dtype), dim=1)
        pos = torch.searchsorted(ex, ix.contiguous())
        pos.clamp_max_(ex.shape[1] - 1)
        seen = torch.gather(ex, 1, pos) == ix
        sc = sc.masked_fill(seen, -torch.inf)
    sc_k, pos = _top_k(sc, k)
    return sc_k, torch.gather(ix, 1, pos)


def _topk_unseen(u, v, k, exclude: Optional[torch.Tensor]):
    n_items = v.shape[0]
    overfetch = k if exclude is None else min(k + exclude.shape[1], n_items)
    if n_items <= _SMALL_N:
        sc, ix = _topk_exact_small(u, v, overfetch)
    else:
        sc, ix = _topk_exact_chunked(u, v, overfetch)
    if exclude is None:
        return sc, ix
    return _filter_seen(sc, ix, exclude, k)


def topk_scores(
    U_rows,                     # (B, k) query user factors
    V: torch.Tensor,            # (n_items, k) item factors
    k: int,
    exclude=None,               # (B, E) int seen items, -1 = none
    method: str = "auto",
    recall_target: float = 0.99,
):
    """Returns (scores (B, k) f32, items (B, k) int64) of the top-k items,
    on V's device.

    ``U_rows`` and ``exclude`` may be host arrays; they are moved to V's
    device. ``exclude`` rows may be padded with -1 (no item has id -1, so
    padding never matches a candidate). ``method`` is validated and
    ``recall_target`` accepted, as the JAX package's ``approx_max_k`` dials;
    every method selects exactly."""
    if k < 1 or k > V.shape[0]:
        raise ValueError(
            f"k must be in [1, n_items={V.shape[0]}], got {k} — a short "
            "(B, <k) result would break shape-(B, k) consumers silently")
    _resolve_method(method, V.shape[0], k)
    U_rows = torch.as_tensor(U_rows, dtype=torch.float32, device=V.device)
    if exclude is not None:
        exclude = torch.as_tensor(exclude, device=V.device)
    return _topk_unseen(U_rows, V, k, exclude)


_PERM_SEED = 0x5EED


def serving_permutation(n_items: int, seed: int = _PERM_SEED):
    """The JAX package's fixed random catalog permutation (``serving_row j
    holds item perm_back[j]``), bit for bit: it decorrelates item id from
    score rank for ``approx_max_k``, and the port serves the same rows so
    that both packages' serving tables and tie orders agree.

    Returns ``(perm_back, perm_fwd)``: serving row ``j`` holds item
    ``perm_back[j]``; item ``i`` lives at serving row ``perm_fwd[i]``.
    Deterministic in ``n_items``."""
    rng = np.random.default_rng(seed + n_items)
    perm_back = rng.permutation(n_items).astype(np.int64)
    perm_fwd = np.empty_like(perm_back)
    perm_fwd[perm_back] = np.arange(n_items, dtype=np.int64)
    return perm_back, perm_fwd


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def permuted_topk(topk, perm_back, perm_fwd):
    """Wrap a ``(Uq, k, excl) -> (sc, it)`` serving backend whose catalog
    rows are in ``perm_back`` order: exclusion ids map forward (-1 padding
    kept), returned serving rows map back to catalog ids on the host.

    A returned row outside ``[0, len(perm_back))`` (the padding of a
    table padded past the catalog) maps to -1; the JAX package raises
    ``IndexError`` there for rows past the end."""
    n = perm_back.shape[0]

    def wrapped(Uq, k, excl):
        if excl is not None:
            e = np.asarray(excl)
            excl = np.where(e >= 0, perm_fwd[np.maximum(e, 0)], -1
                            ).astype(np.int32)
        sc, it = topk(Uq, k, excl)
        it = _host(it)
        inside = (it >= 0) & (it < n)
        return _host(sc), np.where(inside, perm_back[np.where(inside, it, 0)],
                                   -1)
    return wrapped


def grouped_exclusion_topk(user_ids, n, indptr, indices, query_rows, topk,
                           query_chunk: int = 16_384):
    """Degree-bucketed exclude-seen serving (host orchestration).

    Exclusion overfetch is n + the batch's widest exclusion row, so one
    whale user would widen every row's selection. Users are sorted by
    degree, cut at geometric width levels 32·4^j, and each group gets its
    own exclusion width (the level) and top-k calls, ``query_chunk`` users
    at a time.

    ``query_rows(ids) -> (B, k)`` and ``topk(Uq, n, excl) -> (sc, it)`` are
    the backend's callables. Returns NumPy (scores (B, n), items (B, n))
    aligned with ``user_ids``."""
    user_ids = np.atleast_1d(np.asarray(user_ids, np.int64))
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    degs = indptr[user_ids + 1] - indptr[user_ids]
    order = np.argsort(degs, kind="stable")
    sd = degs[order]
    batch = user_ids.shape[0]
    out_s = np.empty((batch, n), np.float32)
    out_i = np.empty((batch, n), np.int64)

    levels, w = [], 32
    maxd = int(sd[-1]) if batch else 0
    while True:
        levels.append(w)
        if w >= maxd:
            break
        w *= 4
    cuts = np.searchsorted(sd, np.asarray(levels), side="right")
    start = 0
    for level, cut in zip(levels, cuts):
        if cut <= start:
            continue
        grp = order[start:cut]
        # exclusion width = the level, not the group's max degree: a few
        # fixed widths, at most 4x padding
        width = level
        start = cut
        lo = indptr[user_ids[grp]]
        gdeg = degs[grp]
        cols = np.arange(width, dtype=np.int64)[None, :]
        valid = cols < gdeg[:, None]
        pos = np.where(valid, lo[:, None] + cols, 0)
        # indices may be EMPTY (every requested user has zero training
        # degree): fancy-indexing an empty array raises, so use zeros
        # (masked to -1 anyway)
        gathered = indices[pos] if indices.size else np.zeros_like(pos)
        excl = np.where(valid, gathered, -1).astype(np.int32)
        for q in range(0, grp.shape[0], query_chunk):
            sl = slice(q, q + query_chunk)
            # the host block goes to the backend: the permutation wrapper
            # maps exclusion ids on the host before topk_scores uploads it
            sc, it = topk(query_rows(user_ids[grp[sl]]), n, excl[sl])
            out_s[grp[sl]] = _host(sc)
            out_i[grp[sl]] = _host(it)
    return out_s, out_i


def sharded_topk(
    U_rows,
    V,
    k: int,
    mesh,
    axis: str = "data",
    exclude=None,
    method: str = "auto",
    recall_target: float = 0.99,
    n_valid: Optional[int] = None,
):
    """Top-k with the catalog row-sharded over ``mesh``; the queries go to
    every shard.

    ``V``: the whole (n, k) catalog (a tensor or array, padded with zero
    rows to a multiple of the shard count and placed one block a shard),
    or the per-shard blocks of a table that is already sharded (a sharded
    fit's). Each local shard selects its top ``fetch_shard`` candidates;
    the candidates of every shard (across processes, gathered through the
    host) are merged on the first local shard's device into the top
    ``fetch``, so the traffic is O(B k S), not O(B n). Across processes
    every process must call it with the same queries, and each gets the
    whole result. ``n_valid``: the true item count of a padded table; rows
    at or past it never become candidates. Returns (scores (B, k), items
    (B, k)) on the first local shard's device; with ``exclude`` (B, E, -1 =
    none) the seen items are filtered from ``k + E`` candidates
    (``_filter_seen``).
    """
    from recommendation_models_tpu_torch.parallel.mesh import gather_parts
    S = mesh.shape[axis]
    local = mesh.local
    if isinstance(V, (torch.Tensor, np.ndarray)):
        V = torch.as_tensor(V, dtype=torch.float32)
        n_rows = V.shape[0]
        per = -(-n_rows // S)
        if per * S != n_rows:
            V = torch.nn.functional.pad(V, (0, 0, 0, per * S - n_rows))
        blocks = tuple(V[s * per:(s + 1) * per].to(d) if s in local else None
                       for s, d in enumerate(mesh.devices))
    else:
        blocks = tuple(V)
        per = blocks[local[0]].shape[0]
        n_rows = per * S
    n_items = n_valid if n_valid is not None else n_rows
    if k < 1 or k > n_items:
        raise ValueError(
            f"k must be in [1, n_items={n_items}], got {k} — the no-"
            "exclude path would silently return fewer than k columns")
    want = k if exclude is None else min(k + exclude.shape[1], n_items)
    # a shard holds only `per` candidates, but the merge pools S of those,
    # so its width stays `want`
    fetch_shard = min(want, per)
    fetch = min(want, S * fetch_shard)
    _resolve_method(method, per, fetch_shard)
    home = mesh.devices[local[0]]
    sc_parts, ix_parts = [None] * S, [None] * S
    for s in local:
        v = blocks[s]
        u = torch.as_tensor(U_rows, dtype=torch.float32, device=v.device)
        base = s * per
        if per <= _SMALL_N:
            sc = _scores(u, v)
            if n_items < base + per:    # the padded tail of the catalog
                sc[:, max(n_items - base, 0):] = -torch.inf
            sc, ix = _top_k(sc, fetch_shard)
        else:
            sc, ix = _topk_exact_chunked(u, v, fetch_shard,
                                         n_valid=n_items - base)
        sc_parts[s] = sc.to(home)
        ix_parts[s] = (ix + base).to(home)
    # every shard's candidates (across processes, through the host)
    sc_parts = gather_parts(mesh, sc_parts)
    ix_parts = gather_parts(mesh, ix_parts)
    sc_all = torch.cat([p.to(home) for p in sc_parts], dim=1)
    ix_all = torch.cat([p.to(home) for p in ix_parts], dim=1)
    top_sc, pos = _top_k(sc_all, fetch)
    top_ix = torch.gather(ix_all, 1, pos)
    if exclude is None:
        return top_sc[:, :k], top_ix[:, :k]
    return _filter_seen(top_sc, top_ix, torch.as_tensor(exclude, device=home),
                        k)


__all__ = ["topk_scores", "sharded_topk", "grouped_exclusion_topk",
           "serving_permutation", "permuted_topk"]
