"""Plain reference of the ALS configurations: the explicit ALS sweep and
exact top-n serving, in plain ``torch`` at float64 by default.

It imports nothing of the port and nothing of the JAX package, and takes
nothing the program made: it is handed the benchmark's ratings (COO, sorted
by user then item) and the benchmark's factor tables, and works everything
out again.

ALS (Zhou et al. 2008, without the degree-weighted ridge): a half-sweep
gives every row ``x = (Σ_j v_j v_jᵀ + reg·I)⁻¹ Σ_j r_j v_j`` over its
observed columns j against the fixed opposite table; a sweep solves the
users given V, then the items given the new U. A row with no rating solves
to 0. Rows are batched by degree (geometric bins, padded within a bin and
masked), and each batch's grams are one batched product and its solves one
batched Cholesky factorization, in blocks that bound the gathered rows.

Serving: the score of (user, item) is ``u · v``; the top n of a user are
the n highest scores among the items it has not rated (with
``exclude_seen``), or among all items.
"""

from __future__ import annotations

import math

import torch

# a degree bin spans degrees within this ratio (the padding it can waste)
_BIN_RATIO = 1.15
# gathered (rows, width, k) entries of one block
_BLOCK_ENTRIES = 1 << 26
# ratings scored at once by ``sse``
_SSE_CHUNK = 1 << 21
# users scored at once by ``topn``
_TOPN_USERS = 2048


class Orientation:
    """One side's CSR on the device: the rows' observed columns and ratings
    (``cols``, ``vals`` in row order, ``indptr``) and the rows' blocks of
    similar degree, made once and reused by every half-sweep."""

    def __init__(self, rows, cols, vals, n_rows: int, dtype):
        order = torch.argsort(rows, stable=True)
        self.cols = cols[order].contiguous()
        self.vals = vals[order].to(dtype).contiguous()
        deg = torch.bincount(rows, minlength=n_rows)
        self.indptr = torch.zeros(n_rows + 1, dtype=torch.int64,
                                  device=rows.device)
        self.indptr[1:] = torch.cumsum(deg, 0)
        self.n_rows = n_rows
        self.deg = deg
        self._blocks = None

    def blocks(self, k: int):
        """[(row ids (B,), width P)] covering every row with a rating."""
        if self._blocks is not None:
            return self._blocks
        deg = self.deg.cpu()
        rows = torch.nonzero(deg > 0).squeeze(1)
        d = deg[rows].double()
        bins = torch.floor(torch.log(d) / math.log(_BIN_RATIO)).long()
        out = []
        for b in torch.unique(bins).tolist():
            sel = rows[bins == b]
            width = int(deg[sel].max())
            per = max(1, _BLOCK_ENTRIES // (max(width, k) * k))
            for s in range(0, sel.shape[0], per):
                out.append((sel[s:s + per].to(self.deg.device), width))
        self._blocks = out
        return out


def half_sweep(side: Orientation, V: torch.Tensor, reg: float):
    """Every row's ridge solution against the opposite table V (n_cols, k),
    in V's dtype: a fresh (n_rows, k) table."""
    k = V.shape[1]
    X = torch.zeros((side.n_rows, k), dtype=V.dtype, device=V.device)
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    for rows, width in side.blocks(k):
        start = side.indptr[rows]
        deg = side.deg[rows]
        offs = torch.arange(width, device=V.device)
        valid = offs[None, :] < deg[:, None]
        pos = torch.where(valid, start[:, None] + offs[None, :], 0)
        m = valid.to(V.dtype)
        Vg = V[side.cols[pos]] * m[:, :, None]             # (B, P, k)
        r = side.vals[pos] * m                              # (B, P)
        G = torch.bmm(Vg.transpose(1, 2), Vg) + reg * eye
        rhs = torch.bmm(Vg.transpose(1, 2), r[:, :, None])
        L = torch.linalg.cholesky(G)
        X[rows] = torch.cholesky_solve(rhs, L)[:, :, 0]
    return X


def sse(users, items, vals, U, V):
    """Σ (r − u·v)² over the observed ratings, in U's dtype."""
    total = torch.zeros((), dtype=U.dtype, device=U.device)
    for s in range(0, users.shape[0], _SSE_CHUNK):
        e = min(s + _SSE_CHUNK, users.shape[0])
        pred = (U[users[s:e]] * V[items[s:e]]).sum(1)
        total += ((vals[s:e].to(U.dtype) - pred) ** 2).sum()
    return total


def fit(users, items, vals, n_users: int, n_items: int, U0, V0,
        reg: float, n_sweeps: int, dtype=torch.float64):
    """``n_sweeps`` sweeps from (U0, V0) in ``dtype``: (U, V, [SSE after
    each sweep])."""
    user_side = Orientation(users, items, vals, n_users, dtype)
    item_side = Orientation(items, users, vals, n_items, dtype)
    U, V = U0.to(dtype), V0.to(dtype)
    history = []
    for _ in range(n_sweeps):
        U = half_sweep(user_side, V, reg)
        V = half_sweep(item_side, U, reg)
        history.append(float(sse(users, items, vals, U, V)))
    return U, V, history


def topn(U, V, n: int, indptr=None, indices=None, dtype=torch.float64):
    """The exact top n of every user of U: (scores (n_users, n), items
    (n_users, n)), scores in ``dtype`` (float64 by default). With
    ``indptr`` and ``indices`` (the users' rated items, CSR) rated items
    never enter; the highest score first."""
    n_users = U.shape[0]
    Vt = V.to(dtype).t().contiguous()
    out_s = torch.empty((n_users, n), dtype=dtype, device=U.device)
    out_i = torch.empty((n_users, n), dtype=torch.int64, device=U.device)
    for s in range(0, n_users, _TOPN_USERS):
        e = min(s + _TOPN_USERS, n_users)
        sc = U[s:e].to(dtype) @ Vt
        if indptr is not None:
            lo, hi = int(indptr[s]), int(indptr[e])
            rows = torch.repeat_interleave(
                torch.arange(e - s, device=U.device),
                (indptr[s + 1:e + 1] - indptr[s:e]).to(U.device))
            sc[rows, indices[lo:hi].to(U.device).long()] = -math.inf
        top, idx = torch.topk(sc, n, dim=1)
        out_s[s:e] = top
        out_i[s:e] = idx
    return out_s, out_i


__all__ = ["Orientation", "half_sweep", "sse", "fit", "topn"]
