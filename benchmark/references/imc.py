"""Plain reference of the IMC configurations: inductive matrix completion
with side features, in plain ``torch`` at float64 by default.

It imports nothing of the port and nothing of the JAX package, and takes
nothing the program made: it is handed the benchmark's ratings (COO), the
feature matrices X (n_users, d_user) and Y (n_items, d_item) and the warm
start (W0, H0), and works everything out again. TF32 is turned off for
every float32 product.

IMC (Jain & Dhillon 2013, "Provable inductive matrix completion"):
``r_ui ≈ x_uᵀ W Hᵀ y_i``, with the objective

    ½‖P_Ω(R − X W Hᵀ Yᵀ)‖² + λ/2 (‖W‖² + ‖H‖²).

A sweep minimises it over W given H, then over H given the new W. With
``z_i = (Y H)_i`` the W half is a least-squares problem whose normal
equations read ``Σ_u x_u x_uᵀ W G_u + λ W = Xᵀ B`` with the row grams
``G_u = Σ_{i ∈ Ω_u} z_i z_iᵀ`` and ``B_u = Σ_{i ∈ Ω_u} r_ui z_i``; the H half
is the same with the roles of users and items swapped. Grams are computed
per row in blocks of rows of similar degree that bound the gathered rows.

Departure from an exact solve: the exact (d·k)² Hessian is 42 GB in
float64 at d = 1,128 and k = 64, so each half runs conjugate gradients on
the operator ``M ↦ Fᵀ[(F M) ⊙_rows G] + λM`` as the program does, with the
same number of steps, a true-residual restart every ``restart`` steps and
a zero step where ``pᵀAp ≤ 0`` or ``rᵀr = 0``. The comparison is then of
precision and arithmetic, not of algorithm. The objective of each sweep is
computed from the residuals of every rating, not from the grams.
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# a degree bin spans degrees within this ratio (the padding it can waste)
_BIN_RATIO = 1.15
# gathered (rows, width, k) entries of one block
_BLOCK_ENTRIES = 1 << 26
# ratings scored at once by ``sse``
_SSE_CHUNK = 1 << 21


class Side:
    """One orientation's CSR on the device (each row's observed columns and
    ratings) and its blocks of rows of similar degree."""

    def __init__(self, rows, cols, vals, n_rows: int, dtype):
        order = torch.argsort(rows, stable=True)
        self.cols = cols[order].contiguous()
        self.vals = vals[order].to(dtype).contiguous()
        self.deg = torch.bincount(rows, minlength=n_rows)
        self.indptr = torch.zeros(n_rows + 1, dtype=torch.int64,
                                  device=rows.device)
        self.indptr[1:] = torch.cumsum(self.deg, 0)
        self.n_rows = n_rows

    def blocks(self, k: int):
        """[(row ids (B,), width P)] covering every row with a rating."""
        deg = self.deg.cpu()
        rows = torch.nonzero(deg > 0).squeeze(1)
        bins = torch.floor(torch.log(deg[rows].double())
                           / math.log(_BIN_RATIO)).long()
        out = []
        for b in torch.unique(bins).tolist():
            sel = rows[bins == b]
            width = int(deg[sel].max())
            per = max(1, _BLOCK_ENTRIES // (max(width, k) * k))
            for s in range(0, sel.shape[0], per):
                out.append((sel[s:s + per].to(self.deg.device), width))
        return out


def row_grams(side: Side, Z: torch.Tensor):
    """Every row's ``G (n_rows, k, k) = Σ z zᵀ`` and ``B (n_rows, k) = Σ r z``
    over its observed columns, in Z's dtype; rows with no rating are 0."""
    n, k = side.n_rows, Z.shape[1]
    G = torch.zeros((n, k, k), dtype=Z.dtype, device=Z.device)
    B = torch.zeros((n, k), dtype=Z.dtype, device=Z.device)
    for rows, width in side.blocks(k):
        offs = torch.arange(width, device=Z.device)
        valid = offs[None, :] < side.deg[rows][:, None]
        pos = torch.where(valid, side.indptr[rows][:, None] + offs[None, :],
                          0)
        m = valid.to(Z.dtype)
        Zg = Z[side.cols[pos]] * m[:, :, None]                 # (b, P, k)
        G[rows] = torch.bmm(Zg.transpose(1, 2), Zg)
        B[rows] = torch.bmm(Zg.transpose(1, 2),
                            (side.vals[pos] * m)[:, :, None])[:, :, 0]
    return G, B


def cg(matvec, b, x0, iters: int, restart: int = 16):
    """``iters`` conjugate-gradient steps on ``matvec`` from x0, with a
    true-residual restart every ``restart`` steps; a step with
    ``pᵀAp ≤ 0`` or ``rᵀr = 0`` takes a zero step."""
    x = x0
    done = 0
    while done < iters:
        length = min(restart, iters - done)
        r = b - matvec(x)
        p = r
        rs = torch.dot(r, r)
        for _ in range(length):
            Ap = matvec(p)
            denom = torch.dot(p, Ap)
            a = rs / denom if denom > 0 else torch.zeros_like(rs)
            x = x + a * p
            r = r - a * Ap
            rs_new = torch.dot(r, r)
            beta = rs_new / rs if rs > 0 else torch.zeros_like(rs)
            p = r + beta * p
            rs = rs_new
        done += length
    return x


def half(side: Side, F, Z, M0, reg: float, cg_iters: int, product=None):
    """``argmin_M ½ Σ_Ω (f_rowᵀ M z_col − r)² + reg/2 ‖M‖²`` by ``cg``
    from M0, in F's dtype. ``product(a, b)``, where given, computes the
    CG operator's products (a lower precision's, for a control); else
    ``a @ b``."""
    mm = product or torch.matmul
    G, B = row_grams(side, Z)
    b = (F.T @ B).reshape(-1)
    shape = M0.shape

    def matvec(v):
        T = mm(F, v.view(shape))
        TG = mm(T.unsqueeze(1), G).squeeze(1)
        return (mm(F.T, TG) + reg * v.view(shape)).reshape(-1)

    return cg(matvec, b, M0.reshape(-1), cg_iters).view(shape)


def sse(users, items, vals, P, Q):
    """Σ (r − p_u · q_i)² over the ratings, for the projected tables
    P = X W and Q = Y H, in P's dtype."""
    total = torch.zeros((), dtype=P.dtype, device=P.device)
    for s in range(0, users.shape[0], _SSE_CHUNK):
        e = min(s + _SSE_CHUNK, users.shape[0])
        pred = (P[users[s:e]] * Q[items[s:e]]).sum(1)
        total += ((vals[s:e].to(P.dtype) - pred) ** 2).sum()
    return total


def objective(users, items, vals, X, Y, W, H, reg: float) -> float:
    """½ SSE + reg/2 (‖W‖² + ‖H‖²), in W's dtype."""
    return float(0.5 * sse(users, items, vals, X @ W, Y @ H)
                 + 0.5 * reg * ((W ** 2).sum() + (H ** 2).sum()))


def fit(users, items, vals, X, Y, W0, H0, reg: float, cg_iters: int,
        n_sweeps: int, dtype=torch.float64, product=None):
    """``n_sweeps`` sweeps from (W0, H0) in ``dtype``: (W, H, [objective
    after each sweep]). ``product``: see ``half``."""
    X, Y = X.to(dtype), Y.to(dtype)
    user_side = Side(users, items, vals, X.shape[0], dtype)
    item_side = Side(items, users, vals, Y.shape[0], dtype)
    W, H = W0.to(dtype), H0.to(dtype)
    history = []
    for _ in range(n_sweeps):
        W = half(user_side, X, Y @ H, W, reg, cg_iters, product)
        H = half(item_side, Y, X @ W, H, reg, cg_iters, product)
        history.append(objective(users, items, vals, X, Y, W, H, reg))
    return W, H, history


__all__ = ["Side", "row_grams", "cg", "half", "sse", "objective", "fit"]
