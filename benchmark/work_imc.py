"""Needed work of an IMC sweep, under ``work``'s conventions: each input
byte read once and each output byte written once; a gram as its lower
triangle, k(k + 1)/2 entries; a rating's gram and rhs terms as
``work.obs_flops``.

A half-step over the rows of F (n, d), the opposite projection Z, and the
factor M (d, k) runs:

- the row grams ``G_r = Σ z zᵀ`` and ``B_r = Σ r z`` of every rating
  (``work.gram_work``);
- the CG: ``cg_passes(cg_iters)`` operator passes
  ``M ↦ Fᵀ[(F M) ⊙_rows G] + λM`` (``matvec_work``), then the objective's
  pass ``Σ_r (F M)_r G_r (F M)_rᵀ`` (``objective_work``).

A sweep adds the projections ``Z = Y H`` and ``X W`` and the right-hand
sides ``Xᵀ B``, ``Yᵀ B`` (``sweep_flops``).
"""

from __future__ import annotations

import numpy as np

from benchmark import work

F32 = work.F32


def cg_passes(iters: int, restart: int = 16) -> int:
    """Operator passes of a restarted CG of ``iters`` steps: one a step and
    one true residual a restart block."""
    return iters + -(-iters // restart)


def matvec_work(n: int, d: int, k: int):
    """(FLOP, bytes) of one operator pass over n rows of F (n, d) with
    M (d, k): F M and Fᵀ T (2ndk FLOP each), the row grams' products
    (2nk²), the ridge term (2dk); F and the grams' triangles read once, M
    read and the result written once."""
    flops = 4.0 * n * d * k + 2.0 * n * k * k + 2.0 * d * k
    nbytes = (n * d + n * work.triangle(k) + 2 * d * k) * F32
    return flops, float(nbytes)


def objective_work(n: int, d: int, k: int):
    """(FLOP, bytes) of the objective's pass: T = F M (2ndk), the row grams'
    products and their dot with T (2nk² + 2nk); F, the grams' triangles and
    M read once."""
    flops = 2.0 * n * d * k + 2.0 * n * k * k + 2.0 * n * k
    nbytes = (n * d + n * work.triangle(k) + d * k) * F32
    return flops, float(nbytes)


def half_cg_work(n: int, d: int, k: int, cg_iters: int):
    """(FLOP, bytes) of one half-step's CG and objective's pass."""
    mf, mb = matvec_work(n, d, k)
    of, ob = objective_work(n, d, k)
    m = cg_passes(cg_iters)
    return m * mf + of, m * mb + ob


def cg_work(n_users: int, n_items: int, d_user: int, d_item: int, k: int,
            cg_iters: int):
    """(FLOP, bytes) of a sweep's two CG halves."""
    wf, wb = half_cg_work(n_users, d_user, k, cg_iters)
    hf, hb = half_cg_work(n_items, d_item, k, cg_iters)
    return wf + hf, wb + hb


def grams_work(users, items, n_users: int, n_items: int, k: int):
    """(FLOP, bytes) of a sweep's row grams: every rating in both halves,
    each half's rows with a rating and the distinct opposite rows read
    once (``work.gram_work``)."""
    users, items = np.asarray(users), np.asarray(items)
    nnz = int(users.shape[0])
    n_u = int(np.count_nonzero(np.bincount(users, minlength=n_users)))
    n_i = int(np.count_nonzero(np.bincount(items, minlength=n_items)))
    uf, ub = work.gram_work(nnz, n_u, n_i, k)
    itf, itb = work.gram_work(nnz, n_i, n_u, k)
    return uf + itf, ub + itb


def sweep_flops(nnz: int, n_users: int, n_items: int, d_user: int,
                d_item: int, k: int, cg_iters: int) -> float:
    """Needed FLOP of one IMC sweep: both halves' grams and CG, the two
    projections and the two right-hand sides."""
    products = 2.0 * 2.0 * k * (n_users * d_user + n_items * d_item)
    return (2.0 * work.obs_flops(nnz, k) + products
            + cg_work(n_users, n_items, d_user, d_item, k, cg_iters)[0])


__all__ = ["cg_passes", "matvec_work", "objective_work", "half_cg_work",
           "cg_work", "grams_work", "sweep_flops"]
