"""Reference-faithful NumPy/SciPy ALS oracle (SURVEY.md §4.2-1).

A copy of the JAX package's ``oracle/als_numpy.py``, kept in the port so
that the port never imports that package. It imports only NumPy and SciPy,
so a host without torch can load it by file path.

It mirrors the *reference's* implementation shape — CSR rating storage,
Python per-row loops, per-row gram accumulation and ``scipy.linalg.solve``
(SURVEY.md §3.1, [B:5]) — not the port's design. It is a parity oracle and
the measured CPU baseline of ``vs_baseline``.

Do not optimize this file: its per-row loop structure IS the baseline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg
import scipy.sparse as sp


class OracleALS:
    """Explicit / implicit alternating least squares, reference-style."""

    def __init__(self, rank=10, reg=0.1, alpha: Optional[float] = None,
                 n_sweeps=10, reg_by_degree=False, seed=0, init_scale=0.01):
        self.rank = rank
        self.reg = reg
        self.alpha = alpha
        self.n_sweeps = n_sweeps
        self.reg_by_degree = reg_by_degree
        self.seed = seed
        self.init_scale = init_scale

    # -- per-row solve: the reference's hot loop body (SURVEY.md §3.1) -----
    def _solve_rows(self, R: sp.csr_matrix, V: np.ndarray) -> np.ndarray:
        n_rows = R.shape[0]
        k = self.rank
        U = np.zeros((n_rows, k), dtype=np.float64)
        G0 = V.T @ V if self.alpha is not None else None
        for u in range(n_rows):                      # Python per-row loop
            lo, hi = R.indptr[u], R.indptr[u + 1]
            idx = R.indices[lo:hi]
            r = R.data[lo:hi].astype(np.float64)
            reg = self.reg * max(len(idx), 1) if self.reg_by_degree else self.reg
            if self.alpha is None:
                if len(idx) == 0:
                    continue
                Vo = V[idx]
                G = Vo.T @ Vo + reg * np.eye(k)
                b = Vo.T @ r
            else:
                Vo = V[idx]
                cm1 = self.alpha * r                  # c - 1
                G = G0 + (Vo.T * cm1) @ Vo + reg * np.eye(k)
                b = Vo.T @ (1.0 + self.alpha * r)     # c * p, p = 1
            U[u] = scipy.linalg.solve(G, b, assume_a="pos")
        return U

    def init_factors(self, n_users, n_items):
        rng = np.random.default_rng(self.seed)
        U = (self.init_scale * rng.standard_normal((n_users, self.rank))
             ).astype(np.float64)
        V = (self.init_scale * rng.standard_normal((n_items, self.rank))
             ).astype(np.float64)
        return U, V

    def fit(self, R, U0=None, V0=None, n_sweeps=None):
        R = sp.csr_matrix(R)
        Rt = sp.csr_matrix(R.T)
        n_users, n_items = R.shape
        if U0 is None or V0 is None:
            self.U_, self.V_ = self.init_factors(n_users, n_items)
        else:
            self.U_, self.V_ = np.array(U0, np.float64), np.array(V0, np.float64)
        self.history_ = []
        for _ in range(self.n_sweeps if n_sweeps is None else n_sweeps):
            self.U_ = self._solve_rows(R, self.V_)
            self.V_ = self._solve_rows(Rt, self.U_)
            self.history_.append(self.train_rmse(R))
        return self

    def half_sweep(self, R, V):
        """One user-side half-sweep given V — for tight per-sweep parity tests."""
        return self._solve_rows(sp.csr_matrix(R), np.asarray(V, np.float64))

    def predict(self, users, items):
        return np.einsum("ok,ok->o", self.U_[users], self.V_[items])

    def train_rmse(self, R: sp.csr_matrix) -> float:
        coo = R.tocoo()
        pred = self.predict(coo.row, coo.col)
        return float(np.sqrt(np.mean((coo.data - pred) ** 2)))

    def score(self, R_test) -> float:
        """Negative RMSE over the test entries (higher is better, sklearn
        convention; SURVEY.md §0 item 5 — semantics documented, not bitwise
        reference-verified)."""
        coo = sp.coo_matrix(R_test)
        pred = self.predict(coo.row, coo.col)
        return -float(np.sqrt(np.mean((coo.data - pred) ** 2)))

    def top_n(self, user: int, n: int, exclude: Optional[np.ndarray] = None):
        s = self.U_[user] @ self.V_.T
        if exclude is not None:
            s[exclude] = -np.inf
        return np.argsort(-s)[:n]


__all__ = ["OracleALS"]
