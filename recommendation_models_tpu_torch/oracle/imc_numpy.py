"""Reference-faithful NumPy IMC oracle (SURVEY.md §3.3, §4.2-1).

A copy of the JAX package's ``oracle/imc_numpy.py``, kept in the port so
that the port never imports that package. It imports only NumPy, so a host
without torch can load it by file path.

Inductive matrix completion: ``r_ui ≈ x_u^T W H^T y_i`` with side features
X (users), Y (items). Trained by alternating minimization; each subproblem
(quadratic in W with H fixed, and vice versa) is solved by conjugate
gradients on the normal equations — the same *objective*
``½‖P_Ω(R − X W H^T Y^T)‖² + λ/2(‖W‖²+‖H‖²)`` the reference minimizes.
"""

from __future__ import annotations

import numpy as np


def _cg(matvec, b, x0, iters=50, tol=1e-10):
    x = x0.copy()
    r = b - matvec(x)
    p = r.copy()
    rs = np.vdot(r, r)
    for _ in range(iters):
        Ap = matvec(p)
        denom = np.vdot(p, Ap)
        if denom <= 0:
            break
        a = rs / denom
        x += a * p
        r -= a * Ap
        rs_new = np.vdot(r, r)
        if rs_new < tol * max(1.0, np.vdot(b, b)):
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


class OracleIMC:
    def __init__(self, rank=8, reg=0.1, n_sweeps=10, cg_iters=50, seed=0,
                 init_scale=0.1):
        self.rank = rank
        self.reg = reg
        self.n_sweeps = n_sweeps
        self.cg_iters = cg_iters
        self.seed = seed
        self.init_scale = init_scale

    def _solve_W(self, users, items, r, X, Z, W0):
        """min_W ½ Σ_o (x_o^T W z_o − r_o)² + λ/2 ‖W‖²  via CG.

        matvec(W) = X^T M Z + λW with M = scatter-add of (x_o^T W z_o) z_o
        onto user rows (dense matmuls + segment sums — see SURVEY.md §3.3).
        """
        n_users = X.shape[0]

        def matvec(Wf):
            W = Wf.reshape(W0.shape)
            S = X @ W                                   # (n_users, k)
            s_obs = np.einsum("ok,ok->o", S[users], Z[items])
            M = np.zeros((n_users, Z.shape[1]))
            np.add.at(M, users, s_obs[:, None] * Z[items])
            return (X.T @ M + self.reg * W).ravel()

        M = np.zeros((n_users, Z.shape[1]))
        np.add.at(M, users, r[:, None] * Z[items])
        b = (X.T @ M).ravel()
        return _cg(matvec, b, W0.ravel(), self.cg_iters).reshape(W0.shape)

    def fit(self, users, items, ratings, X, Y, W0=None, H0=None):
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        r = np.asarray(ratings, np.float64)
        rng = np.random.default_rng(self.seed)
        k = self.rank
        W = (self.init_scale * rng.standard_normal((X.shape[1], k))
             if W0 is None else np.array(W0, np.float64))
        H = (self.init_scale * rng.standard_normal((Y.shape[1], k))
             if H0 is None else np.array(H0, np.float64))
        self.history_ = []
        for _ in range(self.n_sweeps):
            W = self._solve_W(users, items, r, X, Y @ H, W)
            H = self._solve_W(items, users, r, Y, X @ W, H)
            self.W_, self.H_ = W, H
            self.history_.append(self.objective(users, items, r, X, Y))
        return self

    def predict(self, users, items, X, Y):
        return np.einsum("ok,ok->o", X[users] @ self.W_, Y[items] @ self.H_)

    def objective(self, users, items, r, X, Y):
        pred = self.predict(users, items, X, Y)
        return float(0.5 * np.sum((r - pred) ** 2)
                     + 0.5 * self.reg * (np.sum(self.W_ ** 2)
                                         + np.sum(self.H_ ** 2)))

    def rmse(self, users, items, r, X, Y):
        pred = self.predict(users, items, X, Y)
        return float(np.sqrt(np.mean((r - pred) ** 2)))


__all__ = ["OracleIMC"]
