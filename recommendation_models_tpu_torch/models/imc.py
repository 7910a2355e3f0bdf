"""IMC estimator of the PyTorch port: inductive matrix completion with side
features, on one device.

Model: ``r_ui ≈ x_uᵀ W Hᵀ y_i`` with dense feature matrices X (users) and Y
(items), so rows never seen in training are scored through their features.
Objective: ``½‖P_Ω(R − X W Hᵀ Yᵀ)‖² + λ/2(‖W‖² + ‖H‖²)``, minimised by
alternating over W and H. With ``z_i = (Y H)_i`` the W subproblem's Hessian
groups by user,

    Σ_o x_o x_oᵀ W z_o z_oᵀ = Xᵀ [(X W) ⊙_rows G],  G_u = Σ_{i ∈ Ω_u} z_i z_iᵀ,

so each half-step accumulates the per-row (rank × rank) grams once, with the
ALS layout's padded gathers (``ops.gram.gram_rhs``), and each conjugate-
gradient step is then three dense products and no gather. Every product
runs in full f32 (TF32 off): CG iterates against one operator, and a
rounded operator stalls it well above the f64 oracle's objective.

The same surface as the JAX package's ``IMC`` (same kwargs, so
``get_params()`` is identical), NumPy in and out. The fit runs on the CUDA
card unless ``platform='cpu'``. With no ``tol``, ``verbose`` or checkpoint,
the whole fit reads nothing back until its history; ``tol > 0`` reads one
flag per sweep. ``verbose`` and checkpoints take a host loop over sweeps.
Serving (``recommend``, ``top_n``) scores the projected catalog ``Y H`` with
``ops.topk`` on the estimator's device.

Not ported yet: sharded fits (``n_shards > 1`` raises
``NotImplementedError``).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.config import (
    DataConfig, bucket_growth_for_rank,
)
from recommendation_models_tpu_torch.data.layout import (
    csr_arrays, layout_from_coo,
)
from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.evaluate import grouped_by_user
from recommendation_models_tpu_torch.models.base import (
    BaseEstimator, not_ported, resolve_alias,
)
from recommendation_models_tpu_torch.ops.gram import (
    check_full_f32, full_f32, gram_rhs,
)
from recommendation_models_tpu_torch.ops.topk import (
    grouped_exclusion_topk, permuted_topk, serving_permutation, topk_scores,
)
from recommendation_models_tpu_torch.solver.als_sweep import (
    device_buckets, resolve_gather_budget,
)
from recommendation_models_tpu_torch.utils.checkpoint import (
    load_latest, save_checkpoint, wait_pending,
)


def _as_triplets(R) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if isinstance(R, tuple) and len(R) == 3:
        u, i, r = R
        return (np.asarray(u, np.int32), np.asarray(i, np.int32),
                np.asarray(r, np.float32))
    indptr, indices, data, n_users, _ = csr_arrays(R)
    users = np.repeat(np.arange(n_users, dtype=np.int32), np.diff(indptr))
    return users, indices.astype(np.int32), data


def gram_block_rows(p: int, k: int, budget_mb: int, chunk: int = 512) -> int:
    """Rows of one gram block of a bucket of width ``p``: the gathered
    ``(rows, min(p, chunk), k)`` f32 temporary stays under ``budget_mb``."""
    return max(8, (budget_mb * (1 << 20)) // (min(p, chunk) * k * 4)
               // 8 * 8)


def _factor_grams(Z, buckets, n_rows: int, chunk: int = 512,
                  gather_budget_mb: int = 0):
    """Per-row grams ``G (n_rows, k, k) = Σ_Ω z zᵀ``, ``RHS (n_rows, k) =
    Σ_Ω r z`` and ``Σ r²``, from one gather of Z's rows per observation.

    Buckets go in row blocks that keep the gathered ``(rows, chunk, k)``
    temporary under the gather budget (auto: the SSE pass's, at least 8
    MB). Each block's grams are added into G by row id. Padding rows carry
    the id ``n_rows`` and go to one extra row that is sliced off; a real
    row lies in exactly one bucket, so it takes exactly one add onto zero,
    and G is the same bitwise whatever order the adds land in."""
    k = Z.shape[-1]
    dev = Z.device
    budget_mb = resolve_gather_budget(gather_budget_mb, k, buckets,
                                      for_sse=True)
    G = torch.zeros((n_rows + 1, k, k), dtype=torch.float32, device=dev)
    RHS = torch.zeros((n_rows + 1, k), dtype=torch.float32, device=dev)
    r2 = torch.zeros((), dtype=torch.float32, device=dev)
    for b in buckets:
        idx, mask, values, rid = (b["indices"], b["mask"], b["values"],
                                  b["row_ids"])
        bsz, p = idx.shape
        bb = gram_block_rows(p, k, budget_mb, chunk)
        wr = mask * values
        for s in range(0, bsz, bb):
            e = min(s + bb, bsz)
            g, r = gram_rhs(Z, idx[s:e], mask[s:e], wr[s:e], chunk=chunk)
            G.index_add_(0, rid[s:e], g)
            RHS.index_add_(0, rid[s:e], r)
            r2 = r2 + (mask[s:e] * values[s:e] ** 2).sum()
    return G[:n_rows], RHS[:n_rows], r2


def _solve_factor(F, Z, buckets, n_rows: int, M0, reg: float,
                  cg_iters: int):
    """``min_M ½ Σ_Ω (f_rowᵀ M z_col − r)² + reg/2 ‖M‖²`` by restarted CG
    whose Hessian-apply is ``Fᵀ[(F M) ⊙_rows G] + reg M``: dense products,
    no gather inside the loop. Returns (M, sse(M)); the residual at the new
    M comes exactly from the same grams (the objective is quadratic)."""
    check_full_f32(F)
    G, RHS, r2 = _factor_grams(Z, buckets, n_rows)
    b = (F.T @ RHS).reshape(-1)
    shape = M0.shape

    def row_gram(T):            # "ukl,uk->ul": T[u] @ G[u] for every row
        return torch.bmm(T.unsqueeze(1), G).squeeze(1)

    def matvec(Mf):
        M = Mf.view(shape)
        return (F.T @ row_gram(F @ M) + reg * M).reshape(-1)

    M = _cg(matvec, b, M0.reshape(-1), cg_iters).view(shape)
    T = F @ M
    quad = (row_gram(T) * T).sum()
    sse = r2 - 2.0 * torch.dot(b, M.reshape(-1)) + quad
    return M, sse


def _imc_sweep(W, H, X, Y, ub, ib, reg: float, cg_iters: int, n_users: int,
               n_items: int):
    """One sweep: W given H, then H given the new W. Returns (W, H, obj)
    with obj = ½ sse + λ/2(‖W‖² + ‖H‖²) at the sweep's end state, a device
    scalar."""
    W, _ = _solve_factor(X, Y @ H, ub, n_users, W, reg, cg_iters)
    H, sse = _solve_factor(Y, X @ W, ib, n_items, H, reg, cg_iters)
    obj = 0.5 * sse + 0.5 * reg * ((W ** 2).sum() + (H ** 2).sum())
    return W, H, obj


def _imc_fit(W, H, X, Y, ub, ib, reg: float, cg_iters: int, n_sweeps: int,
             n_users: int, n_items: int, tol: float = 0.0):
    """The whole fit: (W, H, hist (n_sweeps,) on the device, sweeps run).

    ``tol == 0`` runs every sweep and reads nothing back. ``tol > 0`` stops
    before sweep i >= 2 once ``|obj[i-2] − obj[i-1]| < tol``, compared in
    f32 on the device values as the JAX package's ``while_loop`` does (one
    flag read back per sweep); sweeps never run stay -1 in ``hist``."""
    hist = torch.full((n_sweeps,), -1.0, dtype=torch.float32,
                      device=W.device)
    i = 0
    while i < n_sweeps:
        if tol > 0 and i >= 2 and not bool(
                torch.abs(hist[i - 2] - hist[i - 1]) >= tol):
            break
        W, H, hist[i] = _imc_sweep(W, H, X, Y, ub, ib, reg, cg_iters,
                                   n_users, n_items)
        i += 1
    return W, H, hist, i


def _cg(matvec, b, x0, iters: int, restart: int = 16):
    """Conjugate gradients with a true-residual restart every ``restart``
    steps: in f32 the recurrence residual drifts from ``b − A x``, and the
    restarts keep the solve on the f64 oracle's track.

    Runs exactly ``iters`` CG steps (the last block is ``iters % restart``
    long) plus one true-residual matvec per block: ``cg_matvec_count``
    matvecs. The step sizes stay device tensors (no host sync): a step
    with ``pᵀAp <= 0`` or ``rᵀr = 0`` takes a zero step, as the JAX
    package's ``where`` does."""

    def block(x, length):
        r = b - matvec(x)
        p = r
        rs = torch.dot(r, r)
        for _ in range(length):
            Ap = matvec(p)
            denom = torch.dot(p, Ap)
            a = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30),
                            0.0)
            x = x + a * p
            r = r - a * Ap
            rs_new = torch.dot(r, r)
            beta = torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30),
                               0.0)
            p = r + beta * p
            rs = rs_new
        return x

    x = x0
    done = 0
    while done < iters:
        step = min(restart, iters - done)
        x = block(x, step)
        done += step
    return x


def cg_matvec_count(iters: int, restart: int = 16) -> int:
    """Matvecs one ``_cg`` call performs: ``iters`` CG steps plus one
    true-residual matvec per restart block."""
    return iters + -(-iters // restart)


class IMC(BaseEstimator):
    """Inductive matrix completion with side features, sklearn-style.

    Parameters mirror the JAX package's estimator. ``platform``: None (the
    card) or 'cpu'. The default init draws W, then H, from NumPy
    ``default_rng(seed)``, scaled by ``init_scale`` and cast to f32, as the
    JAX package does."""

    def __init__(
        self,
        rank: int = 8,
        reg: Optional[float] = None,        # None => 0.1 (alias sentinel)
        n_sweeps: Optional[int] = None,     # None => 10 (alias sentinel)
        tol: float = 0.0,
        cg_iters: int = 50,
        seed: int = 0,
        init_scale: float = 0.1,
        n_shards: Optional[int] = None,
        num_slices: Optional[int] = None,
        platform: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        layout_cache: Optional[str] = None,
        verbose: int = 0,
        lambda_: Optional[float] = None,
        max_iter: Optional[int] = None,
    ):
        self.rank = rank
        self.reg = reg
        self.n_sweeps = n_sweeps
        self.tol = tol
        self.cg_iters = cg_iters
        self.seed = seed
        self.init_scale = init_scale
        self.n_shards = n_shards
        self.num_slices = num_slices
        self.platform = platform
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.layout_cache = layout_cache
        self.verbose = verbose
        # reference-name aliases; take precedence over reg / n_sweeps
        self.lambda_ = lambda_
        self.max_iter = max_iter

    @property
    def _reg(self) -> float:
        return resolve_alias(self.reg, self.lambda_, 0.1, "reg", "lambda_")

    @property
    def _n_sweeps(self) -> int:
        return resolve_alias(self.n_sweeps, self.max_iter, 10,
                             "n_sweeps", "max_iter")

    # ------------------------------------------------------------------
    def _build_layouts(self, users, items, ratings, n_users, n_items, dcfg):
        """Both orientations' padded layouts, optionally through the packed
        on-disk cache: tagged by the full DataConfig and, with a prefix, a
        fingerprint of the observations and the table sizes (which come
        from X and Y, not from the triplets)."""
        from recommendation_models_tpu_torch.data.layout_cache import (
            cached_layout, config_tag, data_fingerprint,
        )

        def build_user():
            return layout_from_coo(users, items, ratings, n_users, n_items,
                                   dcfg)

        def build_item():
            return layout_from_coo(users, items, ratings, n_users, n_items,
                                   dcfg, transpose=True)

        prefix = self.layout_cache
        tag = f".imc.cfg{config_tag(dcfg)}"
        if prefix:
            tag += "." + data_fingerprint(
                users, items, ratings,
                np.asarray([n_users, n_items], np.int64))
        return (cached_layout(f"{prefix}{tag}.user.npz" if prefix else None,
                              build_user),
                cached_layout(f"{prefix}{tag}.item.npz" if prefix else None,
                              build_item))

    def _data_config(self) -> DataConfig:
        """The layout of the gram pass: gather buckets only, with no
        dense-whale block and no hot columns (wide buckets take the whale
        rows), and the rank's bucket growth."""
        return DataConfig(dense_whales=False, hot_cols=0,
                          bucket_growth=bucket_growth_for_rank(self.rank))

    def _init_factors_host(self, d_user: int, d_item: int, W0=None,
                           H0=None):
        """(W, H) as f32 host arrays: a warm start where given, else the next
        draw of ``default_rng(seed)`` (W first), scaled, then cast."""
        rng = np.random.default_rng(self.seed)
        out = []
        for M0, d in ((W0, d_user), (H0, d_item)):
            out.append(np.asarray(M0, np.float32) if M0 is not None else
                       (self.init_scale * rng.standard_normal(
                           (d, self.rank))).astype(np.float32))
        return tuple(out)

    def fit(self, R, X, Y, W0=None, H0=None):
        """Fit W, H on the observations of R with user features X and item
        features Y.

        R: scipy sparse or dense matrix, or a (users, items, ratings)
        triplet tuple. X: (n_users, d_user), Y: (n_items, d_item). W0, H0:
        optional warm starts."""
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.n_shards is not None and self.n_shards > 1:
            raise not_ported("a sharded IMC fit (n_shards > 1)",
                             "Queue 1 item 13d", "IMC")
        device = resolve_device(self.platform)
        users, items, ratings = _as_triplets(R)
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        n_users, n_items = X.shape[0], Y.shape[0]
        if users.size and (users.max() >= n_users or items.max() >= n_items):
            raise ValueError(
                f"observation ids exceed feature rows: max user "
                f"{users.max()} vs X rows {n_users}, max item {items.max()} "
                f"vs Y rows {n_items}")
        if users.size and (users.min() < 0 or items.min() < 0):
            raise ValueError(
                f"observation ids must be non-negative; got min user "
                f"{users.min()}, min item {items.min()}")

        user_layout, item_layout = self._build_layouts(
            users, items, ratings, n_users, n_items, self._data_config())
        reg, cg_iters = float(self._reg), int(self.cg_iters)
        W_h, H_h = self._init_factors_host(X.shape[1], Y.shape[1], W0, H0)

        full_f32()
        ub = device_buckets(user_layout, 1, device)
        ib = device_buckets(item_layout, 1, device)
        Xd = torch.as_tensor(X, device=device)
        Yd = torch.as_tensor(Y, device=device)
        W = torch.as_tensor(W_h, device=device)
        H = torch.as_tensor(H_h, device=device)

        stepwise = bool(self.verbose
                        or (self.checkpoint_dir and self.checkpoint_every))
        if not stepwise:
            W, H, hist, n_done = _imc_fit(W, H, Xd, Yd, ub, ib, reg,
                                          cg_iters, self._n_sweeps, n_users,
                                          n_items, tol=float(self.tol))
            self.history_ = list(hist.cpu().numpy().astype(np.float64)
                                 [:n_done])
        else:
            # tol on the host's floats, async checkpoints, verbose prints
            self.history_ = []
            prev = None
            for s in range(self._n_sweeps):
                W, H, obj = _imc_sweep(W, H, Xd, Yd, ub, ib, reg, cg_iters,
                                       n_users, n_items)
                cur = float(obj)
                self.history_.append(cur)
                if self.verbose:
                    print(f"[IMC] sweep {s + 1}: objective={cur:.6f}")
                self._maybe_checkpoint(s, W, H)
                if self.tol > 0 and prev is not None and abs(prev - cur) < self.tol:
                    break
                prev = cur
            self._finish_checkpoints()

        self.W_ = W.cpu().numpy()
        self.H_ = H.cpu().numpy()
        self._X, self._Y = X, Y
        # seen items per user for recommend(exclude_seen=True), set last
        # with the factors: a refit that fails partway leaves the previous
        # fit's serving state whole
        self._train_indptr, self._train_items = grouped_by_user(
            users, items, n_users)
        self._veff_cache = None
        return self

    # ------------------------------------------------------------------
    def _finish_checkpoints(self):
        if self.checkpoint_dir and self.checkpoint_every:
            wait_pending()

    def _maybe_checkpoint(self, sweep_idx, W, H):
        """Save W, H and the history after every ``checkpoint_every``-th
        sweep, with the scalar hyperparameters as metadata (copied to the
        host before the call returns, written on the background thread)."""
        if not self.checkpoint_dir or not self.checkpoint_every:
            return
        if (sweep_idx + 1) % self.checkpoint_every:
            return
        save_checkpoint(
            self.checkpoint_dir, step=sweep_idx + 1,
            state=dict(W=W, H=H,
                       history=np.asarray(self.history_, np.float32)),
            metadata={k: v for k, v in self.get_params().items()
                      if isinstance(v, (int, float, str, bool, type(None)))},
            wait=False)

    def resume(self, checkpoint_dir: Optional[str] = None):
        """Load W, H and the sweep history of the newest checkpoint; returns
        its step (pass ``W0=model.W_, H0=model.H_`` to the next ``fit`` to
        continue).

        Checkpoints hold no features and no observations, so a previous
        fit's features, training lists and projected catalog are dropped:
        ``predict`` and ``recommend`` then need X and Y passed, and
        ``recommend(exclude_seen=True)`` warns and serves unfiltered until
        the next ``fit``."""
        step, state = load_latest(checkpoint_dir or self.checkpoint_dir)
        for key in ("_X", "_Y", "_train_indptr", "_train_items"):
            self.__dict__.pop(key, None)
        self.W_ = np.asarray(state["W"])
        self.H_ = np.asarray(state["H"])
        self.history_ = list(np.asarray(state["history"]))
        self._veff_cache = None
        return step

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Picklable fitted estimator: the projected catalog's device copy
        is dropped and rebuilt at the next ``recommend``."""
        state = dict(super().__getstate__())
        state.pop("_veff_cache", None)
        return state

    def _check_fitted(self):
        if not hasattr(self, "W_"):
            raise RuntimeError("this IMC instance is not fitted yet")

    def _features(self, X, Y):
        """(X, Y) resolved against the training features, with a guided
        error where there are none (a resumed estimator)."""
        if (X is None and not hasattr(self, "_X")) or (
                Y is None and not hasattr(self, "_Y")):
            raise RuntimeError(
                "feature matrices unavailable: this estimator was resumed "
                "from a checkpoint without training features — pass X and "
                "Y explicitly (or call fit())")
        X = self._X if X is None else np.asarray(X, np.float32)
        Y = self._Y if Y is None else np.asarray(Y, np.float32)
        return X, Y

    def predict(self, users, items, X=None, Y=None) -> np.ndarray:
        """Predicted ratings; pass fresh X/Y rows for cold-start entities
        (users/items then index into the given matrices)."""
        self._check_fitted()
        X, Y = self._features(X, Y)
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        return np.einsum("ok,ok->o", X[users] @ self.W_, Y[items] @ self.H_)

    def predict_all(self, user: int, X=None, Y=None) -> np.ndarray:
        """Scores of every item for one user; pass a fresh 1-row ``X`` for
        a cold-start user. With the training Y it reads the cached
        catalog-order projection."""
        self._check_fitted()
        X, Y = self._features(X, Y)
        if Y is getattr(self, "_Y", None):
            Veff = self._veff_cached()[3]
            return Veff @ (X[user] @ self.W_)
        return (X[user] @ self.W_) @ (Y @ self.H_).T

    def rmse(self, R, X=None, Y=None) -> float:
        users, items, ratings = _as_triplets(R)
        pred = self.predict(users, items, X, Y)
        return float(np.sqrt(np.mean((ratings - pred) ** 2)))

    def score(self, R, X=None, Y=None) -> float:
        """Negative RMSE over observed entries (higher is better)."""
        return -self.rmse(R, X, Y)

    def _veff_cached(self):
        """The projected training catalog ``_Y @ H_``: (the device copy in
        ``serving_permutation`` row order, perm_back, perm_fwd, the host
        copy in catalog order), cached across calls.

        Keyed on H_'s content (hashing it costs microseconds), on _Y's
        identity (the cache holds _Y, so its id cannot be recycled) and on
        the device: any swap or in-place change of H_, any swap of _Y, and
        a change of ``platform`` rebuild it. In-place edits of _Y are the
        caller's to announce (by a swap)."""
        device = resolve_device(self.platform)
        h_key = hash(np.asarray(self.H_).tobytes())
        cache = getattr(self, "_veff_cache", None)
        if (cache is None or cache[0] != h_key or cache[1] is not self._Y
                or cache[2][0].device.type != device.type):
            perm_back, perm_fwd = serving_permutation(self._Y.shape[0])
            veff = self._Y @ self.H_
            self._veff_cache = (h_key, self._Y, (
                torch.as_tensor(veff[perm_back], device=device),
                perm_back, perm_fwd, veff))
        return self._veff_cache[2]

    def recommend(self, user_ids, n: int = 10, X=None, Y=None,
                  exclude_seen: bool = False, method: str = "auto",
                  recall_target: float = 0.99):
        """Top-n items by bilinear score (cold-start capable via X/Y): NumPy
        (scores (B, n), items (B, n)).

        The model is a rank-k dot product after projection (U_eff = X W,
        V_eff = Y H), so it serves through ``ops.topk`` like ALS; selection
        is exact for every ``method``. ``exclude_seen`` drops the training
        items of training users; fresh X rows (another user space) and a
        fresh Y (another catalog) are served unfiltered."""
        self._check_fitted()
        if (X is None and not hasattr(self, "_X")) or (
                Y is None and not hasattr(self, "_Y")):
            raise RuntimeError(
                "recommend() needs feature matrices: this estimator was "
                "resumed from a checkpoint without training features — "
                "pass X and Y explicitly (or call fit())")
        device = resolve_device(self.platform)
        if device.type == "cuda":
            full_f32()
        X = self._X if X is None else np.asarray(X, np.float32)
        fresh_Y = Y is not None
        Y = self._Y if Y is None else np.asarray(Y, np.float32)
        user_ids = np.atleast_1d(np.asarray(user_ids, np.int64))

        def query_rows(ids):
            return torch.as_tensor(X[ids] @ self.W_, device=device)

        if fresh_Y:
            # a fresh catalog gets its own decorrelating permutation
            perm_back, perm_fwd = serving_permutation(Y.shape[0])
            Veff = torch.as_tensor((Y @ self.H_)[perm_back], device=device)
        else:
            Veff, perm_back, perm_fwd, _ = self._veff_cached()
        n = min(n, Veff.shape[0])

        def topk_raw(Uq, kk, excl):
            return topk_scores(Uq, Veff, kk, excl, method=method,
                               recall_target=recall_target)
        topk = permuted_topk(topk_raw, perm_back, perm_fwd)

        if exclude_seen and not hasattr(self, "_train_indptr"):
            warnings.warn(
                "recommend(exclude_seen=True) on an estimator without "
                "training indices (e.g. resumed from a checkpoint): seen "
                "items canNOT be excluded; serving unfiltered scores. "
                "Call fit() to restore exclusion.", stacklevel=2)
        if exclude_seen and fresh_Y:
            # training item ids address the training catalog's rows, not
            # a fresh Y's
            warnings.warn(
                "recommend(exclude_seen=True) with a fresh Y catalog: "
                "seen-item exclusion applies to the training catalog "
                "only; serving unfiltered scores over the new catalog.",
                stacklevel=2)
        if (exclude_seen and hasattr(self, "_train_indptr") and not fresh_Y
                and X is getattr(self, "_X", None) and user_ids.size):
            return grouped_exclusion_topk(user_ids, n, self._train_indptr,
                                          self._train_items, query_rows,
                                          topk)
        return topk(query_rows(user_ids), n, None)

    def top_n(self, user: int, n: int = 10, exclude_seen: bool = False):
        """Single-user convenience: ranked item ids."""
        _, items = self.recommend([user], n, exclude_seen=exclude_seen)
        return items[0]


__all__ = ["IMC", "cg_matvec_count", "gram_block_rows"]
