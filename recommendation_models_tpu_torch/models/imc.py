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

Spans (``utils.profiling``): ``imc.fit`` (a call of the whole fit),
``imc.sweep``, ``imc.half_sweep``; marks, written only under a profiler,
around a half-step's grams (``imc.grams``) and its CG with the objective's
pass (``imc.cg``); counters of the CG's operator passes
(``imc.cg_matvecs``: ``cg_matvec_count(cg_iters) + 1`` a half-step, the
objective's pass included), the gather slots the grams walk
(``imc.gather_slots``, padded rows times P) and the real ratings among them
(``imc.gather_ratings``).

Sharded fits: ``n_shards > 1`` row-shards the users (W step) and items (H
step) over ``get_mesh(n_shards, platform=...)`` (``sharded_sweep_fn``):
each shard accumulates its own rows' grams, and the (d, k) reductions of
the CG are summed over the shards; W and H stay replicated. Across
processes (``parallel.mesh.initialize_distributed``) each process holds
its own shards and runs the CG on the same sums. ``tol > 0``
then takes the host loop, as in the reference. After a sharded fit
``recommend`` serves the projected catalog row-sharded over the fit's mesh
through ``ops.topk.sharded_topk``; an estimator unpickled on a host with
fewer cards warns and serves on one device, and a mesh that cannot be built
raises.
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
    BaseEstimator, resolve_alias,
)
from recommendation_models_tpu_torch.ops.gram import (
    check_full_f32, full_f32, gram_rhs,
)
from recommendation_models_tpu_torch.ops.topk import (
    grouped_exclusion_topk, permuted_topk, serving_permutation, sharded_topk,
    topk_scores,
)
from recommendation_models_tpu_torch.parallel.mesh import (
    cuda_device_counts, get_mesh, shard_put,
)
from recommendation_models_tpu_torch.solver.als_sweep import (
    device_buckets, resolve_gather_budget,
)
from recommendation_models_tpu_torch.utils.checkpoint import (
    load_latest, save_checkpoint, wait_pending,
)
from recommendation_models_tpu_torch.utils.profiling import count, mark, span


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
        if "n_ratings" in b:
            count("imc.gather_slots", bsz * p)
            count("imc.gather_ratings", b["n_ratings"])
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
                  cg_iters: int, sharded: bool = False, mesh=None):
    """``min_M ½ Σ_Ω (f_rowᵀ M z_col − r)² + reg/2 ‖M‖²`` by restarted CG
    whose Hessian-apply is ``Fᵀ[(F M) ⊙_rows G] + reg M``: dense products,
    no gather inside the loop. Returns (M, sse(M)); the residual at the new
    M comes exactly from the same grams (the objective is quadratic).

    ``sharded``: F, Z and buckets are per-shard sequences over the 1-D
    ``mesh`` (each shard's row block of F, the gathered opposite
    projection and its buckets, on the shard's device, ``None`` for a
    shard of another process; ``n_rows`` the rows a shard; default mesh:
    one process over F's devices). Then b, r2, every matvec's ``Fᵀ T`` and
    quad are summed over the shards in shard order through the mesh's
    ``psum`` (the reference's) onto M0's device (the first local shard's),
    and the CG runs there in every process over the same summed values, as
    every shard of the reference holds them."""
    if not sharded:
        shards = ((F, Z, buckets),)

        def psum(parts):
            return parts[0]
    else:
        from recommendation_models_tpu_torch.parallel import mesh as pmesh
        if mesh is None:
            mesh = pmesh.Mesh([f.device for f in F])
        shards = tuple((F[s], Z[s], buckets[s]) for s in mesh.local)

        def psum(parts):
            full = [None] * mesh.size
            for s, part in zip(mesh.local, parts):
                full[s] = part
            return pmesh.psum(mesh, full)[mesh.local[0]].to(M0.device)

    with span("imc.half_sweep"):
        grams = []
        with mark("imc.grams"):
            for f, z, bk in shards:
                check_full_f32(f)
                grams.append(_factor_grams(z, bk, n_rows))
        b = psum([(f.T @ g[1]).reshape(-1)
                  for (f, _, _), g in zip(shards, grams)])
        r2 = psum([g[2] for g in grams])
        shape = M0.shape

        def row_gram(T, G):     # "ukl,uk->ul": T[u] @ G[u] for every row
            return torch.bmm(T.unsqueeze(1), G).squeeze(1)

        def matvec(Mf):
            count("imc.cg_matvecs")
            M = Mf.view(shape)
            return (psum([f.T @ row_gram(f @ M.to(f.device), g[0])
                          for (f, _, _), g in zip(shards, grams)])
                    + reg * M).reshape(-1)

        with mark("imc.cg"):
            M = _cg(matvec, b, M0.reshape(-1), cg_iters).view(shape)
            # the objective's pass: one more pass over the row grams
            count("imc.cg_matvecs")
            quad = []
            for (f, _, _), g in zip(shards, grams):
                T = f @ M.to(f.device)
                quad.append((row_gram(T, g[0]) * T).sum())
            sse = r2 - 2.0 * torch.dot(b, M.reshape(-1)) + psum(quad)
    return M, sse


def _imc_sweep(W, H, X, Y, ub, ib, reg: float, cg_iters: int, n_users: int,
               n_items: int):
    """One sweep: W given H, then H given the new W. Returns (W, H, obj)
    with obj = ½ sse + λ/2(‖W‖² + ‖H‖²) at the sweep's end state, a device
    scalar."""
    with span("imc.sweep"):
        W, _ = _solve_factor(X, Y @ H, ub, n_users, W, reg, cg_iters)
        H, sse = _solve_factor(Y, X @ W, ib, n_items, H, reg, cg_iters)
        obj = 0.5 * sse + 0.5 * reg * ((W ** 2).sum() + (H ** 2).sum())
    return W, H, obj


def _sweep_loop(sweep, W, H, n_sweeps: int, tol: float = 0.0):
    """The whole fit of ``sweep(W, H) -> (W, H, obj)``: (W, H, hist
    (n_sweeps,) on W's device, sweeps run).

    ``tol == 0`` runs every sweep and reads nothing back. ``tol > 0`` stops
    before sweep i >= 2 once ``|obj[i-2] − obj[i-1]| < tol``, compared in
    f32 on the device values as the JAX package's ``while_loop`` does (one
    flag read back per sweep); sweeps never run stay -1 in ``hist``. One
    call is one ``imc.fit`` span."""
    with span("imc.fit", call=True):
        hist = torch.full((n_sweeps,), -1.0, dtype=torch.float32,
                          device=W.device)
        i = 0
        while i < n_sweeps:
            if tol > 0 and i >= 2 and not bool(
                    torch.abs(hist[i - 2] - hist[i - 1]) >= tol):
                break
            W, H, hist[i] = sweep(W, H)
            i += 1
    return W, H, hist, i


def imc_fit(W, H, X, Y, ub, ib, reg: float, cg_iters: int, n_sweeps: int,
            n_users: int, n_items: int, tol: float = 0.0):
    """The whole single-device fit that ``IMC.fit`` runs: ``n_sweeps``
    sweeps of ``_imc_sweep`` from (W, H) on the device, over the users' and
    items' buckets uploaded by ``device_buckets`` (``ub``, ``ib``) and the
    device features X (n_users, d_user) and Y (n_items, d_item). Returns
    (W, H, hist (n_sweeps,) of the objective after each sweep, sweeps
    run); with ``tol == 0`` nothing is read back (``_sweep_loop``). Turns
    TF32 off first: the CG's products run in full f32."""
    full_f32()
    return _sweep_loop(
        lambda W, H: _imc_sweep(W, H, X, Y, ub, ib, reg, cg_iters, n_users,
                                n_items), W, H, n_sweeps, tol)


def sharded_sweep_fn(mesh, X, Y, user_layout, item_layout, reg: float,
                     cg_iters: int, rank: int):
    """The sharded IMC sweep on a 1-D ``mesh`` of S shards: (``sweep(W, H)
    -> (W, H, obj)``, the per-shard bytes of a sweep).

    Users (the W step) and items (the H step) are row-sharded: X and Y are
    padded to ``rows_per_shard · S`` rows, and each shard takes its rows'
    buckets of ``shard_layout(layout, S)``; each process holds its own
    shards. W and H stay replicated (one copy on the first local shard's
    device, in every process). A half-step gathers the projections of
    every shard's own feature rows (``Y_loc H``, rank wide, not the
    features) and solves ``_solve_factor(sharded=True)`` on the mesh. The
    bytes are the reference's analytic count: a half-step's tiled gather
    of the local projection, then the (d, k) sums of b and of each CG
    matvec, and two scalars, as a ring all-reduce, 2(S-1)/S of their
    bytes."""
    from recommendation_models_tpu_torch.data.layout import shard_layout
    from recommendation_models_tpu_torch.parallel.mesh import (
        all_gather, shard_put,
    )
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        put_buckets,
    )
    axis = mesh.axis_names[0]
    S = mesh.size
    ul = shard_layout(user_layout, S)
    il = shard_layout(item_layout, S)
    n_users, n_items = X.shape[0], Y.shape[0]

    def pad_rows(A, rows_per_shard):
        return np.pad(np.asarray(A, np.float32),
                      ((0, rows_per_shard * S - A.shape[0]), (0, 0)))

    Xs = shard_put(mesh, axis, pad_rows(X, ul.rows_per_shard))
    Ys = shard_put(mesh, axis, pad_rows(Y, il.rows_per_shard))
    ub, ib = put_buckets(mesh, axis, ul), put_buckets(mesh, axis, il)

    def tower(F, M, n):
        # the global projection F M on each shard: every shard projects
        # its own rows, then the (rows, k) results are gathered
        return tuple(None if t is None else t[:n] for t in all_gather(
            mesh, [None if f is None else f @ M.to(f.device) for f in F]))

    def sweep(W, H):
        with span("imc.sweep"):
            W, _ = _solve_factor(Xs, tower(Ys, H, n_items), ub,
                                 ul.rows_per_shard, W, reg, cg_iters,
                                 sharded=True, mesh=mesh)
            H, sse = _solve_factor(Ys, tower(Xs, W, n_users), ib,
                                   il.rows_per_shard, H, reg, cg_iters,
                                   sharded=True, mesh=mesh)
            obj = 0.5 * sse + 0.5 * reg * ((W ** 2).sum() + (H ** 2).sum())
        return W, H, obj

    mv = cg_matvec_count(cg_iters)
    ring = 2 * (S - 1) / S

    def half_bytes(rows_per_shard, d):
        gather = (S - 1) * rows_per_shard * rank * 4
        psum = int(ring * 4 * (d * rank * (mv + 1) + 2))
        return gather + psum

    out = {"w_step": half_bytes(il.rows_per_shard, X.shape[1]),
           "h_step": half_bytes(ul.rows_per_shard, Y.shape[1])}
    out["per_sweep_total"] = out["w_step"] + out["h_step"]
    return sweep, out


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
        optional warm starts. ``n_shards > 1`` fits on
        ``get_mesh(n_shards, platform=..., num_slices=...)``'s mesh."""
        return self._fit(R, X, Y, W0, H0, mesh=None)

    def _fit(self, R, X, Y, W0, H0, mesh):
        """``fit``; a sharded fit (``n_shards > 1``) runs on ``mesh`` (a
        1-D mesh of ``n_shards`` devices), None meaning ``get_mesh``'s. A
        one-card host runs S shards only through an explicit ``Mesh((cuda:0,)
        * S)``."""
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        sharded = bool(self.n_shards and self.n_shards > 1)
        if sharded:
            if mesh is None:
                mesh = get_mesh(self.n_shards, platform=self.platform,
                                num_slices=self.num_slices)
            if mesh.size != self.n_shards:
                raise ValueError(f"a mesh of {mesh.size} devices for "
                                 f"n_shards={self.n_shards}")
            device = mesh.devices[mesh.local[0]]
        else:
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
        W = torch.as_tensor(W_h, device=device)
        H = torch.as_tensor(H_h, device=device)
        xbytes = None
        if sharded:
            sweep, xbytes = sharded_sweep_fn(mesh, X, Y, user_layout,
                                             item_layout, reg, cg_iters,
                                             self.rank)
        else:
            ub = device_buckets(user_layout, 1, device)
            ib = device_buckets(item_layout, 1, device)
            Xd = torch.as_tensor(X, device=device)
            Yd = torch.as_tensor(Y, device=device)

            def sweep(W, H):
                return _imc_sweep(W, H, Xd, Yd, ub, ib, reg, cg_iters,
                                  n_users, n_items)

        # as the reference: a sharded fit with tol takes the host loop
        stepwise = bool(self.verbose
                        or (self.checkpoint_dir and self.checkpoint_every)
                        or (sharded and self.tol > 0))
        if not stepwise:
            if sharded:
                W, H, hist, n_done = _sweep_loop(sweep, W, H,
                                                 self._n_sweeps)
            else:
                W, H, hist, n_done = imc_fit(W, H, Xd, Yd, ub, ib, reg,
                                             cg_iters, self._n_sweeps,
                                             n_users, n_items,
                                             tol=float(self.tol))
            self.history_ = list(hist.cpu().numpy().astype(np.float64)
                                 [:n_done])
        else:
            # tol on the host's floats, async checkpoints, verbose prints
            self.history_ = []
            prev = None
            with span("imc.fit", call=True):
                for s in range(self._n_sweeps):
                    W, H, obj = sweep(W, H)
                    cur = float(obj)
                    self.history_.append(cur)
                    if self.verbose:
                        print(f"[IMC] sweep {s + 1}: objective={cur:.6f}")
                    self._maybe_checkpoint(s, W, H)
                    if (self.tol > 0 and prev is not None
                            and abs(prev - cur) < self.tol):
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
        self._veff_dev_cache = None
        # the route recommend() takes onto the fit's mesh
        self._fit_sharded_ = sharded
        self._serve_mesh = mesh if sharded else None
        if xbytes is None:
            self.__dict__.pop("exchange_bytes_per_sweep_", None)
        else:
            self.exchange_bytes_per_sweep_ = xbytes
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
        the next ``fit``. A sharded fit's serving route and caches are
        dropped too; the checkpoint holds the replicated W and H."""
        step, state = load_latest(checkpoint_dir or self.checkpoint_dir)
        for key in ("_X", "_Y", "_train_indptr", "_train_items",
                    "_veff_dev_cache", "_serve_mesh", "_fit_sharded_",
                    "exchange_bytes_per_sweep_"):
            self.__dict__.pop(key, None)
        self.W_ = np.asarray(state["W"])
        self.H_ = np.asarray(state["H"])
        self.history_ = list(np.asarray(state["history"]))
        self._veff_cache = None
        return step

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Picklable fitted estimator: the projected catalog's device copies
        and a sharded fit's mesh are dropped and rebuilt at the next
        ``recommend`` (``_serving_mesh``)."""
        state = dict(super().__getstate__())
        for key in ("_veff_cache", "_veff_dev_cache", "_serve_mesh"):
            state.pop(key, None)
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

    def _serving_mesh(self):
        """The mesh a sharded fit serves on: the fit's, or, for an
        estimator unpickled without it, ``get_mesh(n_shards, ...)`` on this
        host, which raises where it cannot be built (no card, say). The one
        exception: a host with fewer cards than ``n_shards`` warns and
        serves on one device (None)."""
        mesh = getattr(self, "_serve_mesh", None)
        if mesh is not None:
            return mesh
        if resolve_device(self.platform).type == "cuda":
            cards = sum(cuda_device_counts())
            if cards < self.n_shards:
                warnings.warn(
                    f"this IMC was fitted on {self.n_shards} shards, and "
                    f"this run has {cards} CUDA device(s): serving on one "
                    "device", stacklevel=3)
                return None
        return get_mesh(self.n_shards, platform=self.platform,
                        num_slices=self.num_slices)

    def _veff_dev_cached(self):
        """The projected training catalog ``_Y @ H_`` row-sharded over the
        serving mesh, for serving after a sharded fit: (the per-shard
        blocks in ``serving_permutation`` row order, padded with zero rows
        to ``per · S``, mesh, axis, perm_back, perm_fwd), cached under
        ``_veff_cached``'s key; None where ``_serving_mesh`` serves on one
        device."""
        h_key = hash(np.asarray(self.H_).tobytes())
        cache = getattr(self, "_veff_dev_cache", None)
        if cache is not None and cache[0] == h_key and cache[1] is self._Y:
            return cache[2]
        mesh = self._serving_mesh()
        if mesh is None:
            return None
        axis = mesh.axis_names[0]
        S = mesh.size
        n = self._Y.shape[0]
        perm_back, perm_fwd = serving_permutation(n)
        veff = np.asarray((self._Y @ self.H_)[perm_back], np.float32)
        per = -(-n // S)
        veff = np.pad(veff, ((0, per * S - n), (0, 0)))
        out = (shard_put(mesh, axis, veff), mesh, axis, perm_back, perm_fwd)
        self._veff_dev_cache = (h_key, self._Y, out)
        return out

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
        X = self._X if X is None else np.asarray(X, np.float32)
        fresh_Y = Y is not None
        Y = self._Y if Y is None else np.asarray(Y, np.float32)
        user_ids = np.atleast_1d(np.asarray(user_ids, np.int64))

        sharded = None
        if not fresh_Y and getattr(self, "_fit_sharded_", False):
            # after a sharded fit, serving stays on the mesh: the projected
            # catalog is row-sharded and each shard scores its own rows
            sharded = self._veff_dev_cached()
        if sharded is not None:
            Veff_sh, mesh, axis, perm_back, perm_fwd = sharded
            device = mesh.devices[mesh.local[0]]
            n_cat = Y.shape[0]
            n = min(n, n_cat)

            def topk_raw(Uq, kk, excl):
                return sharded_topk(Uq, Veff_sh, kk, mesh, axis=axis,
                                    exclude=excl, method=method,
                                    recall_target=recall_target,
                                    n_valid=n_cat)
        else:
            device = resolve_device(self.platform)
            if fresh_Y:
                # a fresh catalog gets its own decorrelating permutation
                perm_back, perm_fwd = serving_permutation(Y.shape[0])
                Veff = torch.as_tensor((Y @ self.H_)[perm_back],
                                       device=device)
            else:
                Veff, perm_back, perm_fwd, _ = self._veff_cached()
            n = min(n, Veff.shape[0])

            def topk_raw(Uq, kk, excl):
                return topk_scores(Uq, Veff, kk, excl, method=method,
                                   recall_target=recall_target)
        if device.type == "cuda":
            full_f32()
        topk = permuted_topk(topk_raw, perm_back, perm_fwd)

        def query_rows(ids):
            return torch.as_tensor(X[ids] @ self.W_, device=device)

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


__all__ = ["IMC", "cg_matvec_count", "gram_block_rows", "imc_fit",
           "sharded_sweep_fn"]
