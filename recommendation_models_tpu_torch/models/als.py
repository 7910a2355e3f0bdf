"""ALS estimator of the PyTorch port: the single-device fit.

The same sklearn-style surface as the JAX package's ``ALS`` (same kwargs,
so ``get_params()`` is identical), with NumPy / scipy.sparse in and NumPy
out. The fit runs on the CUDA card unless ``platform='cpu'``; with no card
and no ``platform``, ``fit`` raises rather than run on the host.

Objectives: ``alpha=None`` is explicit least squares on ratings, ``alpha=a``
the Hu-Koren-Volinsky confidence-weighted implicit objective. ``score``
returns the negative RMSE.

Serving (``recommend``, ``top_n``) runs ``ops.topk`` on the estimator's
device against a cached copy of the catalog in the serving permutation's
row order, with exact selection whatever ``method`` says.

Checkpoints: with ``checkpoint_dir`` and ``checkpoint_every``, ``fit``
saves the factors and the history after every ``checkpoint_every``-th
sweep (``utils.checkpoint``, on a background thread; ``fit`` waits for the
last write), and ``resume`` loads the newest checkpoint.

Sharded fits: ``n_shards > 1`` runs ``parallel.sharded_als`` on
``parallel.mesh.get_mesh(n_shards, platform=...)`` (S entries of the host
with ``platform='cpu'``, else the first S cards; fewer cards than asked
raise ``ValueError``), with ``exchange`` 'allgather', 'all_to_all' or
'hybrid'. The fitted tables stay on the mesh, padded and row-sharded;
``U_`` and ``V_`` are host copies made at first access, and ``recommend``
serves through ``ops.topk.sharded_topk`` without a whole-table host copy.
Across processes (``parallel.mesh.initialize_distributed``) the first
access of ``U_`` or ``V_``, ``recommend``, pickling and the checkpoints
are collectives: every process must make them, in the same order.
Assigning ``U_`` or ``V_`` drops the device tables and the serving caches.
``topology='obs_parallel'`` with ``num_slices=D`` runs
``parallel.hybrid_als`` on ``get_hybrid_mesh(n_shards, num_slices=D)``'s
``(D, n_shards // D)`` mesh (the observations split across the D slices,
the per-row normal equations summed across them); its fitted tables come
back to the host, and serving takes the single-device route. Another
``topology`` raises the reference's ``ValueError``. The default
single-device init is the reference's ``jax.random`` draw, reproduced by
``prng.py``; a sharded fit draws the reference's sharded init
(``ShardedALSProgram.init_factors``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from recommendation_models_tpu_torch import prng
from recommendation_models_tpu_torch.config import (
    DataConfig, SolveConfig, bucket_growth_for_rank, dense_min_degree_for_rank,
)
from recommendation_models_tpu_torch.data.layout import (
    build_layout, csr_arrays, layout_from_coo,
)
from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.models.base import (
    BaseEstimator, resolve_alias,
)
from recommendation_models_tpu_torch.ops.cholesky import (
    block_batch, hot_cols_auto,
)
from recommendation_models_tpu_torch.ops.gram import full_f32
from recommendation_models_tpu_torch.ops.topk import (
    grouped_exclusion_topk, permuted_topk, serving_permutation,
    sharded_topk, topk_scores,
)
from recommendation_models_tpu_torch.parallel.mesh import (
    get_hybrid_mesh, get_mesh, take_rows, to_host,
)
from recommendation_models_tpu_torch.solver.als_sweep import (
    device_buckets, half_sweep, make_scanned_fit, make_sweep_fns,
)
from recommendation_models_tpu_torch.utils.checkpoint import (
    load_latest, save_checkpoint, wait_pending,
)


class ALS(BaseEstimator):
    """Alternating least squares matrix factorization on a CUDA card.

    Parameters mirror the JAX package's estimator (rank, reg/lambda_,
    n_sweeps/max_iter, tol, seed, solver, chunk, compute_dtype, layout
    knobs). ``platform``: None (the card) or 'cpu'.
    """

    def __init__(
        self,
        rank: int = 10,
        reg: Optional[float] = None,        # None => 0.1 (alias sentinel)
        alpha: Optional[float] = None,
        n_sweeps: Optional[int] = None,     # None => 10 (alias sentinel)
        tol: float = 0.0,
        reg_by_degree: bool = False,
        solver: str = "auto",
        chunk: int = 512,
        gather_budget_mb: int = 0,
        compute_dtype: str = "auto",
        sse_mode: str = "auto",
        n_shards: Optional[int] = None,
        num_slices: Optional[int] = None,
        topology: str = "1d",
        exchange: str = "allgather",
        exchange_head: Optional[int] = None,
        platform: Optional[str] = None,
        seed: int = 0,
        init_scale: float = 0.01,
        min_bucket: int = 8,
        max_bucket: int = 4096,
        bucket_growth: Optional[float] = None,
        hot_cols: Optional[int] = None,
        dense_min_degree: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        layout_cache: Optional[str] = None,
        verbose: int = 0,
        lambda_: Optional[float] = None,
        max_iter: Optional[int] = None,
        data_config: Optional[DataConfig] = None,
    ):
        self.rank = rank
        self.reg = reg
        self.alpha = alpha
        self.n_sweeps = n_sweeps
        self.tol = tol
        self.reg_by_degree = reg_by_degree
        self.solver = solver
        self.chunk = chunk
        self.gather_budget_mb = gather_budget_mb
        self.compute_dtype = compute_dtype
        self.sse_mode = sse_mode
        self.n_shards = n_shards
        self.num_slices = num_slices
        self.topology = topology
        self.exchange = exchange
        self.exchange_head = exchange_head
        self.platform = platform
        self.seed = seed
        self.init_scale = init_scale
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.bucket_growth = bucket_growth
        self.hot_cols = hot_cols
        self.dense_min_degree = dense_min_degree
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.layout_cache = layout_cache
        self.verbose = verbose
        # full structured layout config (overrides the layout kwargs)
        self.data_config = data_config
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

    # Fitted factors. A sharded fit keeps its padded tables on the mesh
    # (per-shard blocks); ``U_`` / ``V_`` copy them to the host at first
    # access. Assigning either drops the device tables, and assigning
    # ``V_`` the serving caches built from the old catalog.
    _U_host = _V_host = None
    _U_dev = _V_dev = None

    @property
    def U_(self) -> np.ndarray:
        if self._U_host is None and self._U_dev is not None:
            self._U_host = to_host(self._U_dev)[: self.n_users_]
        return self._U_host

    @U_.setter
    def U_(self, value):
        self._U_host = value
        self._U_dev = None

    @property
    def V_(self) -> np.ndarray:
        if self._V_host is None and self._V_dev is not None:
            self._V_host = to_host(self._V_dev)[: self.n_items_]
        return self._V_host

    @V_.setter
    def V_(self, value):
        self._V_host = value
        self._V_dev = None
        self._drop_serving_caches()

    def _drop_serving_caches(self):
        for key in ("_vdev_cache", "_vserve_cache"):
            self.__dict__.pop(key, None)

    # ------------------------------------------------------------------
    @classmethod
    def from_configs(cls, solve=None, mesh=None, data=None, fit=None):
        """Build an estimator from the frozen config dataclasses."""
        from recommendation_models_tpu_torch.config import (
            FitConfig, MeshConfig,
        )
        solve = solve or SolveConfig()
        mesh = mesh or MeshConfig()
        data = data or DataConfig()
        fit = fit or FitConfig()
        return cls(
            rank=solve.rank, reg=solve.reg, alpha=solve.alpha,
            reg_by_degree=solve.reg_by_degree, solver=solve.solver,
            chunk=solve.chunk, gather_budget_mb=solve.gather_budget_mb,
            compute_dtype=solve.compute_dtype, sse_mode=solve.sse_mode,
            n_shards=mesh.n_shards, num_slices=mesh.num_slices,
            topology=mesh.topology,
            exchange=mesh.exchange, exchange_head=mesh.exchange_head,
            platform=mesh.platform,
            data_config=data, layout_cache=data.layout_cache,
            n_sweeps=fit.n_sweeps, tol=fit.tol, seed=fit.seed,
            init_scale=fit.init_scale,
            checkpoint_dir=fit.checkpoint_dir,
            checkpoint_every=fit.checkpoint_every,
        )

    @classmethod
    def from_reference_state(cls, state: dict, train_indptr=None,
                             train_indices=None) -> "ALS":
        """A fitted port estimator from the JAX estimator's fitted state.

        ``state`` holds NumPy ``U_``, ``V_``, ``n_users_``, ``n_items_``,
        ``history_`` and ``params`` (the JAX estimator's ``get_params()``).
        A ``data_config`` in the params is converted field by field.
        ``train_indptr`` and ``train_indices`` (the training matrix's CSR
        rows, both or neither) let ``recommend`` exclude seen items; without
        them it warns and serves unfiltered, as the reference does after
        ``resume()``."""
        if (train_indptr is None) != (train_indices is None):
            raise ValueError("pass BOTH train_indptr and train_indices, "
                             "or neither")
        params = dict(state["params"])
        dc = params.get("data_config")
        if dc is not None and not isinstance(dc, DataConfig):
            params["data_config"] = DataConfig(**dataclasses.asdict(dc))
        model = cls(**params)
        model.U_ = np.asarray(state["U_"], np.float32)
        model.V_ = np.asarray(state["V_"], np.float32)
        model.n_users_ = int(state["n_users_"])
        model.n_items_ = int(state["n_items_"])
        model.history_ = list(np.asarray(state["history_"], np.float32))
        if train_indptr is not None:
            model._train_indptr = np.asarray(train_indptr, np.int64)
            model._train_indices = np.asarray(train_indices)
        return model

    def _solve_config(self) -> SolveConfig:
        return SolveConfig(
            rank=self.rank, reg=self._reg, reg_by_degree=self.reg_by_degree,
            alpha=self.alpha, chunk=self.chunk, solver=self.solver,
            gather_budget_mb=self.gather_budget_mb,
            compute_dtype=self.compute_dtype, sse_mode=self.sse_mode,
        )

    def _data_config(self) -> DataConfig:
        if self.data_config is not None:
            # taken verbatim except the two documented autos
            dcfg = self.data_config
            if dcfg.bucket_growth is None:
                dcfg = dataclasses.replace(
                    dcfg, bucket_growth=bucket_growth_for_rank(self.rank))
            if dcfg.dense_min_degree is None:
                dcfg = dataclasses.replace(
                    dcfg, dense_min_degree=dense_min_degree_for_rank(
                        self.rank, dcfg.max_bucket))
            return dcfg
        hot = self.hot_cols
        if hot is None:
            hot = hot_cols_auto(self.rank)
        dmd = self.dense_min_degree
        if dmd is None:
            dmd = dense_min_degree_for_rank(self.rank, self.max_bucket)
        growth = self.bucket_growth
        if growth is None:
            growth = bucket_growth_for_rank(self.rank)
        return DataConfig(min_bucket=self.min_bucket,
                          max_bucket=self.max_bucket, hot_cols=hot,
                          bucket_growth=growth,
                          dense_min_degree=dmd)

    def _build_layouts(self, indptr, indices, data, n_users, n_items, dcfg):
        """Both orientations' padded layouts, optionally through the packed
        on-disk cache (tagged by the full DataConfig and, with a prefix, a
        data fingerprint)."""
        from recommendation_models_tpu_torch.data.layout_cache import (
            cached_layout, config_tag, data_fingerprint,
        )

        def build_user():
            return build_layout(indptr, indices, data, n_users, n_items, dcfg)

        def build_item():
            rows = np.repeat(np.arange(n_users), np.diff(indptr))
            return layout_from_coo(rows, indices, data, n_users, n_items,
                                   dcfg, transpose=True)

        prefix = self.layout_cache
        tag = f".cfg{config_tag(dcfg)}"
        if prefix:
            tag += "." + data_fingerprint(indptr, indices, data)
        user_layout = cached_layout(
            f"{prefix}{tag}.user.npz" if prefix else None, build_user)
        item_layout = cached_layout(
            f"{prefix}{tag}.item.npz" if prefix else None, build_item)
        return user_layout, item_layout

    def _init_factors_host(self, n_users, n_items):
        # the reference's jax.random draw, reproduced in NumPy (prng.py)
        key_u, key_v = prng.split(prng.prng_key(self.seed))
        scale = np.float32(self.init_scale)
        return (scale * prng.normal(key_u, (n_users, self.rank)),
                scale * prng.normal(key_v, (n_items, self.rank)))

    # ------------------------------------------------------------------
    def fit(self, R, U0=None, V0=None):
        """Fit factors to the ratings matrix R (scipy sparse or dense).

        Optional U0/V0 warm starts (both or neither)."""
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self._reg < 0:
            raise ValueError(f"reg must be >= 0, got {self._reg}")
        if self._n_sweeps < 1:
            raise ValueError(f"n_sweeps must be >= 1, got {self._n_sweeps}")
        if (U0 is None) != (V0 is None):
            raise ValueError("warm starts need BOTH U0 and V0")
        sharded = self.n_shards is not None and self.n_shards > 1
        if not sharded and self.topology != "1d":
            raise ValueError(
                f"topology={self.topology!r} needs a sharded fit: set "
                f"n_shards > 1 (got {self.n_shards})")
        if sharded:
            if self.topology not in ("1d", "obs_parallel"):
                raise ValueError(
                    f"topology must be '1d' or 'obs_parallel', got "
                    f"{self.topology!r}")
        else:
            device = resolve_device(self.platform)
        indptr, indices, data, n_users, n_items = csr_arrays(R)
        self.n_users_, self.n_items_ = n_users, n_items
        self._train_indptr, self._train_indices = indptr, indices
        dcfg, scfg = self._data_config(), self._solve_config()
        nnz = indices.shape[0]
        if sharded and self.topology == "obs_parallel":
            return self._fit_hybrid_2d(indptr, indices, data, U0, V0, dcfg,
                                       scfg)
        if sharded:
            return self._fit_sharded(indptr, indices, data, U0, V0, dcfg,
                                     scfg)
        # a previous sharded fit's program holds its device buckets
        self._sharded_program = None
        self.__dict__.pop("exchange_bytes_per_sweep_", None)

        user_layout, item_layout = self._build_layouts(
            indptr, indices, data, n_users, n_items, dcfg)
        ub = device_buckets(user_layout, block_batch(self.rank), device)
        ib = device_buckets(item_layout, block_batch(self.rank), device)

        if U0 is None:
            U0, V0 = self._init_factors_host(n_users, n_items)
        U = torch.as_tensor(np.asarray(U0, np.float32), device=device)
        V = torch.as_tensor(np.asarray(V0, np.float32), device=device)

        stepwise = bool(self.verbose
                        or (self.checkpoint_dir and self.checkpoint_every))
        if not stepwise:
            # one loop over sweeps with no host readback (tol == 0) or one
            # scalar per sweep (tol > 0); sweeps never run come back as -1
            fit_fn = make_scanned_fit(ub, ib, n_users, n_items, scfg,
                                      self._n_sweeps, tol=self.tol,
                                      nnz=max(nnz, 1))
            U, V, sse, n_done = fit_fn(U, V)
            # clamp: near-interpolation fits can give tiny negative SSE
            # from f32 cancellation in the riding identity
            sse_h = np.maximum(sse.cpu().numpy()[:n_done], 0.0)
            self.history_ = list(np.sqrt(sse_h / max(nnz, 1)))
        else:
            sweep, train_sse = make_sweep_fns(ub, ib, n_users, n_items, scfg)
            self.history_ = []
            prev = None
            for s in range(self._n_sweeps):
                U, V = sweep(U, V)
                cur = float(torch.sqrt(train_sse(U, V) / max(nnz, 1)))
                self.history_.append(cur)
                if self.verbose:
                    print(f"[ALS] sweep {s + 1}: train_rmse={cur:.6f}")
                self._maybe_checkpoint(s, U, V)
                if self.tol > 0 and prev is not None and abs(prev - cur) < self.tol:
                    break
                prev = cur
            self._finish_checkpoints()

        self.U_ = U.cpu().numpy()
        self.V_ = V.cpu().numpy()
        return self

    def _sharded_program_on(self, mesh, indptr, indices, data, n_users,
                            n_items, dcfg, scfg):
        """The sharded program of this estimator on ``mesh``: both layouts
        under the exchange's rules (``exchange_layout``), sharded by row
        owner, and ``ShardedALSProgram`` over them."""
        from recommendation_models_tpu_torch.data.layout import shard_layout
        from recommendation_models_tpu_torch.parallel.sharded_als import (
            ShardedALSProgram, exchange_layout,
        )
        S = mesh.size
        dcfg, head = exchange_layout(dcfg, self.exchange, self.exchange_head)
        ul, il = self._build_layouts(indptr, indices, data, n_users, n_items,
                                     dcfg)
        block = block_batch(self.rank)
        return ShardedALSProgram(
            shard_layout(ul, S, row_multiple=block),
            shard_layout(il, S, row_multiple=block),
            mesh, scfg, exchange=self.exchange, head=head)

    def _fit_sharded(self, indptr, indices, data, U0, V0, dcfg, scfg):
        """The 1-D sharded fit on ``get_mesh``'s mesh; the fitted tables
        stay on the mesh."""
        mesh = get_mesh(self.n_shards, platform=self.platform,
                        num_slices=self.num_slices)
        prog = self._sharded_program_on(mesh, indptr, indices, data,
                                        self.n_users_, self.n_items_, dcfg,
                                        scfg)
        self._sharded_program = prog
        self.exchange_bytes_per_sweep_ = prog.collective_bytes_per_sweep()
        if self.verbose:
            mb = self.exchange_bytes_per_sweep_["per_sweep_total"] / 2**20
            print(f"[ALS] exchange={self.exchange} collective traffic "
                  f"{mb:.2f} MiB/shard/sweep")
        if U0 is not None:
            U, V = prog.place_factors(U0, V0)
        else:
            U, V = prog.init_factors(self.seed, self.init_scale)
        U, V = self._run_program_fit(prog, U, V, indices.shape[0])
        # the padded tables stay on the mesh; U_ / V_ copy them lazily
        self._U_dev, self._V_dev = U, V
        self._U_host = self._V_host = None
        self._drop_serving_caches()
        return self

    def _hybrid_shape(self):
        """(D, S) of the 2-D fit: ``num_slices`` slices of ``n_shards //
        num_slices``, with the reference's errors."""
        if self.exchange != "allgather":
            raise ValueError(
                "topology='obs_parallel' has its own comm pattern (intra-"
                "slice gathers + DCN gram psum); exchange modes apply to "
                "the 1-D topology only")
        if not self.num_slices or self.num_slices < 2:
            # a one-slice mesh has no observation split at all
            raise ValueError(
                "topology='obs_parallel' needs num_slices >= 2 (the dcn "
                f"axis carries the observation split), got "
                f"{self.num_slices!r}")
        D = self.num_slices
        if self.n_shards % D:
            raise ValueError(
                f"n_shards={self.n_shards} must be divisible by "
                f"num_slices={D} for the 2-D (dcn x data) mesh")
        return D, self.n_shards // D

    def _hybrid_program_on(self, mesh, indptr, indices, data, n_users,
                           n_items, dcfg, scfg):
        """The 2-D program of this estimator on ``mesh``: layouts with
        neither the dense block nor the hot columns (they need the whole
        opposite table at a position), sharded ``S`` ways with the
        reference's default row multiple."""
        from recommendation_models_tpu_torch.data.layout import shard_layout
        from recommendation_models_tpu_torch.parallel.hybrid_als import (
            HybridALSProgram,
        )
        _, S = self._hybrid_shape()
        dcfg = dataclasses.replace(dcfg, dense_whales=False, hot_cols=0)
        ul, il = self._build_layouts(indptr, indices, data, n_users, n_items,
                                     dcfg)
        return HybridALSProgram(shard_layout(ul, S), shard_layout(il, S),
                                mesh, scfg)

    def _fit_hybrid_2d(self, indptr, indices, data, U0, V0, dcfg, scfg):
        """The observation-parallel fit on ``get_hybrid_mesh``'s ``(D, S)``
        mesh (``n_shards`` = D·S devices). The fitted tables come back to
        the host; serving takes the single-device route."""
        D, S = self._hybrid_shape()
        mesh = get_hybrid_mesh(self.n_shards, num_slices=D,
                               platform=self.platform)
        prog = self._hybrid_program_on(mesh, indptr, indices, data,
                                       self.n_users_, self.n_items_, dcfg,
                                       scfg)
        self._sharded_program = None
        self.exchange_bytes_per_sweep_ = prog.collective_bytes_per_sweep()
        if self.verbose:
            b = self.exchange_bytes_per_sweep_
            print(f"[ALS] obs-parallel 2-D mesh (dcn={D} x data={S}): "
                  f"{b['ici'] / 2**20:.2f} MiB ICI + "
                  f"{b['dcn'] / 2**20:.2f} MiB DCN /device/sweep")
        if U0 is not None:
            U, V = prog.place_factors(U0, V0)
        else:
            U, V = prog.init_factors(self.seed, self.init_scale)
        U, V = self._run_program_fit(prog, U, V, indices.shape[0])
        # the setters drop a previous 1-D fit's device tables and both
        # cached catalogs
        self.U_ = to_host(U)[: self.n_users_]
        self.V_ = to_host(V)[: self.n_items_]
        return self

    def _run_program_fit(self, prog, U, V, nnz):
        """Drive a sharded program's fit and fill ``history_``: one loop
        with no per-sweep readback (``prog.make_fit``), or, with verbose
        output or checkpoints, a sweep at a time (``sweep_with_sse``)."""
        nnz = max(nnz, 1)
        stepwise = bool(self.verbose
                        or (self.checkpoint_dir and self.checkpoint_every))
        if not stepwise:
            fit_fn = prog.make_fit(self._n_sweeps, tol=self.tol, nnz=nnz)
            U, V, sse, n_done = fit_fn(U, V)
            sse_h = np.maximum(sse.cpu().numpy()[:n_done], 0.0)
            self.history_ = list(np.sqrt(sse_h / nnz))
        else:
            self.history_ = []
            prev = None
            for s in range(self._n_sweeps):
                U, V, sse = prog.sweep_with_sse(U, V)
                cur = float(torch.sqrt(torch.clamp_min(sse, 0.0) / nnz))
                self.history_.append(cur)
                if self.verbose:
                    print(f"[ALS] sweep {s + 1}: train_rmse={cur:.6f}")
                self._maybe_checkpoint(s, U, V)
                if (self.tol > 0 and prev is not None
                        and abs(prev - cur) < self.tol):
                    break
                prev = cur
            self._finish_checkpoints()
        return U, V

    def _finish_checkpoints(self):
        if self.checkpoint_dir and self.checkpoint_every:
            wait_pending()

    def _maybe_checkpoint(self, sweep_idx, U, V):
        """Save U, V and the history after every ``checkpoint_every``-th
        sweep, with the scalar hyperparameters and the table sizes as
        metadata (a sharded fit saves its padded tables). The tables are
        copied to the host before the call returns; the file is written on
        the background thread."""
        if not self.checkpoint_dir or not self.checkpoint_every:
            return
        if (sweep_idx + 1) % self.checkpoint_every:
            return
        if isinstance(U, tuple):        # a sharded program's blocks
            U, V = to_host(U), to_host(V)
        meta = {k: v for k, v in self.get_params().items()
                if isinstance(v, (int, float, str, bool, type(None)))}
        meta["n_users"], meta["n_items"] = self.n_users_, self.n_items_
        save_checkpoint(
            self.checkpoint_dir, step=sweep_idx + 1,
            state=dict(U=U, V=V,
                       history=np.asarray(self.history_, np.float32)),
            metadata=meta, wait=False)

    def resume(self, checkpoint_dir: Optional[str] = None):
        """Load the factors and the sweep history of the newest checkpoint
        under ``checkpoint_dir`` (default: the estimator's); returns its
        step.

        The tables are sliced to the true sizes in the checkpoint's
        metadata. A previous fit's serving state (its training lists and
        the device copy of the catalog and a sharded fit's program) is
        dropped: the training observations are not checkpointed, so
        ``recommend(exclude_seen=True)`` warns and serves unfiltered until
        the next ``fit``. A sharded fit's checkpoint holds padded tables;
        they are sliced here."""
        step, state = load_latest(checkpoint_dir or self.checkpoint_dir)
        for key in ("_train_indptr", "_train_indices", "_vdev_cache",
                    "_vserve_cache", "_sharded_program",
                    "exchange_bytes_per_sweep_"):
            self.__dict__.pop(key, None)
        meta = state.get("metadata") or {}
        U = np.asarray(state["U"])
        V = np.asarray(state["V"])
        self.n_users_ = int(meta.get("n_users", U.shape[0]))
        self.n_items_ = int(meta.get("n_items", V.shape[0]))
        self.U_ = U[: self.n_users_]
        self.V_ = V[: self.n_items_]
        self.history_ = list(np.asarray(state["history"]))
        return step

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Picklable fitted estimator: the device copies of the catalog and
        a sharded fit's program are dropped (serving uploads the catalog
        again), and a sharded fit's tables are copied to the host first,
        so a model pickled after a fit on the card unpickles on a host
        without one."""
        state = dict(super().__getstate__())
        for key in ("_vdev_cache", "_vserve_cache", "_sharded_program"):
            state.pop(key, None)
        if state.get("_U_dev") is not None:
            state["_U_host"], state["_V_host"] = self.U_, self.V_
        state.pop("_U_dev", None)
        state.pop("_V_dev", None)
        return state

    def _check_fitted(self):
        if self._U_host is None and self._U_dev is None:
            raise RuntimeError("this ALS instance is not fitted yet")

    def predict(self, users, items=None) -> np.ndarray:
        """Predicted ratings for (user, item) pairs: ``predict(pairs)`` with
        an (n, 2) array or ``predict(users, items)``."""
        self._check_fitted()
        if items is None:
            pairs = np.asarray(users)
            users, items = pairs[:, 0], pairs[:, 1]
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        return np.einsum("ok,ok->o", self.U_[users], self.V_[items])

    def fold_in(self, R_new, side: str = "user") -> np.ndarray:
        """Factors for NEW rows against the fixed fitted opposite table (one
        ridge solve per new row, through the training half-sweep).

        ``R_new``: (n_new, n_items) for ``side='user'``, or (n_users, n_new)
        for ``side='item'``. Returns the (n_new, rank) factor block."""
        self._check_fitted()
        if side not in ("user", "item"):
            raise ValueError(f"side must be 'user' or 'item', got {side!r}")
        indptr, indices, data, a, b = csr_arrays(R_new)
        if side == "item" and a != self.n_users_:
            raise ValueError(f"R_new has {a} rows but the fitted user "
                             f"space is {self.n_users_}")
        if side == "user" and b != self.n_items_:
            raise ValueError(f"R_new has {b} columns but the fitted "
                             f"item space is {self.n_items_}")
        device = resolve_device(self.platform)
        cfg = DataConfig(dense_whales=False, hot_cols=0)
        if side == "item":
            rows = np.repeat(np.arange(a), np.diff(indptr))
            layout = layout_from_coo(rows, indices, data, a, b, cfg,
                                     transpose=True)
            n_new, opp = b, self.U_
        else:
            layout = build_layout(indptr, indices, data, a, b, cfg)
            n_new, opp = a, self.V_
        buckets = device_buckets(layout, block_batch(self.rank), device)
        x = half_sweep(torch.tensor(opp, device=device), buckets, n_new,
                       self._solve_config())
        return x.cpu().numpy()

    def predict_all(self, user: int) -> np.ndarray:
        """Scores for every item for one user."""
        self._check_fitted()
        return self.U_[user] @ self.V_.T

    def rmse(self, R) -> float:
        indptr, indices, data, _, _ = csr_arrays(R)
        users = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        pred = self.predict(users, indices)
        return float(np.sqrt(np.mean((data - pred) ** 2)))

    def score(self, R, y=None) -> float:
        """Negative RMSE over the observed entries of R (higher is better)."""
        return -self.rmse(R)

    def recommend(self, user_ids, n: int = 10, exclude_seen: bool = True,
                  method: str = "auto", recall_target: float = 0.99):
        """Top-n unseen items per user: (scores (B, n), items (B, n)) as
        NumPy arrays.

        Selection is exact for every ``method`` ('auto', 'exact' or
        'approx'; ``recall_target`` is accepted for the reference's
        signature). With ``exclude_seen`` each user's training items are
        dropped (``ops.topk.grouped_exclusion_topk``)."""
        self._check_fitted()
        user_ids = np.atleast_1d(np.asarray(user_ids, np.int64))
        if user_ids.size and (user_ids.min() < 0
                              or user_ids.max() >= self.n_users_):
            raise ValueError(
                f"user ids must be in [0, {self.n_users_}); got "
                f"[{user_ids.min()}, {user_ids.max()}]")
        n = min(n, self.n_items_)    # never ask top_k for more than exists
        query_rows, topk = self._topk_backend(method, recall_target)
        if exclude_seen and not hasattr(self, "_train_indptr"):
            # an estimator resumed or built from factors alone has no
            # training lists: serving with seen items would break the top_n
            # contract
            import warnings
            warnings.warn(
                "recommend(exclude_seen=True) on an estimator without "
                "training indices (e.g. resumed from a checkpoint, or "
                "from_reference_state without train_indptr and "
                "train_indices): seen items canNOT be excluded; serving "
                "unfiltered scores. Call fit() to restore exclusion.",
                stacklevel=2)
        if not (exclude_seen and hasattr(self, "_train_indptr")):
            return topk(query_rows(user_ids), n, None)
        return grouped_exclusion_topk(user_ids, n, self._train_indptr,
                                      self._train_indices, query_rows, topk)

    def _topk_backend(self, method: str, recall_target: float):
        """(query_rows, topk) callables for ``recommend``.

        After a sharded fit whose tables are still on the mesh: query rows
        gathered from the sharded U onto the first shard's device, and
        ``ops.topk.sharded_topk`` against the sharded V re-gathered once in
        ``serving_permutation`` row order (cached; the padded rows stay
        last, masked by ``n_valid``). Otherwise: host ``U_`` rows uploaded
        per chunk, and ``ops.topk.topk_scores`` against the device copy of
        ``V_`` in ``serving_permutation`` row order, cached on the
        estimator and keyed on the identity of ``V_`` (and the device);
        assigning ``V_`` clears both caches."""
        prog = getattr(self, "_sharded_program", None)
        if (prog is not None and self._U_dev is not None
                and self._V_dev is not None):
            return self._sharded_topk_backend(prog, method, recall_target)
        device = resolve_device(self.platform)
        if device.type == "cuda":
            full_f32()
        perm_back, perm_fwd = serving_permutation(self.n_items_)
        cache = getattr(self, "_vdev_cache", None)
        if cache is None or cache[0] is not self.V_ \
                or cache[1].device.type != device.type:
            self._vdev_cache = (self.V_, torch.as_tensor(
                self.V_[perm_back], dtype=torch.float32, device=device))
        V_local = self._vdev_cache[1]

        def query_rows(ids):
            return torch.as_tensor(self.U_[ids], device=device)

        def topk(Uq, k, excl):
            return topk_scores(Uq, V_local, k, excl, method=method,
                               recall_target=recall_target)
        return query_rows, permuted_topk(topk, perm_back, perm_fwd)

    def _sharded_topk_backend(self, prog, method: str, recall_target: float):
        mesh, n_items = prog.mesh, self.n_items_
        U_dev, V_dev = self._U_dev, self._V_dev
        home = mesh.devices[mesh.local[0]]
        if home.type == "cuda":
            full_f32()
        perm_back, perm_fwd = serving_permutation(n_items)
        cache = getattr(self, "_vserve_cache", None)
        if cache is None or cache[0] is not V_dev:
            per = V_dev[mesh.local[0]].shape[0]
            ids = np.concatenate([perm_back,
                                  np.arange(n_items, per * len(V_dev))])
            blocks = []
            for s, d in enumerate(mesh.devices):
                # across processes take_rows is collective: every process
                # takes every block's rows, in turn, and keeps its own
                mine = s in mesh.local
                rows = take_rows(V_dev, ids[s * per:(s + 1) * per],
                                 d if mine else home)
                blocks.append(rows if mine else None)
            self._vserve_cache = (V_dev, tuple(blocks))
        V_serve = self._vserve_cache[1]

        def query_rows(ids):
            return take_rows(U_dev, ids, home)

        def topk(Uq, k, excl):
            return sharded_topk(Uq, V_serve, k, mesh, axis=prog.axis,
                                exclude=excl, method=method,
                                recall_target=recall_target, n_valid=n_items)
        return query_rows, permuted_topk(topk, perm_back, perm_fwd)

    def top_n(self, user: int, n: int = 10, exclude_seen: bool = True):
        """Single-user convenience: ranked item ids."""
        _, items = self.recommend([user], n, exclude_seen)
        return items[0]


__all__ = ["ALS"]
