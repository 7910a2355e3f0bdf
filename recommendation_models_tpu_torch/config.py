"""Config dataclasses of the PyTorch port.

Same fields and defaults as the JAX package's ``config.py``, so that a
configuration means the same layout and the same solve in both packages.
The auto policies below are copied verbatim from the reference. Their
values were tuned on a TPU; they are kept here so that the port builds
the same layouts and picks the same SSE mode, and will be re-derived on
the GPU by whole-epoch runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Controls the per-row normal-equation solve path."""

    rank: int = 10
    # L2 regularization strength (lambda).
    reg: float = 0.1
    # Scale reg by row degree (the "weighted-lambda" ALS variant).
    reg_by_degree: bool = False
    # Implicit-feedback confidence alpha (Hu-Koren-Volinsky). None = explicit.
    alpha: Optional[float] = None
    # Gather/gram chunk along the padded-degree axis.
    chunk: int = 512
    # Row-block budget (MB) for one gathered (rows, P, k) block; 0 = auto,
    # resolved by solver.als_sweep.resolve_gather_budget.
    gather_budget_mb: int = 0
    # 'auto'/'pallas' = the hand-written CUDA kernel for CUDA tensors and its
    # plain PyTorch version for CPU tensors; 'xla' = torch.linalg.cholesky
    # anchor; 'lu' = torch.linalg.solve.
    solver: str = "auto"
    # dtype of the gather/matmul inputs ('auto' = float32 on CPU and CUDA);
    # factors and every accumulation stay float32.
    compute_dtype: str = "auto"
    # Per-sweep training SSE: 'riding' (identity inside the item half),
    # 'separate' (masked_sse pass), 'auto' (sse_separate_for).
    sse_mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: ``n_shards`` > 1 runs the 1-D sharded ALS
    (``parallel/sharded_als.py``) with ``exchange`` 'allgather',
    'all_to_all' or 'hybrid' (``exchange_head`` columns replicated). The
    'obs_parallel' topology and sharded IMC are not ported yet."""

    n_shards: Optional[int] = None
    exchange: str = "allgather"
    exchange_head: Optional[int] = None
    axis: str = "data"
    num_slices: Optional[int] = None
    topology: str = "1d"
    # None = the CUDA card; 'cpu' runs on the host (tests).
    platform: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Ratings ingest and padded-layout construction (see data/layout.py)."""

    min_bucket: int = 8
    max_bucket: int = 4096
    # Geometric bucket-width ratio; None = rank-aware auto at the estimator
    # (bucket_growth_for_rank), 1.25 in the plain layout builders.
    bucket_growth: Optional[float] = None
    # Dense-whale block: rows of degree > dense_min_degree, densest first,
    # while the (W, n_cols) f16 value matrix fits dense_budget_mb. Its
    # observation mask is value != 0.
    dense_whales: bool = True
    dense_budget_mb: int = 2048
    dense_min_degree: Optional[int] = None
    # Hot-column block: the C most popular columns move to per-bucket
    # (B, C) f16 slabs whose gram is built inside the fused solve kernel.
    hot_cols: int = 0
    hot_min_count: Optional[int] = None
    # Opt-in greedy bucket merging (0 = off).
    bucket_merge_slack: int = 0
    # Pad each bucket's row count to a multiple of this.
    row_multiple: int = 8
    # Packed on-disk layout cache prefix; None = rebuild every fit.
    layout_cache: Optional[str] = None


def gather_budget_for_rank(rank: int, nnz: Optional[int] = None) -> int:
    """Rank-aware row-block gather budget (MB); the reference's TPU policy,
    copied verbatim."""
    if rank <= 64:
        return 2
    if nnz is not None and nnz > 40_000_000:
        return 1536
    return 4096


def sse_separate_for(cfg, nnz: Optional[int]) -> bool:
    """Resolve SolveConfig.sse_mode to 'use the separate masked_sse pass?'
    (the reference's per-class policy, copied verbatim). The implicit
    objective has no riding identity and always takes the direct pass."""
    mode = getattr(cfg, "sse_mode", "auto")
    if mode not in ("auto", "riding", "separate"):
        raise ValueError(f"sse_mode must be auto|riding|separate, "
                         f"got {mode!r}")
    if cfg.alpha is not None:
        return True
    if mode != "auto":
        return mode == "separate"
    return (cfg.rank <= 64 and nnz is not None
            and 5_000_000 < nnz <= 40_000_000)


def bucket_growth_for_rank(rank: int) -> float:
    """Rank-aware geometric bucket-growth ratio (copied verbatim)."""
    return 1.12 if rank <= 64 else 1.25


def dense_min_degree_for_rank(rank: int, max_bucket: int = 4096) -> int:
    """Rank-aware dense-whale threshold (copied verbatim)."""
    return min(max(rank * rank // 8, 512), max_bucket)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Sweep-loop hyperparameters."""

    n_sweeps: int = 10
    tol: float = 0.0  # 0 => always run n_sweeps
    seed: int = 0
    init_scale: float = 0.01
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 => disabled


__all__ = ["SolveConfig", "MeshConfig", "DataConfig", "FitConfig",
           "dense_min_degree_for_rank", "gather_budget_for_rank",
           "bucket_growth_for_rank", "sse_separate_for"]
