"""Utilities of the port: checkpoint and resume (``utils.checkpoint``),
metrics records (``utils.logging``) and profiler traces
(``utils.profiling``). The JAX package's ``utils/compat.py`` (``shard_map``
axes) has no counterpart until the sharded programs are ported."""

from recommendation_models_tpu_torch.utils.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    load_latest,
)
from recommendation_models_tpu_torch.utils.logging import MetricsLogger
from recommendation_models_tpu_torch.utils.profiling import trace_sweeps

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_latest",
    "MetricsLogger",
    "trace_sweeps",
]
