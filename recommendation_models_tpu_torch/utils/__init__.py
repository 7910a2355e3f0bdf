"""Utilities of the port: checkpoint and resume (``utils.checkpoint``),
metrics records (``utils.logging``) and profiler traces, spans and counters
(``utils.profiling``). The JAX package's ``utils/compat.py`` (``shard_map``
axes) has no counterpart until the sharded programs are ported.

The names load with their module at first use: the solver and the serving
path import ``utils.profiling``, and ``utils.checkpoint`` imports the
sharded programs, which import the solver."""

import importlib

_HOME = {
    "save_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint",
    "load_latest": "checkpoint",
    "MetricsLogger": "logging",
    "trace_sweeps": "profiling",
}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"),
                   name)
