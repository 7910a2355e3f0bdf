"""Checkpoint and resume of factor tables, on ``torch.save`` / ``torch.load``.

A checkpoint is a directory ``step_%08d`` holding ``state.pt``: a dict of
named host arrays (factor tables, the sweep history), saved as CPU tensors
and loaded with ``weights_only=True``. Non-array ``metadata``
(hyperparameters, table sizes) goes to a JSON sidecar
``step_%08d.meta.json`` beside the directory. Both files are written
atomically (a temporary file, then ``os.replace``), so a crash mid-write
leaves the previous file or none, never a truncated one.

Restore gives NumPy host arrays whatever device the state was saved from,
so a checkpoint written on the card loads on the CPU and back again.

``save_checkpoint(..., wait=False)`` copies the arrays to the host before
it returns (the caller may then overwrite its tensors) and writes the file
on one background thread; :func:`wait_pending` joins those writes, and
:func:`load_latest` calls it first. The format is this package's own: the
JAX package's orbax checkpoints do not load here.

Across processes (``parallel.mesh.initialize_distributed``) every process
calls :func:`save_checkpoint` with the same (replicated, or gathered by
the collective ``to_host``) state, and process 0 alone writes the state
and the sidecar, as the JAX package gates its sidecar; a save with
``wait=True`` and :func:`wait_pending` end at a barrier of every process,
so a process that reads next finds the files committed.
:func:`load_latest` reads in every process.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pickle
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.parallel.mesh import (
    barrier, process_index,
)

_STATE_FILE = "state.pt"

# the background writer of async saves: created at the first one (importing
# this module starts no thread); one worker, so saves commit in call order
_EXECUTOR: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PENDING = []
_LOCK = threading.Lock()


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _replace_atomically(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, then rename."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _to_host(value) -> torch.Tensor:
    """A CPU tensor that owns a copy of ``value`` (a tensor on any device,
    a NumPy array or a scalar)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(value, copy=True))


def _write_state(path: str, host: Dict[str, torch.Tensor]) -> None:
    os.makedirs(path, exist_ok=True)
    _replace_atomically(os.path.join(path, _STATE_FILE),
                        lambda f: torch.save(host, f))


def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    metadata: Optional[Dict[str, Any]] = None,
                    wait: bool = True) -> str:
    """Save ``state`` (name -> tensor, array or scalar) as checkpoint
    ``step`` under ``directory``; ``metadata`` (JSON-serialisable) goes to
    the sidecar. A save without metadata removes a sidecar an earlier run
    left at this step, so that no stale hyperparameters attach to it.

    ``wait=False`` returns once the arrays are on the host and commits the
    file on the background thread (:func:`wait_pending` joins it). Returns
    the checkpoint's directory. Across processes only process 0 writes."""
    path = _ckpt_path(directory, step)
    if process_index() != 0:
        if wait:
            barrier()
        return path
    host = {name: _to_host(v) for name, v in state.items()}
    os.makedirs(path, exist_ok=True)
    meta_path = path + ".meta.json"
    if metadata is not None:
        text = json.dumps(metadata).encode()
        _replace_atomically(meta_path, lambda f: f.write(text))
    elif os.path.exists(meta_path):
        os.remove(meta_path)
    if wait:
        _write_state(path, host)
        barrier()
        return path
    global _EXECUTOR
    with _LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        _PENDING.append(_EXECUTOR.submit(_write_state, path, host))
    return path


def wait_pending() -> None:
    """Block until every async :func:`save_checkpoint` has committed; raise
    the first failed write's exception. Across processes, then wait for
    every process."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for fut in pending:
        fut.result()
    barrier()


def load_checkpoint(directory: str, step: int,
                    name: Optional[str] = None) -> Dict[str, Any]:
    """Restore checkpoint ``step`` as NumPy host arrays, with the sidecar's
    metadata under ``"metadata"`` when there is one.

    ``name``: the directory's name where it does not follow ``step_%08d``
    (a hand-restored ``step_5``, say)."""
    path = (os.path.join(os.path.abspath(directory), name) if name
            else _ckpt_path(directory, step))
    tensors = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                         weights_only=True)
    state: Dict[str, Any] = {k: v.numpy() for k, v in tensors.items()}
    if os.path.exists(path + ".meta.json"):
        if "metadata" in state:
            raise ValueError(
                "checkpoint state already contains a 'metadata' key; the "
                "JSON sidecar would clobber it — rename the state entry")
        with open(path + ".meta.json") as f:
            state["metadata"] = json.load(f)
    return state


def load_latest(directory: str) -> Tuple[int, Dict[str, Any]]:
    """(step, state) of the newest loadable checkpoint under ``directory``.

    Joins this process's pending async saves first. A directory whose state
    file is missing or unreadable (a save that never committed) is skipped
    for the previous step; raises ``FileNotFoundError`` when none loads,
    naming the newest failure."""
    wait_pending()
    directory = os.path.abspath(directory)
    entries = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.isdir(os.path.join(directory, name)):
            entries.append((int(m.group(1)), name))
    if not entries:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    first_err = None
    for step, name in sorted(entries, reverse=True):
        try:
            return step, load_checkpoint(directory, step, name=name)
        except (OSError, RuntimeError, ValueError, EOFError,
                pickle.UnpicklingError) as e:
            if first_err is None:
                first_err = (step, e)
    raise FileNotFoundError(
        f"no loadable checkpoint under {directory}; newest "
        f"(step {first_err[0]}) failed with: {first_err[1]!r}")


__all__ = ["save_checkpoint", "load_checkpoint", "load_latest",
           "wait_pending"]
