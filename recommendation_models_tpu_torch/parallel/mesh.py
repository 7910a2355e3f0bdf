"""The device mesh of the sharded programs, in one process.

The JAX package drives S devices from one process: a 1-D
``jax.sharding.Mesh`` and ``shard_map``. The port's counterpart is a
``Mesh`` over a tuple of ``torch.device``s with one axis name, and a
row-sharded table is a tuple of per-shard row blocks, block ``s`` on
``mesh.devices[s]``. The program's three collectives are functions of the
mesh, written once here:

* ``all_gather``: the blocks concatenated onto each shard's device;
* ``psum``: the sum of the per-shard parts, delivered to each shard;
* ``ppermute``: the rotation by ``shift``; shard ``s``'s part arrives at
  shard ``(s + shift) % S`` (requester ``s`` reading owner ``(s + d) % S``
  is ``ppermute`` by ``d`` there and by ``-d`` back).

A device may repeat: ``Mesh((cuda:0,) * S)`` runs S shards on one card, and
``get_mesh(S, platform='cpu')`` gives S entries of the host, as the JAX
package's tests use S forced host devices. A collective computes its
result once per distinct device and hands it to each shard there.

``get_mesh`` never spreads shards over fewer cards than asked, and never
falls back to the CPU. Multi-process runs (``initialize_distributed``) and
the 2-D mesh (``get_hybrid_mesh``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.models.base import not_ported

Blocks = Tuple[torch.Tensor, ...]


class Mesh:
    """A 1-D mesh: ``devices`` (a device may repeat) along ``axis``."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (axis,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(str(d) for d in self.devices)}; "
                f"axis={self.axis_names[0]!r})")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """The multi-process bootstrap: nothing to do for one process (neither
    ``coordinator_address`` nor ``num_processes``); a multi-process run is
    not ported yet."""
    if coordinator_address is None and num_processes is None:
        return
    raise not_ported("the multi-process bootstrap (--coordinator, "
                     "--num-processes)", "Queue 1 item 13f", "train")


def get_mesh(n_shards: Optional[int] = None,
             axis: str = "data",
             platform: Optional[str] = None,
             num_slices: Optional[int] = None) -> Mesh:
    """A 1-D mesh of ``n_shards`` devices along ``axis``.

    ``platform='cpu'``: ``n_shards`` entries of the host (default 1). Else
    the first ``n_shards`` CUDA cards (default: all); fewer cards than
    asked raise ``ValueError``. ``num_slices`` must divide ``n_shards``;
    in one process the device order is already slice-major."""
    device = resolve_device(platform)
    if device.type == "cpu":
        n = 1 if n_shards is None else n_shards
        devices = [device] * n
    else:
        count = torch.cuda.device_count()
        n = count if n_shards is None else n_shards
        if n > count:
            raise ValueError(f"requested {n} shards but only {count} "
                             f"devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if num_slices is not None and num_slices > 1 and n % num_slices:
        raise ValueError(
            f"n_shards={n} not divisible by num_slices={num_slices}")
    return Mesh(devices, axis)


def get_hybrid_mesh(*args, **kwargs):
    """The 2-D (slices x data) mesh of the observation-parallel program:
    not ported yet."""
    raise not_ported("the 2-D observation-parallel mesh (get_hybrid_mesh)",
                     "Queue 1 item 13e", "ALS")


def shard_put(mesh: Mesh, axis: str, x) -> Blocks:
    """Row-shard a host array along ``axis``: block ``s`` (rows ``s * n /
    S`` up to ``(s + 1) * n / S``) on ``mesh.devices[s]``. The row count
    must divide by the shard count."""
    x = np.ascontiguousarray(x)
    S = mesh.shape[axis]
    if x.shape[0] % S:
        raise ValueError(f"{x.shape[0]} rows do not divide into {S} shards")
    per = x.shape[0] // S
    return tuple(torch.from_numpy(x[s * per:(s + 1) * per]).to(d)
                 for s, d in enumerate(mesh.devices))


def _per_device(mesh: Mesh, make) -> Blocks:
    """``make(device)`` once per distinct device, handed to each shard."""
    done = {}
    for d in mesh.devices:
        if d not in done:
            done[d] = make(d)
    return tuple(done[d] for d in mesh.devices)


def replicate_put(mesh: Mesh, x) -> Blocks:
    """A host array, whole, on every shard's device."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return _per_device(mesh, lambda d: t.to(d))


def to_host(blocks: Sequence[torch.Tensor]) -> np.ndarray:
    """A row-sharded table as one host array (the blocks concatenated)."""
    return np.concatenate([b.detach().cpu().numpy() for b in blocks])


def all_gather(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> Blocks:
    """The whole table, concatenated in shard order, on each shard's
    device."""
    return _per_device(mesh, lambda d: torch.cat([b.to(d) for b in blocks]))


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> Blocks:
    """The sum of the per-shard parts, in shard order, on each shard's
    device."""
    def total(d):
        acc = parts[0].to(d, copy=True)
        for p in parts[1:]:
            acc += p.to(d)
        return acc
    return _per_device(mesh, total)


def ppermute(mesh: Mesh, parts: Sequence[torch.Tensor], shift: int) -> Blocks:
    """The rotation by ``shift``: shard ``s``'s part arrives at shard
    ``(s + shift) % S``, on that shard's device."""
    S = mesh.size
    return tuple(parts[(t - shift) % S].to(mesh.devices[t])
                 for t in range(S))


def take_rows(blocks: Sequence[torch.Tensor], ids, device) -> torch.Tensor:
    """Rows ``ids`` (global, in ``[0, S * rows_per_shard)``) of a
    row-sharded table, gathered onto ``device``: each owner takes its own
    rows and sends them."""
    per = blocks[0].shape[0]
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    if ids.numel() and (int(ids.min()) < 0
                        or int(ids.max()) >= per * len(blocks)):
        raise ValueError(f"row ids must be in [0, {per * len(blocks)})")
    out = torch.empty((ids.shape[0],) + tuple(blocks[0].shape[1:]),
                      dtype=blocks[0].dtype, device=device)
    owner = ids // per
    for o, b in enumerate(blocks):
        pos = torch.nonzero(owner == o).squeeze(1)
        if pos.numel():
            local = (ids[pos] - o * per).to(b.device)
            out[pos.to(device)] = b.index_select(0, local).to(device)
    return out


__all__ = ["Mesh", "get_mesh", "get_hybrid_mesh", "initialize_distributed",
           "shard_put", "replicate_put", "to_host", "all_gather", "psum",
           "ppermute", "take_rows"]
