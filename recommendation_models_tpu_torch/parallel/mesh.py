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

The observation-parallel program runs on a 2-D ``HybridMesh``: a ``(D, S)``
grid of devices (a device may repeat) with the axes ``('dcn', 'data')``,
whose per-position tensors are nested tuples ``parts[d][s]``.
``psum_along`` and ``all_gather_along`` reduce or gather along one axis:
each group (the positions that differ only along that axis) is computed
apart, once per distinct device within the group, so S groups on one card
get S different sums.

``get_mesh`` and ``get_hybrid_mesh`` never spread shards over fewer cards
than asked, and never fall back to the CPU. Multi-process runs
(``initialize_distributed``) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.models.base import not_ported

Blocks = Tuple[torch.Tensor, ...]
Grid = Tuple[Tuple[torch.Tensor, ...], ...]


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


class HybridMesh:
    """A 2-D mesh: ``grid[d][s]`` (a device may repeat), the outer axis
    ``axis_names[0]`` (the slices, 'dcn') over the inner ``axis_names[1]``
    ('data')."""

    def __init__(self, grid: Sequence[Sequence], axes=("dcn", "data")):
        rows = tuple(tuple(torch.device(d) for d in row) for row in grid)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a 2-D mesh needs a non-empty rectangular grid "
                             "of devices")
        if len(axes) != 2:
            raise ValueError(f"a 2-D mesh needs two axis names, got {axes}")
        self.grid = rows
        self.axis_names = tuple(axes)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.grid),
                self.axis_names[1]: len(self.grid[0])}

    @property
    def devices(self) -> tuple:
        """The devices in row-major (slice-major) order."""
        return tuple(d for row in self.grid for d in row)

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    def __repr__(self) -> str:
        return (f"HybridMesh({self.shape}; "
                f"{', '.join(str(d) for d in self.devices)})")


def _resolve_devices(n_shards: Optional[int], platform) -> list:
    """The first ``n_shards`` devices of ``platform``: entries of the host
    for 'cpu' (default 1), else CUDA cards (default: all); fewer cards
    than asked raise ``ValueError``."""
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
    return devices


def get_mesh(n_shards: Optional[int] = None,
             axis: str = "data",
             platform: Optional[str] = None,
             num_slices: Optional[int] = None) -> Mesh:
    """A 1-D mesh of ``n_shards`` devices along ``axis``.

    ``platform='cpu'``: ``n_shards`` entries of the host (default 1). Else
    the first ``n_shards`` CUDA cards (default: all); fewer cards than
    asked raise ``ValueError``. ``num_slices`` must divide ``n_shards``;
    in one process the device order is already slice-major."""
    devices = _resolve_devices(n_shards, platform)
    n = len(devices)
    if num_slices is not None and num_slices > 1 and n % num_slices:
        raise ValueError(
            f"n_shards={n} not divisible by num_slices={num_slices}")
    return Mesh(devices, axis)


def get_hybrid_mesh(n_shards: Optional[int] = None,
                    num_slices: Optional[int] = None,
                    axes=("dcn", "data"),
                    platform: Optional[str] = None) -> HybridMesh:
    """A 2-D ``(num_slices, n_shards // num_slices)`` mesh with the slice
    boundary on the outer axis ``axes[0]``.

    The devices are ``get_mesh``'s (``platform='cpu'``: host entries; else
    the first ``n_shards`` cards, fewer raise ``ValueError``). One process
    is one slice group, so the slices are contiguous equal blocks of them
    (``num_slices`` default 1); a ``num_slices`` that does not divide
    ``n_shards`` raises ``ValueError``. A one-card host runs a 2-D program
    only through an explicit ``HybridMesh`` over a repeated device."""
    devices = _resolve_devices(n_shards, platform)
    n = len(devices)
    num_slices = num_slices or 1
    if n % num_slices:
        raise ValueError(
            f"n_shards={n} not divisible by num_slices={num_slices}")
    per = n // num_slices
    return HybridMesh([devices[i * per:(i + 1) * per]
                       for i in range(num_slices)], axes)


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
    """A row-sharded table as one host array (the blocks concatenated). A
    2-D program's table (``blocks[d][s]``, replicated across the outer
    axis) is taken from its first slice."""
    if blocks and isinstance(blocks[0], tuple):
        blocks = blocks[0]
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


def _groups(mesh: HybridMesh, axis: str):
    """The positions ``(d, s)`` of each group along ``axis``, in axis
    order: one group per inner index along the outer axis, one per outer
    index along the inner axis."""
    D, S = len(mesh.grid), len(mesh.grid[0])
    if axis == mesh.axis_names[0]:
        return [[(d, s) for d in range(D)] for s in range(S)]
    if axis == mesh.axis_names[1]:
        return [[(d, s) for s in range(S)] for d in range(D)]
    raise ValueError(f"axis {axis!r} is not one of {mesh.axis_names}")


def _per_group(mesh: HybridMesh, axis: str,
               make: Callable[[list, torch.device], torch.Tensor]) -> Grid:
    """``make(group, device)`` once per (group along ``axis``, distinct
    device in it), handed to each position of the group on that device."""
    out = [list(row) for row in mesh.grid]
    for group in _groups(mesh, axis):
        done = {}
        for d, s in group:
            dev = mesh.grid[d][s]
            if dev not in done:
                done[dev] = make(group, dev)
            out[d][s] = done[dev]
    return tuple(tuple(row) for row in out)


def psum_along(mesh: HybridMesh, parts: Grid, axis: str) -> Grid:
    """The sum of ``parts[d][s]`` over each group along ``axis`` (in axis
    order), on each position's device."""
    def total(group, dev):
        acc = parts[group[0][0]][group[0][1]].to(dev, copy=True)
        for d, s in group[1:]:
            acc += parts[d][s].to(dev)
        return acc
    return _per_group(mesh, axis, total)


def all_gather_along(mesh: HybridMesh, blocks: Grid, axis: str) -> Grid:
    """The blocks of each group along ``axis``, concatenated in axis order,
    on each position's device."""
    return _per_group(mesh, axis, lambda group, dev: torch.cat(
        [blocks[d][s].to(dev) for d, s in group]))


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


__all__ = ["Mesh", "HybridMesh", "get_mesh", "get_hybrid_mesh",
           "initialize_distributed", "shard_put", "replicate_put", "to_host",
           "all_gather", "psum", "ppermute", "psum_along", "all_gather_along",
           "take_rows"]
