"""The device mesh of the sharded programs, in one process or across
several.

The JAX package drives S devices through a 1-D ``jax.sharding.Mesh`` and
``shard_map``. The port's counterpart is a ``Mesh`` over a tuple of
``torch.device``s with one axis name, and a row-sharded table is a tuple of
per-shard row blocks, block ``s`` on ``mesh.devices[s]``. The program's
three collectives are functions of the mesh, written once here:

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

**Several processes.** ``initialize_distributed`` starts a gloo process
group (the multi-process CLI's ``--coordinator``, ``--num-processes``,
``--process-id``). Then ``get_mesh`` and ``get_hybrid_mesh`` see the global
device list, as ``jax.devices()`` does after ``jax.distributed.initialize``:
each process contributes its own entries (host entries with
``platform='cpu'``, else its visible cards), in process order, and the
mesh records which process owns each position (``owners``). A process
holds only its own positions (``local``): a sharded table is still a tuple
of length S (a ``(D, S)`` grid), with ``None`` where another process owns
the block, and every loop of a program runs over ``local``. The
collectives cross processes: each process computes its local parts as in
one process, the parts are exchanged with gloo through host memory (gloo
gathers CPU tensors only, so each side copies device to host and back),
and each local position gets its result. A sum is taken in position order
after the gather, never by ``all_reduce``, so P processes give bit for bit
the numbers one process gives over the same S entries. Every process must
make the same collective calls in the same order (the sharded estimators'
``U_`` / ``V_`` copies, serving and checkpoints among them), or the run
waits until the group's timeout. gloo over the host is the only transport:
the compute stays on the card.

``get_mesh`` and ``get_hybrid_mesh`` never spread shards over fewer cards
than asked, and never fall back to the CPU.
"""

from __future__ import annotations

import atexit
import datetime
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendation_models_tpu_torch.device import resolve_device

Blocks = Tuple[Optional[torch.Tensor], ...]
Grid = Tuple[Tuple[Optional[torch.Tensor], ...], ...]

# each process's count of CUDA devices, in process order; exchanged at the
# first multi-process mesh on the card
_CUDA_COUNTS: Optional[List[int]] = None
# how long a collective waits for a peer that is alive but late (a peer
# that exits fails it at once)
TIMEOUT = datetime.timedelta(seconds=600)


def _dist():
    import torch.distributed as dist
    return dist


def _running() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return _dist().get_rank() if _running() else 0


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return _dist().get_world_size() if _running() else 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Start the multi-process runtime: a gloo process group of
    ``num_processes`` processes meeting at ``coordinator_address``
    (``host:port``), this one with rank ``process_id``.

    Nothing to do for one process (no arguments, or ``num_processes`` 1),
    and nothing the second time. A multi-process run without a
    coordinator or a ``process_id`` raises ``ValueError``. A collective
    that waits longer than ``TIMEOUT`` for a peer raises, and a peer that
    exits closes its connections, which fails the others' next collective
    at once."""
    if _running():
        return
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is None:
        raise ValueError(f"a coordinator ({coordinator_address}) needs "
                         f"num_processes (--num-processes)")
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if num_processes == 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"a run of {num_processes} processes needs a coordinator "
            f"address (--coordinator) and this process's id "
            f"(--process-id); got {coordinator_address!r} and "
            f"{process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), "
                         f"got {process_id}")
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    # the group's threads are joined before the interpreter tears down (left
    # to the C++ destructors, an exit can abort the process)
    atexit.register(_destroy)


def _destroy() -> None:
    if _running():
        _dist().destroy_process_group()


def barrier() -> None:
    """Wait for every process of the group (nothing in one process)."""
    if process_count() > 1:
        _dist().barrier()


def _host_all_gather(x: torch.Tensor) -> list:
    """Every process's ``x`` (one shape and dtype in all of them) as host
    tensors, in process order: one gloo gather of its bytes, staged
    through host memory."""
    host = x.detach().to("cpu").contiguous()
    flat = host.reshape(-1).view(torch.uint8)
    out = [torch.empty_like(flat) for _ in range(process_count())]
    _dist().all_gather(out, flat)
    return [o.view(host.dtype).reshape(host.shape) for o in out]


def _owners(owners, n: int) -> tuple:
    """The owner of each of ``n`` positions (row-major): this process's
    alone by default; across processes, contiguous and equal blocks in
    process order, every process of the group holding one."""
    if owners is None:
        return (process_index(),) * n
    owners = tuple(int(o) for o in owners)
    P = process_count()
    if len(owners) != n:
        raise ValueError(f"{len(owners)} owners for {n} positions")
    if len(set(owners)) > 1 and (
            n % P or owners != tuple(p for p in range(P)
                                     for _ in range(n // P))):
        raise ValueError(
            f"positions must split into {P} equal blocks in process order, "
            f"one a process; got owners {owners}")
    return owners


class Mesh:
    """A 1-D mesh: ``devices`` (a device may repeat) along ``axis``;
    ``owners[s]`` is the process that holds position ``s`` (default: all
    this process's)."""

    def __init__(self, devices: Sequence, axis: str = "data", owners=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = (axis,)
        self.owners = _owners(owners, len(self.devices))
        me = process_index()
        self.local = tuple(s for s, o in enumerate(self.owners) if o == me)
        self.spans_processes = len(set(self.owners)) > 1

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(str(d) for d in self.devices)}; "
                f"axis={self.axis_names[0]!r})")


class HybridMesh:
    """A 2-D mesh: ``grid[d][s]`` (a device may repeat), the outer axis
    ``axis_names[0]`` (the slices, 'dcn') over the inner ``axis_names[1]``
    ('data'); ``owners[d][s]`` is the process that holds position ``(d,
    s)`` (default: all this process's)."""

    def __init__(self, grid: Sequence[Sequence], axes=("dcn", "data"),
                 owners=None):
        rows = tuple(tuple(torch.device(d) for d in row) for row in grid)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a 2-D mesh needs a non-empty rectangular grid "
                             "of devices")
        if len(axes) != 2:
            raise ValueError(f"a 2-D mesh needs two axis names, got {axes}")
        self.grid = rows
        self.axis_names = tuple(axes)
        S = len(rows[0])
        flat = _owners(None if owners is None
                       else [o for row in owners for o in row],
                       len(rows) * S)
        self.owners = tuple(flat[d * S:(d + 1) * S] for d in range(len(rows)))
        me = process_index()
        self.local = tuple((d, s) for d, row in enumerate(self.owners)
                           for s, o in enumerate(row) if o == me)

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


def cuda_device_counts() -> List[int]:
    """Each process's count of CUDA devices, in process order (exchanged
    once across processes)."""
    global _CUDA_COUNTS
    if process_count() == 1:
        return [torch.cuda.device_count()]
    if _CUDA_COUNTS is None:
        counts = [None] * process_count()
        _dist().all_gather_object(counts, torch.cuda.device_count())
        _CUDA_COUNTS = [int(c) for c in counts]
    return list(_CUDA_COUNTS)


def _resolve_devices(n_shards: Optional[int], platform):
    """(devices, owners) of the first ``n_shards`` global devices of
    ``platform``: host entries for 'cpu' (default one a process), else the
    CUDA cards of every process in process order (default: all); fewer
    devices than asked raise ``ValueError``, as does a count that leaves
    the processes unequal shares."""
    device = resolve_device(platform)
    P = process_count()
    if device.type == "cpu":
        n = P if n_shards is None else n_shards
        devices = [device] * n
        owners = [s * P // n for s in range(n)] if n > 0 else []
    else:
        counts = cuda_device_counts()
        pool = [(p, torch.device("cuda", i))
                for p, c in enumerate(counts) for i in range(c)]
        n = len(pool) if n_shards is None else n_shards
        if n > len(pool):
            raise ValueError(f"requested {n} shards but only {len(pool)} "
                             f"devices")
        devices = [d for _, d in pool[:n]]
        owners = [p for p, _ in pool[:n]]
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    shares = [owners.count(p) for p in range(P)]
    if len(set(shares)) != 1:
        raise ValueError(
            f"n_shards={n} over {P} processes: each process must drive "
            f"n_shards / {P} of them, and the first {n} devices give the "
            f"processes {shares}")
    return devices, owners


def get_mesh(n_shards: Optional[int] = None,
             axis: str = "data",
             platform: Optional[str] = None,
             num_slices: Optional[int] = None) -> Mesh:
    """A 1-D mesh of ``n_shards`` devices along ``axis``.

    ``platform='cpu'``: ``n_shards`` entries of the host (default one a
    process). Else the first ``n_shards`` CUDA cards (default: all); fewer
    cards than asked raise ``ValueError``. Across processes the devices are
    in process order, ``n_shards / P`` a process. ``num_slices`` must
    divide ``n_shards``; the device order is already slice-major."""
    devices, owners = _resolve_devices(n_shards, platform)
    n = len(devices)
    if num_slices is not None and num_slices > 1 and n % num_slices:
        raise ValueError(
            f"n_shards={n} not divisible by num_slices={num_slices}")
    return Mesh(devices, axis, owners)


def get_hybrid_mesh(n_shards: Optional[int] = None,
                    num_slices: Optional[int] = None,
                    axes=("dcn", "data"),
                    platform: Optional[str] = None) -> HybridMesh:
    """A 2-D ``(num_slices, n_shards // num_slices)`` mesh with the slice
    boundary on the outer axis ``axes[0]``.

    The devices are ``get_mesh``'s (``platform='cpu'``: host entries; else
    the first ``n_shards`` cards, fewer raise ``ValueError``). In one
    process the slices are contiguous equal blocks of them (``num_slices``
    default 1); a ``num_slices`` that does not divide ``n_shards`` raises
    ``ValueError``. Across processes each process is one slice, as the
    JAX package groups devices without a ``slice_index`` by process, and a
    ``num_slices`` other than the process count raises ``ValueError``. A
    one-card host runs a 2-D program in one process only through an
    explicit ``HybridMesh`` over a repeated device."""
    devices, owners = _resolve_devices(n_shards, platform)
    n = len(devices)
    P = process_count()
    if P > 1:
        if num_slices is not None and num_slices != P:
            raise ValueError(
                f"{P} real slices found but num_slices={num_slices}")
        num_slices = P
    num_slices = num_slices or 1
    if n % num_slices:
        raise ValueError(
            f"n_shards={n} not divisible by num_slices={num_slices}")
    per = n // num_slices
    return HybridMesh([devices[i * per:(i + 1) * per]
                       for i in range(num_slices)], axes,
                      [owners[i * per:(i + 1) * per]
                       for i in range(num_slices)])


def shard_put(mesh: Mesh, axis: str, x) -> Blocks:
    """Row-shard a host array along ``axis``: block ``s`` (rows ``s * n /
    S`` up to ``(s + 1) * n / S``) on ``mesh.devices[s]``, placed only
    where this process owns it (``None`` elsewhere). The row count must
    divide by the shard count."""
    x = np.ascontiguousarray(x)
    S = mesh.shape[axis]
    if x.shape[0] % S:
        raise ValueError(f"{x.shape[0]} rows do not divide into {S} shards")
    per = x.shape[0] // S
    return tuple(torch.from_numpy(x[s * per:(s + 1) * per]).to(d)
                 if s in mesh.local else None
                 for s, d in enumerate(mesh.devices))


def _per_device(mesh: Mesh, make) -> Blocks:
    """``make(device)`` once per distinct device of this process's
    positions, handed to each of them (``None`` at the others)."""
    done = {}
    out = []
    for s, d in enumerate(mesh.devices):
        if s not in mesh.local:
            out.append(None)
            continue
        if d not in done:
            done[d] = make(d)
        out.append(done[d])
    return tuple(out)


def replicate_put(mesh: Mesh, x) -> Blocks:
    """A host array, whole, on the device of every position this process
    owns."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return _per_device(mesh, lambda d: t.to(d))


def _gather_positions(local: Sequence[torch.Tensor]) -> list:
    """The parts of every position (each process's ``local`` parts, in
    position order, one shape and dtype in all), as host tensors in
    position order: one exchange across the processes."""
    stacked = torch.stack([t.detach().to("cpu") for t in local])
    return [t for block in _host_all_gather(stacked) for t in block.unbind(0)]


def gather_parts(mesh: Mesh, parts: Sequence) -> Sequence:
    """``parts`` (one per position, ``None`` where another process owns
    it) with every position filled: as given in one process, else gathered
    from their owners as host tensors."""
    if not mesh.spans_processes:
        return parts
    return _gather_positions([parts[s] for s in mesh.local])


def to_host(blocks: Sequence) -> np.ndarray:
    """A row-sharded table as one host array (the blocks concatenated).

    Across processes (blocks held elsewhere are ``None``) every process
    gets the whole table, so every process must call it. A 2-D program's
    table (``blocks[d][s]``, replicated across the outer axis) is taken
    from the first slice this process holds whole."""
    if blocks and isinstance(blocks[0], tuple):
        whole = [row for row in blocks if all(b is not None for b in row)]
        if not whole:
            raise ValueError("this process holds no whole slice of the "
                             "table")
        blocks = whole[0]
    if any(b is None for b in blocks):
        blocks = _gather_positions([b for b in blocks if b is not None])
    return np.concatenate([b.detach().cpu().numpy() for b in blocks])


def all_gather(mesh: Mesh, blocks: Blocks) -> Blocks:
    """The whole table, concatenated in shard order, on each shard's
    device."""
    blocks = gather_parts(mesh, blocks)
    return _per_device(mesh, lambda d: torch.cat([b.to(d) for b in blocks]))


def psum(mesh: Mesh, parts: Blocks) -> Blocks:
    """The sum of the per-shard parts, in shard order, on each shard's
    device."""
    parts = gather_parts(mesh, parts)

    def total(d):
        acc = parts[0].to(d, copy=True)
        for p in parts[1:]:
            acc += p.to(d)
        return acc
    return _per_device(mesh, total)


def ppermute(mesh: Mesh, parts: Blocks, shift: int) -> Blocks:
    """The rotation by ``shift``: shard ``s``'s part arrives at shard
    ``(s + shift) % S``, on that shard's device. Across processes every
    part is gathered (one padded shape a rotation), and each process keeps
    what its positions receive."""
    S = mesh.size
    parts = gather_parts(mesh, parts)
    return tuple(parts[(t - shift) % S].to(mesh.devices[t])
                 if t in mesh.local else None for t in range(S))


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


def _per_group(mesh: HybridMesh, axis: str, parts: Grid,
               make: Callable[[list, list, torch.device], torch.Tensor]
               ) -> Grid:
    """``make(group, parts, device)`` once per (group along ``axis``,
    distinct device of this process's positions in it), handed to each of
    them (``None`` at the others). Where a group crosses processes the
    parts are gathered from their owners first."""
    groups = _groups(mesh, axis)
    if any(len({mesh.owners[d][s] for d, s in g}) > 1 for g in groups):
        S = len(mesh.grid[0])
        flat = _gather_positions([parts[d][s] for d, s in mesh.local])
        parts = [flat[d * S:(d + 1) * S] for d in range(len(mesh.grid))]
    local = set(mesh.local)
    out = [[None] * len(row) for row in mesh.grid]
    for group in groups:
        done = {}
        for d, s in group:
            if (d, s) not in local:
                continue
            dev = mesh.grid[d][s]
            if dev not in done:
                done[dev] = make(group, parts, dev)
            out[d][s] = done[dev]
    return tuple(tuple(row) for row in out)


def psum_along(mesh: HybridMesh, parts: Grid, axis: str) -> Grid:
    """The sum of ``parts[d][s]`` over each group along ``axis`` (in axis
    order), on each position's device."""
    def total(group, parts, dev):
        acc = parts[group[0][0]][group[0][1]].to(dev, copy=True)
        for d, s in group[1:]:
            acc += parts[d][s].to(dev)
        return acc
    return _per_group(mesh, axis, parts, total)


def all_gather_along(mesh: HybridMesh, blocks: Grid, axis: str) -> Grid:
    """The blocks of each group along ``axis``, concatenated in axis order,
    on each position's device."""
    return _per_group(mesh, axis, blocks, lambda group, parts, dev: torch.cat(
        [parts[d][s].to(dev) for d, s in group]))


def take_rows(blocks: Blocks, ids, device) -> torch.Tensor:
    """Rows ``ids`` (global, in ``[0, S * rows_per_shard)``) of a
    row-sharded table, gathered onto ``device``: each owner takes its own
    rows and sends them. Across processes (blocks held elsewhere are
    ``None``) every process must call it with the same ids."""
    held = [(o, b) for o, b in enumerate(blocks) if b is not None]
    per = held[0][1].shape[0]
    S = len(blocks)
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= per * S):
        raise ValueError(f"row ids must be in [0, {per * S})")
    shape = (ids.shape[0],) + tuple(held[0][1].shape[1:])
    dtype = held[0][1].dtype
    owner = ids // per
    if len(held) == S:
        out = torch.empty(shape, dtype=dtype, device=device)
        for o, b in held:
            pos = torch.nonzero(owner == o).squeeze(1)
            if pos.numel():
                local = (ids[pos] - o * per).to(b.device)
                out[pos.to(device)] = b.index_select(0, local).to(device)
        return out
    # each process fills the rows of its own blocks; each row is then taken
    # from the process that holds its block (blocks are owned in process
    # order, len(held) a process)
    mine = torch.zeros(shape, dtype=dtype)
    for o, b in held:
        pos = torch.nonzero(owner == o).squeeze(1)
        if pos.numel():
            mine[pos] = b.index_select(0, (ids[pos] - o * per).to(
                b.device)).cpu()
    theirs = _host_all_gather(mine)
    proc = owner // len(held)
    out = theirs[0].clone()
    for p, part in enumerate(theirs[1:], start=1):
        pos = torch.nonzero(proc == p).squeeze(1)
        out[pos] = part[pos]
    return out.to(device)


__all__ = ["Mesh", "HybridMesh", "get_mesh", "get_hybrid_mesh",
           "initialize_distributed", "process_index", "process_count",
           "cuda_device_counts", "barrier", "gather_parts", "shard_put",
           "replicate_put", "to_host", "all_gather", "psum", "ppermute",
           "psum_along", "all_gather_along", "take_rows"]
