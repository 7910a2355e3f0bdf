"""Row gather-and-sum: the CUDA kernel P1, its wrapper and its plain PyTorch
version.

``gather_rows_sum(table, idx, slots)`` computes ``out (1, k) f32 =
Σ_i table[idx[i], :]`` for a contiguous (n, k) f32 table and an (n_gather,)
int32 index vector. It replaces the TPU kernel of the reference's
``scripts/probe_dma_gather.py::make_probe`` (P1), a per-row manual-DMA
gather with ``slots`` row copies in flight; the gather-rate probes
(``probes/dma_gather.py``, ``probes/gather_rates.py``,
``probes/ablate_epoch.py``, ``probes/gather_latency.py``) run it beside the
library gathers.

On the card it is one launch of the kernel of ``csrc/gather.cu``:

- lanes: ``lanes_per_row(k, vec)`` lanes share a row (16 at k=64 with
  16-byte loads, so a warp step gathers two rows and every lane loads; 32
  at k=128; 8 at k=16); rows wider than 32 column groups are cut into
  ``slices_for`` slices, one per block;
- loads in flight: each warp keeps ``slots`` row copies in flight, rounded
  up to whole warp steps and a power-of-two depth (``depth_for``), in
  registers (``ld.global.nc``, no shared-memory ring), a compile-time
  depth per instantiation;
- grid: at most the instantiation's resident blocks, asked of the card
  once per (vec, lanes, depth, device) and cached; fewer for a short index
  vector, so that each warp runs ``MIN_ROUNDS`` pipeline rounds
  (``grid_for``);
- one launch: every block writes its partial row to a scratch buffer and
  takes a ticket from an arrival counter; the last block adds the partials
  in block order and writes ``out``, and the counter wraps back to 0. The
  scratch buffer and its counter are kept per (device, stream), so calls
  on two streams never share a counter;
- bound: for these shapes the L2's read rate (every gathered row's bytes
  over it), beside the bytes bound that counts each distinct row once;
  rows an SM's L1 serves again can beat the L2 bound, which then bounds
  nothing; both are in ``PERF.md`` section 6.

Per call the wrapper makes one ctypes call and one ``torch.empty`` (the
output); nothing on that path queries occupancy or sets a function
attribute.

Contract: any n_gather >= 0 (0 gives zeros), 1 <= k <= 512,
1 <= slots <= 32; anything else, another dtype, a non-contiguous tensor or
tensors on two devices raise ``ValueError``. Ids outside [0, n) are the
caller's fault, as in the reference: the kernel does not check them (the
plain version's ``index_select`` raises). The kernel adds in a fixed order
without atomics in the sum, so repeated calls on one card agree bitwise;
it adds in another order than the plain version, so the two agree per
column within f32 rounding of Σ_i |table[idx_i, j]|.

The wrapper launches the kernel for CUDA tensors and takes the plain
version for CPU tensors, and raises for anything else. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KMAX = 512              # csrc/gather.cu KMAX
SLOTS_MAX = 32          # csrc/gather.cu SLOTS_MAX
WARPS = 8               # csrc/gather.cu WARPS: warps per block
DEFAULT_SLOTS = 8
MIN_ROUNDS = 2          # pipeline rounds per warp before the grid grows

LAUNCHES = {"gather_rows_sum": 0}


def reset_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def lanes_per_row(k: int, vec: int) -> int:
    """Lanes that share a row of k floats loaded ``vec`` at a time: the
    power of two at least the row's column groups, at most a warp."""
    return min(32, _pow2_at_least(-(-k // vec)))


def slices_for(k: int, vec: int, lanes: int) -> int:
    """Column slices of a row (one per block): 1 unless the row has more
    than 32 column groups."""
    return -(-k // (lanes * vec))


def depth_for(slots: int, lanes: int) -> int:
    """Warp steps in flight for ``slots`` row copies per warp: a step
    covers 32 / lanes rows; rounded up to a power of two (at most
    ``lanes``, the kernel's largest depth at that width)."""
    return _pow2_at_least(-(-slots * lanes // 32))


def grid_for(n: int, lanes: int, depth: int, slices: int,
             resident: int) -> int:
    """Blocks of a launch over n ids: ``slices`` per part of idx, as many
    parts as give each warp ``MIN_ROUNDS`` pipeline rounds of ``depth``
    steps, at least 1 and at most the resident blocks allow."""
    per_part = WARPS * (32 // lanes) * depth * MIN_ROUNDS
    parts = min(-(-n // per_part), max(1, resident // slices))
    return max(1, parts) * slices


def gather_rows_sum_plain(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_rows_sum``: ``index_select`` then a sum
    over rows, in f32."""
    return table.index_select(0, idx.long()).sum(0, keepdim=True,
                                                 dtype=torch.float32)


def _check(table: torch.Tensor, idx: torch.Tensor, slots: int) -> None:
    # one test on the launch path, the reason only when it fails
    if (table.dtype is torch.float32 and idx.dtype is torch.int32
            and table.dim() == 2 and idx.dim() == 1
            and isinstance(slots, int) and 1 <= slots <= SLOTS_MAX
            and 1 <= table.shape[1] <= KMAX and table.is_contiguous()
            and idx.is_contiguous() and table.device == idx.device
            and table.device.type in ("cpu", "cuda")):
        return
    if table.dtype != torch.float32:
        raise ValueError(f"table must be float32, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table must be (n, k) and idx (n_gather,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    _check_limits(table.shape[1], slots)
    if table.device != idx.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def _check_limits(k: int, slots: int) -> None:
    if not 1 <= k <= KMAX:
        raise ValueError(f"k must be in [1, {KMAX}], got {k}")
    if not isinstance(slots, int) or not 1 <= slots <= SLOTS_MAX:
        raise ValueError(f"slots must be an int in [1, {SLOTS_MAX}], got "
                         f"{slots!r}")


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = []


def _lib():
    """The library of ``csrc/gather.cu``, built and loaded on first use, its
    limits checked against this module's."""
    if not _LIB:
        from recommendation_models_tpu_torch.ops.build import load
        lib = load("gather")
        lib.gather_resident.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.gather_resident.restype = _I
        lib.gather_rows_sum.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                        _I, _I, _I, _P]
        lib.gather_rows_sum.restype = _I
        lib.gather_error_string.argtypes = [_I]
        lib.gather_error_string.restype = ctypes.c_char_p
        if (lib.gather_kernel_kmax() != KMAX
                or lib.gather_kernel_slots_max() != SLOTS_MAX
                or lib.gather_kernel_warps() != WARPS):
            raise RuntimeError("csrc/gather.cu limits disagree with "
                               "ops/gather.py")
        _LIB.append(lib)
    return _LIB[0]


def _raise_on(err: int, lib) -> None:
    if err:
        msg = lib.gather_error_string(err).decode()
        raise RuntimeError(f"gather_rows_sum kernel failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def _config(k: int, slots: int, vec: int, device: int):
    """(lanes, depth, slices, resident blocks) of a call at (k, slots) with
    ``vec``-float loads on card ``device``: the card is asked once per key."""
    lanes = lanes_per_row(k, vec)
    depth = depth_for(slots, lanes)
    resident = _I(0)
    lib = _lib()
    with torch.cuda.device(device):
        _raise_on(lib.gather_resident(vec, lanes, depth,
                                      ctypes.byref(resident)), lib)
    return lanes, depth, slices_for(k, vec, lanes), resident.value


def gather_config(k: int, slots: int = DEFAULT_SLOTS, vec: int = 4) -> dict:
    """The launch configuration of a call at (k, slots) with ``vec``-float
    loads (4 needs k % 4 == 0) on the current card: lanes a row, steps in
    flight, column slices and the instantiation's resident blocks, for the
    kernel's checks (``probes.gather_latency.edge_counts``). Launches
    nothing; the card is asked once per key."""
    _check_limits(k, slots)
    if vec not in (1, 4) or (vec == 4 and k % 4):
        raise ValueError(f"vec must be 1, or 4 with k % 4 == 0; got {vec}")
    lanes, depth, slices, resident = _config(k, slots, vec,
                                             torch.cuda.current_device())
    return dict(lanes=lanes, depth=depth, slices=slices, resident=resident)


# (device, stream) -> f32 scratch: the partials, then the arrival counter
# (0 between calls; the kernel puts it back). Calls on one stream run in
# order, so they can share it; calls on two streams never do.
_SCRATCH = {}


def _scratch(dev: torch.device, stream: int, floats: int):
    """(partials pointer, counter pointer) of the scratch of (dev, stream),
    grown (zeroed) when it holds fewer than ``floats`` partials."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.shape[0] <= floats:
        cap = max(floats, 0 if buf is None else 2 * (buf.shape[0] - 1))
        buf = _SCRATCH[key] = torch.zeros(cap + 1, dtype=torch.float32,
                                          device=dev)
    ptr = buf.data_ptr()
    return ptr, ptr + 4 * (buf.shape[0] - 1)


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor,
                    slots: int = DEFAULT_SLOTS) -> torch.Tensor:
    """out (1, k) f32 = Σ_i table[idx[i], :] for table (n, k) f32 and idx
    (n_gather,) int32, both contiguous on one device; on a card with
    ``slots`` row copies in flight per warp, in one launch."""
    _check(table, idx, slots)
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_sum_plain(table, idx)
    n, k = idx.shape[0], table.shape[1]
    vec = 4 if k % 4 == 0 and table.data_ptr() % 16 == 0 else 1
    lanes, depth, slices, resident = _config(k, slots, vec, dev.index)
    grid = grid_for(n, lanes, depth, slices, resident)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    partials, counter = _scratch(dev, stream, grid // slices * k)
    out = torch.empty((1, k), dtype=torch.float32, device=dev)
    lib = _LIB[0]
    _raise_on(lib.gather_rows_sum(
        table.data_ptr(), idx.data_ptr(), partials, counter, out.data_ptr(),
        n, k, vec, lanes, depth, slices, grid, stream), lib)
    LAUNCHES["gather_rows_sum"] += 1
    return out


def make_probe(n_rows_table: int, k: int, n_gather: int,
               slots: int = DEFAULT_SLOTS):
    """The reference probe's factory: ``fn(idx, table) -> (1, k) f32``, the
    sum of the ``n_gather`` gathered rows, for the shapes it was made for
    (other shapes raise ``ValueError``, as the reference's fixed
    ``pallas_call`` refuses them). The argument order is the one the
    reference's kernel takes (its docstring says ``fn(table, idx)``)."""
    _check_limits(k, slots)

    def fn(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        if tuple(idx.shape) != (n_gather,):
            raise ValueError(f"idx must have shape ({n_gather},), got "
                             f"{tuple(idx.shape)}")
        if tuple(table.shape) != (n_rows_table, k):
            raise ValueError(f"table must have shape ({n_rows_table}, {k}), "
                             f"got {tuple(table.shape)}")
        return gather_rows_sum(table, idx, slots)

    return fn


def sum_tolerance(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-column tolerance (1, k) of the kernel against its plain version:
    ``2e-6 · Σ_i |table[idx_i, j]| + 1e-6`` (the two add in different orders
    in f32)."""
    return 2e-6 * gather_rows_sum_plain(table.abs(), idx) + 1e-6


__all__ = ["gather_rows_sum", "gather_rows_sum_plain", "make_probe",
           "lanes_per_row", "slices_for", "depth_for", "grid_for",
           "sum_tolerance", "reset_counts", "LAUNCHES", "KMAX", "SLOTS_MAX",
           "DEFAULT_SLOTS", "WARPS", "MIN_ROUNDS"]
