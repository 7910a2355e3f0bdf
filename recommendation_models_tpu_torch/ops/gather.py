"""Row gather-and-sum: the CUDA kernel P1, its wrapper and its plain PyTorch
version.

``gather_rows_sum(table, idx, slots)`` computes ``out (1, k) f32 =
Σ_i table[idx[i], :]`` for a contiguous (n, k) f32 table and an (n_gather,)
int32 index vector. It replaces the TPU kernel of the reference's
``scripts/probe_dma_gather.py::make_probe`` (P1), a per-row manual-DMA
gather with ``slots`` row copies in flight; on the card it is the kernel of
``csrc/gather.cu`` (a persistent grid whose warps each keep ``slots``
cp.async row copies in flight into a ring of shared-memory rows), and the
gather-rate probes (``probes/dma_gather.py``, ``probes/gather_rates.py``,
``probes/ablate_epoch.py``) run it beside the library gathers.

Contract: any n_gather >= 0 (0 gives zeros), 1 <= k <= 512,
1 <= slots <= 32; anything else, another dtype, a non-contiguous tensor or
tensors on two devices raise ``ValueError``. Ids outside [0, n) are the
caller's fault, as in the reference: the kernel does not check them (the
plain version's ``index_select`` raises). The kernel adds in a fixed order
without atomics, so repeated calls on one card agree bitwise; it adds in
another order than the plain version, so the two agree per column within
f32 rounding of Σ_i |table[idx_i, j]|.

The wrapper launches the kernel for CUDA tensors and takes the plain
version for CPU tensors, and raises for anything else. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

KMAX = 512              # csrc/gather.cu KMAX
SLOTS_MAX = 32          # csrc/gather.cu SLOTS_MAX
WARPS_MAX = 8           # csrc/gather.cu WARPS_MAX
SMEM_MAX = 227 * 1024   # csrc/gather.cu SMEM_MAX
DEFAULT_SLOTS = 8

LAUNCHES = {"gather_rows_sum": 0}


def reset_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def ring_warps(k: int, slots: int) -> int:
    """Warps per block of the gather kernel: at most 8, and as many as
    keep the block's ring of ``warps × slots`` rows of k f32 within
    227 KB of shared memory."""
    return min(WARPS_MAX, SMEM_MAX // (slots * k * 4))


def gather_rows_sum_plain(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_rows_sum``: ``index_select`` then a sum
    over rows, in f32."""
    return table.index_select(0, idx.long()).sum(0, keepdim=True,
                                                 dtype=torch.float32)


def _check(table: torch.Tensor, idx: torch.Tensor, slots: int) -> None:
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
        lib.gather_rows_sum_grid.argtypes = [_LL, _I, _I, _I, _I,
                                             ctypes.POINTER(_I)]
        lib.gather_rows_sum_grid.restype = _I
        lib.gather_rows_sum.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I,
                                        _I, _P]
        lib.gather_rows_sum.restype = _I
        lib.gather_error_string.argtypes = [_I]
        lib.gather_error_string.restype = ctypes.c_char_p
        lib.gather_kernel_smem_max.restype = _LL
        if (lib.gather_kernel_kmax() != KMAX
                or lib.gather_kernel_slots_max() != SLOTS_MAX
                or lib.gather_kernel_warps_max() != WARPS_MAX
                or lib.gather_kernel_smem_max() != SMEM_MAX):
            raise RuntimeError("csrc/gather.cu limits disagree with "
                               "ops/gather.py")
        _LIB.append(lib)
    return _LIB[0]


def _raise_on(err: int, lib) -> None:
    if err:
        msg = lib.gather_error_string(err).decode()
        raise RuntimeError(f"gather_rows_sum kernel failed: CUDA error {err} "
                           f"({msg})")


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor,
                    slots: int = DEFAULT_SLOTS) -> torch.Tensor:
    """out (1, k) f32 = Σ_i table[idx[i], :] for table (n, k) f32 and idx
    (n_gather,) int32, both contiguous on one device; on a card with
    ``slots`` row copies in flight per warp."""
    _check(table, idx, slots)
    if table.device.type == "cpu":
        return gather_rows_sum_plain(table, idx)
    n, k = idx.shape[0], table.shape[1]
    dev = table.device
    lib = _lib()
    vec = 4 if k % 4 == 0 and table.data_ptr() % 16 == 0 else 1
    warps = ring_warps(k, slots)
    grid = _I(0)
    _raise_on(lib.gather_rows_sum_grid(n, k, slots, warps, vec,
                                       ctypes.byref(grid)), lib)
    partials = torch.empty((grid.value, k), dtype=torch.float32, device=dev)
    out = torch.empty((1, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.gather_rows_sum(
        table.data_ptr(), idx.data_ptr(), partials.data_ptr(),
        out.data_ptr(), n, k, slots, warps, vec, grid.value, stream), lib)
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
           "ring_warps", "sum_tolerance", "reset_counts", "LAUNCHES", "KMAX",
           "SLOTS_MAX", "DEFAULT_SLOTS"]
