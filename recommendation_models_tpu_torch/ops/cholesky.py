"""Batched ridge-Cholesky solves: CUDA kernels, their wrappers and their
plain PyTorch versions.

Two kernels (``csrc/cholesky_solve.cu``) replace the two TPU kernels that
the ALS sweep runs (``recommendation_models_tpu/ops/pallas/cholesky.py``):

- ``cholesky_solve_batched``: ``x = (G + diag(reg))⁻¹ rhs`` for a batch of
  SPD systems (TPU ``_cholesky_solve_kernel_pair``);
- ``cholesky_solve_hot``: the same solve after adding the hot-column gram
  and rhs terms ``Σ_c wg[b,c] v_c v_cᵀ`` and ``Σ_c wr[b,c] v_c`` inside the
  kernel (TPU ``_cholesky_solve_kernel_hot``).

Shared contract: f32 factorization, ridge added on load, pivots clamped at
``max(d, 1e-30)``, so identity-padded and all-zero systems with rhs 0 solve
to 0. The kernels take batch-major tensors: G (B, k, k), rhs (B, k),
reg (B,), hot slab hv (B, C) bf16, hot factor rows vh (C, k) f32.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors, and raises for anything else. Shapes beyond the
kernel's own limits (``kernel_supported`` / ``hot_kernel_supported``) are
routed, before any launch, to the torch anchor (``torch.linalg.cholesky``)
or to the torch fold of the hot terms, and counted in ``ROUTED``.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from recommendation_models_tpu_torch.ops.gram import objective_weights

PIVOT_FLOOR = 1e-30
KMAX = 128              # csrc/cholesky_solve.cu KMAX
HOT_CMAX = 1024         # csrc/cholesky_solve.cu CMAX
SMEM_MAX = 227 * 1024   # csrc/cholesky_solve.cu SMEM_MAX

LAUNCHES = {"cholesky_solve_batched": 0, "cholesky_solve_hot": 0}
ROUTED = {"cholesky_solve_batched": 0, "cholesky_solve_hot": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, ROUTED):
        for key in d:
            d[key] = 0


def block_batch(k: int) -> int:
    """Row granule of the sweep: buckets are padded, and big buckets split
    into row blocks, in multiples of this. The CUDA kernels take any batch
    size; 256 is the reference's value at k <= 160, kept so row blocks
    match."""
    return 256


def kernel_supported(k: int) -> bool:
    """Whether the CUDA kernels take systems of order k (the shared-memory
    and register tiling cap)."""
    return 1 <= k <= KMAX


def hot_smem_bytes(k: int, c: int) -> int:
    """Dynamic shared memory of the hot kernel's block (``smem_bytes`` in
    csrc/cholesky_solve.cu): vh (C, kp), the column buffers, L, y, 1/L_jj,
    the compacted hot entries and the per-warp counts."""
    kp = (k + 3) // 4 * 4
    tiles = (kp // 4) * (kp // 4 + 1) // 2
    warps = (160 if tiles <= 160 else 256) // 32
    return 4 * (c * kp + 2 * (kp + 4) + kp * (kp + 1) + 2 * kp + 3 * c) \
        + 4 * warps


def hot_kernel_supported(k: int, c: int) -> bool:
    """Whether the fused hot kernel takes order k with a C-wide hot block:
    C up to the layout policy's widest (1024), with vh in shared memory."""
    return (kernel_supported(k) and 1 <= c <= HOT_CMAX
            and hot_smem_bytes(k, c) <= SMEM_MAX)


def hot_cols_cap(k: int) -> int:
    """The reference's hot-column cap (its TPU kernel's VMEM budget: 128 at
    k=64, 32 at k=128), copied verbatim for the layout policy."""
    return min(max((2 * 1024 * 1024 // (k * k * 4)) // 8 * 8, 0), 1024)


def hot_cols_auto(k: int) -> int:
    """Hot-column width of the ALS auto policy (copied verbatim): the cap,
    or 0 when the cap is below 64."""
    cap = hot_cols_cap(k)
    return cap if cap >= 64 else 0


# --------------------------------------------------------------------------
# plain PyTorch versions

def cholesky_solve_plain(G: torch.Tensor, rhs: torch.Tensor,
                         reg: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cholesky_solve_batched``: the kernel's
    right-looking factorization, pivot clamp and column-oriented
    substitutions, vectorized over the batch."""
    b, k, _ = G.shape
    A = G.float().clone()
    A.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    Ld = torch.empty((b, k), dtype=torch.float32, device=G.device)
    for j in range(k):
        d = A[:, j, j].clone()
        inv = torch.rsqrt(torch.clamp_min(d, PIVOT_FLOOR))
        c = A[:, j + 1:, j] * inv[:, None]
        A[:, j + 1:, j + 1:] -= c[:, :, None] * c[:, None, :]
        A[:, j + 1:, j] = c
        Ld[:, j] = d * inv
    piv = torch.clamp_min(Ld, PIVOT_FLOOR)
    y = rhs.float().clone()
    for j in range(k):
        y[:, j] /= piv[:, j]
        y[:, j + 1:] -= A[:, j + 1:, j] * y[:, j:j + 1]
    for j in range(k - 1, -1, -1):
        y[:, j] /= piv[:, j]
        y[:, :j] -= A[:, j, :j] * y[:, j:j + 1]
    return y


def fold_hot(G, rhs, hv, vh, alpha):
    """The hot-column terms added in torch: ``G + Σ_c wg v_c v_cᵀ`` and
    ``rhs + Σ_c wr v_c``, in full f32 (one (B, C) x (C, k²) product)."""
    b, k, _ = G.shape
    hv_f = hv.float()
    wg, wr = objective_weights(hv_f, (hv_f != 0).float(), alpha)
    vh = vh.float()
    P = (vh[:, :, None] * vh[:, None, :]).reshape(vh.shape[0], k * k)
    return (G.float() + (wg @ P).view(b, k, k),
            rhs.float() + wr @ vh)


def cholesky_solve_hot_plain(G, rhs, reg, hv, vh, alpha=None):
    """Plain version of ``cholesky_solve_hot``: the torch fold, then the
    plain solve."""
    G2, rhs2 = fold_hot(G, rhs, hv, vh, alpha)
    return cholesky_solve_plain(G2, rhs2, reg)


def anchor_solve(G, rhs, reg):
    """The torch anchor: ``torch.linalg.cholesky`` and two triangular solves
    on ``G + diag(reg)``; a failed factorization gives NaN rows, as the
    reference's ``jnp.linalg.cholesky`` does."""
    A = G.float().clone()
    A.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[:, None, None],
                    torch.full_like(L, float("nan")), L)
    return torch.cholesky_solve(rhs.float()[:, :, None], L)[:, :, 0]


# --------------------------------------------------------------------------
# kernel wrappers

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from recommendation_models_tpu_torch.ops.build import load
        lib = load("cholesky_solve")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cholesky_solve_batched.argtypes = [P, P, P, P, I, I, P]
        lib.cholesky_solve_batched.restype = I
        lib.cholesky_solve_hot.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                           ctypes.c_float, P]
        lib.cholesky_solve_hot.restype = I
        lib.cholesky_error_string.argtypes = [I]
        lib.cholesky_error_string.restype = ctypes.c_char_p
        lib.cholesky_kernel_kmax.restype = I
        lib.cholesky_kernel_cmax.restype = I
        lib.cholesky_kernel_smem_max.restype = ctypes.c_longlong
        if (lib.cholesky_kernel_kmax() != KMAX
                or lib.cholesky_kernel_cmax() != HOT_CMAX
                or lib.cholesky_kernel_smem_max() != SMEM_MAX):
            raise RuntimeError("csrc/cholesky_solve.cu limits disagree with "
                               "ops/cholesky.py")
        _LIB = lib
    return _LIB


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().cholesky_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def cholesky_solve_batched(G: torch.Tensor, rhs: torch.Tensor,
                           reg: torch.Tensor) -> torch.Tensor:
    """x (B, k) = (G + diag(reg))⁻¹ rhs for G (B, k, k) f32, rhs (B, k) f32,
    reg (B,) f32, all contiguous on one device."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_plain(G, rhs, reg)
    b, k, _ = G.shape
    if not kernel_supported(k):
        ROUTED["cholesky_solve_batched"] += 1
        return anchor_solve(G, rhs, reg)
    dev = G.device
    _check("G", G, (b, k, k), torch.float32, dev)
    _check("rhs", rhs, (b, k), torch.float32, dev)
    _check("reg", reg, (b,), torch.float32, dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().cholesky_solve_batched(G.data_ptr(), rhs.data_ptr(),
                                        reg.data_ptr(), out.data_ptr(),
                                        b, k, stream)
    _raise_on(err, "cholesky_solve_batched")
    LAUNCHES["cholesky_solve_batched"] += 1
    return out


def cholesky_solve_hot(G: torch.Tensor, rhs: torch.Tensor, reg: torch.Tensor,
                       hv: torch.Tensor, vh: torch.Tensor,
                       alpha=None) -> torch.Tensor:
    """``cholesky_solve_batched`` with the hot-column terms of hv (B, C) bf16
    (0 = unobserved) against vh (C, k) f32 added inside the kernel first.
    ``alpha`` None = explicit weights, else the implicit confidence."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_hot_plain(G, rhs, reg, hv, vh, alpha)
    b, k, _ = G.shape
    c = hv.shape[1]
    if not hot_kernel_supported(k, c):
        ROUTED["cholesky_solve_hot"] += 1
        G2, rhs2 = fold_hot(G, rhs, hv, vh, alpha)
        return cholesky_solve_batched(G2, rhs2, reg)
    dev = G.device
    _check("G", G, (b, k, k), torch.float32, dev)
    _check("rhs", rhs, (b, k), torch.float32, dev)
    _check("reg", reg, (b,), torch.float32, dev)
    _check("hv", hv, (b, c), torch.bfloat16, dev)
    _check("vh", vh, (c, k), torch.float32, dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().cholesky_solve_hot(
        G.data_ptr(), rhs.data_ptr(), reg.data_ptr(), hv.data_ptr(),
        vh.data_ptr(), out.data_ptr(), b, k, c,
        0 if alpha is None else 1, 0.0 if alpha is None else float(alpha),
        stream)
    _raise_on(err, "cholesky_solve_hot")
    LAUNCHES["cholesky_solve_hot"] += 1
    return out


__all__ = ["cholesky_solve_batched", "cholesky_solve_hot",
           "cholesky_solve_plain", "cholesky_solve_hot_plain", "fold_hot",
           "anchor_solve", "block_batch", "kernel_supported",
           "hot_kernel_supported", "hot_smem_bytes", "hot_cols_cap",
           "hot_cols_auto",
           "LAUNCHES", "ROUTED", "reset_counts"]
