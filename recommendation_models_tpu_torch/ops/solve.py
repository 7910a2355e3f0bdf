"""Batched SPD solves for the per-row normal equations.

Solver strings (as in the reference):
  'auto'   = 'pallas'
  'pallas' the hand-written CUDA kernel for CUDA tensors, its plain PyTorch
           version for CPU tensors (ops/cholesky.py)
  'xla'    torch.linalg.cholesky + triangular solves (correctness anchor)
  'lu'     torch.linalg.solve (robustness fallback)

The sweep calls the batch-major entries (``solve_spd_batched`` and
``solve_spd_batched_hot``), which feed the kernels their own layout. The
public ``solve_spd_t`` / ``solve_spd_t_hot`` keep the reference's
batch-minor ``(k, k, B)`` signatures and transpose around them.
"""

from __future__ import annotations

import torch

from recommendation_models_tpu_torch.ops.cholesky import (
    anchor_solve, cholesky_solve_2g, cholesky_solve_batched,
    cholesky_solve_hot, fold_hot,
)

_SOLVERS = ("pallas", "xla", "lu")


def resolve_solver(solver: str) -> str:
    """'auto' -> 'pallas' (kernel on CUDA, plain version on CPU)."""
    solver = "pallas" if solver == "auto" else solver
    if solver not in _SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def resolve_compute_dtype(dtype: str) -> str:
    """'auto' -> float32 on both CPU and CUDA (bf16 inputs on the GPU are a
    later, measured decision)."""
    return "float32" if dtype == "auto" else dtype


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def add_ridge(G: torch.Tensor, reg, degrees=None) -> torch.Tensor:
    """G + reg*I, optionally scaling reg per row by its degree."""
    k = G.shape[-1]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    if degrees is None:
        return G + reg * eye
    scale = reg * torch.clamp_min(degrees, 1.0)
    return G + scale[..., None, None] * eye


def flat_ridge(G_flat: torch.Tensor, k: int, reg, degrees=None):
    """add_ridge on flat (B, k*k) systems."""
    eye_flat = torch.eye(k, dtype=G_flat.dtype, device=G_flat.device
                         ).reshape(-1)
    if degrees is None:
        return G_flat + reg * eye_flat
    scale = reg * torch.clamp_min(degrees, 1.0)
    return G_flat + scale[:, None] * eye_flat


def _regv(reg_vec, b, device):
    if reg_vec is None:
        return torch.zeros((b,), dtype=torch.float32, device=device)
    return torch.as_tensor(reg_vec, dtype=torch.float32,
                           device=device).reshape(b).contiguous()


def solve_spd(G: torch.Tensor, rhs: torch.Tensor,
              solver: str = "xla") -> torch.Tensor:
    """Solve ``G x = rhs`` for SPD systems G (..., k, k), rhs (..., k)."""
    solver = resolve_solver(solver)
    k = G.shape[-1]
    batch_shape = G.shape[:-2]
    G = G.reshape((-1, k, k)).float()
    rhs = rhs.reshape((-1, k)).float()
    b = G.shape[0]
    if solver == "lu":
        x = torch.linalg.solve(G, rhs[..., None])[..., 0]
    else:
        reg = torch.zeros((b,), dtype=torch.float32, device=G.device)
        if solver == "pallas":
            x = cholesky_solve_batched(G.contiguous(), rhs.contiguous(), reg)
        else:
            x = anchor_solve(G, rhs, reg)
    return x.reshape(batch_shape + (k,))


def solve_spd_batched(G: torch.Tensor, rhs: torch.Tensor,
                      solver: str = "auto", reg_vec=None) -> torch.Tensor:
    """Batch-major solve: G (B, k, k), rhs (B, k), per-system ridge
    ``reg_vec`` (B,) -> x (B, k). On 'pallas' the ridge is added inside the
    kernel on load."""
    solver = resolve_solver(solver)
    b, k, _ = G.shape
    regv = _regv(reg_vec, b, G.device)
    if solver == "pallas":
        return cholesky_solve_batched(G.float().contiguous(),
                                      rhs.float().contiguous(), regv)
    if solver == "xla":
        return anchor_solve(G, rhs, regv)
    A = G.float().clone()
    A.diagonal(dim1=1, dim2=2).add_(regv[:, None])
    return solve_spd(A, rhs, "lu")


def solve_spd_batched_hot(G: torch.Tensor, rhs: torch.Tensor,
                          hv: torch.Tensor, vh: torch.Tensor, alpha=None,
                          solver: str = "auto", reg_vec=None) -> torch.Tensor:
    """``solve_spd_batched`` with the hot-column terms of hv (B, C) against
    the hot factor rows vh (C, k) (already rounded to the compute dtype).
    On 'pallas' they are added inside the fused kernel; the other solvers
    fold them in torch first."""
    solver = resolve_solver(solver)
    b = G.shape[0]
    if solver == "pallas":
        if G.is_cuda:
            # the kernel reads a bf16 slab (exact for half-star ratings)
            hv = hv.to(torch.bfloat16)
        return cholesky_solve_hot(
            G.float().contiguous(), rhs.float().contiguous(),
            _regv(reg_vec, b, G.device), hv.contiguous(),
            vh.float().contiguous(), alpha=alpha)
    G2, rhs2 = fold_hot(G, rhs, hv, vh, alpha)
    return solve_spd_batched(G2, rhs2, solver, reg_vec=reg_vec)


def solve_spd_flat(G_flat: torch.Tensor, rhs: torch.Tensor, k: int,
                   solver: str = "auto", reg_vec=None) -> torch.Tensor:
    """Solve FLAT (B, k*k) row-major systems (the dense-block layout)."""
    b = G_flat.shape[0]
    return solve_spd_batched(G_flat.reshape(b, k, k), rhs, solver,
                             reg_vec=reg_vec)


def solve_spd_t(Gt: torch.Tensor, rhst: torch.Tensor, solver: str = "auto",
                reg_vec=None, Gt2: torch.Tensor = None) -> torch.Tensor:
    """Batch-minor solve (the reference's signature): Gt (k, k, B),
    rhst (k, B) -> x (k, B).

    ``Gt2``: an optional second (k, k, B) gram term. On 'pallas' the
    two-operand kernel sums it on load (``G + G2`` is never stored); the
    other solvers upcast both operands to f32 and then add them."""
    if Gt2 is None:
        x = solve_spd_batched(Gt.permute(2, 0, 1), rhst.t(), solver,
                              reg_vec=reg_vec)
        return x.t()
    solver = resolve_solver(solver)
    b = Gt.shape[2]
    if solver == "pallas":
        x = cholesky_solve_2g(Gt.permute(2, 0, 1).float().contiguous(),
                              Gt2.permute(2, 0, 1).float().contiguous(),
                              rhst.t().float().contiguous(),
                              _regv(reg_vec, b, Gt.device))
        return x.t()
    return solve_spd_t(Gt.float() + Gt2.float(), rhst, solver,
                       reg_vec=reg_vec)


def solve_spd_t_hot(Gt: torch.Tensor, rhst: torch.Tensor, hvT: torch.Tensor,
                    vT: torch.Tensor, alpha=None, solver: str = "auto",
                    reg_vec=None) -> torch.Tensor:
    """Batch-minor hot solve (the reference's signature): hvT (C, B) hot
    values, vT (k, C) hot factor rows -> x (k, B)."""
    x = solve_spd_batched_hot(Gt.permute(2, 0, 1), rhst.t(), hvT.t(), vT.t(),
                              alpha=alpha, solver=solver, reg_vec=reg_vec)
    return x.t()


__all__ = ["solve_spd", "solve_spd_batched", "solve_spd_batched_hot",
           "solve_spd_flat", "solve_spd_t", "solve_spd_t_hot", "add_ridge",
           "flat_ridge", "resolve_solver", "resolve_compute_dtype",
           "torch_dtype"]
