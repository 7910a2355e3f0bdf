"""Gram accumulation for the per-row normal equations.

Per row u with observed columns and weights, ``G_u = Σ_p wg_p v_p v_pᵀ`` and
``rhs_u = Σ_p wr_p v_p``, computed for a whole padded bucket at once: the
opposite factor rows are gathered with ``index_select`` and contracted with
batched matrix products, chunked along the padded-degree axis P so a whale
row never materializes more than a ``(B, chunk, k)`` gather.

Weights are caller-supplied so one path covers both objectives:
  explicit ALS:  wg = mask,             wr = mask * rating
  implicit ALS:  wg = alpha*rating*mask, wr = (1 + alpha*rating) * mask

``compute_dtype`` sets the precision of the gathered inputs; products and
sums are always float32. The contractions must never run in TF32: it rounds
the outer-product entries, and the gram can then go indefinite.
"""

from __future__ import annotations

import torch


def full_f32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_full_f32(t: torch.Tensor) -> None:
    """Raise if a CUDA contraction over ``t`` could run in TF32."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is enabled: the gram contractions need full "
                           "float32 (call ops.gram.full_f32())")


def _accumulate(V, indices, wg, wr, chunk, compute_dtype, G, rhs):
    """G (B, k, k) += Σ_p wg v vᵀ, rhs (B, k) += Σ_p wr v, in place, over
    P-axis chunks of at most ``chunk`` columns."""
    b, p = indices.shape
    k = V.shape[-1]
    rhs3 = rhs.unsqueeze(-1)
    for s in range(0, p, chunk):
        e = min(s + chunk, p)
        Vg = V.index_select(0, indices[:, s:e].reshape(-1)).view(b, e - s, k)
        # the weighted copy rounds like the reference (in compute_dtype);
        # the products then run in f32, exact for bf16 inputs
        Vw = Vg * wg[:, s:e, None].to(compute_dtype)
        Vg32 = Vg.float()
        G.baddbmm_(Vw.float().transpose(1, 2), Vg32)
        rhs3.baddbmm_(Vg32.transpose(1, 2),
                      wr[:, s:e, None].to(compute_dtype).float())
    return G, rhs


def gram_rhs(V, indices, wg, wr, chunk: int = 512,
             compute_dtype=torch.float32):
    """``G (B, k, k)`` and ``rhs (B, k)`` of one bucket (batch-major).

    V (n_cols, k) opposite factor table; indices (B, P) column ids into V;
    wg / wr (B, P) gram and rhs weights (0 on padding)."""
    check_full_f32(V)
    b = indices.shape[0]
    k = V.shape[-1]
    V = V.to(compute_dtype)
    G = torch.zeros((b, k, k), dtype=torch.float32, device=V.device)
    rhs = torch.zeros((b, k), dtype=torch.float32, device=V.device)
    return _accumulate(V, indices, wg, wr, chunk, compute_dtype, G, rhs)


def gram_rhs_t(V, indices, wg, wr, chunk: int = 512,
               compute_dtype=torch.float32, init=None):
    """Batch-minor form: ``G (k, k, B)`` and ``rhs (k, B)``, the reference's
    kernel layout (returned as transposed views of batch-major tensors).

    ``init``: optional (G0 (k, k, B), rhs0 (k, B)) starting accumulators;
    as in the reference, the P axis is then split in at least two chunks."""
    check_full_f32(V)
    b, p = indices.shape
    k = V.shape[-1]
    V = V.to(compute_dtype)
    if init is not None and p > 8:
        half = -(-p // 2)
        chunk = min(chunk, -(-half // 8) * 8)
    if init is None:
        G = torch.zeros((b, k, k), dtype=torch.float32, device=V.device)
        rhs = torch.zeros((b, k), dtype=torch.float32, device=V.device)
    else:
        G = init[0].permute(2, 0, 1).float().contiguous()
        rhs = init[1].t().float().contiguous()
    G, rhs = _accumulate(V, indices, wg, wr, chunk, compute_dtype, G, rhs)
    return G.permute(1, 2, 0), rhs.t()


def objective_weights(values, mask, alpha):
    """(wg, wr) for ``gram_rhs`` given the objective: ``alpha is None`` is
    explicit least squares; otherwise confidence ``c = 1 + alpha*r`` on the
    binarized preference (Hu-Koren-Volinsky)."""
    if alpha is None:
        return mask, mask * values
    conf_minus_1 = alpha * values * mask
    return conf_minus_1, (1.0 + alpha * values) * mask


__all__ = ["gram_rhs", "gram_rhs_t", "objective_weights", "full_f32",
           "check_full_f32"]
