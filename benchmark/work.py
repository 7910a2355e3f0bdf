"""Needed work, peaks and the shares taken against them.

Needed work is what a cell's inputs need, counted once per input and output
byte: observed ratings (a 4-byte column id and a 4-byte rating each), never
padded slots or the dense block's zeros; a gram as its lower triangle,
k(k + 1)/2 entries, not k². A rating adds ``k(k + 1)`` FLOP to its row's
triangle (a multiply and an add an entry) and ``2k`` to its rhs.

Peaks (NVIDIA H100 SXM data sheet, dense, without sparsity, at the full
700 W): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.
The configurations compute in float32; a product accurate to float32 can
be built from tensor-core passes, so the bf16 rate bounds any float32
program and a share against it cannot pass 100%. The float32 rate outside
the tensor cores (67 TFLOP/s) bounds only today's code and is given in
prose beside the shares, never as their base.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12          # H100 SXM, bf16 dense on the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM, HBM3
PEAK_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5: 989 TFLOP/s "
               "bf16 dense, 3.35 TB/s HBM3, 700 W")

RATING_BYTES = 8             # an int32 column id and a float32 rating
F32 = 4


def triangle(k: int) -> int:
    """Entries of a k x k gram's lower triangle."""
    return k * (k + 1) // 2


def obs_flops(n_obs: int, k: int) -> float:
    """FLOP of ``n_obs`` ratings' gram (triangle) and rhs terms."""
    return float(n_obs) * (k * (k + 1) + 2 * k)


def solve_flops(n_systems: int, k: int) -> float:
    """FLOP of ``n_systems`` ridge-Cholesky solves of order k: the factor
    (k³/3) and the two substitutions (2k²)."""
    return float(n_systems) * (k ** 3 / 3.0 + 2.0 * k * k)


def gram_work(n_obs: int, n_rows: int, n_cols: int, k: int):
    """(FLOP, bytes) of the grams and rhs of ``n_rows`` rows holding
    ``n_obs`` observed ratings over ``n_cols`` distinct opposite rows: the
    ratings and the opposite factor rows read once, each row's triangle and
    rhs written once."""
    flops = obs_flops(n_obs, k)
    nbytes = (n_obs * RATING_BYTES + n_cols * k * F32
              + n_rows * (triangle(k) + k) * F32)
    return flops, float(nbytes)


def solve_work(n_systems: int, k: int, hot_obs: int = 0, n_hot: int = 0):
    """(FLOP, bytes) of ``n_systems`` solves: each reads its triangle, rhs
    and ridge and writes x once; ``hot_obs`` observed hot ratings add
    their terms and bytes, and the ``n_hot`` hot factor rows are read once."""
    flops = solve_flops(n_systems, k) + obs_flops(hot_obs, k)
    nbytes = (n_systems * (triangle(k) + 2 * k + 1) * F32
              + hot_obs * RATING_BYTES + n_hot * k * F32)
    return flops, float(nbytes)


def sweep_flops(nnz: int, n_users: int, n_items: int, k: int) -> float:
    """Needed FLOP of one ALS sweep: every rating's terms in both halves
    and one solve a row on each side."""
    return 2.0 * obs_flops(nnz, k) + solve_flops(n_users + n_items, k)


def topk_work(batch: int, n_items: int, k: int, n_excl: int, n_out: int):
    """(FLOP, bytes) of one top-``n_out`` call for ``batch`` users over
    ``n_items`` items: every score (2k FLOP); the query rows, the item
    table, the ``n_excl`` exclusion ids and the (batch, n_out) result (an
    id and a score) each once."""
    flops = 2.0 * batch * n_items * k
    nbytes = ((batch + n_items) * k * F32 + n_excl * 4
              + batch * n_out * (4 + F32))
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOP over the
    peak rate and the bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_share(flops: float, nbytes: float, seconds: float):
    """Percent of the roofline: least time over the measured seconds, or
    None when nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(flops, nbytes) / seconds


def mfu(flops: float, seconds: float):
    """Percent of the peak FLOP rate that ``flops`` in ``seconds`` reach."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / PEAK_FLOPS / seconds


__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "PEAK_SOURCE",
           "triangle", "obs_flops", "solve_flops", "gram_work", "solve_work",
           "sweep_flops", "topk_work", "least_seconds", "roofline_share",
           "mfu"]
