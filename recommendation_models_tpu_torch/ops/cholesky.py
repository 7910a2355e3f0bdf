"""Batched ridge-Cholesky solves: CUDA kernels, their wrappers and their
plain PyTorch versions.

Eight kernels replace the TPU kernels of
``recommendation_models_tpu/ops/pallas/cholesky.py``. Two carry the ALS
sweep (``csrc/cholesky_solve.cu``, orders k <= 160):

- ``cholesky_solve_batched``: ``x = (G + diag(reg))⁻¹ rhs`` for a batch of
  SPD systems (TPU ``_cholesky_solve_kernel_pair``);
- ``cholesky_solve_hot``: the same solve after adding the hot-column gram
  and rhs terms ``Σ_c wg[b,c] v_c v_cᵀ`` and ``Σ_c wr[b,c] v_c`` inside the
  kernel (TPU ``_cholesky_solve_kernel_hot``).

One takes the reference's single-block regime past k = 160
(``csrc/cholesky_large.cu``):

- ``cholesky_solve_large``: the ``cholesky_solve_batched`` solve (and, with
  a second gram, the ``cholesky_solve_2g`` one) at 160 < kp <= 656 for a
  batch of at most ``block_batch(k)`` systems (halved with two grams), one
  thread-block cluster a system (the same TPU kernels at their one-block
  grid). It computes B1's and B3's functions, so their plain versions are
  its own.

Five run the solve-variant path, the public solve API with its variant
options (``cholesky_solve_t``, ``cholesky_solve``, ``cholesky_solve_flat``,
``ops/solve.py::solve_spd_t(Gt2=)``) and ``probes/solve_variants.py``:

- ``cholesky_solve_2g``: ``A = G + G2 + diag(reg)`` summed on load, then the
  ``cholesky_solve_batched`` solve (TPU ``_cholesky_solve_kernel_2g``,
  ``csrc/cholesky_solve.cu``);
- ``cholesky_solve_rank1``: a right-looking factor with ``fcols`` columns
  per step and substitutions with ``srows`` rows per step (TPU
  ``_cholesky_solve_kernel``; ``csrc/cholesky_rank_panel.cu``);
- ``cholesky_solve_panel``: the rank-8 panel factor (TPU
  ``_cholesky_solve_kernel_panel``; ``csrc/cholesky_rank_panel.cu``);
- ``cholesky_solve_schur``: the two-level Schur factor, k % 16 == 0 (TPU
  ``_cholesky_solve_kernel_schur``; ``csrc/cholesky_rank_panel.cu``);
- ``cholesky_solve_dual``: the rank-2 factor and two-row substitutions,
  to kp = 128 two systems a block with their factors interleaved, past it
  one system a block in the panel frame (TPU
  ``_cholesky_solve_kernel_dual``; ``csrc/cholesky_rank_panel.cu``).

Past kp = 128 ``cholesky_solve_rank1`` (every fcols, srows) and
``cholesky_solve_dual`` factor in 8-column panels with every term taken
alone (``variant_frame``): the rank-1 and rank-2 schedules give each
element its terms in the same order, so there the four give the same bits,
as their plain versions do everywhere. ``cholesky_solve_schur`` takes the
same panels there in Schur's order of terms (each A22 group rides the
left panel that holds its columns), and ``cholesky_solve_batched`` takes
B4 (1, 1)'s kernel (``cholesky_solve_batched_panel``) beyond its latency
kernel's wave, or two waves up to kp = 152 (``solve_frame``).

The last four take k <= 160 at any batch in ``csrc/cholesky_rank_panel.cu``
and, past it, the reference's one-block regime (160 < kp <= 656, a batch
of at most ``block_batch(k)``) in ``csrc/cholesky_large_variants.cu``
(``cholesky_solve_variant_large``: one cluster a system, each schedule's
own order of terms), counted under the wrapper's name and in
``LARGE_LAUNCHES``.

The one-block kernels share ``csrc/cholesky_cluster.cuh``'s frame: a
system takes a cluster of C CTAs, one an SM, and its factor lives in the
cluster's distributed shared memory, its 32-column panels dealt to the
CTAs in the cyclic order reflected every C panels. ``cluster_size`` is the
rule for C (B x C fills the card's SMs where the batch leaves room, and
each CTA's share of the factor and its copy of a panel fit in shared
memory, the batch's clusters in one wave as the card places them);
``forced_cluster`` takes another C, to measure one on another's ground.

Shared contract: f32 factorization, ridge added on load, pivots clamped at
``max(d, 1e-30)``, so identity-padded and all-zero systems with rhs 0 solve
to 0. The kernels take batch-major tensors: G (B, k, k), rhs (B, k),
reg (B,), hot slab hv (B, C) bf16, hot factor rows vh (C, k) f32.

``cholesky_solve_batched``, ``cholesky_solve_hot`` and
``cholesky_solve_2g`` each have two kernels, one per regime, and the
wrapper picks one per launch (``solve_frame`` is the rule): a batch of
at most the latency kernel's resident blocks (one wave, as the sweep's
256-row blocks are) is solved one system per block in 4-column panels; a
larger one by the persistent throughput kernel, or for B1 past kp = 128
mostly by the panel frame above. ``forced_regime`` takes one kernel at
every batch, to measure each on the other's ground.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors, and raises for anything else. The routing is the
reference's: a (k, B) batch that the JAX package sends to XLA
(``kernel_supported``, its ``pallas_supported``; ``hot_kernel_supported``,
its hot gate) is routed, before any launch, to the torch anchor
(``torch.linalg.cholesky``) or to the torch fold of the hot terms, and
counted in ``ROUTED``; the variant wrappers follow the same rule.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from recommendation_models_tpu_torch.ops.gram import objective_weights

PIVOT_FLOOR = 1e-30
KMAX = 160              # csrc/cholesky_solve.cu KMAX (B1-B3)
VARIANT_KMAX = 160      # csrc/cholesky_rank_panel.cu KMAX (B4-B5c)
LARGE_KMAX = 656        # csrc/cholesky_large.cu and cholesky_large_variants.cu
                        # KMAX (the one-block regime)
LARGE_PANEL = 32        # csrc/cholesky_cluster.cuh NB: the one-block
                        # kernels' panel width (k is padded to it)
CLUSTER_MAX = 8         # the largest cluster cluster_size picks (the card's
                        # portable size; csrc/cholesky_cluster.cuh takes 16)
CLUSTER_LIMIT = 16      # csrc/cholesky_cluster.cuh CMAX
CTA_SMEM = 232_448      # an H100 CTA's largest dynamic shared memory
HOT_CMAX = 1024         # csrc/cholesky_solve.cu CMAX
SMEM_MAX = 227 * 1024   # csrc/cholesky_solve.cu SMEM_MAX
# each source's largest order (its cholesky_kernel_kmax export)
SOURCE_KMAX = {"cholesky_solve": KMAX, "cholesky_rank_panel": VARIANT_KMAX,
               "cholesky_large": LARGE_KMAX,
               "cholesky_large_variants": LARGE_KMAX}
# the reference's VMEM budget of a batch block past kp = 160
# (ops/pallas/cholesky.py block_batch / pallas_supported)
_VMEM_BUDGET = 40 * 1024 * 1024

KERNELS = ("cholesky_solve_batched", "cholesky_solve_hot", "cholesky_solve_2g",
           "cholesky_solve_rank1", "cholesky_solve_panel",
           "cholesky_solve_schur", "cholesky_solve_dual",
           "cholesky_solve_large")
LAUNCHES = dict.fromkeys(KERNELS, 0)
ROUTED = dict.fromkeys(KERNELS, 0)
# the launches of LAUNCHES that took a regime kernel's latency kernel
LATENCY_LAUNCHES = dict.fromkeys(("cholesky_solve_batched",
                                  "cholesky_solve_hot", "cholesky_solve_2g"),
                                 0)
# the variant kernels, and the launches of LAUNCHES that took their
# one-block kernel (csrc/cholesky_large_variants.cu) past kp = 160
VARIANT_KINDS = ("cholesky_solve_rank1", "cholesky_solve_panel",
                 "cholesky_solve_schur", "cholesky_solve_dual")
LARGE_LAUNCHES = dict.fromkeys(VARIANT_KINDS, 0)
PANEL_WIDTH = 8         # the panel width and the Schur phase's group
                        # (csrc/cholesky_rank_panel.cu PW)
RANK1_SCHEDULES = ((1, 1), (1, 2), (2, 1))   # (fcols, srows) of the kernel
RANK_FRAME_KPMAX = 128  # csrc/cholesky_rank_panel.cu frame_config: past this
                        # padded order B4, B5b and B5c factor in panels, and
                        # so does B1 at most batches (solve_frame)
B1_TWO_WAVE_KPMAX = 152  # the largest padded order at which B1 keeps its
                         # throughput kernel for a batch of at most two
                         # latency waves (csrc/cholesky_solve.cu's <256, 3>
                         # tile configuration)


def reset_counts() -> None:
    for d in (LAUNCHES, ROUTED, LATENCY_LAUNCHES, LARGE_LAUNCHES):
        for key in d:
            d[key] = 0


def _pad8(k: int) -> int:
    return -(-k // 8) * 8


def block_batch(k: int) -> int:
    """Row granule of the sweep (copied verbatim from the reference, whose
    TPU kernel blocks its batch by it): buckets are padded, and big buckets
    split into row blocks, in multiples of this. 512 at padded order
    kp <= 32, 256 up to 160, then the most systems of order kp whose three
    (kp, kp) f32 blocks fit in 40 MiB, in multiples of 8, at least 8."""
    kp = _pad8(k)
    if kp <= 32:
        return 512
    if kp <= 160:
        return 256
    return max(8, (_VMEM_BUDGET // (3 * kp * kp * 4)) // 8 * 8)


def two_operand_block(k: int) -> int:
    """The reference's batch block with a second gram (``Gt2``): half of
    ``block_batch``, in multiples of 8, at least 8."""
    return max(block_batch(k) // 2 // 8 * 8, 8)


def cluster_owner(p: int, c: int) -> int:
    """The CTA of a one-block cluster of c that holds 32-column panel p:
    the cyclic order reflected every c panels (0 .. c-1, c-1 .. 0, ...;
    ``owner_of`` in csrc/cholesky_cluster.cuh)."""
    r = p % (2 * c)
    return r if r < c else 2 * c - 1 - r


@functools.lru_cache(maxsize=None)
def cluster_smem_bytes(kq: int, c: int) -> int:
    """Dynamic shared memory of a CTA of the one-block kernels at padded
    order kq (a multiple of 32) and cluster size c, at the CTA that needs
    the most (``smem_bytes`` in csrc/cholesky_cluster.cuh): its panels
    (panel p: ``kq / 32 - p`` blocks of 32 x 32 floats) and its copy of
    another CTA's panel (the rows from its first panel past the step's),
    after the signals (three mbarriers a panel), the panel offsets, y,
    1 / L_jj, the inverse pivots and the diagonal block."""
    np_ = kq // LARGE_PANEL
    owned = [[p for p in range(np_) if cluster_owner(p, c) == x]
             for x in range(c)]
    most = 0
    for x in range(c):
        copy = max((np_ - next(q for q in owned[x] if q > j)
                    for j in range(np_ - 1)
                    if cluster_owner(j, c) != x and owned[x]
                    and owned[x][-1] > j), default=0)
        most = max(most, sum(np_ - p for p in owned[x]) + copy)
    fixed = (-(-6 * np_ // 4) * 4 + -(-np_ // 4) * 4 + 2 * kq + LARGE_PANEL
             + LARGE_PANEL * LARGE_PANEL)
    return 4 * (fixed + most * LARGE_PANEL * LARGE_PANEL)


_cluster_forced = None   # forced_cluster's choice; None: cluster_size picks


@functools.lru_cache(maxsize=None)
def _cluster_fits(kq: int):
    """The cluster sizes up to ``CLUSTER_MAX`` (and the panels) whose
    CTAs' shares fit in ``CTA_SMEM`` at padded order kq."""
    return tuple(c for c in range(1, min(CLUSTER_MAX, kq // LARGE_PANEL) + 1)
                 if cluster_smem_bytes(kq, c) <= CTA_SMEM)


@functools.lru_cache(maxsize=None)
def _card_holds(k: int, c: int, device: int) -> int:
    return active_clusters(k, c)


def cluster_size(k: int, b: int, sms: int = None) -> int:
    """CTAs of a system's cluster in the one-block kernels for b systems of
    order k: the largest c <= ``CLUSTER_MAX`` (and no more than the
    32-column panels) whose CTAs' shares fit in ``CTA_SMEM`` and whose b
    clusters the card holds at once, so that the batch fills the card in
    one wave where it leaves room; where no c that fits does, the smallest
    that fits. How many clusters of c the card holds is the card's own
    answer (``active_clusters``, asked once a size) on a card, and sms // c
    for a card of ``sms`` SMs given (a count that ignores how the SMs group
    into GPCs: an H100 holds 15 clusters of 8, not 16)."""
    kq = -(-k // LARGE_PANEL) * LARGE_PANEL
    fits = _cluster_fits(kq)
    if not fits:
        raise ValueError(f"no cluster of at most {CLUSTER_MAX} holds order "
                         f"{k}")
    if sms is None:
        dev = torch.cuda.current_device()
        holds = {c: _card_holds(k, c, dev) for c in fits}
    else:
        holds = {c: sms // c for c in fits}
    one_wave = [c for c in fits if holds[c] >= b]
    return max(one_wave) if one_wave else min(fits)


@contextlib.contextmanager
def forced_cluster(c: int):
    """Inside the block every one-block launch takes clusters of c CTAs,
    whatever its batch (the kernel refuses a c whose share does not fit),
    so that one cluster size can be timed on another's ground."""
    global _cluster_forced
    _cluster_forced = int(c)
    try:
        yield
    finally:
        _cluster_forced = None


def kernel_supported(k: int, b: int, two_operand: bool = False) -> bool:
    """Whether a batch of b systems of order k takes a kernel: the
    reference's ``pallas_supported`` (its Pallas kernels, else XLA). Any
    batch at padded order kp <= 160; past it a batch of at most one block
    (``block_batch``, or ``two_operand_block`` with a second gram), while
    three such blocks fit in the 40 MiB budget (kp <= 656). Unlike the
    reference's entries, every order is taken, not only multiples of 8: the
    kernels pad k themselves."""
    if k < 1:
        return False
    kp = _pad8(k)
    bt = two_operand_block(kp) if two_operand else block_batch(kp)
    if kp > 160 and 3 * kp * kp * bt * 4 > _VMEM_BUDGET:
        return False
    return bt >= 128 or b <= bt


def latency_regime(batch: int, resident: int) -> bool:
    """The solve kernels' regime rule, which the wrappers apply at every
    launch: a batch of at most ``resident`` systems, the latency kernel's
    resident blocks on the card, fits in one wave and is solved one system
    per block by the latency kernel; a larger batch goes to the persistent
    throughput kernel (``solve_frame`` has B1's exception past kp = 128)."""
    return batch <= resident


def solve_frame(name: str, batch: int, k: int, resident: int) -> str:
    """The kernel a launch of ``name`` (one of ``REGIME_KINDS``) takes for
    ``batch`` systems of order k <= ``KMAX``, given the latency kernel's
    ``resident`` blocks on the card (``forced_regime`` aside): "latency"
    or "throughput" by ``latency_regime``, both kernels of
    ``csrc/cholesky_solve.cu``; except that past kp = ``RANK_FRAME_KPMAX``
    ``cholesky_solve_batched`` (B1) takes "panel", the panel frame of
    ``csrc/cholesky_rank_panel.cu`` (``cholesky_solve_batched_panel``, B4
    (1, 1)'s kernel there), at every batch beyond the latency kernel's,
    but a batch of at most two of its waves up to kp =
    ``B1_TWO_WAVE_KPMAX``, which keeps the throughput kernel. Measured on
    an H100 at k = 129-160 (``PERF.md``): the latency kernel took
    0.79-0.92x the panel frame's time to one wave; at 133-256 rows the
    throughput kernel 0.94-0.95x at k = 129-144 and 1.13-1.16x at 153 and
    160; at 4,097 rows the panel frame 0.66-0.82x the throughput kernel's
    time."""
    latency = latency_regime(batch, resident)
    if latency or name != "cholesky_solve_batched":
        return "latency" if latency else "throughput"
    kp = (k + 3) // 4 * 4
    if kp <= RANK_FRAME_KPMAX or (kp <= B1_TWO_WAVE_KPMAX
                                  and batch <= 2 * resident):
        return "throughput"
    return "panel"


def hot_smem_bytes(k: int, c: int, latency: bool = False) -> int:
    """Dynamic shared memory of the hot kernel's block in either regime
    (``smem_bytes`` in csrc/cholesky_solve.cu). Throughput: vh (C, kp),
    the column buffers 2 (kp + 4), L, y, 1/L_jj, the hot weights and
    columns (3 C) and the per-warp counts. Latency: one region of
    max(C kp, 2 (4 kp + 20)) floats (the compacted hot rows, then the two
    panel buffers), L, y, 1/L_jj, the hot weights (2 C) and the per-warp
    counts."""
    kp = (k + 3) // 4 * 4
    tiles = (kp // 4) * (kp // 4 + 1) // 2
    warps = (160 if tiles <= 160 else 256) // 32
    region = (max(c * kp, 2 * (4 * kp + 20)) if latency
              else c * kp + 2 * (kp + 4))
    return 4 * (region + kp * (kp + 1) + 2 * kp + 2 * c) \
        + 4 * ((0 if latency else c) + warps)


@functools.lru_cache(maxsize=None)
def hot_kernel_supported(k: int, c: int) -> bool:
    """Whether the fused hot kernel takes order k with a C-wide hot block,
    at any batch: the reference's hot gate (a 128-multiple batch block, so
    kp <= 160, and C <= ``hot_cols_cap(k)``), with vh in shared memory (the
    throughput kernel's block; the latency kernel's is never larger where
    it matters, and the launch takes the throughput kernel when it is)."""
    return (1 <= k and block_batch(k) % 128 == 0
            and 1 <= c <= min(hot_cols_cap(k), HOT_CMAX)
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
    substitutions, vectorized over the batch (the one-column, one-row
    schedule of ``cholesky_solve_rank1_plain``)."""
    return cholesky_solve_rank1_plain(G, rhs, reg, 1, 1)


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


def cholesky_solve_2g_plain(G, G2, rhs, reg):
    """Plain version of ``cholesky_solve_2g``: the two grams summed in f32
    on load, then the plain solve."""
    return cholesky_solve_plain(G.float() + G2.float(), rhs, reg)


def _load_plain(G, reg):
    A = G.float().clone()
    A.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    return A


def _step1_plain(A, Ld, j, end):
    """One column step: L[:, j], then the rank-1 update of the trailing
    rows against the columns (j, end)."""
    d = A[:, j, j].clone()
    inv = torch.rsqrt(torch.clamp_min(d, PIVOT_FLOOR))
    c = A[:, j + 1:, j] * inv[:, None]
    A[:, j + 1:, j + 1:end] -= c[:, :, None] * c[:, None, :end - j - 1]
    A[:, j + 1:, j] = c
    Ld[:, j] = d * inv


def _step2_plain(A, Ld, j, end):
    """One rank-2 step over columns (j, j+1): L[:, j], L[:, j+1] corrected
    by it, then the two rank-1 terms against the columns [j+2, end)."""
    d1 = A[:, j, j].clone()
    inv1 = torch.rsqrt(torch.clamp_min(d1, PIVOT_FLOOR))
    c1 = A[:, j + 1:, j] * inv1[:, None]
    l12 = c1[:, 0]
    d2 = A[:, j + 1, j + 1] - l12 * l12
    inv2 = torch.rsqrt(torch.clamp_min(d2, PIVOT_FLOOR))
    c2 = (A[:, j + 2:, j + 1] - c1[:, 1:] * l12[:, None]) * inv2[:, None]
    trail = A[:, j + 2:, j + 2:end]
    trail -= c1[:, 1:, None] * c1[:, None, 1:end - j - 1]
    trail -= c2[:, :, None] * c2[:, None, :end - j - 2]
    A[:, j + 1:, j] = c1
    A[:, j + 2:, j + 1] = c2
    Ld[:, j] = d1 * inv1
    Ld[:, j + 1] = d2 * inv2


def _rank_update_plain(A, L, r0, width):
    """``A[r0:, r0:] -= L Lᵀ`` for the (B, k - r0, width) block L, the
    rank-``width`` sum accumulated first (one term per column)."""
    upd = torch.zeros_like(A[:, r0:, r0:])
    for p in range(width):
        upd += L[:, :, p, None] * L[:, None, :, p]
    A[:, r0:, r0:] -= upd


def _substitute_plain(A, Ld, rhs, srows):
    """Forward (L y = rhs) and back (Lᵀ x = y) substitution against the
    factor in A's lower triangle, column-oriented as the kernels run them,
    ``srows`` rows per step."""
    k = A.shape[1]
    piv = torch.clamp_min(Ld, PIVOT_FLOOR)
    y = rhs.float().clone()
    j = 0
    while srows == 2 and j + 1 < k:
        yj = y[:, j] / piv[:, j]
        yj1 = (y[:, j + 1] - A[:, j + 1, j] * yj) / piv[:, j + 1]
        y[:, j], y[:, j + 1] = yj, yj1
        y[:, j + 2:] -= A[:, j + 2:, j] * yj[:, None]
        y[:, j + 2:] -= A[:, j + 2:, j + 1] * yj1[:, None]
        j += 2
    for j in range(j, k):
        y[:, j] /= piv[:, j]
        y[:, j + 1:] -= A[:, j + 1:, j] * y[:, j:j + 1]
    j = k - 1
    while srows == 2 and j >= 1:
        xj = y[:, j] / piv[:, j]
        xj1 = (y[:, j - 1] - A[:, j, j - 1] * xj) / piv[:, j - 1]
        y[:, j], y[:, j - 1] = xj, xj1
        y[:, :j - 1] -= A[:, j, :j - 1] * xj[:, None]
        y[:, :j - 1] -= A[:, j - 1, :j - 1] * xj1[:, None]
        j -= 2
    for j in range(j, -1, -1):
        y[:, j] /= piv[:, j]
        y[:, :j] -= A[:, j, :j] * y[:, j:j + 1]
    return y


def _factor_plain(G, reg, fcols):
    """A right-looking factor with ``fcols`` (1 or 2) columns per step (an
    odd k ends on one column): L in A's lower triangle, its diagonal in
    Ld."""
    b, k, _ = G.shape
    A = _load_plain(G, reg)
    Ld = torch.empty((b, k), dtype=torch.float32, device=G.device)
    j = 0
    while fcols == 2 and j + 1 < k:
        _step2_plain(A, Ld, j, k)
        j += 2
    for j in range(j, k):
        _step1_plain(A, Ld, j, k)
    return A, Ld


def cholesky_solve_rank1_plain(G, rhs, reg, fcols=1, srows=1):
    """Plain version of ``cholesky_solve_rank1``: a right-looking factor
    with ``fcols`` (1 or 2) columns per step (an odd k ends on one column),
    then the substitutions with ``srows`` rows per step."""
    _check_schedule(fcols, srows)
    return _substitute_plain(*_factor_plain(G, reg, fcols), rhs, srows)


def cholesky_solve_dual_plain(G, rhs, reg):
    """Plain version of ``cholesky_solve_dual``: each system's rank-2
    factor and two-row substitutions, in the kernel's step order (to kp =
    128 the kernel interleaves two systems' chains; each system's
    arithmetic is its own)."""
    return _substitute_plain(*_factor_plain(G, reg, 2), rhs, 2)


def cholesky_solve_panel_plain(G, rhs, reg):
    """Plain version of ``cholesky_solve_panel``: panels of 8 columns, each
    factored left-looking (column jj takes the panel's earlier columns'
    terms only when it comes up), then one rank-8 update of the trailing
    block; one-row substitutions."""
    b, k, _ = G.shape
    A = _load_plain(G, reg)
    Ld = torch.empty((b, k), dtype=torch.float32, device=G.device)
    for j0 in range(0, k, PANEL_WIDTH):
        pw = min(PANEL_WIDTH, k - j0)
        P = A[:, j0:, j0:j0 + pw]          # a view: factored in place
        for jj in range(pw):
            d = P[:, jj, jj].clone()
            for p in range(jj):
                d -= P[:, jj, p] * P[:, jj, p]
            inv = torch.rsqrt(torch.clamp_min(d, PIVOT_FLOOR))
            v = P[:, jj + 1:, jj].clone()
            for p in range(jj):
                v -= P[:, jj + 1:, p] * P[:, jj, p][:, None]
            P[:, jj + 1:, jj] = v * inv[:, None]
            Ld[:, j0 + jj] = d * inv
        _rank_update_plain(A, P[:, pw:], j0 + pw, pw)
    return _substitute_plain(A, Ld, rhs, 1)


def cholesky_solve_schur_plain(G, rhs, reg, srows=2):
    """Plain version of ``cholesky_solve_schur`` (k % 16 == 0): rank-2
    steps over the left half updating only columns < k/2, the deferred
    ``A22 -= L21 L21ᵀ`` in rank-8 groups, rank-2 steps over the right half,
    then the substitutions with ``srows`` rows per step."""
    b, k, _ = G.shape
    _check_schur(k, srows)
    h = k // 2
    A = _load_plain(G, reg)
    Ld = torch.empty((b, k), dtype=torch.float32, device=G.device)
    for j in range(0, h, 2):
        _step2_plain(A, Ld, j, h)
    for g in range(0, h, PANEL_WIDTH):
        _rank_update_plain(A, A[:, h:, g:g + PANEL_WIDTH], h, PANEL_WIDTH)
    for j in range(h, k, 2):
        _step2_plain(A, Ld, j, k)
    return _substitute_plain(A, Ld, rhs, srows)


def _check_schedule(fcols, srows):
    if (fcols, srows) not in RANK1_SCHEDULES:
        raise ValueError(f"(fcols, srows) must be one of {RANK1_SCHEDULES}, "
                         f"got {(fcols, srows)}")


def _check_schur(k, srows):
    if k % 16:
        raise ValueError(f"schur variant requires k % 16 == 0, got k={k}")
    if srows not in (1, 2):
        raise ValueError(f"srows must be 1 or 2, got {srows}")


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

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of each source: name -> argument types (all return an
# error code; 0 is success)
SOURCES = {
    "cholesky_solve": {
        "cholesky_solve_batched": [_P, _P, _P, _P, _I, _I, _P],
        "cholesky_solve_hot": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               ctypes.c_float, _P],
        "cholesky_solve_2g": [_P, _P, _P, _P, _P, _I, _I, _P],
        "cholesky_solve_resident": [_I, _I, _I,
                                    ctypes.POINTER(ctypes.c_longlong)],
    },
    "cholesky_large": {
        "cholesky_solve_large": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "cholesky_large_active_clusters": [_I, _I,
                                           ctypes.POINTER(ctypes.c_longlong)],
    },
    "cholesky_large_variants": {
        "cholesky_solve_variant_large": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _P],
    },
    "cholesky_rank_panel": {
        "cholesky_solve_rank1": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "cholesky_solve_panel": [_P, _P, _P, _P, _I, _I, _P],
        "cholesky_solve_schur": [_P, _P, _P, _P, _I, _I, _I, _P],
        "cholesky_solve_dual": [_P, _P, _P, _P, _I, _I, _P],
        "cholesky_solve_batched_panel": [_P, _P, _P, _P, _I, _I, _P],
        "cholesky_rank_panel_resident": [_I, _I, _I,
                                         ctypes.POINTER(ctypes.c_longlong)],
    },
}
_LIBS = {}


def _lib(source: str = "cholesky_solve"):
    """The library of ``csrc/<source>.cu``, built and loaded on first use,
    its limits checked against this module's."""
    lib = _LIBS.get(source)
    if lib is None:
        from recommendation_models_tpu_torch.ops.build import load
        lib = load(source)
        for name, argtypes in SOURCES[source].items():
            # a regime kernel's latency export takes the same arguments
            lat = (name + "_lat",) if name in REGIME_KINDS else ()
            for fn in (name, *lat):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
        lib.cholesky_error_string.argtypes = [_I]
        lib.cholesky_error_string.restype = ctypes.c_char_p
        lib.cholesky_kernel_kmax.restype = _I
        ok = lib.cholesky_kernel_kmax() == SOURCE_KMAX[source]
        if source == "cholesky_solve":
            lib.cholesky_kernel_cmax.restype = _I
            lib.cholesky_kernel_smem_max.restype = ctypes.c_longlong
            ok = ok and (lib.cholesky_kernel_cmax() == HOT_CMAX
                         and lib.cholesky_kernel_smem_max() == SMEM_MAX)
        if not ok:
            raise RuntimeError(f"csrc/{source}.cu limits disagree with "
                               "ops/cholesky.py")
        _LIBS[source] = lib
    return lib


def _check(name, t, shape, dtype, device):
    # one test on the launch path (the device by its index, the cheapest
    # query), the reason only when it fails
    if (t.dtype is dtype and t.shape == shape
            and t.get_device() == device.index and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous")


def _stream(dev: torch.device) -> int:
    """The raw handle of PyTorch's current stream on the CUDA device ``dev``
    (a launch goes there), read without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


REGIME_KINDS = ("cholesky_solve_batched", "cholesky_solve_hot",
                "cholesky_solve_2g")
_forced = None       # forced_regime's choice; None: latency_regime picks


@functools.lru_cache(maxsize=None)
def _resident(name: str, k: int, c: int, device: int) -> int:
    """The latency kernel of ``name`` at (k, C): its resident blocks on
    card ``device`` (the current one), asked once."""
    resident = ctypes.c_longlong(0)
    lib = _lib()
    _raise_on(lib.cholesky_solve_resident(REGIME_KINDS.index(name), k, c,
                                          ctypes.byref(resident)), name, lib)
    return resident.value


# csrc/cholesky_rank_panel.cu's schedule codes (enum Sched) of the kernels
# that are not cholesky_solve_rank1's (whose code is its fcols)
SCHED_CODE = {"cholesky_solve_panel": 8, "cholesky_solve_schur": 16,
              "cholesky_solve_dual": 32}


@functools.lru_cache(maxsize=None)
def _variant_resident(sched: int, srows: int, k: int, device: int) -> int:
    resident = ctypes.c_longlong(0)
    lib = _lib("cholesky_rank_panel")
    _raise_on(lib.cholesky_rank_panel_resident(sched, srows, k,
                                               ctypes.byref(resident)),
              "cholesky_rank_panel_resident", lib)
    return resident.value


def variant_frame(name: str, k: int) -> str:
    """The factor frame of a ``csrc/cholesky_rank_panel.cu`` kernel at
    order k (1 <= k <= ``VARIANT_KMAX``): "panel" (8-column panels; B5a at
    every order, B4 and B5c past kp = ``RANK_FRAME_KPMAX`` with each term
    alone, B5b there in Schur's order of terms), "rank" (column or
    column-pair steps: B4 and B5c to kp = 128) or "schur" (B5b's rank-2
    steps with its A22 groups riding them, to kp = 128)."""
    if (name == "cholesky_solve_panel"
            or (k + 3) // 4 * 4 > RANK_FRAME_KPMAX):
        return "panel"
    return "schur" if name == "cholesky_solve_schur" else "rank"


def variant_block_systems(name: str, k: int) -> int:
    """Systems a block of a ``csrc/cholesky_rank_panel.cu`` kernel carries
    at order k: ``cholesky_solve_dual`` two in the rank frame (each with its
    substitution warp), every kernel one otherwise."""
    return 2 if (name == "cholesky_solve_dual"
                 and variant_frame(name, k) == "rank") else 1


def variant_resident(name: str, k: int, fcols: int = 1,
                     srows: int = 1) -> int:
    """Blocks of a ``csrc/cholesky_rank_panel.cu`` kernel at order k that
    the current card holds at once (asked once; launches nothing):
    ``cholesky_solve_rank1`` of (fcols, srows), ``cholesky_solve_panel``,
    ``cholesky_solve_schur`` of srows (k % 16 == 0) or
    ``cholesky_solve_dual``, whose block carries ``variant_block_systems``
    systems (two to kp = 128, one past it)."""
    if name == "cholesky_solve_rank1":
        _check_schedule(fcols, srows)
        sched = fcols
    elif name == "cholesky_solve_schur":
        _check_schur(k, srows)
        sched = SCHED_CODE[name]
    elif name == "cholesky_solve_panel":
        sched, srows = SCHED_CODE[name], 1
    elif name == "cholesky_solve_dual":
        sched, srows = SCHED_CODE[name], 2
    else:
        raise ValueError(f"no residency query for {name}")
    return _variant_resident(sched, srows, k, torch.cuda.current_device())


def solve_regime(name: str, batch: int, k: int, c: int = 0):
    """(latency?, resident) of a launch of ``name`` (one of
    ``REGIME_KINDS``) at (batch, k, C) on the current card: the latency
    kernel's resident blocks, and whether ``solve_frame`` gives the batch
    the latency kernel (``forced_regime`` aside). Launches nothing."""
    resident = _resident(name, k, c, torch.cuda.current_device())
    return solve_frame(name, batch, k, resident) == "latency", resident


# the C exports of the REGIME_KINDS launches that are not in
# csrc/cholesky_solve.cu
EXPORT_SOURCE = {"cholesky_solve_batched_panel": "cholesky_rank_panel"}


def _pick(name: str, batch: int, k: int, c: int, device: int) -> str:
    """The C export a launch takes: ``name`` (throughput), ``name +
    "_lat"``, or past kp = 128 for B1 ``cholesky_solve_batched_panel`` (of
    ``csrc/cholesky_rank_panel.cu``, ``EXPORT_SOURCE``), by ``solve_frame``
    or ``forced_regime``."""
    if _forced:
        frame = "latency"
    elif _forced is None or (name == "cholesky_solve_batched" and
                             (k + 3) // 4 * 4 > RANK_FRAME_KPMAX):
        resident = _resident(name, k, c, device)
        # forced off the latency kernel: the kernel of a batch past its wave
        frame = solve_frame(name, batch if _forced is None
                            else max(batch, resident + 1), k, resident)
    else:
        frame = "throughput"
    return {"latency": name + "_lat", "throughput": name,
            "panel": name + "_panel"}[frame]


@contextlib.contextmanager
def forced_regime(latency: bool):
    """Inside the block every launch of a ``REGIME_KINDS`` kernel takes the
    latency (True) or the throughput (False) kernel, whatever its batch
    (False for B1 past kp = 128: the kernel ``solve_frame`` gives the batch,
    or a batch one past the latency kernel's wave, whichever is larger):
    both take any batch, so each can be timed on the other's ground."""
    global _forced
    _forced = bool(latency)
    try:
        yield
    finally:
        _forced = None


def _raise_on(err: int, name: str, lib) -> None:
    if err:
        msg = lib.cholesky_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")


def _device_kind(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.is_cpu:
        return "cpu"
    raise ValueError(f"unsupported device {t.device}")


def _large_inputs(name, G, G2, rhs, reg):
    """Checks of a one-block launch's inputs; its output, the padded order
    kq (k rounded up to the kernels' 32-column panels) and the cluster size
    (``cluster_size``, or ``forced_cluster``'s); kq is None for an empty
    batch. The kernels keep the factor in the clusters' shared memory, so a
    launch allocates nothing else."""
    b, k, _ = G.shape
    dev = G.device
    if not 1 <= k <= LARGE_KMAX:
        raise ValueError(f"{name} takes 1 <= k <= {LARGE_KMAX}, got {k}")
    _check("G", G, (b, k, k), torch.float32, dev)
    if G2 is not None:
        _check("G2", G2, (b, k, k), torch.float32, dev)
    _check("rhs", rhs, (b, k), torch.float32, dev)
    _check("reg", reg, (b,), torch.float32, dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out, None, 0
    c = _cluster_forced
    if c is None:
        c = cluster_size(k, b)
    return out, -(-k // LARGE_PANEL) * LARGE_PANEL, c


def active_clusters(k: int, c: int) -> int:
    """Clusters of c CTAs of the one-block kernels at order k that the
    current card holds at once (``cudaOccupancyMaxActiveClusters``, asked
    once; the variants' kernels take the same shared memory and threads);
    raises where a CTA's share does not fit. Launches nothing."""
    n = ctypes.c_longlong(0)
    lib = _lib("cholesky_large")
    _raise_on(lib.cholesky_large_active_clusters(k, c, ctypes.byref(n)),
              "cholesky_large_active_clusters", lib)
    return n.value


def multiwave_cluster(k: int, b: int) -> int:
    """The smallest cluster size above ``cluster_size(k, b)`` whose b
    clusters at order k the current card cannot hold at once
    (``active_clusters(k, c) < b``), for a launch that takes more than one
    wave of clusters (``forced_cluster``); raises where no size the
    kernels take does."""
    kq = -(-k // LARGE_PANEL) * LARGE_PANEL
    for c in range(cluster_size(k, b) + 1,
                   min(CLUSTER_LIMIT, kq // LARGE_PANEL) + 1):
        if (cluster_smem_bytes(kq, c) <= CTA_SMEM
                and active_clusters(k, c) < b):
            return c
    raise ValueError(f"no cluster size makes {b} systems of order {k} "
                     f"more than one wave")


def _launch_large(G, G2, rhs, reg):
    """Checks and one launch of ``cholesky_solve_large`` (``csrc/
    cholesky_large.cu``, the batch wrappers' kernel past kp = 160); a failed
    launch raises."""
    b, k, _ = G.shape
    out, kq, c = _large_inputs("cholesky_solve_large", G, G2, rhs, reg)
    if kq is None:
        return out
    lib = _lib("cholesky_large")
    err = lib.cholesky_solve_large(
        G.data_ptr(), 0 if G2 is None else G2.data_ptr(), rhs.data_ptr(),
        reg.data_ptr(), out.data_ptr(), b, k, kq, c, _stream(G.device))
    _raise_on(err, "cholesky_solve_large", lib)
    LAUNCHES["cholesky_solve_large"] += 1
    return out


def _launch_variant_large(name, G, rhs, reg, sched, srows):
    """Checks and one launch of ``cholesky_solve_variant_large`` (``csrc/
    cholesky_large_variants.cu``, the variant wrappers' kernel past kp =
    160) with the schedule ``sched`` (``csrc/cholesky_rank_panel.cu``'s
    code) and ``srows``, counted under ``name``; a failed launch raises."""
    b, k, _ = G.shape
    out, kq, c = _large_inputs(name, G, None, rhs, reg)
    if kq is None:
        return out
    lib = _lib("cholesky_large_variants")
    err = lib.cholesky_solve_variant_large(
        G.data_ptr(), rhs.data_ptr(), reg.data_ptr(), out.data_ptr(), b, k,
        kq, c, sched, srows, _stream(G.device))
    _raise_on(err, name, lib)
    LAUNCHES[name] += 1
    LARGE_LAUNCHES[name] += 1
    return out


def _launch_variant(name, G, rhs, reg, sched, srows, ints=()):
    """A variant kernel's launch, or its routing by the reference's rule
    (``kernel_supported``; Schur's k % 16 is checked before): the torch
    anchor where the reference goes to XLA (counted in ``ROUTED``), the
    one-block kernel past k = 160, else the kernel of
    ``csrc/cholesky_rank_panel.cu`` of the C signature ``name(G, rhs, reg,
    out, B, k, *ints, stream)``."""
    b, k, _ = G.shape
    if not kernel_supported(k, b):
        ROUTED[name] += 1
        return anchor_solve(G, rhs, reg)
    if k > VARIANT_KMAX:
        return _launch_variant_large(name, G, rhs, reg, sched, srows)
    return _launch_solve(name, "cholesky_rank_panel", G, rhs, reg,
                         ints=ints)


def _launch_solve(name, source, G, rhs, reg, G2=None, ints=()):
    """Checks and one launch of the batch-major solve kernel ``name`` of
    ``csrc/<source>.cu``, of the C signature ``name(G, [G2,] rhs, reg, out,
    B, k, *ints, stream)``; a failed launch raises."""
    b, k, _ = G.shape
    dev = G.device
    _check("G", G, (b, k, k), torch.float32, dev)
    if G2 is not None:
        _check("G2", G2, (b, k, k), torch.float32, dev)
    _check("rhs", rhs, (b, k), torch.float32, dev)
    _check("reg", reg, (b,), torch.float32, dev)
    out = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    grams = (G.data_ptr(),) if G2 is None else (G.data_ptr(), G2.data_ptr())
    stream = _stream(dev)
    fn = _pick(name, b, k, 0, dev.index) if name in REGIME_KINDS else name
    lib = _lib(EXPORT_SOURCE.get(fn, source))
    err = getattr(lib, fn)(*grams, rhs.data_ptr(), reg.data_ptr(),
                           out.data_ptr(), b, k, *ints, stream)
    _raise_on(err, name, lib)
    LAUNCHES[name] += 1
    if fn.endswith("_lat"):
        LATENCY_LAUNCHES[name] += 1
    return out


def cholesky_solve_batched(G: torch.Tensor, rhs: torch.Tensor,
                           reg: torch.Tensor) -> torch.Tensor:
    """x (B, k) = (G + diag(reg))⁻¹ rhs for G (B, k, k) f32, rhs (B, k) f32,
    reg (B,) f32, all contiguous on one device."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_plain(G, rhs, reg)
    b, k, _ = G.shape
    if not kernel_supported(k, b):
        ROUTED["cholesky_solve_batched"] += 1
        return anchor_solve(G, rhs, reg)
    if k > KMAX:
        return _launch_large(G, None, rhs, reg)
    return _launch_solve("cholesky_solve_batched", "cholesky_solve", G, rhs,
                         reg)


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
    stream = _stream(dev)
    lib = _lib()
    fn = _pick("cholesky_solve_hot", b, k, c, dev.index)
    err = getattr(lib, fn)(
        G.data_ptr(), rhs.data_ptr(), reg.data_ptr(), hv.data_ptr(),
        vh.data_ptr(), out.data_ptr(), b, k, c,
        0 if alpha is None else 1, 0.0 if alpha is None else float(alpha),
        stream)
    _raise_on(err, "cholesky_solve_hot", lib)
    LAUNCHES["cholesky_solve_hot"] += 1
    if fn.endswith("_lat"):
        LATENCY_LAUNCHES["cholesky_solve_hot"] += 1
    return out


def cholesky_solve_2g(G: torch.Tensor, G2: torch.Tensor, rhs: torch.Tensor,
                      reg: torch.Tensor) -> torch.Tensor:
    """x (B, k) = (G + G2 + diag(reg))⁻¹ rhs, the second gram G2 (B, k, k)
    f32 summed inside the kernel on load."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_2g_plain(G, G2, rhs, reg)
    b, k, _ = G.shape
    if not kernel_supported(k, b, two_operand=True):
        ROUTED["cholesky_solve_2g"] += 1
        return anchor_solve(G.float() + G2.float(), rhs, reg)
    if k > KMAX:
        return _launch_large(G, G2, rhs, reg)
    return _launch_solve("cholesky_solve_2g", "cholesky_solve", G, rhs, reg,
                         G2=G2)



def cholesky_solve_rank1(G: torch.Tensor, rhs: torch.Tensor,
                         reg: torch.Tensor, fcols: int = 1,
                         srows: int = 1) -> torch.Tensor:
    """The ``cholesky_solve_batched`` solve with a right-looking factor of
    ``fcols`` columns per step and substitutions of ``srows`` rows per step,
    (fcols, srows) in ``RANK1_SCHEDULES``."""
    _check_schedule(fcols, srows)
    if _device_kind(G) == "cpu":
        return cholesky_solve_rank1_plain(G, rhs, reg, fcols, srows)
    return _launch_variant("cholesky_solve_rank1", G, rhs, reg, fcols, srows,
                           ints=(fcols, srows))


def cholesky_solve_panel(G: torch.Tensor, rhs: torch.Tensor,
                         reg: torch.Tensor) -> torch.Tensor:
    """The ``cholesky_solve_batched`` solve with the rank-8 panel factor and
    one-row substitutions."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_panel_plain(G, rhs, reg)
    return _launch_variant("cholesky_solve_panel", G, rhs, reg,
                           SCHED_CODE["cholesky_solve_panel"], 1)


def cholesky_solve_schur(G: torch.Tensor, rhs: torch.Tensor,
                         reg: torch.Tensor, srows: int = 2) -> torch.Tensor:
    """The ``cholesky_solve_batched`` solve with the two-level Schur factor
    (k % 16 == 0) and substitutions of ``srows`` rows per step."""
    k = G.shape[1]
    _check_schur(k, srows)
    if _device_kind(G) == "cpu":
        return cholesky_solve_schur_plain(G, rhs, reg, srows)
    return _launch_variant("cholesky_solve_schur", G, rhs, reg,
                           SCHED_CODE["cholesky_solve_schur"], srows,
                           ints=(srows,))


def cholesky_solve_dual(G: torch.Tensor, rhs: torch.Tensor,
                        reg: torch.Tensor) -> torch.Tensor:
    """The ``cholesky_solve_batched`` solve with the rank-2 factor and
    two-row substitutions (to kp = 128 two systems a block, their factors
    interleaved; past it one a block in the panel frame); any B."""
    if _device_kind(G) == "cpu":
        return cholesky_solve_dual_plain(G, rhs, reg)
    return _launch_variant("cholesky_solve_dual", G, rhs, reg,
                           SCHED_CODE["cholesky_solve_dual"], 2)


# --------------------------------------------------------------------------
# entries with the reference's names and flags

def cholesky_solve_variant(G: torch.Tensor, rhs: torch.Tensor,
                           reg: torch.Tensor, panel: bool = False,
                           pair: bool = True, schur: bool = False,
                           subs2: bool = True, dual: bool = False,
                           G2: torch.Tensor = None) -> torch.Tensor:
    """Batch-major solve with the reference's variant flags, in its order of
    precedence (``_cholesky_solve_t``): ``G2`` (the two-operand kernel,
    whatever the other flags say but ``dual``), then ``dual`` (whatever the
    others say, as in the reference), ``schur``, ``panel`` and ``pair``.
    ``subs2`` picks two-row substitutions where the kernel has the choice;
    ``pair`` with ``subs2`` is ``cholesky_solve_batched``."""
    if G2 is not None:
        if dual:
            raise ValueError("dual variant has no two-operand form")
        return cholesky_solve_2g(G, G2, rhs, reg)
    if dual:
        return cholesky_solve_dual(G, rhs, reg)
    srows = 2 if subs2 else 1
    if schur:
        return cholesky_solve_schur(G, rhs, reg, srows)
    if panel:
        return cholesky_solve_panel(G, rhs, reg)
    if pair:
        if subs2:
            return cholesky_solve_batched(G, rhs, reg)
        return cholesky_solve_rank1(G, rhs, reg, 2, 1)
    return cholesky_solve_rank1(G, rhs, reg, 1, srows)


def cholesky_solve_t(Gt: torch.Tensor, rhst: torch.Tensor,
                     regv: torch.Tensor, panel: bool = False,
                     pair: bool = True, schur: bool = False,
                     subs2: bool = True, dual: bool = False,
                     Gt2: torch.Tensor = None) -> torch.Tensor:
    """Batch-minor entry (the reference's ``_cholesky_solve_t``): Gt
    (k, k, B) with the ridge not yet added, rhst (k, B), regv (1, B) ->
    x (k, B); ``Gt2`` an optional second (k, k, B) gram summed on load. Any
    B; the systems are transposed to the kernels' batch-major layout."""
    def batch_major(t):
        return t.permute(2, 0, 1).float().contiguous()

    x = cholesky_solve_variant(
        batch_major(Gt), rhst.t().float().contiguous(),
        regv.reshape(-1).float().contiguous(), panel=panel, pair=pair,
        schur=schur, subs2=subs2, dual=dual,
        G2=None if Gt2 is None else batch_major(Gt2))
    return x.t()


def cholesky_solve(G: torch.Tensor, rhs: torch.Tensor,
                   panel: bool = False) -> torch.Tensor:
    """Solve ``G x = rhs`` for G (B, k, k) with the ridge already added,
    rhs (B, k) -> x (B, k); ``panel=True`` takes the rank-8 panel kernel."""
    b = G.shape[0]
    reg = torch.zeros((b,), dtype=torch.float32, device=G.device)
    return cholesky_solve_variant(G.float().contiguous(),
                                  rhs.float().contiguous(), reg, panel=panel)


def cholesky_solve_flat(G_flat: torch.Tensor, rhs: torch.Tensor, k: int,
                        reg_vec=None, panel: bool = False) -> torch.Tensor:
    """``cholesky_solve`` on FLAT (B, k*k) row-major systems, with the
    per-system ridge ``reg_vec`` (B,) added inside the kernel on load."""
    b = G_flat.shape[0]
    if reg_vec is None:
        reg = torch.zeros((b,), dtype=torch.float32, device=G_flat.device)
    else:
        reg = torch.as_tensor(reg_vec, dtype=torch.float32,
                              device=G_flat.device).reshape(b).contiguous()
    return cholesky_solve_variant(
        G_flat.float().reshape(b, k, k).contiguous(),
        rhs.float().contiguous(), reg, panel=panel)


__all__ = ["cholesky_solve_batched", "cholesky_solve_hot",
           "cholesky_solve_2g", "cholesky_solve_rank1",
           "cholesky_solve_panel", "cholesky_solve_schur",
           "cholesky_solve_dual",
           "cholesky_solve_plain", "cholesky_solve_hot_plain",
           "cholesky_solve_2g_plain", "cholesky_solve_rank1_plain",
           "cholesky_solve_panel_plain", "cholesky_solve_schur_plain",
           "cholesky_solve_dual_plain",
           "cholesky_solve_variant", "cholesky_solve_t", "cholesky_solve",
           "cholesky_solve_flat", "fold_hot",
           "anchor_solve", "block_batch", "two_operand_block",
           "kernel_supported", "cluster_size", "cluster_owner",
           "cluster_smem_bytes", "forced_cluster", "active_clusters",
           "multiwave_cluster",
           "hot_kernel_supported", "hot_smem_bytes", "hot_cols_cap",
           "hot_cols_auto", "latency_regime", "solve_frame", "solve_regime",
           "variant_resident", "variant_frame", "variant_block_systems",
           "forced_regime", "REGIME_KINDS", "VARIANT_KINDS", "KERNELS",
           "RANK1_SCHEDULES", "LAUNCHES", "ROUTED", "LATENCY_LAUNCHES",
           "LARGE_LAUNCHES", "reset_counts"]
