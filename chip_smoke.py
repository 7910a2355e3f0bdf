#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, in order; any failure exits
non-zero before the result lines are printed:

1. environment: the card, its power limit, torch and nvcc versions, and the
   build of the port's CUDA source (timed);
2. kernel ``cholesky_solve_batched`` against its plain PyTorch version at
   k=64: B=65,536 systems; both regimes and their boundary (B = 1, 255,
   256, 257, the latency kernel's resident count as the card reports it
   and that count +- 1, and 4,201), where each batch must take the kernel
   that ``latency_regime`` names and the other regime's kernel must agree
   too; the flat dense-block entry
   at the main path's dense width; identity-padded / all-zero systems in
   both regimes. Device time per call from ``torch.profiler`` (so host
   gaps do not count) at 256 rows, the dense width and 65,536, beside the
   host's µs per call (wall time over 200 calls) and the library solve's
   device time at the same batch;
3. kernel ``cholesky_solve_hot`` the same way at k=64, C=128, with rows of
   the ML-25M-shaped data's bf16 hot slab, explicit and alpha=2.0 weights
   at every boundary batch, a bitwise repeat, and device time and host cost
   at 256 rows and 65,536;
3b. the solve-variant kernels against their plain versions at k=64,
   B=65,536 and the 256-row block: ``cholesky_solve_2g`` (two grams summed
   on load), ``cholesky_solve_rank1`` in its three (fcols, srows)
   instantiations, ``cholesky_solve_panel``, ``cholesky_solve_schur``
   (srows 1 and 2) and ``cholesky_solve_dual``; ``cholesky_solve_2g`` also
   at B1's boundary batches, with exact zeros in both regimes and its
   device time and host cost at 256 rows. Then the solve-variant path
   as a user runs it, with the launch counts set to 0 just before and read
   just after: ``solve_spd_t(Gt2=)`` at k=64, B=65,536, and the variant
   probe (``probes/solve_variants.py``) at k=128, B=65,536 with pair, rank1,
   pair_s1, panel, schur, schur_s1 and dual. After the counts are read,
   every kernel and instantiation the probe ran is held against its plain
   version on the probe's own k=128 systems (the kernel on all 65,536, the
   first 4,096 compared) and timed there;
3c. the row gather-and-sum kernel ``gather_rows_sum`` (P1) against its
   plain version: at the gather probe's shape (62,423 x 128 f32 table,
   200,000 ids) with 4, 8 and 16 slots; at the main path's gathers (one
   launch over all of the user half's bucket ids into the item table, one
   over the item half's into the user table, on the warm-start factors);
   at 0, 1 and slots - 1 ids, k=13 and k=512, and an unaligned table; and
   a bitwise repeat. Then the gather-rate path as a user runs it, with the
   launch count set to 0 just before and read just after: the probes
   ``probes.dma_gather``, ``probes.gather_rates`` (their defaults),
   ``probes.ablate_epoch.run`` on the ML-25M layouts (3 iterations) and
   ``probes.gather_budget.run`` on the item half, then the user half;
4. ML-1M-shaped rank-64 fits through ``ALS.fit``, 10 sweeps, against the
   JAX package's histories recorded on a CPU (rtol 1e-3 per sweep);
5. the main path as a user runs it: ``ALS(rank=64).fit(R)`` on ML-25M-shaped
   data (auto layout, 10 sweeps), train RMSE within 3% of the reference's
   0.3170; the kernels' launch counts come from this run. Then
   epoch_seconds as ``bench.py`` times it: the solver's whole-fit loop on
   uploaded layouts, which must reproduce the fit's history;
6. one JSON line describing every kernel, then the result line. Each
   entry's numbers are at its ``k`` and ``batch``; B1, B2 and B3 also have
   ``resident`` (the latency kernel's resident blocks), ``regime_by_batch``
   and ``by_batch`` (device ms, host µs, library device ms and bound ms at
   each timed batch); a kernel the probe runs also has ``at_probe_shape``,
   its numbers at the probe's k=128, and ``gather_rows_sum`` has
   ``at_main_path``, its numbers at both halves' gathers.

``--profile`` adds one profiled main-path sweep and prints its device time
by kernel and the device's idle share (not run by default).

Tolerances: a solve kernel agrees with its plain version when
|x - x_plain| <= 5e-4 * scale + 5e-4 * |x_plain|, scale = max(|x_plain|, 1)
(the reference's tests/test_pallas_cholesky.py tolerance). The gather
kernel agrees per column j when |x - x_plain| <= 2e-6 * sum_i
|table[idx_i, j]| + 1e-6: the two add the same f32 rows in different
orders.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s without
# tensor cores; bounds are stated against them at the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ATOL_SCALE = 5e-4
RTOL = 5e-4

RANK = 64
SWEEPS = 10
RMSE_ANCHOR = 0.3170        # BENCH_r05.json train_rmse, ML-25M rank 64
RMSE_ANCHOR_RTOL = 0.03
HISTORY_RTOL = 1e-3

# ML-1M-shaped rank-64 train-RMSE histories of the JAX package, recorded on
# a CPU with (MODE = "separate" and "auto"):
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np, scipy.sparse as sp
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   from recommendation_models_tpu import ALS
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   g = np.random.default_rng(0)
#   U0 = 0.01 * g.standard_normal((6040, 64)).astype(np.float32)
#   V0 = 0.01 * g.standard_normal((3706, 64)).astype(np.float32)
#   m = ALS(rank=64, reg=0.1, n_sweeps=10, solver="xla",
#           compute_dtype="float32", sse_mode=MODE,
#           platform="cpu").fit(R, U0=U0, V0=V0)
#   print([float(x) for x in m.history_])'
# Every sweep of the exact (separate masked_sse) history is checked. Of the
# auto (riding-identity) history only the first three sweeps are: its later
# sweeps carry the identity's own f32 cancellation error (sweep 10: 0.217656
# against a direct RMSE of the same factors of 0.217412), which differs
# between summation orders by about that much.
REF_ML1M_SEPARATE = [
    0.8559578061103821, 0.477059543132782, 0.3594265878200531,
    0.31086301803588867, 0.2821512818336487, 0.2622409462928772,
    0.24724319577217102, 0.23535947501659393, 0.22561043500900269,
    0.21741198003292084]
REF_ML1M_AUTO = [
    0.8559545874595642, 0.4769742488861084, 0.3592991530895233,
    0.3109422028064728, 0.2821660339832306, 0.26207029819488525,
    0.2472238838672638, 0.23537057638168335, 0.22535580396652222,
    0.21765612065792084]

_PALLAS = "recommendation_models_tpu/ops/pallas/cholesky.py"
TPU_KERNEL = {
    "cholesky_solve_batched": f"{_PALLAS}:226",
    "cholesky_solve_hot": f"{_PALLAS}:286",
    "cholesky_solve_2g": f"{_PALLAS}:239",
    "cholesky_solve_rank1": f"{_PALLAS}:198",
    "cholesky_solve_panel": f"{_PALLAS}:107",
    "cholesky_solve_schur": f"{_PALLAS}:697",
    "cholesky_solve_dual": f"{_PALLAS}:675",
    "gather_rows_sum": "scripts/probe_dma_gather.py:49",
}
_CSRC = "recommendation_models_tpu_torch/csrc/"
SOURCE = {
    "cholesky_solve_batched": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_hot": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_2g": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_rank1": _CSRC + "cholesky_variants.cu",
    "cholesky_solve_panel": _CSRC + "cholesky_variants.cu",
    "cholesky_solve_schur": _CSRC + "cholesky_variants.cu",
    "cholesky_solve_dual": _CSRC + "cholesky_variants.cu",
    "gather_rows_sum": _CSRC + "gather.cu",
}
MAIN_PATH = "ALS(rank=64).fit, ML-25M shape"
PATH = {
    "cholesky_solve_batched": MAIN_PATH,
    "cholesky_solve_hot": MAIN_PATH,
    "cholesky_solve_2g": "ops.solve.solve_spd_t(Gt2=), k=64, B=65,536",
    "cholesky_solve_rank1": "probes.solve_variants, k=128, B=65,536",
    "cholesky_solve_panel": "probes.solve_variants, k=128, B=65,536",
    "cholesky_solve_schur": "probes.solve_variants, k=128, B=65,536",
    "cholesky_solve_dual": "probes.solve_variants, k=128, B=65,536",
    "gather_rows_sum": "probes.dma_gather / probes.ablate_epoch gather only",
}
MAIN_KERNELS = ("cholesky_solve_batched", "cholesky_solve_hot")
PROBE_VARIANTS = "pair,rank1,pair_s1,panel,schur,schur_s1,dual"
PROBE_K, PROBE_B, PROBE_REG = 128, 65_536, 0.05   # the probe's defaults
N_CHECK = 4_096       # systems of the k=128 check held against plain
ABL_ITERS = 3         # iterations of each epoch-ablation line


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# ---------------------------------------------------------------- helpers

def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls,
    after ``warm`` warm-up calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, x, ref):
    """(max abs error, within tolerance?) of x against the plain ref."""
    scale = max(float(ref.abs().max()), 1.0)
    err = (x - ref).abs()
    ok = bool(torch.isfinite(x).all()) and bool(
        (err <= ATOL_SCALE * scale + RTOL * ref.abs()).all())
    return float(err.max()), ok


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solve_flops(b: int, k: int) -> float:
    # Cholesky factor k^3/3 + forward and back substitution 2 k^2
    return b * (k ** 3 / 3.0 + 2.0 * k * k)


def solve_bytes(b: int, k: int) -> float:
    # G is symmetric, so a solve must read its lower triangle, k(k+1)/2
    # floats, plus rhs (k) and reg (1), and write x (k)
    return 4.0 * b * (k * (k + 1) / 2.0 + 2 * k + 1)


# ----------------------------------------------------------------- phases

def phase_environment(torch):
    from recommendation_models_tpu_torch.ops import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    ver = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    sources = sorted({os.path.basename(p)[:-3] for p in SOURCE.values()})
    t0 = time.perf_counter()
    build.build(*sources)        # one nvcc per source, all started together
    log(f"# build: {', '.join(f'csrc/{n}.cu' for n in sources)} in "
        f"{time.perf_counter() - t0:.1f}s")
    return card


def boundary_check(torch, name, fn, plain, args, k, c=0):
    """The kernel against its plain version at the batches of both regimes
    and their boundary: 1, 255, 256, 257, the latency kernel's resident
    count (as the card reports it) and that count +- 1, and 4,201 (the main
    path's dense width), each the first b systems of ``args`` (batch-major
    tensors; a 2-d tensor of C rows is passed whole), each repeated
    bitwise, and equal bitwise to the kernel of the regime that
    ``latency_regime`` names; the other regime's kernel is held against the
    plain version at the same batch. Returns (max abs error, resident,
    {batch: regime})."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    _, resident = ch.solve_regime(name, 1, k, c)
    batches = sorted(b for b in {1, 255, 256, 257, resident - 1, resident,
                                 resident + 1, 4_201} if b >= 1)
    err_all, regimes = 0.0, {}
    n = args[0].shape[0]
    for b in batches:
        lat, _ = ch.solve_regime(name, b, k, c)
        regimes[b] = "latency" if lat else "throughput"
        sl = tuple(a[:b].contiguous() if a.shape[0] == n else a
                   for a in args)
        x = fn(*sl)
        ref = plain(*sl)
        err, ok = compare(torch, x, ref)
        check(ok, f"{name} disagrees with its plain version at B={b} "
                  f"({regimes[b]}; max abs err {err:.3e})")
        check(torch.equal(x, fn(*sl)),
              f"{name} is not bitwise repeatable at B={b} ({regimes[b]})")
        with ch.forced_regime(lat):
            check(torch.equal(x, fn(*sl)),
                  f"{name} at B={b} did not take the {regimes[b]} kernel")
        with ch.forced_regime(not lat):
            err_o, ok_o = compare(torch, fn(*sl), ref)
        check(ok_o, f"{name}'s other-regime kernel disagrees at B={b} "
                    f"(max abs err {err_o:.3e})")
        err_all = max(err_all, err, err_o)
    check(set(regimes.values()) == {"latency", "throughput"},
          f"{name}: the boundary batches did not cover both regimes")
    return err_all, resident, regimes


def latency_numbers(torch, fn, library, b):
    """Device ms per call from torch.profiler (host gaps do not count),
    host µs per call (wall time over 200 calls, no sync inside) and the
    library call's device ms, at batch b."""
    from recommendation_models_tpu_torch.probes import host_us, profiled_ms
    from recommendation_models_tpu_torch.probes.solve_latency import reps_for
    reps = reps_for(b)
    return dict(device_ms=profiled_ms(fn, reps), host_us=host_us(fn),
                library_device_ms=profiled_ms(library, max(2, reps // 4)))


def phase_b1(torch, dev, flat_w, b=65_536, k=RANK):
    """B1 at B=65,536, at the batches of both regimes and their boundary,
    and through the flat entry at the main path's dense-block width; device
    time (profiler) and host cost at 256 rows, the dense width and
    65,536."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_flat
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(1)
    G, rhs, reg = random_systems(b, k, 48, gen, dev)
    x = ch.cholesky_solve_batched(G, rhs, reg)
    ref = ch.cholesky_solve_plain(G, rhs, reg)
    err, ok = compare(torch, x, ref)
    check(ok, f"cholesky_solve_batched disagrees with its plain version "
              f"(max abs err {err:.3e})")
    err_b, resident, regimes = boundary_check(
        torch, "cholesky_solve_batched", ch.cholesky_solve_batched,
        ch.cholesky_solve_plain, (G, rhs, reg), k)
    rb = ch.block_batch(k)
    Gb, rhsb, regb = G[:rb].contiguous(), rhs[:rb], reg[:rb]
    # the flat (W, k*k) dense-block entry with a per-row ridge
    Gf, rf, _ = random_systems(flat_w, k, 600, gen, dev)
    regf = 0.1 * (1.0 + torch.rand(flat_w, generator=gen, device=dev))
    xf = solve_spd_flat(Gf.reshape(flat_w, k * k), rf, k, "auto",
                        reg_vec=regf)
    err_f, ok_f = compare(torch, xf, ch.cholesky_solve_plain(Gf, rf, regf))
    check(ok_f, f"flat entry disagrees (max abs err {err_f:.3e})")
    # identity-padded and all-zero systems with rhs 0 solve to exactly 0,
    # in the latency regime (8 systems) and the throughput one
    for nz in (8, resident + 1):
        Gz = torch.zeros(nz, k, k, device=dev)
        Gz[nz // 2:] = torch.eye(k, device=dev)
        z = ch.cholesky_solve_batched(Gz, torch.zeros(nz, k, device=dev),
                                      torch.zeros(nz, device=dev))
        check(bool((z == 0).all()),
              f"zero / identity systems did not solve to 0 (B={nz})")
    eye = torch.eye(k, device=dev)

    def library_on(Gs, rs, gs):
        return lambda: torch.cholesky_solve(
            rs[:, :, None], torch.linalg.cholesky(
                Gs + gs[:, None, None] * eye))

    library = library_on(G, rhs, reg)
    ms = time_ms(torch, lambda: ch.cholesky_solve_batched(G, rhs, reg), 10)
    plain_ms = time_ms(torch, lambda: ch.cholesky_solve_plain(G, rhs, reg),
                       2, warm=1)
    lib_ms = time_ms(torch, library, 5)
    lib_err, _ = compare(torch, library()[:, :, 0], ref)
    lat = {rb: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(Gb, rhsb, regb),
               library_on(Gb, rhsb, regb), rb),
           flat_w: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(Gf, rf, regf),
               library_on(Gf, rf, regf), flat_w),
           b: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(G, rhs, reg),
               library, b)}
    bound_ms, bound_by = bound(solve_bytes(b, k), solve_flops(b, k))
    log(f"# B1 cholesky_solve_batched k={k} B={b}: max_abs_err={err:.3e} "
        f"(boundary B={sorted(regimes)}: {err_b:.3e}, resident {resident}; "
        f"flat W={flat_w}: {err_f:.3e}; library vs "
        f"plain {lib_err:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    by_batch = per_batch(lat, k)
    for n, v in by_batch.items():
        log(f"# B1 B={n} ({regimes.get(int(n), 'throughput')}): device_ms="
            f"{v['device_ms']:.5f} host_us={v['host_us']:.1f} "
            f"library_device_ms={v['library_device_ms']:.5f} "
            f"bound_ms={v['bound_ms']:.5f}")
    return dict(k=k, batch=b, max_abs_err=max(err, err_b, err_f), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, resident=resident,
                regime_by_batch=regimes, by_batch=by_batch)


def per_batch(lat, k, counts=None):
    """The latency numbers by batch, each with its bound; ``counts(n)``
    gives the (bytes, flops) of n systems (default: the plain solve's)."""
    counts = counts or (lambda n: (solve_bytes(n, k), solve_flops(n, k)))
    return {str(n): dict(v, bound_ms=bound(*counts(n))[0])
            for n, v in lat.items()}


def hot_slab_sample(torch, layout, b, dev):
    """``b`` real rows, drawn at random, of the layout's hot slabs (bf16,
    (b, C)): the main path's own hot sparsity."""
    import numpy as np
    hv = np.concatenate([bk.hot_vals[bk.row_ids < layout.n_rows]
                         for bk in layout.buckets])
    check(hv.shape[0] >= b, "not enough hot-slab rows")
    take = np.sort(np.random.default_rng(3).choice(hv.shape[0], b,
                                                   replace=False))
    return torch.from_numpy(hv[take].astype(np.float32)).to(
        dev, torch.bfloat16)


def phase_b2(torch, dev, hv, k=RANK):
    """B2 at B=65,536 on rows of the main path's hot slab, at the batches of
    both regimes and their boundary, with both weightings; device time
    (profiler) and host cost at 256 rows and 65,536."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    b, c = hv.shape
    gen = torch.Generator(device=dev).manual_seed(2)
    G, rhs, reg = random_systems(b, k, 40, gen, dev)
    vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
    x = ch.cholesky_solve_hot(G, rhs, reg, hv, vh)
    ref = ch.cholesky_solve_hot_plain(G, rhs, reg, hv, vh)
    err, ok = compare(torch, x, ref)
    check(ok, f"cholesky_solve_hot disagrees with its plain version "
              f"(max abs err {err:.3e})")
    xi = ch.cholesky_solve_hot(G, rhs, reg, hv, vh, alpha=2.0)
    err_i, ok_i = compare(torch, xi, ch.cholesky_solve_hot_plain(
        G, rhs, reg, hv, vh, alpha=2.0))
    check(ok_i, f"implicit hot solve disagrees (max abs err {err_i:.3e})")
    check(torch.equal(x, ch.cholesky_solve_hot(G, rhs, reg, hv, vh)),
          "cholesky_solve_hot is not bitwise repeatable")
    err_b, resident, regimes = boundary_check(
        torch, "cholesky_solve_hot", ch.cholesky_solve_hot,
        ch.cholesky_solve_hot_plain, (G, rhs, reg, hv, vh), k, c)
    err_bi, _, _ = boundary_check(
        torch, "cholesky_solve_hot",
        lambda *a: ch.cholesky_solve_hot(*a, alpha=2.0),
        lambda *a: ch.cholesky_solve_hot_plain(*a, alpha=2.0),
        (G, rhs, reg, hv, vh), k, c)
    # zero and identity systems with rhs 0 and no hot entries solve to
    # exactly 0 in both regimes
    for nz in (8, resident + 1):
        Gz = torch.zeros(nz, k, k, device=dev)
        Gz[nz // 2:] = torch.eye(k, device=dev)
        z = ch.cholesky_solve_hot(Gz, torch.zeros(nz, k, device=dev),
                                  torch.zeros(nz, device=dev),
                                  torch.zeros_like(hv[:nz]), vh)
        check(bool((z == 0).all()),
              f"zero / identity hot systems did not solve to 0 (B={nz})")
    rb = ch.block_batch(k)
    blk = (G[:rb].contiguous(), rhs[:rb], reg[:rb], hv[:rb].contiguous(), vh)
    xb = ch.cholesky_solve_hot(*blk)
    check(torch.equal(xb, ch.cholesky_solve_hot(*blk)),
          f"cholesky_solve_hot is not bitwise repeatable at B={rb}")
    eye = torch.eye(k, device=dev)

    def library_on(Gs, rs, gs, hs):
        def library():
            G2, rhs2 = ch.fold_hot(Gs, rs, hs, vh, None)
            return torch.cholesky_solve(
                rhs2[:, :, None], torch.linalg.cholesky(
                    G2 + gs[:, None, None] * eye))
        return library

    nnz = int((hv != 0).sum())
    ms = time_ms(torch, lambda: ch.cholesky_solve_hot(G, rhs, reg, hv, vh),
                 10)
    plain_ms = time_ms(
        torch, lambda: ch.cholesky_solve_hot_plain(G, rhs, reg, hv, vh), 2,
        warm=1)
    lib_ms = time_ms(torch, library_on(G, rhs, reg, hv), 5)
    lat = {rb: latency_numbers(torch, lambda: ch.cholesky_solve_hot(*blk),
                               library_on(*blk[:4]), rb),
           b: latency_numbers(
               torch, lambda: ch.cholesky_solve_hot(G, rhs, reg, hv, vh),
               library_on(G, rhs, reg, hv), b)}

    def hot_bound(n):
        # each nonzero hot entry adds a symmetric rank-1 term, k(k+1)
        # flops for its lower triangle, and 2k flops to the rhs
        nz = nnz if n == b else int((hv[:n] != 0).sum())
        return (solve_bytes(n, k) + 2.0 * n * c + 4.0 * c * k,
                solve_flops(n, k) + (k * (k + 1) + 2.0 * k) * nz)

    bound_ms, bound_by = bound(*hot_bound(b))
    by_batch = per_batch(lat, k, hot_bound)
    log(f"# B2 cholesky_solve_hot k={k} C={c} B={b} hot nnz={nnz} "
        f"({nnz / (b * c):.3f} dense): max_abs_err={err:.3e} "
        f"(implicit {err_i:.3e}; boundary B={sorted(regimes)}: "
        f"{max(err_b, err_bi):.3e}, resident {resident}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    for n, v in by_batch.items():
        log(f"# B2 B={n}: device_ms={v['device_ms']:.5f} "
            f"host_us={v['host_us']:.1f} library_device_ms="
            f"{v['library_device_ms']:.5f} bound_ms={v['bound_ms']:.5f}")
    return dict(k=k, batch=b, max_abs_err=max(err, err_i, err_b, err_bi),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, resident=resident,
                regime_by_batch=regimes, by_batch=by_batch)


def variant_systems(torch, dev, b=65_536, k=RANK):
    """The variant phase's inputs: k=64 systems as phase 2's, and a second
    gram (16 random factor rows a system) for the two-operand kernel."""
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(4)
    G, rhs, reg = random_systems(b, k, 48, gen, dev)
    G2, _, _ = random_systems(b, k, 16, gen, dev)
    return G, G2, rhs, reg


def phase_variants(torch, dev, G, G2, rhs, reg):
    """Each solve-variant kernel (every instantiation) against its plain
    version at k=64, B=65,536 and at the 256-row block, with its time, its
    plain version's, the library solve's and its bound."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    b, k, _ = G.shape
    rb = ch.block_batch(k)
    eye = torch.eye(k, device=dev)

    def library(A):
        return lambda: torch.cholesky_solve(
            rhs[:, :, None], torch.linalg.cholesky(
                A + reg[:, None, None] * eye))

    lib_ms = {"one": time_ms(torch, library(G), 5)}
    G12 = G + G2
    lib_ms["two"] = time_ms(torch, library(G12), 5)
    del G12
    runs = [("cholesky_solve_2g", "", ch.cholesky_solve_2g,
             ch.cholesky_solve_2g_plain, (G, G2, rhs, reg), ())]
    runs += [("cholesky_solve_rank1", f"fcols={f},srows={r}",
              ch.cholesky_solve_rank1, ch.cholesky_solve_rank1_plain,
              (G, rhs, reg), (f, r)) for f, r in ch.RANK1_SCHEDULES]
    runs.append(("cholesky_solve_panel", "", ch.cholesky_solve_panel,
                 ch.cholesky_solve_panel_plain, (G, rhs, reg), ()))
    runs += [("cholesky_solve_schur", f"srows={r}", ch.cholesky_solve_schur,
              ch.cholesky_solve_schur_plain, (G, rhs, reg), (r,))
             for r in (1, 2)]
    runs.append(("cholesky_solve_dual", "", ch.cholesky_solve_dual,
                 ch.cholesky_solve_dual_plain, (G, rhs, reg), ()))
    # the entry reported per kernel: the TPU kernel's own default schedule
    # (rank1: pair=False, subs2=False; schur: subs2=True)
    reported = {"cholesky_solve_rank1": "fcols=1,srows=1",
                "cholesky_solve_schur": "srows=2"}
    results = {}
    for name, label, fn, plain, args, extra in runs:
        x = fn(*args, *extra)
        ref = plain(*args, *extra)
        err, ok = compare(torch, x, ref)
        check(ok, f"{name} {label} disagrees with its plain version "
                  f"(max abs err {err:.3e})")
        blk = tuple(a[:rb].contiguous() for a in args)
        err_b, ok_b = compare(torch, fn(*blk, *extra), plain(*blk, *extra))
        check(ok_b, f"{name} {label}: {rb}-row block disagrees "
                    f"(max abs err {err_b:.3e})")
        del x, ref
        extra_fields = {}
        if name == "cholesky_solve_2g":
            # B3 takes B1's two regimes: its boundary, exact zeros in both,
            # and its device time and host cost at 256 rows
            err_bd, resident, regimes = boundary_check(
                torch, name, fn, plain, args, k)
            err_b = max(err_b, err_bd)
            for nz in (8, resident + 1):
                Gz = torch.zeros(nz, k, k, device=dev)
                Gz[nz // 2:] = torch.eye(k, device=dev)
                z = fn(Gz, torch.zeros_like(Gz),
                       torch.zeros(nz, k, device=dev),
                       torch.zeros(nz, device=dev))
                check(bool((z == 0).all()),
                      f"zero / identity B3 systems did not solve to 0 "
                      f"(B={nz})")
            A = blk[0] + blk[1]
            lat = {rb: latency_numbers(
                torch, lambda: fn(*blk), lambda: torch.cholesky_solve(
                    blk[2][:, :, None], torch.linalg.cholesky(
                        A + blk[3][:, None, None] * eye)), rb)}
            extra_fields = dict(
                resident=resident, regime_by_batch=regimes,
                by_batch=per_batch(lat, k, lambda n: (
                    solve_bytes(n, k) + 4.0 * n * k * (k + 1) / 2,
                    solve_flops(n, k) + n * k * (k + 1) / 2)))
            v = lat[rb]
            log(f"# B3 B={rb} ({regimes[rb]}): device_ms={v['device_ms']:.5f} "
                f"host_us={v['host_us']:.1f} library_device_ms="
                f"{v['library_device_ms']:.5f}; boundary B={sorted(regimes)}"
                f" max_abs_err={err_bd:.3e}, resident {resident}")
        ms = time_ms(torch, lambda: fn(*args, *extra), 10)
        plain_ms = time_ms(torch, lambda: plain(*args, *extra), 2, warm=1)
        block_ms = time_ms(torch, lambda: fn(*blk, *extra), 50)
        two = name == "cholesky_solve_2g"
        n_bytes = solve_bytes(b, k) + (4.0 * b * k * (k + 1) / 2 if two
                                       else 0.0)
        n_flops = solve_flops(b, k) + (b * k * (k + 1) / 2 if two else 0.0)
        bound_ms, bound_by = bound(n_bytes, n_flops)
        lms = lib_ms["two" if two else "one"]
        log(f"# {' '.join(filter(None, (name, label)))} k={k} B={b}: "
            f"max_abs_err={err:.3e} "
            f"(B={rb}: {err_b:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"library_ms={lms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); "
            f"B={rb} ms={block_ms:.4f}")
        r = results.setdefault(name, dict(k=k, batch=b, max_abs_err=0.0,
                                          instantiations={}))
        r["max_abs_err"] = max(r["max_abs_err"], err, err_b)
        r.update(extra_fields)
        if label:
            r["instantiations"][label] = ms
        if reported.get(name, label) == label:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lms,
                     bound_ms=bound_ms, bound_by=bound_by)
    for r in results.values():
        if not r["instantiations"]:
            del r["instantiations"]
    return results


def phase_variant_path(torch, dev, G, G2, rhs, reg):
    """The solve-variant path as a user runs it, counted: the public
    two-operand solve ``solve_spd_t(Gt2=)`` at k=64, B=65,536 (batch-minor
    views, as its callers hold them), then the variant probe at k=128,
    B=65,536 through its ``main``."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_t
    from recommendation_models_tpu_torch.probes import solve_variants
    torch.cuda.synchronize()
    ch.reset_counts()
    x = solve_spd_t(G.permute(1, 2, 0), rhs.t(), "auto", reg_vec=reg,
                    Gt2=G2.permute(1, 2, 0))
    torch.cuda.synchronize()
    err, ok = compare(torch, x.t(), ch.cholesky_solve_2g_plain(G, G2, rhs,
                                                               reg))
    check(ok and tuple(x.shape) == (RANK, G.shape[0]),
          f"solve_spd_t(Gt2=) disagrees (max abs err {err:.3e})")
    del x
    t0 = time.perf_counter()
    rc = solve_variants.main(["--platform", "cuda"], env=dict(
        PSV_K=str(PROBE_K), PSV_B=str(PROBE_B), PSV_ITERS="10",
        PSV_VARIANTS=PROBE_VARIANTS))
    torch.cuda.synchronize()
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    log(f"# solve-variant path: solve_spd_t(Gt2=) max_abs_err={err:.3e}; "
        f"probe k={PROBE_K} in {time.perf_counter() - t0:.1f}s rc={rc}; "
        f"launches={launches} routed={routed}")
    check(rc == 0, "the solve-variant probe failed")
    check(not any(routed.values()), f"variant-path calls were routed: "
                                    f"{routed}")
    return launches


def phase_probe_shape(torch, dev):
    """Every kernel and instantiation the probe runs, on the probe's own
    k=128, B=65,536 systems (``make_systems``, ridge 0.05): the kernel
    solves all of them, and its first ``N_CHECK`` solutions are held
    against the plain version on those systems. Timed there, beside the
    bound and the library solve at that shape. Run after the path's counts
    are read, so these launches are not counted."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.solve_variants import (
        make_systems)
    k, b = PROBE_K, PROBE_B
    G, rhs = make_systems(k, b, dev)
    reg = torch.full((b,), PROBE_REG, device=dev)
    n = N_CHECK
    Gc, rhsc, regc = G[:n].contiguous(), rhs[:n].contiguous(), reg[:n]
    runs = [("cholesky_solve_batched", "", ch.cholesky_solve_batched,
             ch.cholesky_solve_plain, ())]
    runs += [("cholesky_solve_rank1", f"fcols={f},srows={r}",
              ch.cholesky_solve_rank1, ch.cholesky_solve_rank1_plain, (f, r))
             for f, r in ch.RANK1_SCHEDULES]
    runs.append(("cholesky_solve_panel", "", ch.cholesky_solve_panel,
                 ch.cholesky_solve_panel_plain, ()))
    runs += [("cholesky_solve_schur", f"srows={r}", ch.cholesky_solve_schur,
              ch.cholesky_solve_schur_plain, (r,)) for r in (1, 2)]
    runs.append(("cholesky_solve_dual", "", ch.cholesky_solve_dual,
                 ch.cholesky_solve_dual_plain, ()))
    reported = {"cholesky_solve_rank1": "fcols=1,srows=1",
                "cholesky_solve_schur": "srows=2"}
    eye = torch.eye(k, device=dev)

    def library():
        return torch.cholesky_solve(rhs[:, :, None], torch.linalg.cholesky(
            G + reg[:, None, None] * eye))

    lib_ms = time_ms(torch, library, 2, warm=1)
    bound_ms, bound_by = bound(solve_bytes(b, k), solve_flops(b, k))
    results = {}
    for name, label, fn, plain, extra in runs:
        x = fn(G, rhs, reg, *extra)
        err, ok = compare(torch, x[:n], plain(Gc, rhsc, regc, *extra))
        check(ok, f"{name} {label} at k={k}, B={b} disagrees with its plain "
                  f"version on the first {n} systems (max abs err "
                  f"{err:.3e})")
        del x
        ms = time_ms(torch, lambda: fn(G, rhs, reg, *extra), 3, warm=1)
        log(f"# {' '.join(filter(None, (name, label)))} k={k} B={b}: "
            f"max_abs_err={err:.3e} (first {n} vs plain) ms={ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        r = results.setdefault(name, dict(k=k, batch=b, checked=n,
                                          max_abs_err=0.0, bound_ms=bound_ms,
                                          bound_by=bound_by,
                                          library_ms=lib_ms,
                                          instantiations={}))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label:
            r["instantiations"][label] = ms
        if reported.get(name, label) == label:
            r["ms"] = ms
    for r in results.values():
        if not r["instantiations"]:
            del r["instantiations"]
    return results


def gather_check(torch, table, idx, slots=None):
    """(out, max abs error, agrees?) of the gather kernel (``slots`` None:
    the wrapper's default) against its plain version, per column within
    2e-6 * sum |rows| + 1e-6."""
    from recommendation_models_tpu_torch.ops import gather as ga
    x = ga.gather_rows_sum(table, idx, slots or ga.DEFAULT_SLOTS)
    ref = ga.gather_rows_sum_plain(table, idx)
    err = (x - ref).abs()
    ok = (bool(torch.isfinite(x).all()) and tuple(x.shape) == (1, ref.shape[1])
          and bool((err <= ga.sum_tolerance(table, idx)).all()))
    return x, float(err.max()), ok


def gather_numbers(torch, table, idx, reps, slots=None):
    """The gather kernel's time, its plain version's, the library call's
    (``embedding_bag(mode="sum")``) and its bound on these inputs: every
    distinct row touched read once, the ids read once, the output written
    once; one add per gathered element."""
    import torch.nn.functional as F
    from recommendation_models_tpu_torch.ops import gather as ga
    n, k = idx.shape[0], table.shape[1]
    slots = slots or ga.DEFAULT_SLOTS
    offsets = torch.zeros(1, dtype=idx.dtype, device=idx.device)
    ms = time_ms(torch, lambda: ga.gather_rows_sum(table, idx, slots), reps)
    plain_ms = time_ms(torch, lambda: ga.gather_rows_sum_plain(table, idx),
                       max(2, reps // 4), warm=1)
    lib_ms = time_ms(torch, lambda: F.embedding_bag(idx, table, offsets,
                                                    mode="sum"),
                     max(2, reps // 4), warm=1)
    distinct = int(torch.unique(idx).numel())
    bound_ms, bound_by = bound(4.0 * (distinct * k + n + k), float(n * k))
    return dict(k=k, batch=n, distinct_rows=distinct, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_gather(torch, dev, ul, il):
    """P1 ``gather_rows_sum`` against its plain version and timed: at the
    gather probe's shape (slots 4, 8, 16), at both halves' gathers of the
    main path (every bucket id of the half, one launch, slots 8) on the
    warm-start factor tables, at ragged sizes, and bitwise repeated."""
    from recommendation_models_tpu_torch.ops import gather as ga
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.probes import dma_gather
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    n_table, k, n = dma_gather.N_TABLE, dma_gather.K, dma_gather.N_GATHER
    table, idx = dma_gather.make_inputs(n_table, k, n, dev)
    res = {"instantiations": {}}
    err_all = 0.0
    for slots in dma_gather.SLOTS:
        _, err, ok = gather_check(torch, table, idx, slots)
        check(ok, f"gather_rows_sum slots={slots} disagrees with its plain "
                  f"version at the probe's shape (max abs err {err:.3e})")
        num = gather_numbers(torch, table, idx, 20, slots)
        res["instantiations"][f"slots={slots}"] = num["ms"]
        err_all = max(err_all, err)
        if slots == ga.DEFAULT_SLOTS:
            res.update(num)
        log(f"# P1 gather_rows_sum n_table={n_table} k={k} ids={n} "
            f"slots={slots}: max_abs_err={err:.3e} ms={num['ms']:.4f} "
            f"({n / num['ms'] / 1e3:.1f} M rows/s) plain_ms="
            f"{num['plain_ms']:.4f} library_ms={num['library_ms']:.4f} "
            f"bound_ms={num['bound_ms']:.5f} ({num['bound_by']}, "
            f"{num['distinct_rows']} distinct rows)")
    # ragged sizes: no ids, one, fewer than the slots; k=13 (4-byte
    # copies), k=512 with 32 slots (the widest ring), an unaligned table
    ragged = [(table, idx[:0], 8), (table, idx[:1], 8), (table, idx[:7], 8)]
    gen = torch.Generator(device=dev).manual_seed(5)
    t13 = torch.randn(1000, 13, generator=gen, device=dev)
    t512 = torch.randn(3000, 512, generator=gen, device=dev)
    flat = torch.randn(600 * 64 + 1, generator=gen, device=dev)
    t_off = flat[1:].view(600, 64)
    for t, slots in ((t13, 8), (t512, 32), (t_off, 8)):
        ids = torch.randint(0, t.shape[0], (5_000,), generator=gen,
                            device=dev, dtype=torch.int32)
        ragged.append((t, ids, slots))
    for t, ids, slots in ragged:
        x, err, ok = gather_check(torch, t, ids, slots)
        check(ok, f"gather_rows_sum disagrees at k={t.shape[1]}, "
                  f"{ids.shape[0]} ids, slots={slots} (max abs err "
                  f"{err:.3e})")
        if ids.shape[0] == 0:
            check(bool((x == 0).all()), "no ids did not give zeros")
        err_all = max(err_all, err)
    # the main path's gathers: all of a half's bucket ids at once
    U0, V0 = (torch.from_numpy(a).to(dev) for a in warm_start(ul.n_rows,
                                                              il.n_rows))
    at_main = {}
    for tag, layout, tbl in (("user_half", ul, V0), ("item_half", il, U0)):
        bs = device_buckets(layout, block_batch(RANK), dev)
        ids = torch.cat([b["indices"].reshape(-1) for b in bs
                         if "indices" in b])
        del bs
        x, err, ok = gather_check(torch, tbl, ids)
        check(ok, f"gather_rows_sum disagrees at the main path's {tag} "
                  f"gather (max abs err {err:.3e})")
        check(torch.equal(x, ga.gather_rows_sum(tbl, ids)),
              f"gather_rows_sum is not bitwise repeatable ({tag})")
        num = gather_numbers(torch, tbl, ids, 5)
        num["max_abs_err"] = err
        at_main[tag] = num
        err_all = max(err_all, err)
        log(f"# P1 gather_rows_sum at the main path's {tag} gather: table "
            f"{tuple(tbl.shape)}, {ids.shape[0]} ids: max_abs_err={err:.3e} "
            f"ms={num['ms']:.4f} ({ids.shape[0] / num['ms'] / 1e3:.1f} M "
            f"rows/s) plain_ms={num['plain_ms']:.4f} library_ms="
            f"{num['library_ms']:.4f} bound_ms={num['bound_ms']:.5f} "
            f"({num['bound_by']}, {num['distinct_rows']} distinct rows)")
        del ids
    x1 = ga.gather_rows_sum(table, idx)
    check(torch.equal(x1, ga.gather_rows_sum(table, idx)),
          "gather_rows_sum is not bitwise repeatable at the probe's shape")
    res.update(max_abs_err=err_all, at_main_path=at_main)
    return res


def phase_gather_path(torch, dev, ul, il):
    """The gather-rate path as a user runs it, counted: the gather probe
    and the gather-rate probe through their ``main`` (defaults), the epoch
    ablation on the ML-25M layouts and the gather-budget sweep of the item
    half, then of the user half."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.ops import gather as ga
    from recommendation_models_tpu_torch.probes import (
        ablate_epoch, dma_gather, gather_budget, gather_rates)
    torch.cuda.synchronize()
    ga.reset_counts()
    t0 = time.perf_counter()
    rc = {"dma_gather": dma_gather.main(["--platform", "cuda"]),
          "gather_rates": gather_rates.main(["--platform", "cuda"], env={})}
    res = ablate_epoch.run(ul, il, SolveConfig(rank=RANK, reg=0.1),
                           ABL_ITERS, dev)
    rc["ablate_epoch"] = 0 if res["ok"] else 1
    for side, layout in (("item", il), ("user", ul)):
        gather_budget.run(layout, RANK, gather_budget.BUDGETS, ABL_ITERS,
                          side, dev)
    rc["gather_budget"] = 0
    torch.cuda.synchronize()
    launches = ga.LAUNCHES["gather_rows_sum"]
    log(f"# gather-rate path in {time.perf_counter() - t0:.1f}s: rc={rc} "
        f"launches={{'gather_rows_sum': {launches}}}")
    check(not any(rc.values()), f"a gather probe failed: {rc}")
    check(launches > 0, "gather_rows_sum was not launched on its path")
    return launches


def phase_ml1m(torch, dev):
    """ML-1M-shaped rank-64 fits through ``ALS.fit`` against the recorded
    JAX histories: the separate-SSE history sweep by sweep, and the first
    three sweeps of the auto (riding-identity) history."""
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    n_users, n_items, n_obs = SCALES["ml1m"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items)
    for mode, ref, n_check in (("separate", REF_ML1M_SEPARATE, SWEEPS),
                               ("auto", REF_ML1M_AUTO, 3)):
        ch.reset_counts()
        t0 = time.perf_counter()
        m = ALS(rank=RANK, reg=0.1, n_sweeps=SWEEPS, sse_mode=mode,
                platform=dev.type).fit(R, U0=U0, V0=V0)
        secs = time.perf_counter() - t0
        launches = dict(ch.LAUNCHES)
        hist = [float(h) for h in m.history_]
        rel = [abs(a - b) / b for a, b in zip(hist, ref)]
        log(f"# ML-1M rank {RANK} sse_mode={mode}: nnz={R.nnz} fit "
            f"{secs:.2f}s history={hist} rel diff vs JAX CPU="
            f"{[float(f'{x:.2e}') for x in rel]} (checked: first "
            f"{n_check}) launches={launches}")
        check(len(hist) == SWEEPS, "ML-1M fit ran too few sweeps")
        check(max(rel[:n_check]) <= HISTORY_RTOL,
              f"ML-1M {mode} history differs from the reference: {rel}")
        check(all(launches[n] > 0 for n in MAIN_KERNELS),
              f"a kernel was not launched in the ML-1M fit: {launches}")


def build_main_path_data():
    """ML-25M-shaped data and both auto layouts (host side, as bench.py)."""
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        main_path_layouts)
    t0 = time.perf_counter()
    (u, i, r), ul, il = main_path_layouts("ml25m", RANK)
    log(f"# ML-25M data: {r.shape[0]} obs, layouts in "
        f"{time.perf_counter() - t0:.1f}s; user {len(ul.buckets)} buckets "
        f"waste {ul.padding_waste():.2%} dense "
        f"{0 if ul.dense_ids is None else ul.dense_ids.shape[0]}; item "
        f"{len(il.buckets)} buckets waste {il.padding_waste():.2%} dense "
        f"{0 if il.dense_ids is None else il.dense_ids.shape[0]}; hot C="
        f"{0 if ul.hot_ids is None else ul.hot_ids.shape[0]}")
    return (u, i, r), ul, il


def phase_main_path(torch, coo):
    """The main path as a user runs it: ``ALS(rank=64).fit(R)`` on the card
    (auto layout, 10 sweeps). The kernels' launch counts come from here."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    u, i, r = coo
    n_users, n_items = SCALES["ml25m"][:2]
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.reset_counts()
    t0 = time.perf_counter()
    m = ALS(rank=RANK, reg=0.1, n_sweeps=SWEEPS).fit(R, U0=U0, V0=V0)
    fit_s = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    routed = dict(ch.ROUTED)
    peak = torch.cuda.max_memory_allocated()
    hist = [float(h) for h in m.history_]
    rmse = hist[-1]
    log(f"# main path ALS(rank={RANK}).fit, ML-25M shape: fit_seconds="
        f"{fit_s:.2f} (layout build and upload included) history={hist} "
        f"train_rmse={rmse:.4f} max_memory_allocated={peak} "
        f"launches={launches} routed={routed}")
    check(len(hist) == SWEEPS, "main path ran too few sweeps")
    check(np.isfinite(m.U_).all() and np.isfinite(m.V_).all()
          and m.U_.shape == (n_users, RANK) and m.V_.shape == (n_items, RANK),
          "main path factors are not finite or have the wrong shape")
    check(abs(rmse - RMSE_ANCHOR) <= RMSE_ANCHOR_RTOL * RMSE_ANCHOR,
          f"train RMSE {rmse:.4f} is not within 3% of {RMSE_ANCHOR}")
    check(all(launches[n] > 0 for n in MAIN_KERNELS),
          f"a kernel was not launched on the main path: {launches}")
    check(not any(routed.values()), f"main-path calls were routed: {routed}")
    return launches, hist


def phase_epoch(torch, dev, nnz, ul, il, main_hist, profile=False):
    """epoch_seconds as bench.py times it: the solver's whole-fit loop on
    uploaded layouts, warmed up, clocked from the first sweep to the
    history readback (the fit's only sync); with ``profile``, one sweep's
    device time by kernel and the device's idle share of the epoch."""
    import numpy as np
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        profile_sweep, scanned_fits, time_fit)
    fit, one, U0, V0 = scanned_fits(ul, il, nnz, dev, RANK)
    epoch_s, U, V, sse_h, n_done = time_fit(fit, U0, V0)
    hist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    rel = max(abs(a - b) / b for a, b in zip(hist, main_hist))
    log(f"# main path epoch_seconds={epoch_s:.4f} ({SWEEPS} sweeps in "
        f"{epoch_s * SWEEPS:.3f}s; history max rel diff vs ALS.fit "
        f"{rel:.2e})")
    check(n_done == SWEEPS and rel <= HISTORY_RTOL,
          "the timed fit does not reproduce ALS.fit's history")
    if profile:
        log(json.dumps({"profile": profile_sweep(one, U, V, epoch_s)}))
    return epoch_s


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import recommendation_models_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.gram import full_f32
    dev = torch.device("cuda")
    full_f32()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t_start = time.perf_counter()
    phase_environment(torch)
    coo, ul, il = build_main_path_data()
    results = {"cholesky_solve_batched": phase_b1(
        torch, dev, flat_w=il.dense_ids.shape[0])}
    results["cholesky_solve_hot"] = phase_b2(
        torch, dev, hot_slab_sample(torch, ul, 65_536, dev))
    torch.cuda.empty_cache()
    systems = variant_systems(torch, dev)
    results.update(phase_variants(torch, dev, *systems))
    launches = phase_variant_path(torch, dev, *systems)
    del systems
    torch.cuda.empty_cache()
    at_probe = phase_probe_shape(torch, dev)
    torch.cuda.empty_cache()
    results["gather_rows_sum"] = phase_gather(torch, dev, ul, il)
    torch.cuda.empty_cache()
    launches["gather_rows_sum"] = phase_gather_path(torch, dev, ul, il)
    torch.cuda.empty_cache()
    phase_ml1m(torch, dev)
    main_launches, hist = phase_main_path(torch, coo)
    launches.update({n: main_launches[n] for n in MAIN_KERNELS})
    torch.cuda.empty_cache()
    phase_epoch(torch, dev, coo[2].shape[0], ul, il, hist,
                profile="--profile" in argv)
    kernels = []
    for name in TPU_KERNEL:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "path": PATH[name],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "k": r["k"], "batch": r["batch"],
            **{f: r[f] for f in ("resident", "regime_by_batch", "by_batch")
               if f in r},
            **({"instantiations": r["instantiations"]}
               if "instantiations" in r else {}),
            **({"at_probe_shape": at_probe[name]} if name in at_probe
               else {}),
            **({"at_main_path": r["at_main_path"]} if "at_main_path" in r
               else {})})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(f"# total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
