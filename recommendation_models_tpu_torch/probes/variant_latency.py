"""Device time of the solve-variant kernels at the shapes they are compared
at, beside their bound, plain version and the library solve.

    python -m recommendation_models_tpu_torch.probes.variant_latency \
        [--shapes 64:65536,64:256,128:65536] [--kernels all] [--plain] \
        [--ptxas SRC.cu,...] [--save DIR] [--against DIR]

For each shape ``k:B`` and each kernel instantiation (``rank1_11``,
``rank1_12``, ``rank1_21``: ``cholesky_solve_rank1`` with (fcols, srows);
``panel``; ``schur_1``, ``schur_2``; ``dual``; and B1
``cholesky_solve_batched`` as ``batched``, the yardstick of the same
solve, and as ``batched_lat`` its latency kernel at every batch,
``forced_regime(True)``; not in ``all``; B2 ``cholesky_solve_hot`` as
``hot`` and ``hot_implicit`` (a ``hot_cols_cap(k)``-wide bf16 hot slab,
28% nonzero, explicit and implicit weights, alpha 1) and B3
``cholesky_solve_2g`` as ``2g`` (a second gram of 16 random factor rows),
each on the same systems, and each of B1-B3 as ``<name>_lat``,
``<name>_tp`` and ``<name>_panel``, the kernel ``forced_regime(True)``,
``forced_regime(False)`` and ``forced_regime("panel")`` give at every
batch: the latency kernel, the kernel of a batch past its wave and, past
kp = 128, the panel frame (skipped where the checkout cannot force it);
not in ``all``), one JSON line with
``device_ms`` (device time per call from ``torch.profiler``, so host gaps
do not count; null where the profiler did not record every call, as it
drops some calls milliseconds long), ``event_ms`` (CUDA events around
the same calls; with the stream kept full, the device time of such
calls),
``max_abs_err`` and ``agrees`` (the kernel against its plain version on
the first ``min(B, 1024)`` systems, within 5e-4·scale + 5e-4·|x|),
``bound_ms`` (the lower triangle of G, rhs, reg and x once over 3.35 TB/s,
or k³/3 + 2k² flops a system over 67 TFLOP/s, whichever is larger),
``library_ms`` and ``library_event_ms`` (``torch.linalg.cholesky`` +
``cholesky_solve``, read both ways, the device ms from one traced call
where the profiler dropped some of ``reps``; B2 after the torch fold of
its hot terms, B3 on G + G2), ``cluster`` (past k = 160, where the
checkout's ``ops.cholesky`` has ``cluster_size``: the CTAs of a system's
cluster in the one-block kernel), ``blocks_per_sm`` and ``frame`` (to k =
160, a ``csrc/cholesky_rank_panel.cu`` kernel's resident blocks an SM and
its factor frame, ``ops.cholesky.variant_frame``: "rank", "panel" or
"schur"; null for B1-B3 and where the checkout has no such query), for
B1-B3 to k = 160 ``regime`` (its kernel by the checkout's rule,
``solve_frame``: "latency", "throughput" or "panel"), ``resident`` (the
latency kernel's resident blocks) and ``blocks_by_smem`` (the blocks an
SM of 228 KB that the regime's block of dynamic shared memory, plus the
runtime's 1 KB, allows: ``hot_smem_bytes`` for the latency and throughput
kernels, ``panel_smem_bytes`` for the panel frame where the checkout has
it; B1 and B3 as a hot block of width 0) and, with
``--plain``, ``plain_ms`` (CUDA events, one call). Any order 1 <= k <= 160
is taken, the narrow-last-panel orders (kp % 8 == 4: 129, 147, 153) too.
Past k = 160 the shapes are the one-block kernels' (``--shapes
656:1,656:8``, at most ``block_batch(k)`` systems). Systems:
at k = 128 the variant probe's (``probes.solve_variants.make_systems``,
ridge 0.05), else grams of 48 random factor rows with a 0.1 ridge
(``probes.solve_latency.random_systems``, seed 0).

``--save DIR`` writes each solution to ``DIR``; ``--against DIR`` adds
``bitwise_equal``, whether each solution equals the one a ``--save`` run
wrote there (on the same inputs: their fingerprint must match), which is
how two trees' kernels are held bit for bit against each other.

``--ptxas`` compiles each named source with ``nvcc -Xptxas -v`` (the
build's flags) and prints, per kernel, its registers, spill bytes, static
shared memory and the blocks per SM its registers allow at its thread
count (``resident_by_registers``: 64 K registers per SM in 256-register
warp granules, at most 64 warps and 32 blocks).

The probe imports only ``ops.cholesky``'s public wrappers and plain
versions, so it times another checkout's kernels when run from that
checkout's root (``python -m`` puts the working directory first on the
path): that is how two trees are compared in one call.
Runs only on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

from recommendation_models_tpu_torch.probes import (
    device_rows, step_rows, time_ms)

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
N_CHECK = 1024
SM_SMEM = 233_472     # an H100 SM's shared memory, in bytes
BLOCK_RESERVED = 1024  # what the runtime keeps of it for each block
HOT_ALPHA = 1.0       # the implicit weights' alpha
ALL = ("rank1_11", "rank1_12", "rank1_21", "panel", "schur_1", "schur_2",
       "dual", "batched", "hot", "hot_implicit", "2g")
# B1-B3 by their probe names: (wrapper, what it adds to the solve)
REGIME = {"batched": ("cholesky_solve_batched", None),
          "hot": ("cholesky_solve_hot", "hot"),
          "hot_implicit": ("cholesky_solve_hot", "hot"),
          "2g": ("cholesky_solve_2g", "2g")}
FORCED = tuple(f"{n}_{f}" for n in ("batched", "hot", "2g")
               for f in ("lat", "tp", "panel"))
# the forced_regime argument of each forced suffix
FORCE = {"_lat": True, "_tp": False, "_panel": "panel"}
KNOWN = ALL + FORCED
# each instantiation's wrapper and residency query arguments (the
# cholesky_rank_panel.cu kernels; B1 ``batched`` has none here)
RESIDENCY = {"rank1_11": ("cholesky_solve_rank1", 1, 1),
             "rank1_12": ("cholesky_solve_rank1", 1, 2),
             "rank1_21": ("cholesky_solve_rank1", 2, 1),
             "panel": ("cholesky_solve_panel", 1, 1),
             "schur_1": ("cholesky_solve_schur", 1, 1),
             "schur_2": ("cholesky_solve_schur", 1, 2),
             "dual": ("cholesky_solve_dual", 1, 2)}


def fused_inputs(b: int, k: int, dev, seed: int = 1) -> dict:
    """What B2 and B3 add to b systems of order k, made from ``seed``: a
    second gram ``G2`` (16 random factor rows a system), a
    ``hot_cols_cap(k)``-wide bf16 hot slab ``hv`` (28% nonzero, half-star
    ratings) and its hot factor rows ``vh`` (0.3 N(0, 1))."""
    from recommendation_models_tpu_torch.ops.cholesky import hot_cols_cap
    from recommendation_models_tpu_torch.probes.solve_latency import (
        hot_slab, random_systems)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = hot_cols_cap(k)
    return dict(G2=random_systems(b, k, 16, gen, dev)[0],
                hv=hot_slab(b, c, gen, dev),
                vh=0.3 * torch.randn(c, k, generator=gen, device=dev))


def kernels(ch, extra=None):
    """name -> (kernel call, plain call), each of (G, rhs, reg). B2's and
    B3's calls take what they add to the solve from ``extra(G)`` (the
    first ``len(G)`` systems'; by default ``fused_inputs`` of G's shape)."""
    if extra is None:
        def extra(G):
            return fused_inputs(G.shape[0], G.shape[1], G.device)
    out = {}
    for f, s in ((1, 1), (1, 2), (2, 1)):
        out[f"rank1_{f}{s}"] = (
            lambda G, r, g, f=f, s=s: ch.cholesky_solve_rank1(G, r, g, f, s),
            lambda G, r, g, f=f, s=s: ch.cholesky_solve_rank1_plain(
                G, r, g, f, s))
    out["panel"] = (ch.cholesky_solve_panel, ch.cholesky_solve_panel_plain)
    for s in (1, 2):
        out[f"schur_{s}"] = (
            lambda G, r, g, s=s: ch.cholesky_solve_schur(G, r, g, s),
            lambda G, r, g, s=s: ch.cholesky_solve_schur_plain(G, r, g, s))
    out["dual"] = (ch.cholesky_solve_dual, ch.cholesky_solve_dual_plain)
    out["batched"] = (ch.cholesky_solve_batched, ch.cholesky_solve_plain)

    def hot(alpha):
        def call(fn):
            def run(G, r, g):
                x = extra(G)
                return fn(G, r, g, x["hv"], x["vh"], alpha)
            return run
        return call(ch.cholesky_solve_hot), call(ch.cholesky_solve_hot_plain)
    out["hot"] = hot(None)
    out["hot_implicit"] = hot(HOT_ALPHA)
    out["2g"] = tuple(
        (lambda G, r, g, fn=fn: fn(G, extra(G)["G2"], r, g))
        for fn in (ch.cholesky_solve_2g, ch.cholesky_solve_2g_plain))

    def forced(fn, latency):
        def call(G, r, g):
            with ch.forced_regime(latency):
                return fn(G, r, g)
        return call
    for name in ("batched", "hot", "2g"):
        fn, plain = out[name]
        for suffix, how in FORCE.items():
            out[name + suffix] = (forced(fn, how), plain)
    return out


def base_name(name: str) -> str:
    """B1-B3's probe name without its forced regime (``hot_lat`` ->
    ``hot``); any other name as it is."""
    for f in FORCE:
        if name in FORCED and name.endswith(f):
            return name[:-len(f)]
    return name


def blocks_per_sm(ch, name, k):
    """Resident blocks an SM of a ``csrc/cholesky_rank_panel.cu`` kernel
    at order k (``variant_resident`` over the SM count), or None (B1, or
    past k = 160)."""
    if name not in RESIDENCY or k > ch.VARIANT_KMAX:
        return None
    wrapper, f, s = RESIDENCY[name]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ch.variant_resident(wrapper, k, f, s) / sms


def frame(ch, name, k):
    """The factor frame of a ``csrc/cholesky_rank_panel.cu`` kernel at
    order k (``ops.cholesky.variant_frame``, where the checkout has it)."""
    fn = getattr(ch, "variant_frame", None)
    if fn is None or name not in RESIDENCY or k > ch.VARIANT_KMAX:
        return None
    return fn(RESIDENCY[name][0], k)


def bound_ms(b: int, k: int, grams: int = 1, c: int = 0, nnz: int = 0):
    """(ms, "bytes" or "operations") of b solves of order k: each gram's
    lower triangle, rhs, reg and x moved once (with a hot block of width
    c, its (b, c) bf16 slab and (c, k) rows too) over 3.35 TB/s, or k³/3
    + 2k² flops a system, the second gram's sum and k (k + 1) + 2k flops
    an observed hot entry (``nnz`` of them) over 67 TFLOP/s."""
    tri = k * (k + 1) / 2
    t_bytes = (4.0 * b * (grams * tri + 2 * k + 1) + 2.0 * b * c
               + 4.0 * c * k) / PEAK_BYTES_PER_S
    t_ops = (b * (k ** 3 / 3.0 + 2.0 * k * k + (grams - 1) * tri)
             + (k * (k + 1) + 2.0 * k) * nnz) / PEAK_F32_FLOPS
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def systems(k: int, b: int, dev):
    if k == 128:
        from recommendation_models_tpu_torch.probes.solve_variants import (
            make_systems)
        G, rhs = make_systems(k, b, dev)
        return G, rhs, torch.full((b,), 0.05, device=dev)
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(0)
    return random_systems(b, k, 48, gen, dev)


def device_ms(fn, reps):
    """Device ms per call of ``fn`` over ``reps`` calls (``device_rows``
    summed), or None where the profiler did not record every call: it drops
    the events of some calls milliseconds long, and a kernel counted fewer
    than ``reps`` times, or not a whole number of times a call, would
    under-read."""
    try:
        rows = device_rows(fn, reps)
    except RuntimeError:
        return None
    if any(n < reps or n % reps for _, n, _ in rows):
        return None
    return sum(us for us, _, _ in rows) / 1e3 / reps


def library_device_ms(fn, reps):
    """The library call's device ms: ``device_ms`` over ``reps`` calls, or
    where the profiler dropped some of them, one call traced in its active
    step after a wait and a warm-up call (``step_rows``); None if neither
    recorded device time."""
    ms = device_ms(fn, reps)
    if ms is None:
        rows = step_rows(fn)
        ms = sum(us for us, _, _ in rows) / 1e3 if rows else None
    return ms


def agrees(x, ref):
    err = (x - ref).abs()
    scale = max(float(ref.abs().max()), 1.0)
    return float(err.max()), bool(torch.isfinite(x).all()) and bool(
        (err <= 5e-4 * scale + 5e-4 * ref.abs()).all())


def libraries(G, rhs, reg, full, ch):
    """The library solve of each B1-B3 function on the shape's systems:
    kind (None, "hot", "hot_implicit" or "2g") -> call."""
    eye = torch.eye(G.shape[1], device=G.device)

    def solve(A, r):
        return torch.cholesky_solve(r[:, :, None], torch.linalg.cholesky(
            A + reg[:, None, None] * eye))

    def hot(alpha):
        def call():
            Gf, rf = ch.fold_hot(G, rhs, full["hv"], full["vh"], alpha)
            return solve(Gf, rf)
        return call
    return {None: lambda: solve(G, rhs), "hot": hot(None),
            "hot_implicit": hot(HOT_ALPHA),
            "2g": lambda: solve(G + full["G2"], rhs)}


def regime_row(ch, name, b, k, full):
    """B1-B3's fields of a row: ``regime`` (the kernel the checkout's rule,
    or the forced regime, takes), ``resident`` and ``blocks_by_smem``."""
    base = base_name(name)
    wrapper, fused = REGIME[base]
    c = int(full["hv"].shape[1]) if fused == "hot" else 0
    lat, resident = ch.solve_regime(wrapper, b, k, c)
    rule = getattr(ch, "solve_frame", None)
    if name.endswith("_lat") and name in FORCED:
        regime = "latency"
    elif name.endswith("_panel") and name in FORCED:
        regime = "panel" if (k + 3) // 4 * 4 > 128 else "throughput"
    elif rule is None:
        regime = "latency" if lat and not name.endswith("_tp") \
            else "throughput"
    else:
        # forced off the latency kernel: the kernel of a batch past its wave
        regime = rule(wrapper, max(b, resident + 1) if name.endswith("_tp")
                      else b, k, resident)
    if regime == "panel":
        size = getattr(ch, "panel_smem_bytes", None)
        smem = size(k, fused, c) if size else None
    else:
        smem = ch.hot_smem_bytes(k, c, latency=regime == "latency")
    return dict(regime=regime, resident=resident, smem_bytes=smem,
                blocks_by_smem=(None if smem is None else
                                SM_SMEM // (smem + BLOCK_RESERVED)))


def run(shapes, names, plain=False, save=None, against=None):
    from recommendation_models_tpu_torch.ops import cholesky as ch
    dev = torch.device("cuda")
    rows = []
    for k, b in shapes:
        G, rhs, reg = systems(k, b, dev)
        # B2's and B3's additions, where the shape takes them
        fused = k <= ch.KMAX and any(
            REGIME.get(base_name(n), (0, None))[1] for n in names)
        full = fused_inputs(b, k, dev) if fused else {}

        def extra(Gx):
            n = Gx.shape[0]
            return dict(G2=full["G2"][:n], hv=full["hv"][:n], vh=full["vh"])
        table = kernels(ch, extra)
        lib_calls = libraries(G, rhs, reg, full, ch) if fused else {}
        if not fused:
            eye = torch.eye(k, device=dev)
            lib_calls[None] = lambda: torch.cholesky_solve(
                rhs[:, :, None], torch.linalg.cholesky(
                    G + reg[:, None, None] * eye))
        reps = 200 if b <= 1024 else 10 if k <= 64 else 3
        lib_reps = max(2, reps // 4)
        lib = {}
        n = min(b, N_CHECK)
        Gc, rc, gc = G[:n].contiguous(), rhs[:n].contiguous(), reg[:n]
        for name in names:
            if name.startswith("schur") and k % 16:
                continue
            base = base_name(name)
            kind = REGIME.get(base, (None, None))[1]
            if kind and not fused:
                continue
            if name.endswith("_panel") and name in FORCED and "panel" not in \
                    getattr(ch, "FORCED_FRAMES", ()):
                continue
            lib_kind = base if kind else None
            if lib_kind not in lib:
                lib[lib_kind] = (library_device_ms(lib_calls[lib_kind],
                                                   lib_reps),
                                 time_ms(lib_calls[lib_kind], lib_reps,
                                         warm=1))
            if kind == "hot":
                bms, by = bound_ms(b, k, c=full["hv"].shape[1],
                                   nnz=int((full["hv"] != 0).sum()))
            else:
                bms, by = bound_ms(b, k, grams=2 if kind == "2g" else 1)
            fn, pl = table[name]
            x = fn(G, rhs, reg)
            err, ok = agrees(x[:n], pl(Gc, rc, gc))
            same = saved(x, G, f"{name}_{k}_{b}", save, against)
            size = getattr(ch, "cluster_size", None)
            row = dict(kernel=name, k=k, batch=b,
                       cluster=(size(k, b) if size and k > ch.VARIANT_KMAX
                                else None),
                       blocks_per_sm=blocks_per_sm(ch, name, k),
                       frame=frame(ch, name, k),
                       device_ms=device_ms(lambda: fn(G, rhs, reg), reps),
                       event_ms=time_ms(lambda: fn(G, rhs, reg), reps,
                                        warm=1),
                       max_abs_err=err, agrees=ok, bitwise_equal=same,
                       bound_ms=bms,
                       bound_by=by, library_ms=lib[lib_kind][0],
                       library_event_ms=lib[lib_kind][1])
            if plain:
                row["plain_ms"] = time_ms(lambda: pl(G, rhs, reg), 1, warm=0)
            if base in REGIME and k <= ch.KMAX:
                row.update(regime_row(ch, name, b, k, full or dict(
                    hv=torch.empty(0, 0))))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del G, rhs, reg, full, table, lib_calls
        torch.cuda.empty_cache()
    return rows


def saved(x, G, tag, save, against):
    """With ``save``, write the solution (and a fingerprint of its inputs)
    to ``save/<tag>.pt``; with ``against``, whether the solution equals the
    one saved there bit for bit (None without it). The saved inputs'
    fingerprint must match, or the comparison is refused."""
    finger = torch.stack([G.sum(), G[-1].sum(), G[0, -1].sum()]).cpu()
    if save:
        os.makedirs(save, exist_ok=True)
        torch.save(dict(x=x.cpu(), finger=finger),
                   os.path.join(save, f"{tag}.pt"))
    if not against:
        return None
    ref = torch.load(os.path.join(against, f"{tag}.pt"))
    if not torch.equal(ref["finger"], finger):
        raise RuntimeError(f"{tag}: the saved run had other inputs")
    return bool(torch.equal(ref["x"], x.cpu()))


def resident_by_registers(regs: int, threads: int) -> int:
    """Blocks per SM that ``regs`` registers a thread allow (H100: 64 K
    registers in 256-register warp granules, 64 warps, 32 blocks)."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    return min(65536 // per_warp // warps, 64 // warps, 32)


def ptxas(source: str):
    """``parse_ptxas`` of ``nvcc -Xptxas -v`` on ``source``."""
    from recommendation_models_tpu_torch.ops import build
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           "/dev/null", source]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if log.returncode:
        raise RuntimeError(log.stderr[-4000:])
    return parse_ptxas(log.stderr)


def parse_ptxas(log: str):
    """Per kernel of a ``-Xptxas -v`` log: registers, spill bytes (stores,
    loads), static shared memory, and, where the mangled name's first
    template argument gives the thread count (``ILi<n>E``), the blocks per
    SM the registers allow. A kernel whose launch bound adds its
    substitution warps to that count (the rank/panel kernels: n + 32
    threads, the panel frame of the rank schedules past kp = 128, ``SCHED``
    64, too; n + 64 for the dual schedule to kp = 128, ``SCHED`` 32, its
    fourth template argument) is read so, and the one-block kernels
    (``cluster_solve_kernel<SCHED, SROWS, TWO_G>``, and the earlier
    ``variant_large_kernel<SCHED, SROWS>``), whose template arguments are
    their schedule, at their 256 threads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m2.group(1)) if m2 else 0
            # the int template arguments of the mangled name (Li160E...)
            t = re.search(r"ILi(\d+)E((?:Li\d+E)*)", cur["kernel"])
            if ("cluster_solve_kernel" in cur["kernel"]
                    or "variant_large_kernel" in cur["kernel"]):
                cur["threads"] = 256
            elif t:
                extra = 0
                if "rank_panel_kernel" in cur["kernel"]:
                    rest = re.findall(r"Li(\d+)E", t.group(2))
                    extra = 64 if rest[2:3] == ["32"] else 32
                cur["threads"] = int(t.group(1)) + extra
            if "threads" in cur:
                cur["resident_by_registers"] = resident_by_registers(
                    cur["registers"], cur["threads"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="64:65536,64:256,128:65536")
    ap.add_argument("--kernels", default="all")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain versions (slow)")
    ap.add_argument("--save", default=None,
                    help="directory to save each solution in")
    ap.add_argument("--against", default=None,
                    help="directory of a --save run to compare bitwise")
    ap.add_argument("--ptxas", default="",
                    help="comma list of CUDA sources to report")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variant_latency: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    for src in filter(None, args.ptxas.split(",")):
        for row in ptxas(src):
            print(json.dumps(dict(source=src, **row)), flush=True)
    names = ALL if args.kernels == "all" else args.kernels.split(",")
    unknown = [n for n in names if n not in KNOWN]
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: {KNOWN}")
    shapes = [tuple(int(v) for v in s.split(":"))
              for s in args.shapes.split(",")]
    rows = run(shapes, names, args.plain, args.save, args.against)
    return 0 if all(r["agrees"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
