"""Latency probe of the main path's two solve kernels: device time and host
cost per call, at the batches the main path launches them with.

    python -m recommendation_models_tpu_torch.probes.solve_latency \
        [--batches 256,4201,65536] [--k 64] [--hot-cols 128] [--regimes]
    python -m recommendation_models_tpu_torch.probes.solve_latency \
        --k 656 --batches 1,8 [--cluster 16]

For B1 ``cholesky_solve_batched`` and B2 ``cholesky_solve_hot`` (a random
bf16 hot slab, 28% nonzero as the ML-25M main path's) at each batch, one
JSON line with:

- ``regime``: the kernel that the checkout's rule picks at this batch
  (``solve_frame``: "latency", "throughput" or, for B1 past kp = 128,
  "panel"; ``latency_regime`` in a checkout without it), and
  ``resident``, the latency kernel's resident blocks it is picked against;
- ``device_ms``: device time per call from ``torch.profiler`` (every device
  kernel of the window summed, over ``reps`` calls), so that the host's
  gaps between calls do not count;
- ``event_ms``: CUDA events around the same back-to-back calls (host gaps
  count whenever the host enqueues slower than the device runs);
- ``host_us``: host wall time per call over at least 200 calls with no
  synchronisation inside (the wrapper, its checks and the launch);
- ``library_ms``: device time per call, from the profiler, of
  ``torch.linalg.cholesky`` + ``cholesky_solve`` on the same systems (B2:
  after the torch fold of the hot terms);
- ``max_abs_err``: the kernel against its plain version on the first
  ``min(B, 4096)`` systems;
- with ``--regimes``, ``latency_device_ms`` and ``throughput_device_ms``:
  the device time of each regime's kernel at this batch (``forced_regime``;
  for B1 past kp = 128 the second is the panel frame's),
  both checked against the plain version, to place the crossover.

Past k = 160 (``--k 168`` to ``656``) the batch wrappers take the
one-block kernel (``cholesky_solve_large``): the probe then times
``cholesky_solve_batched`` at each batch and ``cholesky_solve_2g`` at each
batch of at most ``two_operand_block(k)``, on grams of 3k/4 random factor
rows, one JSON line each with ``kernel`` ``cholesky_solve_large`` and
``grams`` 1 or 2, ``event_ms``, ``device_ms`` (null where the profiler
did not record every call), ``host_us``, ``library_ms`` and
``library_event_ms`` (the library solve, read both ways), ``max_abs_err``
against the plain version, ``bound_ms`` and, where the checkout's
``ops.cholesky`` has ``cluster_size``, the ``cluster`` the launch took
(thread blocks a system). ``--cluster C`` times those launches at C
CTAs a system instead of the rule's (``ops.cholesky.forced_cluster``),
to compare cluster sizes. The hot kernel is routed to the torch fold at
those orders and is not timed.

The probe imports only ``ops.cholesky``'s public wrappers and this
package's timers, so the same file measures another checkout's kernels
(one that has them) when that checkout is first on ``PYTHONPATH``. Runs
only on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from recommendation_models_tpu_torch.probes import (
    device_rows, host_us, profiled_ms, time_ms)

N_CHECK = 4096
HOT_DENSITY = 0.28      # nonzero share of the ML-25M main path's hot slab


def random_systems(b: int, k: int, degree: int, gen, dev):
    """Grams of ``degree`` random factor rows a system (rank-deficient when
    degree < k, as ALS rows are), rhs N(0, 1) and a 0.1 ridge."""
    X = 0.3 * torch.randn(b, degree, k, generator=gen, device=dev)
    G = torch.bmm(X.transpose(1, 2), X).contiguous()
    rhs = torch.randn(b, k, generator=gen, device=dev)
    return G, rhs, torch.full((b,), 0.1, device=dev)


def hot_slab(b: int, c: int, gen, dev) -> torch.Tensor:
    """(b, c) bf16 half-star ratings, ``HOT_DENSITY`` of them nonzero."""
    keep = torch.rand(b, c, generator=gen, device=dev) < HOT_DENSITY
    stars = torch.randint(1, 11, (b, c), generator=gen, device=dev) * 0.5
    return torch.where(keep, stars, 0.0).to(torch.bfloat16)


def reps_for(b: int) -> int:
    return 200 if b <= 1024 else 50 if b <= 8192 else 10


def agrees(x, ref):
    """(max abs error, within 5e-4 scale + 5e-4 |ref|?) of x against ref."""
    err = (x - ref).abs()
    scale = max(float(ref.abs().max()), 1.0)
    return float(err.max()), bool(torch.isfinite(x).all()) and bool(
        (err <= 5e-4 * scale + 5e-4 * ref.abs()).all())


def measure(name, fn, plain, library, b, k, c=0, regimes=False):
    """One kernel at one batch: the numbers of the module docstring."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    n = min(b, N_CHECK)
    ref = plain(n)
    err, ok = agrees(fn()[:n], ref)
    reps = reps_for(b)
    rows = device_rows(fn, reps)
    lat, resident = ch.solve_regime(name, b, k, c)
    frame = getattr(ch, "solve_frame", None)
    row = dict(kernel=name, batch=b,
               regime=(frame(name, b, k, resident) if frame
                       else "latency" if lat else "throughput"),
               resident=resident,
               device_ms=sum(r[0] for r in rows) / 1e3 / reps,
               event_ms=time_ms(fn, reps, warm=1), host_us=host_us(fn),
               library_ms=profiled_ms(library, max(2, reps // 4)),
               max_abs_err=err, agrees=ok,
               device_kernels=sorted(r[2] for r in rows))
    if regimes:
        for tag, forced in (("latency", True), ("throughput", False)):
            with ch.forced_regime(forced):
                e, o = agrees(fn()[:n], ref)
                row[f"{tag}_device_ms"] = profiled_ms(fn, reps)
            row["max_abs_err"] = max(row["max_abs_err"], e)
            row["agrees"] = row["agrees"] and o
    return row


def one_block_bound(b: int, k: int, grams: int = 1):
    """(ms, "bytes" or "operations"): the least time of b solves of order k
    on an H100, each gram's lower triangle, rhs, reg and x moved once over
    3.35 TB/s, or k³/3 + 2k² flops a system (and the second gram's sum)
    over 67 TFLOP/s f32, whichever is longer."""
    tri = k * (k + 1) / 2
    t_bytes = 4.0 * b * (grams * tri + 2 * k + 1) / 3.35e12
    t_ops = b * (k ** 3 / 3.0 + 2.0 * k * k + (grams - 1) * tri) / 67e12
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def one_block_rows(batches, k: int, seed: int = 0, cluster: int = None):
    """The one-block kernel's rows past k = 160 (the module docstring)."""
    import contextlib
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.variant_latency import (
        device_ms)
    forced = (ch.forced_cluster(cluster) if cluster
              else contextlib.nullcontext())
    with forced:
        return _one_block_rows(ch, device_ms, batches, k, seed, cluster)


def _one_block_rows(ch, device_ms, batches, k, seed, cluster):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    eye = torch.eye(k, device=dev)
    rows = []
    for b in batches:
        G, rhs, reg = random_systems(b, k, 3 * k // 4, gen, dev)
        G2 = random_systems(b, k, 16, gen, dev)[0]
        cases = [(1, ch.cholesky_solve_batched, ch.cholesky_solve_plain,
                  (G, rhs, reg), G)]
        if b <= ch.two_operand_block(k):
            cases.append((2, ch.cholesky_solve_2g, ch.cholesky_solve_2g_plain,
                          (G, G2, rhs, reg), G + G2))
        for grams, fn, plain, args, A in cases:
            def library(A=A):
                return torch.cholesky_solve(rhs[:, :, None],
                                            torch.linalg.cholesky(
                                                A + reg[:, None, None] * eye))
            ch.reset_counts()
            x = fn(*args)
            launched = ch.LAUNCHES["cholesky_solve_large"] == 1
            err, ok = agrees(x, plain(*args))
            ok = ok and launched and torch.equal(x, fn(*args))
            bms, by = one_block_bound(b, k, grams)
            size = getattr(ch, "cluster_size", None)
            rows.append(dict(
                kernel="cholesky_solve_large", grams=grams, k=k, batch=b,
                cluster=cluster or (size(k, b) if size else None),
                event_ms=time_ms(lambda: fn(*args), 20, warm=2),
                device_ms=device_ms(lambda: fn(*args), 20),
                host_us=host_us(lambda: fn(*args)),
                library_ms=device_ms(library, 5),
                library_event_ms=time_ms(library, 5, warm=1),
                max_abs_err=err, agrees=ok, bound_ms=bms, bound_by=by))
        del G, G2, rhs, reg
        torch.cuda.empty_cache()
    return rows


def run(batches, k: int = 64, c: int = 128, seed: int = 0, regimes=False,
        cluster: int = None):
    """The rows of the probe, one per kernel and batch."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    if k > ch.KMAX:
        return one_block_rows(batches, k, seed, cluster)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    eye = torch.eye(k, device=dev)
    rows = []
    for b in batches:
        G, rhs, reg = random_systems(b, k, 48, gen, dev)
        rows.append(measure(
            "cholesky_solve_batched",
            lambda: ch.cholesky_solve_batched(G, rhs, reg),
            lambda n: ch.cholesky_solve_plain(G[:n], rhs[:n], reg[:n]),
            lambda: torch.cholesky_solve(
                rhs[:, :, None], torch.linalg.cholesky(
                    G + reg[:, None, None] * eye)), b, k, regimes=regimes))
        del G, rhs, reg
        G, rhs, reg = random_systems(b, k, 40, gen, dev)
        hv = hot_slab(b, c, gen, dev)
        vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)

        def library():
            G2, rhs2 = ch.fold_hot(G, rhs, hv, vh, None)
            return torch.cholesky_solve(
                rhs2[:, :, None], torch.linalg.cholesky(
                    G2 + reg[:, None, None] * eye))

        rows.append(measure(
            "cholesky_solve_hot",
            lambda: ch.cholesky_solve_hot(G, rhs, reg, hv, vh),
            lambda n: ch.cholesky_solve_hot_plain(
                G[:n], rhs[:n], reg[:n], hv[:n].contiguous(), vh),
            library, b, k, c, regimes=regimes))
        del G, rhs, reg, hv, vh
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="256,4201,65536")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--hot-cols", type=int, default=128)
    ap.add_argument("--regimes", action="store_true",
                    help="also time each regime's kernel at every batch")
    ap.add_argument("--cluster", type=int, default=None,
                    help="past k = 160: CTAs a system instead of the rule's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("solve_latency: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    batches = [int(x) for x in args.batches.split(",")]
    ok = True
    for row in run(batches, args.k, args.hot_cols, regimes=args.regimes,
                   cluster=args.cluster):
        print(json.dumps(row), flush=True)
        ok = ok and row["agrees"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
