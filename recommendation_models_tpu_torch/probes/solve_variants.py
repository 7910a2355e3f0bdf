"""Isolated batched-solve probe: time the port's Cholesky solve variants.

    python -m recommendation_models_tpu_torch.probes.solve_variants \
        [--platform cpu]

The port's counterpart of the reference's ``scripts/probe_solve_variants.py``.
Every variant of the table solves the same systems, made from numpy's
``default_rng(0)`` as the reference makes them, through
``ops.cholesky.cholesky_solve_variant`` (batch-major, so a time is the
kernel's and not a layout transpose's). Each solution is checked on the
first 4,096 systems against the library solve (``torch.linalg.cholesky``
and ``cholesky_solve``, the port's 'xla' anchor): the run fails above a
relative error of 5e-2. On the card each variant is timed as the mean of
``PSV_ITERS`` calls between CUDA events; the solutions are compared bitwise
with the first variant's, and the ``schur/pair`` time ratio is printed.
Beside each variant's time stand its kernel launches and the calls routed
to the torch anchor (``ops.cholesky.LAUNCHES`` and ``ROUTED``, read around
its checked call), and the run ends with the whole ``ROUTED`` count.

Env: PSV_K (default 128; the kernels take any order to 656, one block a
system past 160), PSV_B (65536 to k = 160, past it the reference's
one-block batch ``block_batch(k)``: a larger batch is routed, as the
reference sends it to XLA), PSV_ITERS (10), PSV_VARIANTS (comma list of the
table's names; default pair,schur). PSV_BT, the TPU kernel's batch block,
has no counterpart here and is refused.

Runs on the CUDA card, and raises when there is none, unless
``--platform cpu`` is given; on the CPU the wrappers take the kernels' plain
versions and nothing is timed. A variant that raises ends the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops import cholesky as ch
from recommendation_models_tpu_torch.ops.cholesky import (
    anchor_solve, cholesky_solve_variant)
from recommendation_models_tpu_torch.probes import time_ms

VARIANT_KW = {
    "rank1": dict(panel=False, pair=False, subs2=False),   # the r1 baseline
    "pair": dict(panel=False, pair=True),
    "panel": dict(panel=True),
    "schur": dict(panel=False, schur=True),
    # subs2=False ablations (rank-1 substitutions)
    "pair_s1": dict(panel=False, pair=True, subs2=False),
    "schur_s1": dict(panel=False, schur=True, subs2=False),
    # dual-chain interleave (two systems per thread block, their rank-2
    # chains interleaved)
    "dual": dict(panel=False, dual=True),
}
N_REF = 4096
MAX_REL_ERR = 5e-2


def make_systems(k: int, b: int, device: torch.device, chunk: int = 4096):
    """G = m mᵀ + 0.1 I for m = N(0, 1/k) (b, k, k), and rhs N(0, 1) (b, k),
    drawn from ``default_rng(0)`` in the reference's order; m is drawn in
    chunks of ``chunk`` systems and multiplied on ``device``."""
    rng = np.random.default_rng(0)
    G = torch.empty((b, k, k), dtype=torch.float32, device=device)
    eye = 0.1 * torch.eye(k, dtype=torch.float32, device=device)
    for s in range(0, b, chunk):
        n = min(chunk, b - s)
        m = torch.from_numpy(
            rng.standard_normal((n, k, k)).astype(np.float32)).to(device)
        m = m / float(np.sqrt(k))
        torch.bmm(m, m.transpose(1, 2), out=G[s:s + n])
        G[s:s + n] += eye
    rhs = torch.from_numpy(
        rng.standard_normal((b, k)).astype(np.float32)).to(device)
    return G, rhs


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    if env.get("PSV_BT"):
        raise SystemExit(
            "PSV_BT sets the TPU kernel's batch block; the CUDA kernels "
            "solve one system per thread block on a persistent grid and "
            "have no such block. Unset PSV_BT.")
    k = int(env.get("PSV_K", "128"))
    b = int(env.get("PSV_B", "65536" if k <= ch.KMAX
                    else str(ch.block_batch(k))))
    iters = int(env.get("PSV_ITERS", "10"))
    variants = env.get("PSV_VARIANTS", "pair,schur").split(",")
    unknown = [v for v in variants if v not in VARIANT_KW]
    if unknown:
        raise SystemExit(f"unknown PSV_VARIANTS {unknown}; the table has "
                         f"{sorted(VARIANT_KW)}")
    device = resolve_device(args.platform)
    timed = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if timed else "cpu"
    print(f"# k={k} B={b} iters={iters} device={kind}", flush=True)

    G, rhs = make_systems(k, b, device)
    reg = torch.full((b,), 0.05, dtype=torch.float32, device=device)
    nref = min(b, N_REF)
    xref = anchor_solve(G[:nref], rhs[:nref], reg[:nref])
    denom = xref.abs().clamp_min(1e-3)

    results, sols = {}, {}
    routed0 = dict(ch.ROUTED)
    for v in variants:
        kw = VARIANT_KW[v]
        launched, routed = sum(ch.LAUNCHES.values()), sum(ch.ROUTED.values())
        x = cholesky_solve_variant(G, rhs, reg, **kw)
        counts = (f"launches={sum(ch.LAUNCHES.values()) - launched} "
                  f"routed={sum(ch.ROUTED.values()) - routed}")
        sols[v] = x
        err = float(((x[:nref] - xref).abs() / denom).max())
        if not bool(torch.isfinite(x).all()):
            err = float("inf")
        if timed:
            ms = time_ms(lambda: cholesky_solve_variant(G, rhs, reg, **kw),
                         iters)
            results[v] = ms
            print(f"{v:8s} {ms:9.3f} ms  {b / ms / 1e3:7.2f} Msys/s  "
                  f"max_rel_err={err:.2e}  {counts}", flush=True)
        else:
            print(f"{v:8s} (cpu, untimed)  max_rel_err={err:.2e}  {counts}",
                  flush=True)
        if not err <= MAX_REL_ERR:
            print(f"!! {v}: correctness FAILURE", flush=True)
            return 1
    names = list(sols)
    for other in names[1:]:
        same = torch.equal(sols[names[0]], sols[other])
        print(f"# bitwise {names[0]} == {other}: {same}")
    if "pair" in results and "schur" in results:
        print(f"# schur/pair = {results['schur'] / results['pair']:.3f}")
    routed = {n: c - routed0[n] for n, c in ch.ROUTED.items()}
    print(f"# ROUTED {json.dumps(routed)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
