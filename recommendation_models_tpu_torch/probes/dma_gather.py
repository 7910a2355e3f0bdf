"""Gather-rate probe: the port's row gather-and-sum kernel (P1) against the
library gathers.

    python -m recommendation_models_tpu_torch.probes.dma_gather \
        [--platform cpu]

The port of the reference's ``scripts/probe_dma_gather.py::main``. A
62,423 x 128 f32 table and 200,000 uniform ids are drawn from numpy's
``default_rng(0)`` in the reference's order. For slots 4, 8 and 16 the
kernel (``ops.gather.make_probe``, ``fn(idx, table)``) sums the gathered
rows, and a line gives the rate, the time and the checksum, as the
reference prints them. The reference's last line quoted a TPU figure; here
two library lines are measured on the same inputs instead:
``torch.nn.functional.embedding_bag(mode="sum")``, one PyTorch call that
computes the same function, and ``index_select`` + ``sum``, the gram's own
gather. The port calls neither on its path.

On the card each time is the mean of 10 calls between CUDA events after
one warm-up call. Every result is held against the plain version
(``ops.gather.gather_rows_sum_plain``) per column within
``2e-6 · Σ_i |table[idx_i, j]| + 1e-6``; the run returns 1 above it.
Runs on the CUDA card, and raises when there is none, unless
``--platform cpu`` is given; on the CPU the wrapper takes the plain version
and nothing is timed. ``main(argv, n_table=, k=, n_gather=)`` takes another
shape.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops.gather import (
    gather_rows_sum_plain, make_probe, sum_tolerance)
from recommendation_models_tpu_torch.probes import time_ms

N_TABLE, K, N_GATHER = 62_423, 128, 200_000   # the reference's shape
SLOTS = (4, 8, 16)
ITERS = 10


def make_inputs(n_table: int, k: int, n_gather: int, device: torch.device):
    """(table (n_table, k) f32, idx (n_gather,) int32) from
    ``default_rng(0)``, in the reference's order."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n_table, k)).astype(np.float32)
    idx = rng.integers(0, n_table, n_gather).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def main(argv=None, n_table: int = N_TABLE, k: int = K,
         n_gather: int = N_GATHER) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.platform)
    timed = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if timed else "cpu"
    table, idx = make_inputs(n_table, k, n_gather, device)
    print(f"# table ({n_table}, {k}) f32, {n_gather} ids, device={kind}",
          flush=True)
    ref = gather_rows_sum_plain(table, idx)
    tol = sum_tolerance(table, idx)

    def report(label, fn):
        out = fn()
        err = float((out - ref).abs().max()) if n_gather else 0.0
        ok = bool(((out - ref).abs() <= tol).all())
        if timed:
            ms = time_ms(fn, ITERS, warm=1)
            print(f"{label}: {n_gather / ms / 1e3:8.2f} M rows/s "
                  f"({ms:.4f} ms for {n_gather} rows)  checksum "
                  f"{float(out.sum()):.3f}  max_abs_err={err:.2e}", flush=True)
        else:
            print(f"{label}: (cpu, untimed)  checksum {float(out.sum()):.3f}"
                  f"  max_abs_err={err:.2e}", flush=True)
        if not ok:
            print(f"!! {label}: disagrees with the plain version", flush=True)
        return ok

    ok = True
    for slots in SLOTS:
        fn = make_probe(n_table, k, n_gather, slots=slots)
        ok &= report(f"slots={slots:3d}", lambda: fn(idx, table))
    offsets = torch.zeros(1, dtype=idx.dtype, device=device)
    ok &= report("embedding_bag sum (library)", lambda: F.embedding_bag(
        idx, table, offsets, mode="sum"))
    ok &= report("index_select + sum (library)",
                 lambda: gather_rows_sum_plain(table, idx))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
