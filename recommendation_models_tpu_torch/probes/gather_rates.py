"""Row-gather rates on the card: the port of the reference's
``scripts/ablate_gather.py``.

    python -m recommendation_models_tpu_torch.probes.gather_rates \
        [--platform cpu]

The reference dissected the TPU's gather rate at the narrow-bucket gram's
shapes: a (162,541, 64) table and (14,592, 56) = 817,152 uniform ids, drawn
from numpy's ``default_rng(0)`` in its order. The same lines, with torch
ops on the card:

- materialized gathers (``index_select`` to (B, P, 64)) from the bf16 and
  the f32 table, with uniform, iota (the locality ceiling) and row-sorted
  ids;
- the summed gather: ``index_select`` then ``sum``, and
  ``embedding_bag(mode="sum")``, which sums without materializing;
- H1, two gathered rows paired into one 128-wide row (a view in torch);
- H4, the gram at k=64 and as a 128-wide paired gram (two observations
  per slot, the two diagonal 64 x 64 blocks kept), both with the port's
  f32 products (``ops/gram.py``: bf16 inputs upcast, no TF32);
- P1, the port's gather-and-sum kernel (``ops.gather.gather_rows_sum``,
  8 slots) on the f32 table and the same ids, held against its plain
  version (the run returns 1 if they disagree).

Each line is the mean device time of ``GAB_ITERS`` calls between CUDA
events after one warm-up call, with the rate in gathered rows per second.
The reference's scan with a carry perturbation kept XLA from hoisting
loop-invariant work; eager torch hoists nothing.

Env (the reference's): GAB_TABLE (162541), GAB_B (14592), GAB_P (56),
GAB_K (64), GAB_ITERS (10). Runs on the CUDA card, and raises when there is
none, unless ``--platform cpu`` is given; on the CPU every line runs once,
untimed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from recommendation_models_tpu_torch.device import resolve_device
from recommendation_models_tpu_torch.ops.gather import (
    gather_rows_sum, gather_rows_sum_plain, sum_tolerance)
from recommendation_models_tpu_torch.ops.gram import full_f32
from recommendation_models_tpu_torch.probes import timed


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    T = int(env.get("GAB_TABLE", 162_541))
    B = int(env.get("GAB_B", 14_592))
    P = int(env.get("GAB_P", 56))
    K = int(env.get("GAB_K", 64))
    iters = int(env.get("GAB_ITERS", 10))
    dev = resolve_device(args.platform)
    full_f32()

    rng = np.random.default_rng(0)
    Vf = torch.from_numpy(
        rng.standard_normal((T, K)).astype(np.float32)).to(dev)
    Vb = Vf.to(torch.bfloat16)
    idx_np = rng.integers(0, T, (B, P)).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    idx_seq = torch.from_numpy(
        (np.arange(B * P, dtype=np.int64) % T).astype(np.int32)
        .reshape(B, P)).to(dev)
    idx_sorted = torch.from_numpy(np.sort(idx_np, axis=1)).to(dev)
    wg = torch.from_numpy(
        rng.uniform(0.5, 1, (B, P)).astype(np.float32)).to(dev)
    rows = B * P
    flat = idx.reshape(-1)
    offsets = torch.zeros(1, dtype=torch.int32, device=dev)
    q = P // 2

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# table ({T},{K}), idx ({B},{P}) = {rows:,} rows, {iters} iters, "
          f"device={kind}", flush=True)

    def take(v, i):
        return v.index_select(0, i.reshape(-1)).view(*i.shape, K)

    def line(label, fn):
        timed(fn, iters, dev, label, rows=rows, width=52)

    # --- raw gather rates ------------------------------------------------
    line("take bf16 -> (B,P,64) materialized", lambda: take(Vb, idx))
    line("take f32  -> (B,P,64) materialized", lambda: take(Vf, idx))
    line("take bf16, iota idx (locality ceiling)", lambda: take(Vb, idx_seq))
    line("take bf16, row-sorted idx", lambda: take(Vb, idx_sorted))
    line("take bf16 + sum (materialized, then summed)",
         lambda: take(Vb, idx).sum((0, 1)))
    line("embedding_bag bf16 sum (no materialization)",
         lambda: F.embedding_bag(flat, Vb, offsets, mode="sum"))

    # --- H1: pair two gathered rows into 128-wide rows --------------------
    line("take bf16 -> reshape (B,P/2,128)",
         lambda: take(Vb, idx[:, :2 * q]).reshape(B, q, 2 * K))

    # --- H4: gram shapes at equal useful work -----------------------------
    def gram64(v, i, w):
        vg = take(v, i)
        vw = vg * w[..., None].to(vg.dtype)
        return torch.bmm(vw.float().transpose(1, 2), vg.float())

    def gram128_pair(v, i, w):
        vg = take(v, i[:, :2 * q]).reshape(B, q, 2 * K)
        vw = vg * w[:, :2 * q].reshape(B, q, 2, 1).expand(
            B, q, 2, K).reshape(B, q, 2 * K).to(vg.dtype)
        g = torch.bmm(vw.float().transpose(1, 2), vg.float())
        return g[:, :K, :K] + g[:, K:, K:]

    line("gram k=64 (f32 products)", lambda: gram64(Vb, idx, wg))
    line("gram 128-pair (2 obs/slot, f32 products)",
         lambda: gram128_pair(Vb, idx, wg))

    # --- P1: the port's gather-and-sum kernel -----------------------------
    out = gather_rows_sum(Vf, flat)
    err = (out - gather_rows_sum_plain(Vf, flat)).abs()
    ok = bool((err <= sum_tolerance(Vf, flat)).all())
    line("P1 gather_rows_sum f32, slots=8 (no materialization)",
         lambda: gather_rows_sum(Vf, flat))
    print(f"# P1 against its plain version: max_abs_err="
          f"{float(err.max()):.2e} {'ok' if ok else 'DISAGREES'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
