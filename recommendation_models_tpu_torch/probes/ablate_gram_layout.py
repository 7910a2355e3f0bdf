"""The gram's two output layouts over one side's gathered buckets: the
batch-minor ``gram_rhs_t`` against the batch-major ``gram_rhs``.

    python -m recommendation_models_tpu_torch.probes.ablate_gram_layout \
        [--platform cpu]

The port's counterpart of the JAX package's ``scripts/ablate_gram_layout.py``.
There the question was a relayout tax: XLA copied each gathered
(bb, P, k) block before the klb gram product. Its two variants here, each
the sum of every gram and rhs over every gathered bucket of the
``ABL_SIDE`` layout, split in row blocks as the sweep splits them
(``probes.ablate_epoch.row_blocks``, the counterpart of the script's
``_blocks``), the inputs in bf16 as in the script:

- "klb (current)": ``ops.gram.gram_rhs_t``, the reference's kernel layout
  (k, k, B) and (k, B);
- "bkl (batch-major)": ``ops.gram.gram_rhs``, (B, k, k) and (B, k), the
  script's ``bpk,bpl->bkl`` form.

The port accumulates batch-major either way and ``gram_rhs_t`` returns
transposed views (its ``init=`` path copies the starting accumulators in;
the sweep calls ``gram_rhs``). So the card's question is whether the
klb variant copies: besides each variant's time (``probes.timed``: mean
device ms over ``ABL_ITERS`` calls between CUDA events after a warm-up
call), the probe profiles one pass of each and reports its ``aten::copy_``
calls and their device ms (host self ms with ``--platform cpu``).

The layout is the script's: ``layout_from_coo`` with the default
``DataConfig`` (``probes.profile_half.side_layout``, cached as
``<ABL_CACHE_DIR>/<scale>_<side>.npz``), the opposite table 0.01 N(0, 1)
from ``default_rng(0)``, ``SolveConfig(rank, reg=0.1, solver="auto",
compute_dtype="auto")``. ``run(layout, ...)`` takes a layout the caller
built. With ``--platform cpu`` every line runs once, untimed, and
``ABL_SCALE`` defaults to ``tiny``.

Env (the script's): ABL_SCALE (ml25m), ABL_RANK (64), ABL_ITERS (5),
ABL_SIDE (user), ABL_CACHE_DIR (``build/layout_cache`` at the checkout's
root).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from recommendation_models_tpu_torch.probes import (
    LAYOUT_CACHE_DIR, SCALES, timed)


def gram_sum(v, bs, cfg, rank: int, batch_minor: bool):
    """Σ (G.sum() + rhs.sum()) over every row block of the gathered buckets
    ``bs``, through ``gram_rhs_t`` (``batch_minor``) or ``gram_rhs``, bf16
    inputs."""
    from recommendation_models_tpu_torch.ops.gram import (
        gram_rhs, gram_rhs_t, objective_weights)
    from recommendation_models_tpu_torch.probes.ablate_epoch import (
        row_blocks)
    from recommendation_models_tpu_torch.solver.als_sweep import widen_chunk
    fn = gram_rhs_t if batch_minor else gram_rhs
    acc = torch.zeros((), dtype=torch.float32, device=v.device)
    for b, s, e in row_blocks(bs, cfg, rank):
        bsz, p = b["indices"].shape
        wg, wr = objective_weights(b["values"][s:e], b["mask"][s:e], None)
        G, r = fn(v, b["indices"][s:e], wg, wr,
                  chunk=widen_chunk(cfg.chunk, bsz, p),
                  compute_dtype=torch.bfloat16)
        acc = acc + G.sum() + r.sum()
    return acc


def copies(fn, device) -> dict:
    """The ``aten::copy_`` calls of one profiled call of ``fn`` (after a
    warm one, ``probes.profile_half.profiled``) and their device ms (host
    self ms on the CPU)."""
    from recommendation_models_tpu_torch.probes.profile_half import profiled
    on_card = device.type == "cuda"
    prof, _ = profiled(fn, device, host_ops=True)
    calls, ms = 0, 0.0
    for ev in prof.key_averages():
        if ev.key == "aten::copy_":
            calls += ev.count
            ms += (ev.device_time_total if on_card
                   else ev.self_cpu_time_total) / 1e3
    return {"copy_calls": calls, "copy_ms": ms,
            "copy_unit": "device" if on_card else "host self"}


def run(layout, side: str, n_opp: int, rank: int = 64, n_iters: int = 5,
        device=None) -> dict:
    """Both variants on ``layout``: {variant: {"ms", "sum", copies}} (ms
    None on the CPU)."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.ops.gram import full_f32
    from recommendation_models_tpu_torch.probes.profile_half import (
        opposite_table)
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    dev = resolve_device(device)
    if dev.type == "cuda":
        full_f32()
    cfg = SolveConfig(rank=rank, reg=0.1, solver="auto",
                      compute_dtype="auto")
    bs = device_buckets(layout, block_batch(rank), dev)
    T = opposite_table(n_opp, rank, dev)
    out = {"side": side, "rank": rank, "n_rows": layout.n_rows,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    for key, label, minor in (("klb", "gram klb (current)", True),
                              ("bkl", "gram bkl (batch-major)", False)):
        def fn():
            return gram_sum(T, bs, cfg, rank, minor)
        ms = timed(fn, n_iters, dev, f"{side} {label}")
        c = copies(fn, dev)
        total = float(fn().item())
        print(f"#   {side} {key}: aten::copy_ {c['copy_calls']} calls, "
              f"{c['copy_ms']:.3f} ms ({c['copy_unit']}); sum {total:.6e}",
              flush=True)
        out[key] = {"ms": ms, "sum": total, **c}
    return out


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.probes.profile_half import (
        side_layout)
    dev = resolve_device(args.platform)
    scale = env.get("ABL_SCALE", "ml25m" if dev.type == "cuda" else "tiny")
    rank = int(env.get("ABL_RANK", "64"))
    n_iters = int(env.get("ABL_ITERS", "5"))
    side = env.get("ABL_SIDE", "user")
    n_users, n_items, _ = SCALES[scale]
    layout = side_layout(scale, side,
                         env.get("ABL_CACHE_DIR", str(LAYOUT_CACHE_DIR)))
    rec = run(layout, side, n_items if side == "user" else n_users, rank,
              n_iters, dev)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
