"""One half-sweep's device time by kernel and by stream.

    python -m recommendation_models_tpu_torch.probes.profile_half \
        [user|item] [--platform cpu]

The port's counterpart of the JAX package's ``scripts/profile_half.py``.
On one side's layout of the synthetic ratings of ``ABL_SCALE``
(``layout_from_coo`` with the default ``DataConfig``, the script's build;
cached by ``data/layout_cache.py`` as ``<ABL_CACHE_DIR>/<scale>_<side>.npz``,
the script's name) and a 0.01 N(0, 1) opposite table from
``default_rng(0)``, it runs one warm ``solver.als_sweep.half_sweep``
(``SolveConfig(rank, reg=0.1, solver="auto", compute_dtype="auto")``),
then one under ``torch.profiler`` with CUDA activity, exports the Chrome
trace into ``PROF_DIR`` and prints, in place of the script's xplane parse,
the device ms of each stream and, under it, of each kernel name (top 40),
with the regime solve a kernel belongs to (``probes.epoch_profile.
solve_kernel``).

``torch.profiler`` drops events (a rank-160 sweep once read 220.2 against
347.3 device ms). So the table's sum is printed beside a CUDA-event time
of the same half-sweep (``probes.time_ms``), and the table is flagged where
the two differ by more than 10%. The event time also counts the device's
idle gaps while the host enqueues, so a flag says "profiler drop or idle
device"; the solve launches the table recorded against those the wrappers
counted (``ops.cholesky.LAUNCHES``) tell the first apart.

With ``--platform cpu`` the half-sweep runs on the host under a
CPU-activity profile, and the table holds the host operators' self time by
thread (no device number; ``ABL_SCALE`` defaults to ``tiny``).

Env (the script's): ABL_SCALE (ml25m), ABL_RANK (64), ABL_CACHE_DIR
(``build/layout_cache`` at the checkout's root), PROF_DIR
(``build/profile_half``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import (
    LAYOUT_CACHE_DIR, SCALES, time_ms)
from recommendation_models_tpu_torch.probes.epoch_profile import solve_kernel

PROF_DIR = Path(__file__).resolve().parents[2] / "build" / "profile_half"
TOP = 40
FLAG_SHARE = 0.10


def side_layout(scale: str, side: str, cache_dir, coo=None):
    """The script's layout of ``side`` ('user' or 'item') at ``scale``:
    ``layout_from_coo`` with the default ``DataConfig``, cached as
    ``<cache_dir>/<scale>_<side>.npz`` (``cache_dir`` None: not cached;
    ``coo`` = (u, i, r) reuses the ratings)."""
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.data.layout_cache import (
        cached_layout)
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_users, n_items, n_obs = SCALES[scale]

    def build():
        u, i, r = coo if coo is not None else synthetic_ratings(
            n_users, n_items, n_obs, rank=16, seed=0)
        return layout_from_coo(u, i, r, n_users, n_items,
                               transpose=(side == "item"))

    path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"{scale}_{side}.npz")
    return cached_layout(path, build)


def opposite_table(n_opp: int, rank: int, device) -> torch.Tensor:
    """The script's opposite table: 0.01 N(0, 1) from ``default_rng(0)``,
    f32."""
    rng = np.random.default_rng(0)
    return torch.from_numpy((0.01 * rng.standard_normal((n_opp, rank))
                             ).astype(np.float32)).to(device)


def op_table(prof, device_type, top: int = TOP) -> dict:
    """The profile's time by lane and name: each CUDA stream's kernels and
    copies (``device_type`` CUDA), or each host thread's operators by self
    time (CPU). Returns {"total_ms", "lanes": [{"lane", "ms", "ops":
    [{"name", "ms", "calls", "solve"}] (longest first, at most ``top``)}]},
    lanes longest first."""
    cuda = device_type == torch.autograd.DeviceType.CUDA
    by_op = defaultdict(lambda: [0.0, 0])
    lanes = defaultdict(float)
    for ev in prof.events():
        if ev.device_type != device_type:
            continue
        us = ev.self_device_time_total if cuda else ev.self_cpu_time_total
        if us <= 0:
            continue
        lane = (f"stream {ev.device_resource_id}" if cuda
                else f"thread {ev.thread}")
        row = by_op[(lane, ev.name)]
        row[0] += us / 1e3
        row[1] += 1
        lanes[lane] += us / 1e3
    out = []
    for lane, ms in sorted(lanes.items(), key=lambda kv: -kv[1]):
        ops = sorted(((n, v) for (ln, n), v in by_op.items() if ln == lane),
                     key=lambda kv: -kv[1][0])[:top]
        out.append({"lane": lane, "ms": ms,
                    "ops": [{"name": n, "ms": v[0], "calls": v[1],
                             "solve": solve_kernel(n)} for n, v in ops]})
    return {"total_ms": sum(lanes.values()), "lanes": out}


def profiled(fn, device, host_ops: bool = False):
    """``fn`` once warm, then once under ``torch.profiler`` with the solve
    wrappers' counts set to 0 just before: CUDA activity on the card (and
    CPU activity too with ``host_ops``), CPU activity on the host.
    Returns (the profiler, the profiled call's result)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from recommendation_models_tpu_torch.ops import cholesky as ch
    on_card = device.type == "cuda"
    fn()
    if on_card:
        torch.cuda.synchronize()
    ch.reset_counts()
    acts = [ProfilerActivity.CUDA] if on_card else []
    if host_ops or not on_card:
        acts.append(ProfilerActivity.CPU)
    with torch_profile(activities=acts) as prof:
        out = fn()
        if on_card:
            torch.cuda.synchronize()
    return prof, out


def profile(fn, device, trace_path=None):
    """``fn`` profiled (``profiled``), its trace exported to
    ``trace_path``: (``op_table`` of the profiled run with the solve
    launches the wrappers counted in that run, the profiled call's
    result)."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    on_card = device.type == "cuda"
    prof, out = profiled(fn, device)
    launched = {n: v for n, v in ch.LAUNCHES.items() if v}
    if trace_path is not None:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    table = op_table(prof, torch.autograd.DeviceType.CUDA if on_card
                     else torch.autograd.DeviceType.CPU)
    recorded = defaultdict(int)
    for lane in table["lanes"]:
        for op in lane["ops"]:
            if op["solve"]:
                recorded[op["solve"]] += op["calls"]
    table["solve_launches"] = launched
    table["solve_recorded"] = dict(recorded)
    return table, out


def run(layout, side: str, n_opp: int, rank: int = 64, device=None,
        prof_dir=PROF_DIR, label: str = "") -> dict:
    """One half-sweep of ``layout`` profiled and printed; on the card also
    its CUDA-event time and the flag. Returns the record."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets, half_sweep)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = SolveConfig(rank=rank, reg=0.1, solver="auto",
                      compute_dtype="auto")
    bs = device_buckets(layout, block_batch(rank), dev)
    T = opposite_table(n_opp, rank, dev)

    def half():
        return half_sweep(T, bs, layout.n_rows, cfg)

    trace = None if prof_dir is None else os.path.join(
        prof_dir, f"{label or side}.trace.json")
    table, _ = profile(half, dev, trace)
    rec = {"side": side, "rank": rank, "n_rows": layout.n_rows,
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "trace": trace, **table, "event_ms": None, "table_share": None,
           "flagged": None}
    unit = "device" if on_card else "host self"
    if on_card:
        ev = time_ms(half, 3, warm=1)
        share = table["total_ms"] / ev
        rec.update(event_ms=ev, table_share=share,
                   flagged=abs(1.0 - share) > FLAG_SHARE)
        print(f"== {side} half-sweep: table {table['total_ms']:.3f} ms of "
              f"device time against {ev:.3f} ms between CUDA events "
              f"({share:.1%})"
              + ("  FLAGGED: they differ by more than 10% (the profiler "
                 "dropped events, or the device idled between launches)"
                 if rec["flagged"] else ""), flush=True)
        print(f"   solve launches counted {table['solve_launches']}, "
              f"recorded {table['solve_recorded']}", flush=True)
    else:
        print(f"== {side} half-sweep (cpu): table {table['total_ms']:.3f} "
              f"ms of host self time", flush=True)
    for lane in table["lanes"]:
        print(f"-- {lane['lane']}: {lane['ms']:.2f} ms {unit} total")
        for op in lane["ops"]:
            tag = f"  [{op['solve']}]" if op["solve"] else ""
            print(f"   {op['ms']:9.3f} ms {op['calls']:6d}x  "
                  f"{op['name'][:100]}{tag}")
    sys.stdout.flush()
    return rec


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("side", nargs="?", default="item",
                    choices=("user", "item"))
    ap.add_argument("--platform", default=None,
                    help="'cpu' for the host; default: the CUDA card")
    args = ap.parse_args(argv)
    from recommendation_models_tpu_torch.device import resolve_device
    from recommendation_models_tpu_torch.ops.gram import full_f32
    dev = resolve_device(args.platform)
    if dev.type == "cuda":
        full_f32()
    scale = env.get("ABL_SCALE", "ml25m" if dev.type == "cuda" else "tiny")
    rank = int(env.get("ABL_RANK", "64"))
    n_users, n_items, _ = SCALES[scale]
    layout = side_layout(scale, args.side,
                         env.get("ABL_CACHE_DIR", str(LAYOUT_CACHE_DIR)))
    rec = run(layout, args.side, n_items if args.side == "user" else n_users,
              rank, dev, env.get("PROF_DIR", str(PROF_DIR)))
    for lane in rec["lanes"]:
        del lane["ops"][10:]           # the JSON line keeps each lane's top 10
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
