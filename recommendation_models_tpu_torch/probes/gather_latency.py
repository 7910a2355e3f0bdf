"""Per-call cost of the row gather-and-sum kernel P1 at the shapes it runs
at, beside its bytes bound, its L2 bound, its plain version and the library
gather.

    python -m recommendation_models_tpu_torch.probes.gather_latency \
        [--shapes probe,user_block,item_block,user_blocks,item_blocks,halves]
        [--l2-latency] [--platform cpu]

Shapes (k=64 ones on the main path's warm-start factor tables, the
ML-25M-shaped rank-64 auto layouts of ``probes.epoch_profile``, cached
under ``build/layout_cache/`` at the root of the checkout that holds this
file):

- ``probe``: the gather probe's 62,423 x 128 f32 table and 200,000 ids
  (``probes.dma_gather``), at slots 4, 8 and 16;
- ``user_block`` / ``item_block``: the ids of one row block of the sweep
  (``probes.ablate_epoch.row_blocks``, the block of median id count) of
  the user half on V and of the item half on U, slots 8;
- ``user_blocks`` / ``item_blocks``: one call per row block of the half,
  as the epoch ablation's gather-only line makes them; numbers are for the
  whole loop;
- ``halves``: one call over all of each half's bucket ids.

One JSON line per shape: ``device_us`` (device µs per call by kernel,
from ``torch.profiler``, so host gaps do not count: each kernel's mean
over the calls the profiler recorded, as it drops some calls a
millisecond long; ``{}``, and ``device_ms`` null, where it recorded none),
``kernels_per_call``, ``host_us`` (wall µs per call over at least 200
calls with no sync inside), ``event_ms`` (CUDA events around the calls,
the stream kept full), ``rows_per_s`` (ids over event time), ``tb_s``
(gathered bytes, n_gather × k × 4, over device time, else event time),
``bytes_bound_ms`` (each distinct row, the ids and the output once over
3.35 TB/s), ``l2_bound_ms`` (n_gather × k × 4 B over the L2 read rate
measured in the same run: the least time if every gathered row crossed
from the L2; rows an SM's L1 serves again, as the halves' skewed ids do,
can beat it), ``plain_ms`` and ``library_ms``
(``embedding_bag(mode="sum")``, CUDA events), ``max_abs_err`` against the
plain version and ``agrees``.
A first line gives the card, the tree whose ``ops/gather.py`` ran, and the
L2 read rate: the read kernel of ``csrc/l2_probe.cu`` (every thread of a
full grid reading a warm 16 MB f32 buffer over and over with loads that
skip the L1), beside five library calls over the same buffer by device
time (``L2_YARDSTICKS``: ``x.sum()`` and other reductions, and a copy
counted as read and write), yardsticks the port never calls; the rate is
the fastest of them. ``--l2-latency`` adds the L2 hit latency by pointer
chase (``csrc/l2_probe.cu``).

The probe imports only ``ops.gather``'s public wrapper and plain version,
so it times another checkout's kernel when that checkout is first on
``PYTHONPATH``: that is how two trees are compared in one call. With ``--platform cpu`` it runs at
the tiny scale and a small probe shape, untimed (the wrapper takes the
plain version), and prints the bounds.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from recommendation_models_tpu_torch.probes import (
    device_rows, host_us, time_ms)

PEAK_BYTES_PER_S = 3.35e12
RANK = 64
ALL_SHAPES = ("probe", "user_block", "item_block", "user_blocks",
              "item_blocks", "halves")
CACHE = Path(__file__).resolve().parents[2] / "build" / "layout_cache"
L2_MB = 16


def bytes_bound_ms(distinct: int, n: int, k: int) -> float:
    """Every distinct row touched, the ids and the output once, over the
    HBM rate."""
    return 4.0 * (distinct * k + n + k) / PEAK_BYTES_PER_S * 1e3


def l2_bound_ms(n: int, k: int, l2_bytes_per_s: float) -> float:
    """Every gathered row's bytes over the measured L2 read rate."""
    return 4.0 * n * k / l2_bytes_per_s * 1e3


def tb_s(n: int, k: int, ms: float) -> float:
    """Gathered bytes per second, in TB/s, at ``ms`` per call."""
    return 4.0 * n * k / (ms * 1e-3) / 1e12


def edge_counts(k: int, slots: int, vec: int, resident: int):
    """The id counts at the gather kernel's edges for (k, slots, vec) on a
    card with ``resident`` blocks of its instantiation (``ops.gather.
    gather_config``): 0, 1, and each of these ± 1: a warp step's rows, a
    warp's steps in flight, a block's, one part of the grid rule, two parts,
    and the count where the grid stops growing."""
    from recommendation_models_tpu_torch.ops import gather as ga
    lanes = ga.lanes_per_row(k, vec)
    rows = 32 // lanes
    depth = ga.depth_for(slots, lanes)
    per_part = ga.WARPS * rows * depth * ga.MIN_ROUNDS
    cap = max(1, resident // ga.slices_for(k, vec, lanes)) * per_part
    marks = {rows, rows * depth, ga.WARPS * rows * depth, per_part,
             2 * per_part, cap}
    return sorted({0, 1} | {m + d for m in marks for d in (-1, 0, 1)
                            if m + d >= 0})


def per_call(rows, calls: int):
    """{kernel: device µs per call} and kernels per call from
    ``device_rows`` over ``calls`` calls. The profiler drops the events of
    some calls milliseconds long, so each kernel's time is its mean over the
    events recorded, times its launches per call (at least 1)."""
    us, per = {}, 0
    for t, n, name in rows:
        launches = max(1, round(n / calls))
        us[name] = us.get(name, 0.0) + t / n * launches
        per += launches
    return us, per


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


# library calls over a warm 16 MB f32 tensor x (y: its copy target), the
# L2's yardsticks: name -> (call, bytes moved in units of x's size)
L2_YARDSTICKS = {
    "x.sum()": (lambda x, y: x.sum(), 1),
    "x.amax()": (lambda x, y: x.amax(), 1),
    "x.view(-1, 64).sum(0)": (lambda x, y: x.view(-1, 64).sum(0), 1),
    "x.view(-1, 4096).sum(1)": (lambda x, y: x.view(-1, 4096).sum(1), 1),
    "y.copy_(x)": (lambda x, y: y.copy_(x), 2),
}


L2_READ = "l2_read kernel"
L2_READ_PASSES = 64


@functools.lru_cache(maxsize=None)
def _l2_lib():
    """The library of this checkout's ``csrc/l2_probe.cu``, built by this
    checkout's ``ops/build.py``: the tree whose kernel is timed may lack
    the source."""
    import ctypes
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_gather_latency_build", Path(__file__).resolve().parents[1] / "ops"
        / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = build.load("l2_probe")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.l2_chase.argtypes = [p, ll, p, p, p]
    lib.l2_chase.restype = ctypes.c_int
    lib.l2_read.argtypes = [p, ll, ctypes.c_int, ctypes.c_int, p, p]
    lib.l2_read.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def l2_rates(dev, reps: int = 400) -> dict:
    """Bytes/s read from the L2 by the read kernel of ``csrc/l2_probe.cu``
    (``L2_READ``: a full grid, ``L2_READ_PASSES`` passes a launch) and by
    each of ``L2_YARDSTICKS``, by device time, over a 16 MB f32 tensor
    warmed into the L2 first."""
    x = torch.randn(L2_MB << 18, device=dev)
    y = torch.empty_like(x)
    out = {}
    for name, (fn, moved) in L2_YARDSTICKS.items():
        us, _ = per_call(device_rows(lambda: fn(x, y), reps, warm=5), reps)
        out[name] = moved * (L2_MB << 20) / (sum(us.values()) * 1e-6)
    lib = _l2_lib()
    sink = torch.empty(1, device=dev)
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def read():
        _raise_on(lib.l2_read(x.data_ptr(), x.numel() // 4, L2_READ_PASSES,
                              blocks, sink.data_ptr(), stream), "l2_read")

    us, _ = per_call(device_rows(read, 20, warm=3), 20)
    out[L2_READ] = L2_READ_PASSES * (L2_MB << 20) / (sum(us.values())
                                                      * 1e-6)
    return out


def l2_read_rate(dev) -> float:
    """The L2 read rate, bytes/s: the fastest of ``l2_rates``."""
    return max(l2_rates(dev).values())


def l2_latency(dev, mb: int = L2_MB, hops: int = 200_000):
    """(ns, SM cycles) per hop of a one-thread pointer chase through a
    random cycle of ``mb`` MB, warmed once (``csrc/l2_probe.cu``)."""
    lib = _l2_lib()
    n = mb << 18
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(n, generator=gen, device=dev)
    nxt = torch.empty(n, dtype=torch.int64, device=dev)
    nxt[perm] = torch.roll(perm, -1)
    nxt = nxt.to(torch.int32)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chase(h):
        _raise_on(lib.l2_chase(nxt.data_ptr(), h, sink.data_ptr(),
                               cycles.data_ptr(), stream), "l2_chase")

    chase(n)                                       # warm the whole cycle
    ms = time_ms(lambda: chase(hops), 3, warm=1)
    return ms * 1e6 / hops, int(cycles.item()) / hops


def layouts():
    from recommendation_models_tpu_torch.data.layout_cache import (
        cached_layout)
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        main_path_layouts)
    CACHE.mkdir(parents=True, exist_ok=True)
    built = []

    def side(i):
        if not built:
            built.append(main_path_layouts("ml25m", RANK))
        return built[0][1 + i]

    return (cached_layout(str(CACHE / "ml25m.main.r64.user.npz"),
                          lambda: side(0)),
            cached_layout(str(CACHE / "ml25m.main.r64.item.npz"),
                          lambda: side(1)))


def half_inputs(dev, scale: str):
    """{'user'/'item': (table, [ids of each row block], all ids)}: the
    user half gathers V, the item half U."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.probes.ablate_epoch import (
        row_blocks)
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    if scale == "ml25m":
        ul, il = layouts()
    else:
        from recommendation_models_tpu_torch.probes.epoch_profile import (
            main_path_layouts)
        _, ul, il = main_path_layouts(scale, RANK)
    U0, V0 = (torch.from_numpy(a).to(dev)
              for a in warm_start(ul.n_rows, il.n_rows, RANK))
    cfg = SolveConfig(rank=RANK, reg=0.1)
    out = {}
    for tag, layout, tbl in (("user", ul, V0), ("item", il, U0)):
        bs = device_buckets(layout, block_batch(RANK), dev)
        blocks = [b["indices"][s:e].reshape(-1)
                  for b, s, e in row_blocks(bs, cfg, RANK)]
        out[tag] = (tbl, blocks, torch.cat(blocks))
    return out


def measure(label, table, ids, slots, dev, l2_rate, reps, lib_reps=2,
            loop=None, **extra):
    """One JSON row: the wrapper on (table, ids, slots), or on each
    (table, ids) of ``loop`` in turn when it is given (numbers for the
    loop)."""
    import torch.nn.functional as F
    from recommendation_models_tpu_torch.ops import gather as ga
    calls = loop or [ids]
    n = sum(int(i.shape[0]) for i in calls)
    k = table.shape[1]

    def fn():
        for i in calls:
            ga.gather_rows_sum(table, i, slots)

    def plain():
        for i in calls:
            ga.gather_rows_sum_plain(table, i)

    def library():
        for i in calls:
            F.embedding_bag(i, table, offs, mode="sum")

    offs = torch.zeros(1, dtype=torch.int32, device=dev)
    err, ok = 0.0, True
    for i in calls:
        x = ga.gather_rows_sum(table, i, slots)
        ref = ga.gather_rows_sum_plain(table, i)
        e = (x - ref).abs()
        err = max(err, float(e.max()))
        ok = ok and bool((e <= ga.sum_tolerance(table, i)).all())
    distinct = int(torch.unique(torch.cat(calls)).numel())
    row = dict(shape=label, n_gather=n, k=k, slots=slots, calls=len(calls),
               distinct_rows=distinct, max_abs_err=err, agrees=ok,
               bytes_bound_ms=bytes_bound_ms(distinct, n, k), **extra)
    if l2_rate:
        row["l2_bound_ms"] = l2_bound_ms(n, k, l2_rate)
    if dev.type != "cuda":
        fn()
        return row
    try:
        us, per = per_call(device_rows(fn, reps), reps)
        dev_ms = sum(us.values()) / 1e3
    except RuntimeError:   # the profiler recorded none of the calls
        us, per, dev_ms = {}, None, None
    ev = time_ms(fn, reps, warm=1)
    if loop is None:
        host = host_us(fn)
    else:                  # 3 loops, no sync inside, per call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        host = (time.perf_counter() - t0) / (3 * len(calls)) * 1e6
        torch.cuda.synchronize()
    row.update(device_us=us,
               kernels_per_call=None if per is None else per / len(calls),
               device_ms=dev_ms, host_us=host,
               event_ms=ev, rows_per_s=n / (ev * 1e-3),
               tb_s=tb_s(n, k, dev_ms or ev),
               plain_ms=time_ms(plain, lib_reps, warm=1),
               library_ms=time_ms(library, lib_reps if n < 1e6 else 1,
                                  warm=1))
    return row


def run(shapes, dev, with_latency=False, scale="ml25m",
        probe_shape=None):
    from recommendation_models_tpu_torch.ops import gather as ga
    from recommendation_models_tpu_torch.probes import dma_gather
    head = dict(tree=str(Path(ga.__file__).resolve().parents[2]),
                device=dev.type)
    l2_rate = None
    if dev.type == "cuda":
        head.update(card=card(), kind=torch.cuda.get_device_name(dev),
                    torch=torch.__version__)
        rates = l2_rates(dev)
        l2_rate = max(rates.values())
        head["l2_read_tb_s"] = l2_rate / 1e12
        head["l2_yardsticks_tb_s"] = {n: r / 1e12 for n, r in rates.items()}
        if with_latency:
            ns, cyc = l2_latency(dev)
            head.update(l2_latency_ns=ns, l2_latency_cycles=cyc)
    print(json.dumps(head), flush=True)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if "probe" in shapes:
        nt, k, n = probe_shape or (dma_gather.N_TABLE, dma_gather.K,
                                   dma_gather.N_GATHER)
        table, idx = dma_gather.make_inputs(nt, k, n, dev)
        for slots in dma_gather.SLOTS:
            emit(measure("probe", table, idx, slots, dev, l2_rate, 50,
                         lib_reps=5))
        del table, idx
    if not set(shapes) & set(ALL_SHAPES[1:]):
        return rows
    halves = half_inputs(dev, scale)
    slots = ga.DEFAULT_SLOTS
    for tag in ("user", "item"):
        tbl, blocks, _ = halves[tag]
        if f"{tag}_block" in shapes:
            order = sorted(range(len(blocks)),
                           key=lambda j: blocks[j].shape[0])
            med = order[len(order) // 2]
            emit(measure(f"{tag}_block", tbl, blocks[med], slots, dev,
                         l2_rate, 200, lib_reps=5, block=med,
                         blocks=len(blocks)))
        if f"{tag}_blocks" in shapes:
            emit(measure(f"{tag}_blocks", tbl, None, slots, dev, l2_rate, 3,
                         loop=blocks))
    if "halves" in shapes:
        for tag in ("user", "item"):
            tbl, _, ids = halves[tag]
            emit(measure(f"{tag}_half", tbl, ids, slots, dev, l2_rate, 5,
                         lib_reps=2))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(ALL_SHAPES))
    ap.add_argument("--l2-latency", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="'cpu': tiny scale, untimed; default: the card")
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    unknown = [s for s in shapes if s not in ALL_SHAPES]
    if unknown:
        raise SystemExit(f"unknown shapes {unknown}; known: {ALL_SHAPES}")
    if args.platform == "cpu":
        rows = run(shapes, torch.device("cpu"), scale="tiny",
                   probe_shape=(2_000, 128, 5_000))
    else:
        if not torch.cuda.is_available():
            print("gather_latency: needs a CUDA card (or --platform cpu)",
                  file=sys.stderr)
            return 2
        rows = run(shapes, torch.device("cuda"), args.l2_latency)
    return 0 if all(r["agrees"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
