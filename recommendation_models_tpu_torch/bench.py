"""The port's bench: the counterpart of the JAX package's ``bench.py``.

    python -m recommendation_models_tpu_torch.bench [--platform cpu]

Prints ONE JSON line on stdout, in ``bench.py``'s schema: ``metric``,
``value``, ``unit``, ``vs_baseline`` and ``extra``; progress goes to
stderr as ``#`` lines. The env knobs are ``bench.py``'s, with the same
names and defaults:

- ``BENCH_MODE`` = ``train`` (default), ``serving`` or ``imc``;
- ``BENCH_SCALE`` = a key of ``probes.SCALES`` (default ``ml25m``),
  ``BENCH_RANK`` (64), ``BENCH_SWEEPS`` (10), ``BENCH_ALPHA`` (unset: the
  explicit objective; a value: the implicit one with that confidence);
- ``BENCH_SOLVER`` (``auto``: the CUDA kernels; ``xla``: the
  ``torch.linalg`` anchor), ``BENCH_DTYPE`` (``auto`` = float32);
- the layout and solve policies, each auto at the rank unless set:
  ``BENCH_HOT_COLS``, ``BENCH_DMD`` (dense-whale threshold),
  ``BENCH_GROWTH`` (bucket growth), ``BENCH_GATHER_MB`` (row-block gather
  budget), ``BENCH_SSE_MODE`` (``auto``, ``riding`` or ``separate``);
- ``BENCH_LAYOUT_CACHE`` (a directory: each side's layout is cached there
  under ``bench.py``'s file names, in the format both packages read),
  ``BENCH_ORACLE_ROWS`` (1000: the CPU oracle's sample),
  ``BENCH_DEADLINE_S`` (2700: the watchdog).

Modes:

- **train**: the synthetic ratings of the scale, both layouts under the
  rank's policies, uploaded and warmed up by one sweep
  (``probes.epoch_profile.scanned_fits``); then one fit of
  ``BENCH_SWEEPS`` sweeps from the bench's warm start, timed on the host
  clock from the first sweep to the SSE history's readback (the fit's one
  sync). ``value`` is rows solved per second, ``vs_baseline`` its ratio
  to the NumPy oracle's half-sweep on the first ``BENCH_ORACLE_ROWS``
  users (best of 3). ``extra`` holds ``bench.py``'s keys and the port's:
  the card's name and power limit, ``max_memory_allocated``, the dense
  block's rows and TFLOP a sweep, the history, and a direct RMSE of the
  final factors (``masked_sse``, after the timed fit);
- **serving**: ``probes.serving``'s config at ``BENCH_RANK``;
- **imc**: ``probes.imc``'s config at ``min(BENCH_RANK, 32)``.

Where it differs from ``bench.py``, by design: the gather roof is the
card's (each gathered f32 row read once at the H100's 3.35 TB/s:
``3.35e12 / (4 rank)`` rows/s) and not the TPU's measured rate; there is
no retry (a CUDA error leaves the process's context unusable); a failure
prints ``bench.py``'s failure record and exits 1, and so does the
watchdog; and it runs on the card unless ``--platform cpu`` is given,
never falling back to the host. On the host every step runs untimed, and
every device number is null.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from recommendation_models_tpu_torch.probes import SCALES

# H100 SXM HBM rate (NVIDIA data sheet): the gather roof's bytes per second
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One bench run: the env knobs, parsed (None = the rank's auto
    policy)."""

    scale: str = "ml25m"
    rank: int = 64
    sweeps: int = 10
    solver: str = "auto"
    compute_dtype: str = "auto"
    mode: str = "train"
    alpha: Optional[float] = None
    hot_cols: Optional[int] = None
    dense_min_degree: Optional[int] = None
    growth: Optional[float] = None
    gather_mb: Optional[int] = None
    sse_mode: str = "auto"
    layout_cache: Optional[str] = None
    oracle_rows: int = 1000

    @classmethod
    def from_env(cls, env=None) -> "BenchConfig":
        """The knobs as ``bench.py`` reads them (an unset or empty
        ``BENCH_ALPHA``, ``BENCH_GROWTH`` or ``BENCH_GATHER_MB`` is
        auto)."""
        env = os.environ if env is None else env

        def knob(name, conv, default=None, empty_is_unset=True):
            v = env.get(name)
            if v is None or (empty_is_unset and v == ""):
                return default
            return conv(v)
        return cls(
            scale=env.get("BENCH_SCALE", "ml25m"),
            rank=int(env.get("BENCH_RANK", "64")),
            sweeps=int(env.get("BENCH_SWEEPS", "10")),
            solver=env.get("BENCH_SOLVER", "auto"),
            compute_dtype=env.get("BENCH_DTYPE", "auto"),
            mode=env.get("BENCH_MODE", "train"),
            alpha=knob("BENCH_ALPHA", float),
            hot_cols=knob("BENCH_HOT_COLS", int, empty_is_unset=False),
            dense_min_degree=knob("BENCH_DMD", int, empty_is_unset=False),
            growth=knob("BENCH_GROWTH", float),
            gather_mb=knob("BENCH_GATHER_MB", int),
            sse_mode=env.get("BENCH_SSE_MODE", "auto"),
            layout_cache=knob("BENCH_LAYOUT_CACHE", str),
            oracle_rows=int(env.get("BENCH_ORACLE_ROWS", "1000")))

    def data_config(self):
        """The layout policy: each knob, or the rank's auto value."""
        from recommendation_models_tpu_torch.config import (
            DataConfig, bucket_growth_for_rank, dense_min_degree_for_rank)
        from recommendation_models_tpu_torch.ops.cholesky import (
            hot_cols_auto)
        return DataConfig(
            hot_cols=(self.hot_cols if self.hot_cols is not None
                      else hot_cols_auto(self.rank)),
            dense_min_degree=(self.dense_min_degree
                              if self.dense_min_degree is not None
                              else dense_min_degree_for_rank(self.rank)),
            bucket_growth=(self.growth if self.growth
                           else bucket_growth_for_rank(self.rank)))

    def solve_options(self) -> dict:
        """``SolveConfig`` fields besides rank, reg and alpha."""
        return dict(solver=self.solver, compute_dtype=self.compute_dtype,
                    sse_mode=self.sse_mode,
                    **({"gather_budget_mb": self.gather_mb}
                       if self.gather_mb else {}))

    def metric(self) -> str:
        """``bench.py``'s metric name of a train run."""
        head = ("als_rows_solved" if self.alpha is None
                else "als_implicit_rows_solved")
        return (f"{head}_per_sec_per_chip_rank{self.rank}_{self.scale}"
                f"_synth")


def gather_roof_rows_per_s(rank: int) -> float:
    """Rows a second the card can gather at most: each gathered f32 row of
    ``rank`` floats read once at the HBM rate."""
    return PEAK_BYTES_PER_S / (rank * 4)


def dense_tflop_per_sweep(ul, il, rank: int) -> float:
    """TFLOP a sweep of the dense blocks' gram and rhs products
    (``dense_gram_rhs``: (W, n) x (n, k² + k) in each half)."""
    flops = 0.0
    for lay in (ul, il):
        if lay.dense_ids is not None:
            flops += 2.0 * lay.dense_ids.shape[0] * lay.n_cols * (
                rank * rank + rank)
    return flops / 1e12


def train_layouts(cfg: BenchConfig, coo=None):
    """((u, i, r), user layout, item layout): the synthetic ratings of
    ``cfg.scale`` (``coo`` reuses them) laid out under ``cfg``'s policy;
    with ``cfg.layout_cache`` each side is loaded from, or built into,
    ``bench.py``'s cache file."""
    from recommendation_models_tpu_torch.data.layout import layout_from_coo
    from recommendation_models_tpu_torch.data.layout_cache import (
        cached_layout)
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        main_path_layouts)
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    n_users, n_items, n_obs = SCALES[cfg.scale]
    if coo is None:
        coo = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    dcfg = cfg.data_config()
    if not cfg.layout_cache:
        return main_path_layouts(cfg.scale, cfg.rank, coo=coo, dcfg=dcfg)
    u, i, r = coo
    os.makedirs(cfg.layout_cache, exist_ok=True)
    tag = (f"{cfg.scale}.hot{dcfg.hot_cols}.dmd{dcfg.dense_min_degree}"
           + (f".g{dcfg.bucket_growth}" if dcfg.bucket_growth != 1.25
              else ""))

    def side(transpose: bool):
        which = "item" if transpose else "user"
        return cached_layout(
            os.path.join(cfg.layout_cache, f"{tag}.{which}.npz"),
            lambda: layout_from_coo(u, i, r, n_users, n_items,
                                    transpose=transpose, config=dcfg))
    return coo, side(False), side(True)


def oracle_rows_per_sec(coo, n_users: int, n_items: int, V: np.ndarray,
                        rank: int, rows: int) -> float:
    """The CPU baseline of ``bench.py``: rows/s of the NumPy oracle's
    half-sweep (``oracle.OracleALS``, explicit, reg 0.1) over the first
    ``rows`` users (at least 200), best of 3."""
    import scipy.sparse as sp
    from recommendation_models_tpu_torch.oracle import OracleALS
    u, i, r = coo
    sample = min(n_users, max(200, rows))
    keep = u < sample
    Rs = sp.csr_matrix((r[keep], (u[keep], i[keep])), shape=(sample, n_items))
    oracle = OracleALS(rank=rank, reg=0.1)
    V64 = np.asarray(V, np.float64)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        oracle.half_sweep(Rs, V64)
        best = min(best, time.perf_counter() - t0)
    rate = sample / best
    log(f"# oracle: {rate:.1f} rows/s over {sample} rows")
    return rate


def train_record(cfg: BenchConfig, coo, ul, il, device: torch.device
                 ) -> dict:
    """Train mode on built layouts (``train_layouts``): the bench's record.

    Uploads the layouts and warms up with one sweep, then times one fit of
    ``cfg.sweeps`` sweeps from the warm start; after it, a direct RMSE of
    the final factors (``masked_sse``) and the CPU oracle. The card's peak
    memory covers the upload, the warm-up and the timed fit."""
    from recommendation_models_tpu_torch.config import sse_separate_for
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        scanned_fits, time_fit)
    from recommendation_models_tpu_torch.probes.gather_latency import card
    from recommendation_models_tpu_torch.solver.als_sweep import masked_sse
    on_card = device.type == "cuda"
    nnz = int(coo[2].shape[0])
    n_users, n_items = ul.n_rows, il.n_rows
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fits = scanned_fits(ul, il, nnz, device, cfg.rank, cfg.alpha,
                        cfg.sweeps, **cfg.solve_options())
    epoch_s, U, V, sse_h, n_done = time_fit(fits.fit, fits.U0, fits.V0)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    hist = np.sqrt(np.maximum(sse_h[:n_done].astype(np.float64), 0) / nnz)
    rmse = float(hist[-1])
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    if on_card:
        log(f"# cuda: {epoch_s:.3f}s/epoch, rmse={rmse:.4f}, device={name}")
    else:
        log(f"# cpu (untimed): rmse={rmse:.4f}")
    direct = masked_sse(U, V, fits.user_buckets, chunk=fits.cfg.chunk,
                        gather_budget_mb=fits.cfg.gather_budget_mb)
    direct_rmse = float(np.sqrt(max(float(direct), 0.0) / nnz))
    separate = sse_separate_for(fits.cfg, nnz)
    V_host = V.cpu().numpy()
    del fits, U, V
    oracle = oracle_rows_per_sec(coo, n_users, n_items, V_host, cfg.rank,
                                 cfg.oracle_rows)
    gathered = int(ul.padded_slots + il.padded_slots)
    roof = gather_roof_rows_per_s(cfg.rank)
    value = roof_fraction = None
    if on_card:
        elapsed = epoch_s * cfg.sweeps
        value = (n_users + n_items) * cfg.sweeps / elapsed
        roof_fraction = gathered * cfg.sweeps / elapsed / roof
    return {
        "metric": cfg.metric(),
        "value": value,
        "unit": "rows/s/chip",
        "vs_baseline": None if value is None else value / oracle,
        "extra": {
            "epoch_seconds": epoch_s if on_card else None,
            "train_rmse": rmse,
            "nnz": nnz,
            "solver": cfg.solver,
            "compute_dtype": cfg.compute_dtype,
            "oracle_rows_per_sec": oracle,
            "gathered_rows_per_epoch": gathered,
            "gather_roof_rows_per_s": roof,
            "roof_fraction": roof_fraction,
            "device": name,
            "card": card() if on_card else None,
            "max_memory_allocated": peak,
            "dense_rows": {
                "user": 0 if ul.dense_ids is None else ul.dense_ids.shape[0],
                "item": 0 if il.dense_ids is None else il.dense_ids.shape[0]},
            "dense_tflop_per_sweep": dense_tflop_per_sweep(ul, il, cfg.rank),
            "sweeps": int(n_done),
            "history": [float(h) for h in hist],
            "direct_rmse": direct_rmse,
            "sse_mode": "separate" if separate else "riding",
        },
    }


def serving_record(cfg: BenchConfig, device: torch.device) -> dict:
    """Serving mode: ``probes.serving``'s config at ``cfg.rank`` on the
    ratings of ``cfg.scale``."""
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.probes import serving as sv
    n_users, n_items, n_obs = SCALES[cfg.scale]
    coo = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    train, train_obs, eval_users, rel_eval = sv.serving_split(
        coo, n_users, n_items)
    model = sv.fit_serving_model(train, device.type, cfg.rank)
    record, _ = sv.measure(model, train_obs, eval_users, rel_eval, device,
                           cfg.scale)
    return record


def imc_record(cfg: BenchConfig, device: torch.device) -> dict:
    """IMC mode: ``probes.imc``'s config at ``min(cfg.rank, 32)`` (the
    side features are 64 and 48 wide) on at most 2,000,000 observations
    of ``cfg.scale``."""
    from recommendation_models_tpu_torch.probes import imc as im
    rank = min(cfg.rank, 32)
    if rank != cfg.rank:
        log(f"# imc: BENCH_RANK={cfg.rank} capped to {rank} "
            f"(side-feature widths {im.D_USER}/{im.D_ITEM})")
    n_obs = SCALES[cfg.scale][2]
    if n_obs > im.MAX_OBS:
        log(f"# imc: training on {im.MAX_OBS} of {n_obs} obs")
    data = im.imc_data(cfg.scale, rank)
    record, _ = im.measure(data, device, cfg.scale, rank=rank)
    return record


def run(cfg: BenchConfig, device: torch.device) -> dict:
    """One bench run in ``cfg.mode`` on ``device``: the record."""
    if cfg.mode == "serving":
        return serving_record(cfg, device)
    if cfg.mode == "imc":
        return imc_record(cfg, device)
    t0 = time.perf_counter()
    coo, ul, il = train_layouts(cfg)
    data_s = time.perf_counter() - t0
    log(f"# data: {coo[2].shape[0]} obs, layout waste user="
        f"{ul.padding_waste():.2%} item={il.padding_waste():.2%}, "
        f"{data_s:.1f}s")
    return train_record(cfg, coo, ul, il, device)


def failure_record(exc: BaseException) -> dict:
    """``bench.py``'s failure record: no real metric is negative."""
    return {"metric": "bench_failed", "value": -1.0, "unit": "error",
            "vs_baseline": -1.0,
            "error": f"{type(exc).__name__}: {str(exc)[:500]}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cpu': on the host, untimed; default: the card")
    args = ap.parse_args(argv)
    out = sys.stdout
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "2700"))

    def fire():
        print(json.dumps(failure_record(TimeoutError(
            f"bench exceeded BENCH_DEADLINE_S={deadline:.0f}s"))),
            file=out, flush=True)
        os._exit(1)

    watchdog = threading.Timer(deadline, fire)
    watchdog.daemon = True
    watchdog.start()
    try:
        # the one JSON line is the only output on stdout
        with contextlib.redirect_stdout(sys.stderr):
            from recommendation_models_tpu_torch.device import resolve_device
            cfg = BenchConfig.from_env()
            record = run(cfg, resolve_device(args.platform))
    except Exception as exc:  # noqa: BLE001 -- the record is the contract
        traceback.print_exc(file=sys.stderr)
        print(json.dumps(failure_record(exc)), file=out, flush=True)
        return 1
    finally:
        watchdog.cancel()
    print(json.dumps(record), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
