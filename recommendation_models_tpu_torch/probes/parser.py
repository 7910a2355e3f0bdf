"""Ingest rate of the native ratings parser at ML-25M scale.

    python -m recommendation_models_tpu_torch.probes.parser \
        [--rows 25000000] [--dir build/parser_bench]

The port's counterpart of ``scripts/bench_parser.py``. Writes a real-format
``ratings.csv`` of ``--rows`` rows once (random ids in ML-25M's ranges,
half-star ratings, a fixed timestamp; kept in ``--dir`` for later runs),
then times ``data.native.parse_ratings`` end to end into NumPy, and the
``np.loadtxt`` fallback on the first 1,000,000 rows for the ratio. It
runs on the host's CPU alone (no card), and prints the host's CPU model
beside the rates, then one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "parser_bench"
HEADER = "userId,movieId,rating,timestamp"
SEPARATOR = {"csv": ",", "dat": "::"}
CHUNK = 1_000_000
LOADTXT_ROWS = 1_000_000


def write_ratings(path, users, items, ratings, fmt: str = "csv",
                  timestamp: int = 1234567890) -> None:
    """Write (user, item, rating) rows in a MovieLens format, ``csv``
    (``ratings.csv``, with its header) or ``dat`` (``ratings.dat``, ``::``),
    ``CHUNK`` rows at a time; ids are written as given, each row ends with
    ``timestamp``."""
    sep = SEPARATOR[fmt]
    with open(path, "w") as f:
        if fmt == "csv":
            f.write(HEADER + "\n")
        for s in range(0, len(ratings), CHUNK):
            e = min(s + CHUNK, len(ratings))
            f.write("\n".join(
                f"{a}{sep}{b}{sep}{c}{sep}{timestamp}" for a, b, c in zip(
                    users[s:e].tolist(), items[s:e].tolist(),
                    ratings[s:e].tolist())) + "\n")


def cpu_model() -> str:
    """The host CPU's model name, with its core count: ``/proc/cpuinfo``'s
    ``model name``, else ``lscpu``'s, else its vendor, family and model
    numbers, else the machine type."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "")
    if not name or name == "unknown":
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), "")
        except (OSError, subprocess.SubprocessError):
            name = ""
    if not name or name == "unknown":
        name = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                                   "model") if k in info)
    return f"{name or platform.machine()} ({os.cpu_count()} logical CPUs)"


def main(argv=None) -> int:
    from recommendation_models_tpu_torch.data import native
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=25_000_000)
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    args = ap.parse_args(argv)
    n = args.rows
    os.makedirs(args.dir, exist_ok=True)
    path = os.path.join(args.dir, f"parser_bench_{n}.csv")
    write_s = None
    if not os.path.exists(path):
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        tmp = f"{path}.{os.getpid()}.tmp"
        write_ratings(tmp, rng.integers(1, 162_541, n),
                      rng.integers(1, 62_423, n),
                      rng.integers(1, 11, n) / 2.0)
        os.replace(tmp, path)
        write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"# {path}: {size / 2**20:.1f} MiB"
          + ("" if write_s is None else f", written in {write_s:.1f}s"),
          flush=True)
    if not native.available():
        print("parser: the native parser did not build", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    arr = native.parse_ratings(path, ",", skip_header=True)
    dt = time.perf_counter() - t0
    if arr is None or arr.shape != (n, 3):
        print(f"parser: parsed {getattr(arr, 'shape', None)}, want ({n}, 3)",
              file=sys.stderr)
        return 1
    del arr
    m = min(n, LOADTXT_ROWS)
    t0 = time.perf_counter()
    np.loadtxt(path, delimiter=",", usecols=(0, 1, 2), skiprows=1,
               max_rows=m)
    dt_np = time.perf_counter() - t0
    cpu = cpu_model()
    record = {
        "rows": n, "mib": size / 2**20, "native_seconds": dt,
        "native_mb_s": size / 2**20 / dt, "native_mrows_s": n / dt / 1e6,
        "loadtxt_rows": m, "loadtxt_seconds": dt_np,
        "loadtxt_mrows_s": m / dt_np / 1e6,
        "ratio": (n / dt) / (m / dt_np), "write_seconds": write_s,
        "cpu": cpu,
    }
    print(f"native parser on {cpu}: {n} rows, {record['mib']:.0f} MiB in "
          f"{dt:.2f}s = {record['native_mb_s']:.0f} MiB/s, "
          f"{record['native_mrows_s']:.1f} Mrows/s")
    print(f"np.loadtxt baseline: {m} rows in {dt_np:.2f}s = "
          f"{record['loadtxt_mrows_s']:.2f} Mrows/s "
          f"({record['ratio']:.1f}x)")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
