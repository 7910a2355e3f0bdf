"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's result as the last line of
standard output (one JSON object), and each number compared beside its
limit as the last lines of standard error. Exits with another code than 0,
and prints no result, when there is no CUDA card or fewer than the cell
asks for, when the port cannot be imported (a checkout that holds only the
benchmark), or when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "recommendation_models_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fix_cache_dirs() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths. The
    port builds its own CUDA sources into ``build/kernels/`` of the
    checkout."""
    cache = ROOT / "build" / "benchmark-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_cache_dirs()
    import torch

    from benchmark import harness
    bench = harness.Benchmark(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import recommendation_models_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the port cannot be imported ({exc})",
              file=sys.stderr)
        return 4
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=T_START,
                              root=ROOT)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 5
    for line in result["notes"]:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
