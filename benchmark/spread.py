"""Measure a cell's spread as the bounds are set from it.

    python3 -m benchmark.spread --workload <name> --seeds S1 ... S6 \
        [--sets 2] [--seconds 30] [--trace-seeds T1 T2 T3] [--out FILE]

Runs ``python3 -m benchmark.run`` for the cell once per seed, in ``--sets``
sets of the same seeds (each run a process of its own, one after another),
then once with ``--trace 1`` per trace seed, and prints one JSON object:
every run's result line, and for each end-to-end metric each set's median
and its spread, the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) over the median. A bound is about
five times the widest spread, and never under 1%.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def one_run(workload, seed, seconds, trace):
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t
    line = done.stdout.strip().splitlines()[-1] if done.stdout.strip() else ""
    try:
        result = json.loads(line)
    except ValueError:
        result = None
    return {"seed": seed, "trace": trace, "rc": done.returncode,
            "wall_s": wall, "result": result,
            "stderr_tail": done.stderr[-1500:]}


def spread(values):
    """(median, (q3 - q1) / median) of ``values``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def summarize(runs, n_sets):
    by_set = [[r for r in runs if r["set"] == s and r["trace"] == 0]
              for s in range(n_sets)]
    names = set()
    for r in runs:
        if r["result"] and r["trace"] == 0:
            names |= set(r["result"]["metrics"])
    out = {}
    for name in sorted(names):
        sets = []
        for s in by_set:
            vals = [r["result"]["metrics"][name]["value"] for r in s
                    if r["result"] and name in r["result"]["metrics"]]
            if len(vals) >= 2:
                med, spr = spread(vals)
                sets.append({"values": vals, "median": med, "spread": spr})
        widest = max((s["spread"] for s in sets), default=None)
        out[name] = {"sets": sets, "widest_spread": widest,
                     "bound_5x": None if widest is None
                     else max(0.01, 5 * widest)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            runs.append(dict(one_run(args.workload, seed, args.seconds, 0),
                             set=s))
            print(json.dumps({k: runs[-1][k] for k in
                              ("set", "seed", "rc", "wall_s")}),
                  file=sys.stderr, flush=True)
    for seed in args.trace_seeds:
        runs.append(dict(one_run(args.workload, seed, args.seconds, 1),
                         set=-1))
    report = {"workload": args.workload, "seconds": args.seconds,
              "summary": summarize(runs, args.sets),
              "correct": [r["result"]["correct"] if r["result"] else None
                          for r in runs],
              "runs": runs}
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps({"workload": args.workload,
                      "summary": report["summary"],
                      "correct": report["correct"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
