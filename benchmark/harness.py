"""Find a cell's files by name, run its runner, read its metrics and make
the result line.

Everything a cell needs is found from ``BENCHMARK.json`` (beside this
package) by name: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``runner`` names a module of ``runners/``),
``workloads/<cell>.json`` (the limits of ``correct``) and
``metrics/<metric>.py`` (each metric's ``read(run)``, which returns a
number or None when it finds nothing to read). A cell reports, without a
trace, the end-to-end metrics that list it (or list no cells) and, with a
trace, the per-layer metrics that list it: every per-layer metric names
its cells.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Optional

import torch

from benchmark import check, trace

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the harness found, and what the runner
    measured."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: Optional[float] = None
    layout_build_s: Optional[float] = None
    window: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    capture: Optional[trace.Capture] = None
    traced_units: int = 0
    work: dict = dataclasses.field(default_factory=dict)
    numbers: dict = dataclasses.field(default_factory=dict)
    # host seconds of the run's phases (set-up, window, trace, comparison)
    phase_s: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    directory that holds ``BENCHMARK.json`` and this package)."""

    def __init__(self, root: Path = HERE.parent):
        self.root = Path(root)
        self.here = self.root / "benchmark"
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return load_json(self.root / entry["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, name: str) -> dict:
        return load_json(self.here / "workloads" / f"{name}.json")["limits"]

    def metrics(self, cell: str, traced: bool):
        """The metrics a run of ``cell`` reports: end-to-end without a
        trace, per-layer with one."""
        if not traced:
            return [m for m in self.spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        mod_name = "benchmark_metric_" + metric.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def device_info(run: Run) -> dict:
    dev = run.device
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": int(run.cell["chips"])}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(run.memory_peak_bytes)
    return info


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device, t_start: Optional[float] = None,
             root: Path = HERE.parent) -> dict:
    """Run cell ``name`` once on ``device`` and return its result line (a
    dict): ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    with a trace ``breakdown``, and last ``checks`` (each number compared
    beside its limit)."""
    bench = Benchmark(root)
    cell = bench.cell(name)
    run = Run(name=name, cell=cell, config=bench.config(cell["config"]),
              traffic=bench.traffic(cell["traffic"]),
              limits=bench.limits(name), seed=int(seed),
              seconds=float(seconds), trace=bool(traced),
              device=torch.device(device),
              t_start=time.perf_counter() if t_start is None else t_start)
    runner = importlib.import_module(
        f"benchmark.runners.{run.traffic['runner']}")
    runner.run(run)
    run.notes = notes(run)
    metrics = {}
    for m in bench.metrics(name, traced):
        value = bench.reader(m["name"])(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, checks = check.verdict(run.numbers, run.limits)
    result: dict[str, Any] = {
        "correct": bool(correct and run.failed == 0),
        "attempted": int(run.attempted), "failed": int(run.failed),
        "metrics": metrics, "device": device_info(run)}
    if traced and run.capture is not None:
        summary = trace.summary(run.capture)
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["notes"] = run.notes
    result["checks"] = checks
    return result


def notes(run: Run) -> list:
    """Lines about the run for standard error: its phases, and with a
    trace the device seconds launched inside each span."""
    out = [f"phase {k} {v!r} s" for k, v in run.phase_s.items()]
    cap = run.capture
    if cap is not None:
        linked = sum(1 for op in cap.device_ops if op[3] is not None)
        out.append(f"trace {len(cap.device_ops)} device operations, "
                   f"{linked} linked to a launch")
        for span in sorted(cap.spans):
            out.append(f"span {span} {trace.span_device_ns(cap, span) / 1e9!r}"
                       f" device s, {len(cap.spans[span])} spans")
    return out


__all__ = ["Run", "Benchmark", "run_cell", "load_json"]
