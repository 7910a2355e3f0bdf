"""The port's observability utilities (``utils/logging.py``,
``utils/profiling.py``) against the JAX package's: the cases of
tests/test_utils_obs.py, with the JSONL records equal to the JAX logger's
apart from ``ts``, and ``trace_sweeps`` writing a ``torch.profiler`` Chrome
trace on the CPU."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from recommendation_models_tpu.utils.logging import (
    MetricsLogger as RefMetricsLogger)
from recommendation_models_tpu.utils.profiling import Timer as RefTimer
from recommendation_models_tpu_torch import utils as port_utils
from recommendation_models_tpu_torch.utils.logging import MetricsLogger
from recommendation_models_tpu_torch.utils.profiling import Timer, trace_sweeps

torch.set_num_threads(2)

RECORDS = [(1, dict(train_rmse=0.5, collective_bytes=123)),
           (2, dict(train_rmse=0.25)),
           (3, dict(train_rmse=np.float32(0.125).item(), fit_seconds=1.5,
                    note="text is kept", eval_users=7))]


def _records(cls, jsonl, tb=None):
    m = cls(str(jsonl), None if tb is None else str(tb))
    for step, rec in RECORDS:
        m.log(step, **rec)
    m.close()
    return [json.loads(line) for line in open(jsonl)]


def test_metrics_logger_jsonl_and_tensorboard(tmp_path):
    tb = tmp_path / "tb"
    lines = _records(MetricsLogger, tmp_path / "m.jsonl", tb)
    ref = _records(RefMetricsLogger, tmp_path / "ref.jsonl")
    assert [l["step"] for l in lines] == [1, 2, 3]
    assert lines[0]["train_rmse"] == 0.5
    assert lines[0]["collective_bytes"] == 123
    for got, want in zip(lines, ref):
        assert abs(got.pop("ts") - want.pop("ts")) < 60
        assert got == want
        assert list(got) == list(want)            # same key order too
    # tensorboard event files written when tensorboardX is importable
    if os.path.isdir(tb):
        assert any(os.scandir(tb))


def test_metrics_logger_appends_like_the_reference(tmp_path):
    jsonl = tmp_path / "sub" / "m.jsonl"          # parent made on demand
    _records(MetricsLogger, jsonl)
    assert len(_records(MetricsLogger, jsonl)) == 2 * len(RECORDS)


def test_metrics_logger_without_tensorboardx_warns(tmp_path, monkeypatch,
                                                   caplog):
    """The card's host has no tensorboardX: the logger warns and keeps the
    JSONL, as the reference does."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)   # import fails
    with caplog.at_level("WARNING", logger="recommendation_models_tpu_torch"):
        lines = _records(MetricsLogger, tmp_path / "m.jsonl",
                         tmp_path / "tb")
    assert [r.getMessage() for r in caplog.records] == [
        "tensorboardX unavailable; TB logging disabled"]
    assert len(lines) == len(RECORDS)
    assert not os.path.exists(tmp_path / "tb")


def test_metrics_logger_noop_paths():
    m = MetricsLogger(None, None)     # disabled sinks must be safe
    m.log(1, x=1.0)
    m.close()


def test_timer_rates():
    with Timer() as t, RefTimer() as ref:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    assert t.rows_per_sec(100) == 100 / t.elapsed
    assert t.rows_per_sec(100, n_chips=4) == 25 / t.elapsed
    assert t.rows_per_sec(100, n_chips=0) == 100 / t.elapsed
    assert ref.rows_per_sec(100, n_chips=0) == 100 / ref.elapsed


def test_trace_sweeps_writes_profile(tmp_path):
    d = tmp_path / "trace"
    with trace_sweeps(str(d)):
        (torch.ones((8, 8)) * 2).sum().item()
    found = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(found) == 1, os.listdir(d)
    with open(d / found[0]) as f:
        trace = json.load(f)
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert any(n and n.startswith("aten::mul") for n in names)


def test_trace_sweeps_none_is_noop(tmp_path):
    with trace_sweeps(None):
        pass
    with trace_sweeps(""):
        pass
    assert not os.listdir(tmp_path)


def test_utils_exports_the_reference_names():
    from recommendation_models_tpu import utils as ref_utils
    assert sorted(port_utils.__all__) == sorted(ref_utils.__all__)
    for name in port_utils.__all__:
        assert callable(getattr(port_utils, name))
