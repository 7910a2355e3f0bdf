"""The port's spans and counters (``utils.profiling``) and the benchmark's
readers of them: the recorder's ring, totals, self time and ids; its two
clocks against the profiler's events and ``time.perf_counter``; what a
span and an inactive mark may not call; the sites in a CPU ``ALS.fit``,
``recommend`` and kernel build; the benchmark's own wraps still finding
the port's functions; and each of the seven per-layer metrics that read
the recorder, on a made-up run."""

import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark import harness, program_spans, trace, work
from benchmark.conftest import TINY
from recommendation_models_tpu_torch.data.layout import csr_arrays
from recommendation_models_tpu_torch.models.als import ALS
from recommendation_models_tpu_torch.ops import build as kbuild
from recommendation_models_tpu_torch.ops.cholesky import block_batch
from recommendation_models_tpu_torch.utils import profiling
from recommendation_models_tpu_torch.utils.profiling import Recorder

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
# what a profiler reader takes for its own ranges and for CUDA API calls
RESERVED = ("bench.", "cu")


def names(recs):
    return [r.name for r in recs]


# -- the recorder ---------------------------------------------------------

@pytest.mark.parametrize("n_spans,ring_size", [(3, 4), (4, 4), (9, 4)])
def test_ring_keeps_the_last_records_and_totals_keep_all(n_spans,
                                                          ring_size):
    rec = Recorder(ring_size)
    for _ in range(n_spans):
        with rec.span("x"):
            pass
    kept = rec.recent("x")
    assert len(kept) == min(n_spans, ring_size)
    assert [r.id for r in kept] == list(range(n_spans - len(kept) + 1,
                                              n_spans + 1))
    assert rec.summary()["spans"]["x"]["count"] == n_spans
    rec.reset()
    assert rec.recent() == [] and rec.summary()["spans"] == {}


def test_totals_self_time_parent_and_call_ids():
    rec = Recorder()
    with rec.span("outer") as outer:
        with rec.span("call", call=True) as call:
            with rec.span("inner") as inner:
                time.sleep(0.002)
            with rec.span("inner"):
                pass
        time.sleep(0.001)
    by = {r.id: r for r in rec.recent()}
    assert names(rec.recent()) == ["inner", "inner", "call", "outer"]
    assert by[outer.id].parent == 0 and by[outer.id].call == 0
    assert by[call.id].parent == outer.id and by[call.id].call == call.id
    assert by[inner.id].parent == call.id and by[inner.id].call == call.id
    s = rec.summary()["spans"]
    dur = {r.id: r.pc_end_ns - r.pc_start_ns for r in rec.recent()}
    inners = sum(d for i, d in dur.items() if by[i].name == "inner")
    assert s["inner"] == {"count": 2, "total_ns": inners,
                          "self_ns": inners}
    assert s["call"]["self_ns"] == dur[call.id] - inners
    assert s["outer"]["self_ns"] == dur[outer.id] - dur[call.id]
    assert s["outer"]["self_ns"] >= 1_000_000
    for r in rec.recent():
        assert r.start_ns <= r.end_ns and r.pc_start_ns <= r.pc_end_ns


def test_counters_and_the_kernel_launch_counts():
    from recommendation_models_tpu_torch.ops import cholesky, gather
    rec = Recorder()
    rec.count("a")
    rec.count("a", 3)
    c = rec.summary()["counters"]
    assert c["a"] == 4
    for kernel, n in cholesky.LAUNCHES.items():
        assert c[f"ops.cholesky.LAUNCHES.{kernel}"] == n
    for kernel, n in cholesky.ROUTED.items():
        assert c[f"ops.cholesky.ROUTED.{kernel}"] == n
    assert (c["ops.gather.LAUNCHES.gather_rows_sum"]
            == gather.LAUNCHES["gather_rows_sum"])


def test_threads_nest_their_own_spans():
    rec = Recorder()
    errors = []

    def work_():
        try:
            for _ in range(200):
                with rec.span("t", call=True) as t:
                    with rec.span("u") as u:
                        pass
                assert u.parent == t.id and u.call == t.id
        except AssertionError as exc:       # reported by the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work_)
                   for _ in range(2 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    s = rec.summary()["spans"]
    assert s["t"]["count"] == s["u"]["count"] == 200 * len(threads)
    ids = {r.id: r for r in rec.recent()}
    assert all(ids[r.parent].name == "t" for r in rec.recent()
               if r.name == "u")


def test_both_clocks_hold_what_ran_inside():
    from torch.profiler import ProfilerActivity, profile
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("s"):
            torch.ones(1000).sum()
            t = time.perf_counter()
    (r,) = rec.recent("s")
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::sum"]
    assert evs and all(r.start_ns <= e.start_ns() <= e.end_ns() <= r.end_ns
                       for e in evs)
    assert r.pc_start_ns <= t * 1e9 <= r.pc_end_ns


def test_a_span_and_an_inactive_mark_call_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called")
    for mod, attr in ((torch.cuda, "synchronize"),
                      (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch, "tensor"), (torch, "zeros"), (torch, "empty")):
        monkeypatch.setattr(mod, attr, refuse)
    rec = Recorder()
    assert not torch.autograd._profiler_enabled()
    with rec.mark("m"):
        pass
    with rec.span("s"):
        pass
    assert names(rec.recent()) == ["s"]
    assert "m" not in rec.summary()["spans"]


def test_a_mark_is_written_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.mark("m"):
            pass
    assert names(rec.recent()) == ["m"]


def test_trace_sweeps_writes_the_spans_on_the_traces_clock(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace_sweeps(str(d)):
        with profiling.span("block"):
            (torch.ones((64, 64)) * 2).sum()
    (chrome,) = d.glob("*.pt.trace.json")
    (spans,) = d.glob("*.spans.json")
    assert spans.name == chrome.name.replace(".pt.trace.json",
                                             ".spans.json")
    t, s = json.loads(chrome.read_text()), json.loads(spans.read_text())
    assert s["baseTimeNanoseconds"] == t["baseTimeNanoseconds"]
    (block,) = [e for e in s["traceEvents"] if e["name"] == "block"]
    mul = [e for e in t["traceEvents"]
           if e.get("name", "").startswith("aten::mul")]
    assert mul and all(block["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= block["ts"] + block["dur"] for e in mul)


# -- the sites ------------------------------------------------------------

def ratings(n_users=120, n_items=80, n_obs=2400, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_obs)
    i = rng.integers(0, n_items, n_obs)
    key = np.unique(u * n_items + i)
    u, i = key // n_items, key % n_items
    r = rng.integers(1, 11, u.shape[0]) / 2.0
    return sp.csr_matrix((r.astype(np.float32), (u, i)),
                         shape=(n_users, n_items))


@pytest.fixture
def fresh():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("profiled", [False, True])
def test_a_fit_records_its_sweeps_and_gather_counts(fresh, profiled):
    from torch.profiler import ProfilerActivity, profile
    R = ratings()
    n = 3
    est = ALS(rank=8, n_sweeps=n, platform="cpu", hot_cols=0,
              dense_min_degree=10 ** 9, sse_mode="separate")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            est.fit(R)
    else:
        est.fit(R)
    s = fresh.summary()
    count = {k: v["count"] for k, v in s["spans"].items()}
    assert count["als.fit"] == 1 and count["als.sweep"] == n
    assert count["als.half_sweep"] == 2 * n and count["als.sse"] == n
    assert count["layout.build"] == 1
    assert ("als.grams" in count) == ("als.solves" in count) == profiled
    recs = fresh.recent()
    by = {r.id: r for r in recs}
    (fit,) = [r for r in recs if r.name == "als.fit"]
    assert all(r.call == fit.id for r in recs if r.name.startswith("als."))
    for r in recs:
        if r.name in ("als.grams", "als.solves"):
            assert by[r.parent].name == "als.half_sweep"
    assert not any(r.name.startswith(RESERVED) for r in recs)
    # every rating sits in a gather bucket of each orientation (no dense
    # block, no hot columns): each half-sweep walks them once
    ul, il = est._build_layouts(*csr_arrays(R), est._data_config())
    assert ul.dense_ids is None and il.dense_ids is None
    mult = block_batch(8)
    slots = sum(-(-b.indices.shape[0] // m) * m * b.indices.shape[1]
                for lay in (ul, il) for b in lay.buckets
                for m in [mult if b.indices.shape[0] >= mult else 8])
    assert s["counters"]["als.gather_ratings"] == 2 * n * R.nnz
    assert s["counters"]["als.gather_slots"] == n * slots


def serving_estimator(degrees, n_items=300, rank=4, seed=1):
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    indices = np.concatenate([rng.choice(n_items, d, replace=False)
                              for d in degrees]).astype(np.int32)
    U = rng.standard_normal((len(degrees), rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    state = {"U_": U, "V_": V, "n_users_": U.shape[0],
             "n_items_": n_items, "history_": [],
             "params": {"rank": rank, "reg": 0.1, "platform": "cpu"}}
    return ALS.from_reference_state(state, train_indptr=indptr,
                                    train_indices=indices)


@pytest.mark.parametrize("exclude_seen", [False, True])
def test_recommend_records_its_phases_per_level_and_call(fresh,
                                                         exclude_seen):
    # degrees at two of the overfetch path's exclusion levels (32 and
    # 128); the masked path serves them all in one pass
    degrees = [5, 20, 32, 40, 100, 7]
    est = serving_estimator(degrees)
    users = np.arange(len(degrees))
    est.recommend(users, 5, exclude_seen)
    s = fresh.summary()
    count = {k: v["count"] for k, v in s["spans"].items()}
    assert count["serve.recommend"] == 1
    # one exclusion step a call: the degrees and the pairs on the device
    assert count.get("serve.exclusions", 0) == (1 if exclude_seen else 0)
    for phase in ("serve.upload", "serve.select", "serve.readback"):
        assert count[phase] == 1
    assert s["counters"]["serve.users"] == len(degrees)
    assert (s["counters"].get("serve.exclusion_ids", 0)
            == (sum(degrees) if exclude_seen else 0))
    # every degree is at most n_items - n: no user takes the overfetch path
    assert s["counters"].get("serve.exclusion_fallback_users", 0) == 0
    recs = fresh.recent()
    (call,) = [r for r in recs if r.name == "serve.recommend"]
    assert call.call == call.id
    assert all(r.call == call.id for r in recs)
    assert not any(r.name.startswith(RESERVED) for r in recs)


def test_a_kernel_build_is_one_span_and_counts_its_sources(fresh,
                                                           monkeypatch,
                                                           tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kbuild, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    kbuild.build("gather", "cholesky_solve")
    kbuild.build("gather")                       # built: no nvcc, no span
    s = fresh.summary()
    assert s["spans"]["kernels.build"]["count"] == 1
    assert s["counters"]["kernels.built"] == 2


@pytest.fixture(scope="module")
def tiny_program():
    """The tiny benchmark configuration (a dense item block, hot columns,
    several buckets) through the train runner's set-up, on the CPU."""
    from benchmark.runners import als_train
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "als-ml25m-r64.json").read_text())
    cfg.update(TINY)
    dev = torch.device("cpu")
    coo, U0, V0 = als_train.inputs(cfg, 5, dev)
    _, dcfg, scfg = als_train.program(cfg, dev)
    # the SSE pass of the rank-64 cell (the tiny size lets it ride)
    scfg = dataclasses.replace(scfg, sse_mode="separate")
    fit = als_train.build(cfg, coo, dev, dcfg, scfg, 1)[0]
    return cfg, fit, U0, V0


@pytest.mark.parametrize("traffic", ["train", "serve"])
def test_the_benchmarks_wraps_still_find_the_ports_functions(traffic,
                                                             tiny_program):
    cfg, fit, U0, V0 = tiny_program
    wraps = json.loads((REPO / "benchmark" / "traffic" /
                        f"{traffic}.json").read_text())["spans"]
    if traffic == "train":
        def call():
            with torch.profiler.record_function(trace.PREFIX + "call"):
                fit(U0.clone(), V0.clone())
    else:
        from benchmark.runners import als_serve
        indptr, indices, U, V, order = als_serve.inputs(cfg, 5,
                                                        torch.device("cpu"))
        est = als_serve.program(cfg, torch.device("cpu"), indptr, indices,
                                U, V)

        def call():
            with torch.profiler.record_function(trace.PREFIX + "call"):
                est.recommend(order[:64], 10, True)
    with trace.spans(wraps):
        cap = trace.capture(call, cuda=False)
    if traffic == "train":
        assert set(cap.spans) == {"call"} | {w[2] for w in wraps}
    else:
        # the masked exclusion selects through topk_scores; only users
        # with fewer than n unseen items take grouped_exclusion_topk, which
        # stays an attribute of models.als for trace.spans' getattr above
        assert set(cap.spans) == {"call", "topk_scores"}
    # the wraps are gone after the block
    for mod_name, attr, _ in wraps:
        fn = getattr(sys.modules[mod_name], attr)
        assert not hasattr(fn, "__wrapped__")


# -- the seven readers ----------------------------------------------------

S = 1_000_000_000     # ns in a second


def rec(name, pc, prof=(0, 0), id_=0):
    return profiling.SpanRecord(name, prof[0], prof[1], pc[0], pc[1], id_,
                                0, 0)


# the window's two calls: [1 s, 2 s) and [2 s, 3 s); the traced call at
# [100, 1000) ns on the profiler's clock, after them
RING = [
    rec("layout.build", (S // 10, S // 5), (10, 50)),
    rec("als.sweep", (S + S // 10, S + 3 * S // 10)),             # 200 ms
    rec("als.sweep", (2 * S + S // 10, 2 * S + S // 2)),          # 400 ms
    rec("serve.recommend", (S + 1, S + 9 * S // 10)),
    rec("serve.exclusions", (S + S // 10, S + 15 * S // 100)),    # 50 ms
    rec("serve.exclusions", (S + S // 5, S + 22 * S // 100)),     # 20 ms
    rec("serve.readback", (S + S // 2, S + 51 * S // 100)),       # 10 ms
    rec("serve.recommend", (2 * S + 1, 2 * S + 9 * S // 10)),
    rec("serve.exclusions", (2 * S + S // 10, 2 * S + 13 * S // 100)),
    rec("serve.readback", (2 * S + S // 2, 2 * S + 53 * S // 100)),
    # the traced call (outside the window)
    rec("als.sweep", (4 * S, 5 * S), (150, 900)),
    rec("serve.readback", (4 * S, 4 * S + S // 2), (150, 900)),
    rec("als.grams", (4 * S, 4 * S), (110, 200)),
    rec("als.grams", (4 * S, 4 * S), (300, 400)),
    rec("als.grams", (4 * S, 4 * S), (1100, 1200)),     # after the call
    rec("als.dense", (4 * S, 4 * S), (500, 700)),
]
SUMMARY = {"spans": {"als.sweep": {"count": 4, "total_ns": 0,
                                   "self_ns": 0}},
           "counters": {"ops.cholesky.LAUNCHES.cholesky_solve_batched": 30,
                        "ops.cholesky.LAUNCHES.cholesky_solve_hot": 10,
                        "ops.cholesky.ROUTED.cholesky_solve_batched": 99,
                        "als.gather_ratings": 30, "als.gather_slots": 120}}
GRAM, DENSE = (2e6, 3e6), (5e6, 1e6)      # needed (FLOP, bytes)


def capture():
    """Device operations: k1 and k2 launched in the grams marks (50 + 100
    ns), k3 in the mark after the call, d1 and a copy in the dense span
    (100 + 10 ns), k4 outside every mark."""
    return trace.Capture(
        device_ops=[("k1", 120, 170, 150), ("k2", 320, 420, 350),
                    ("d1", 550, 650, 600), ("Memcpy", 660, 670, 650),
                    ("k4", 720, 800, 710), ("k3", 1150, 1190, 1150)],
        spans={"call": [(100, 1000)]}, host_ops=[])


def run(window=True, cap=True):
    r = harness.Run(name="x", cell={}, config={}, traffic={}, limits={},
                    seed=0, seconds=1.0, trace=True,
                    device=torch.device("cpu"), t_start=0.0)
    if window:
        r.window = {"calls": [(1.0, 2.0, 10, True), (2.0, 3.0, 10, True)]}
    r.capture = capture() if cap else None
    r.traced_units = 2
    r.work = {"gram": GRAM, "dense": DENSE}
    return r


class FakeRecorder:
    def __init__(self, ring, summary=SUMMARY):
        self.ring, self.summary_ = ring, summary

    def recent(self, name=None):
        return [r for r in self.ring if name is None or r.name == name]

    def summary(self):
        return self.summary_


EXPECTED = {
    "enqueue_ms.train": 300.0,
    "exclusion_build_ms.serve": (50 + 20 + 30) / 2,
    "result_wait_ms.serve": (10 + 30) / 2,
    "bucket_grams_roofline.train": work.roofline_share(*GRAM, 150e-9 / 2),
    "dense_block_roofline.train": work.roofline_share(*DENSE, 110e-9 / 2),
    "solve_launches_per_sweep.train": 40 / 4,
    "gather_useful_share.train": 25.0,
}
RING_METRICS = ("enqueue_ms.train", "exclusion_build_ms.serve",
                "result_wait_ms.serve")
TRACE_METRICS = ("bucket_grams_roofline.train",
                 "dense_block_roofline.train")


def reader(metric):
    return harness.Benchmark(REPO).reader(metric)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_the_made_up_run(metric, monkeypatch):
    monkeypatch.setattr(program_spans, "profiling",
                        lambda: FakeRecorder(RING))
    assert reader(metric)(run()) == pytest.approx(EXPECTED[metric],
                                                  rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_nothing_where_its_data_is_missing(metric,
                                                        monkeypatch):
    read = reader(metric)
    # a program without the recorder
    monkeypatch.setattr(program_spans, "profiling", lambda: None)
    assert read(run()) is None
    # an overflowed ring, holding the traced call's records alone: its
    # oldest record closed after the window's and the traced call's start
    monkeypatch.setattr(program_spans, "profiling",
                        lambda: FakeRecorder(RING[10:]))
    if metric in RING_METRICS + TRACE_METRICS:
        assert read(run()) is None
    # an empty capture and an empty window
    monkeypatch.setattr(program_spans, "profiling",
                        lambda: FakeRecorder(RING))
    if metric in TRACE_METRICS:
        assert read(run(cap=False)) is None
        empty = run()
        empty.capture = empty.capture._replace(spans={})
        assert read(empty) is None
    if metric in RING_METRICS:
        assert read(run(window=False)) is None
    # counters of nothing
    monkeypatch.setattr(program_spans, "profiling", lambda: FakeRecorder(
        RING, {"spans": {}, "counters": {}}))
    if metric not in RING_METRICS + TRACE_METRICS:
        assert read(run()) is None


def test_the_new_metrics_are_entries_of_the_benchmark():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for metric in EXPECTED:
        m = entries[metric]
        assert (m["source"] == "device_trace") == (metric in TRACE_METRICS)
        assert m["workloads"]
        assert (REPO / "benchmark" / "metrics" / f"{metric}.py").exists()
