"""The spread that bounds are set from: quartiles as
``statistics.quantiles(values, n=4)`` gives them, over the median."""

from __future__ import annotations

import statistics

import pytest

from benchmark import spread


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert spread.spread(vals) == (med, (q3 - q1) / med)


def test_summary_takes_the_wider_set_and_floors_the_bound():
    def run(s, v, trace=0):
        return {"set": s, "trace": trace,
                "result": {"metrics": {"sweep_s": {"value": v}}}}
    runs = ([run(0, v) for v in (1.0, 1.001, 0.999, 1.0)]
            + [run(1, v) for v in (1.0, 1.1, 0.9, 1.0)]
            + [run(-1, 5.0, trace=1)])
    got = spread.summarize(runs, 2)["sweep_s"]
    assert [len(s["values"]) for s in got["sets"]] == [4, 4]
    assert got["widest_spread"] == pytest.approx(spread.spread(
        [1.0, 1.1, 0.9, 1.0])[1])
    assert got["bound_5x"] == pytest.approx(5 * got["widest_spread"])
    tight = spread.summarize([run(0, 1.0), run(0, 1.0)], 1)["sweep_s"]
    assert tight["bound_5x"] == 0.01
