"""The gather latency probe's host-side pieces: the bytes bound, the L2
bound, the TB/s and per-call device-time arithmetic it states beside each
shape, and its run on the CPU at a small size."""

import json

import pytest
import torch

from recommendation_models_tpu_torch.probes import gather_latency as gl

torch.set_num_threads(2)


@pytest.mark.parametrize("distinct,n,k", [
    (62_423, 200_000, 128),        # the probe: every table row touched
    (1_234, 6_144, 64),
    (0, 0, 64),                    # no ids: the output alone
])
def test_bytes_bound_counts_each_distinct_row_once(distinct, n, k):
    want = 4.0 * (distinct * k + n + k) / 3.35e12 * 1e3
    assert gl.bytes_bound_ms(distinct, n, k) == pytest.approx(want)


@pytest.mark.parametrize("n,k,rate,ms", [
    (200_000, 128, 5e12, 200_000 * 512 / 5e12 * 1e3),
    (14_400_000, 64, 4e12, 14_400_000 * 256 / 4e12 * 1e3),
    (0, 64, 4e12, 0.0),
])
def test_l2_bound_counts_every_gathered_row(n, k, rate, ms):
    assert gl.l2_bound_ms(n, k, rate) == pytest.approx(ms)


@pytest.mark.parametrize("n,k,ms,tbs", [
    (14_400_000, 64, 1.832, 14_400_000 * 256 / 1.832e-3 / 1e12),
    (200_000, 128, 0.0371, 200_000 * 512 / 0.0371e-3 / 1e12),
])
def test_tb_s_is_gathered_bytes_over_device_time(n, k, ms, tbs):
    assert gl.tb_s(n, k, ms) == pytest.approx(tbs)


@pytest.mark.parametrize("rows,calls,us,per", [
    ([(300.0, 10, "gather_sum_kernel"), (40.0, 10, "gather_finish_kernel")],
     10, {"gather_sum_kernel": 30.0, "gather_finish_kernel": 4.0}, 2),
    ([(30.0, 10, "gather_sum_kernel")], 10, {"gather_sum_kernel": 3.0}, 1),
    ([(64.0, 640, "a"), (36.0, 1280, "b")], 640,
     {"a": 0.1, "b": 36.0 / 640}, 3),
    # the profiler dropped 2 of 5 calls: the mean over the recorded ones
    ([(3000.0, 3, "gather_sum_kernel")], 5, {"gather_sum_kernel": 1000.0},
     1),
])
def test_per_call_splits_device_time_by_kernel(rows, calls, us, per):
    got, n = gl.per_call(rows, calls)
    assert got == pytest.approx(us) and n == per


def test_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(gl.torch.cuda, "is_available", lambda: False)
    assert gl.main(["--shapes", "probe"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_probe_refuses_unknown_shapes():
    with pytest.raises(SystemExit):
        gl.main(["--shapes", "probe,bogus", "--platform", "cpu"])


def test_probe_runs_on_cpu_at_a_small_size(capsys):
    """Every shape at the tiny scale, untimed: the wrapper agrees with its
    plain version and each line carries its bytes bound, and no device
    metric is written."""
    assert gl.main(["--platform", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    head, rows = lines[0], lines[1:]
    assert head["device"] == "cpu" and "l2_read_tb_s" not in head
    shapes = [r["shape"] for r in rows]
    assert shapes == ["probe"] * 3 + ["user_block", "user_blocks",
                                      "item_block", "item_blocks",
                                      "user_half", "item_half"]
    for r in rows:
        assert r["agrees"] and r["bytes_bound_ms"] > 0
        assert "device_ms" not in r and "event_ms" not in r
    blocks = {r["shape"]: r for r in rows}
    # the row blocks of a half cover its ids
    for tag in ("user", "item"):
        assert blocks[f"{tag}_blocks"]["n_gather"] == \
            blocks[f"{tag}_half"]["n_gather"]
        assert blocks[f"{tag}_blocks"]["calls"] == blocks[f"{tag}_block"][
            "blocks"]


@pytest.mark.parametrize("empty_runs,ok", [
    (0, True),
    (2, True),         # two runs with nothing recorded, the third has it
    (3, False),        # none of the runs recorded anything
])
def test_device_rows_profiles_again_when_nothing_was_recorded(
        monkeypatch, empty_runs, ok):
    """``device_rows`` profiles a run again when the profiler recorded no
    device activity, up to ``PROFILE_TRIES`` (3) runs, and raises when none
    did."""
    import torch.profiler
    from recommendation_models_tpu_torch import probes

    class Ev:
        device_type = torch.autograd.DeviceType.CUDA
        self_device_time_total = 30.0
        count = 10
        key = "gather_sum_kernel"

    runs = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            runs.append(1)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [] if len(runs) <= empty_runs else [Ev()]

    calls = []
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    fn = lambda: calls.append(1)                       # noqa: E731
    if ok:
        rows = probes.device_rows(fn, reps=10, warm=1)
        assert rows == [(30.0, 10, "gather_sum_kernel")]
        assert len(runs) == empty_runs + 1
    else:
        with pytest.raises(RuntimeError, match="no device time"):
            probes.device_rows(fn, reps=10, warm=1)
        assert len(runs) == probes.PROFILE_TRIES == 3
    assert len(calls) == 1 + 10 * len(runs)
