"""The solve-variant latency probe's host-side pieces: the residency its
register counts allow, its reading of an ``nvcc -Xptxas -v`` log, and the
bound it states beside each kernel."""

import pytest

from recommendation_models_tpu_torch.probes import variant_latency as vl

# the shape of ptxas's report for two kernels (trimmed)
LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117rank_panel_kernelILi160ELi1ELi3ELi1ELi1EEEvPKfS2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117rank_panel_kernelILi160ELi1ELi3ELi1ELi1EEEvPKfS2_S2_Pfiiii
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114variant_kernelILi256ELi3ELi16ELi2EEEvPKfS2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114variant_kernelILi256ELi3ELi16ELi2EEEvPKfS2_S2_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem, 376 bytes cmem[0]
"""


@pytest.mark.parametrize("regs,threads,blocks", [
    (48, 160, 8), (63, 160, 6), (40, 160, 10), (72, 160, 5),
    (128, 256, 2), (146, 256, 1), (48, 192, 7), (112, 288, 2),
    (113, 288, 1),
    (16, 32, 32),
])
def test_resident_by_registers(regs, threads, blocks):
    assert vl.resident_by_registers(regs, threads) == blocks


def test_parse_ptxas_reads_each_kernel():
    rows = vl.parse_ptxas(LOG)
    assert [r["registers"] for r in rows] == [48, 128]
    assert [r["spill_bytes"] for r in rows] == [[8, 12], [0, 0]]
    assert [r["static_smem"] for r in rows] == [0, 16]
    # the rank/panel kernel's block is its factor threads and one warp
    assert [r["threads"] for r in rows] == [192, 256]
    assert [r["resident_by_registers"] for r in rows] == [7, 2]


def test_parse_ptxas_counts_the_dual_kernels_two_warps():
    """The dual schedule (SCHED 32, the fourth template argument after
    NTH, NT and NQ) adds a substitution warp per system."""
    log = LOG.replace("ILi160ELi1ELi3ELi1ELi1E", "ILi160ELi1ELi3ELi32ELi2E")
    rows = vl.parse_ptxas(log)
    assert rows[0]["threads"] == 224
    assert rows[0]["resident_by_registers"] == vl.resident_by_registers(48,
                                                                       224)


def test_parse_ptxas_reads_the_panel_frame_of_the_rank_schedules():
    """Past kp = 128 B4 and B5c run the panel frame with every term alone
    (``ALONE``, schedule code 64): one system and one substitution warp a
    block, <224, 4> factor threads, so 256 threads, the dual's too."""
    log = LOG.replace("ILi160ELi1ELi3ELi1ELi1E", "ILi224ELi4ELi5ELi64ELi2E")
    rows = vl.parse_ptxas(log)
    assert rows[0]["threads"] == 256
    assert rows[0]["resident_by_registers"] == vl.resident_by_registers(48,
                                                                       256)


def test_parse_ptxas_reads_the_one_block_variant_kernels():
    """``clu::cluster_solve_kernel<SCHED, SROWS, TWO_G>`` (csrc/
    cholesky_cluster.cuh, instantiated in cholesky_large_variants.cu and
    cholesky_large.cu): its template arguments are its schedule, and its
    block is 256 threads."""
    log = LOG.replace(
        "_ZN12_GLOBAL__N_117rank_panel_kernelILi160ELi1ELi3ELi1ELi1EEEvPKfS2_"
        "S2_Pfiiii", "_ZN3clu20cluster_solve_kernelILi16ELi2ELb0EEEvNS_4ArgsE")
    rows = vl.parse_ptxas(log)
    assert rows[0]["threads"] == 256
    assert rows[0]["resident_by_registers"] == vl.resident_by_registers(48,
                                                                       256)


@pytest.mark.parametrize("k,b,by", [(64, 65_536, "bytes"),
                                    (128, 65_536, "operations"),
                                    (64, 256, "bytes")])
def test_bound_is_the_larger_of_bytes_and_operations(k, b, by):
    ms, got = vl.bound_ms(b, k)
    t_bytes = 4.0 * b * (k * (k + 1) / 2 + 2 * k + 1) / 3.35e12 * 1e3
    t_ops = b * (k ** 3 / 3 + 2 * k * k) / 67e12 * 1e3
    assert got == by
    assert ms == pytest.approx(max(t_bytes, t_ops))


def test_probe_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(vl.torch.cuda, "is_available", lambda: False)
    assert vl.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("rows,ms", [
    ([(3000.0, 3, "k")], 1.0),                      # every call recorded
    ([(2000.0, 6, "a"), (1000.0, 3, "b")], 1.0),    # two kernels a call
    ([(1000.0, 1, "k")], None),                     # calls dropped
    ([(2000.0, 5, "a"), (1000.0, 3, "b")], None),   # not whole calls
])
def test_device_ms_is_null_where_the_profiler_dropped_calls(monkeypatch,
                                                            rows, ms):
    monkeypatch.setattr(vl, "device_rows", lambda fn, reps: rows)
    assert vl.device_ms(lambda: None, 3) == ms


def test_device_ms_is_null_without_device_time(monkeypatch):
    def no_rows(fn, reps):
        raise RuntimeError("torch.profiler recorded no device time")
    monkeypatch.setattr(vl, "device_rows", no_rows)
    assert vl.device_ms(lambda: None, 3) is None
