"""enqueue_ms.imc: the mean host ms of the port's ``imc.sweep`` spans
inside the window's fit calls (perf-counter clock; no profiler runs in the
window): what the host spends on an IMC sweep, against ``sweep_s``."""

from benchmark import program_spans


def read(run):
    recs = program_spans.in_window(run, "imc.sweep")
    if not recs:
        return None
    return sum(r.pc_end_ns - r.pc_start_ns for r in recs) / 1e6 / len(recs)
