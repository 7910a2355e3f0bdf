"""grams_roofline.imc: the least time of a sweep's row grams (``run.work
["imc_grams"]``, ``work_imc.grams_work``: every rating's terms in both
halves) over the device time of the operations launched inside the port's
``imc.grams`` marks of the traced call, per traced sweep, in %."""

from benchmark import program_spans, work


def read(run):
    need = run.work.get("imc_grams")
    ns = program_spans.launched_ns(run, "imc.grams")
    if need is None or not ns or not run.traced_units:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
