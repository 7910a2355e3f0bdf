"""cg_roofline.imc: the least time of a sweep's CG work (``run.work
["imc_cg"]``, ``work_imc.cg_work``: both halves' operator passes and
objective's passes) over the device time of the operations launched inside
the port's ``imc.cg`` marks of the traced call, per traced sweep, in %."""

from benchmark import program_spans, work


def read(run):
    need = run.work.get("imc_cg")
    ns = program_spans.launched_ns(run, "imc.cg")
    if need is None or not ns or not run.traced_units:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
