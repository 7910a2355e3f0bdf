"""dense_block_roofline.train: the least time of the dense block's needed
work in a sweep (``run.work["dense"]``) over the device time of the
operations launched inside the port's ``als.dense`` spans of the traced
call (the block's grams, solve and scatter), per traced sweep, in %."""

from benchmark import program_spans, work


def read(run):
    need = run.work.get("dense")
    ns = program_spans.launched_ns(run, "als.dense")
    if need is None or not ns or not run.traced_units:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
