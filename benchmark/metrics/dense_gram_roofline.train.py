"""dense_gram_roofline.train: the least time of the dense block's needed work in a sweep
(``run.work["dense"]``) over the device time of the operations launched
inside the ``dense_gram_rhs`` span, per traced sweep, in %."""

from benchmark import trace, work


def read(run):
    cap = run.capture
    need = run.work.get("dense")
    if cap is None or need is None or not run.traced_units:
        return None
    ns = trace.span_device_ns(cap, "dense_gram_rhs")
    if ns <= 0:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
