"""gram_roofline.train: the least time of the bucket grams' needed work in a sweep
(``run.work["gram"]``) over the device time of the operations launched
inside the ``gram_rhs`` span, per traced sweep, in %."""

from benchmark import trace, work


def read(run):
    cap = run.capture
    need = run.work.get("gram")
    if cap is None or need is None or not run.traced_units:
        return None
    ns = trace.span_device_ns(cap, "gram_rhs")
    if ns <= 0:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
