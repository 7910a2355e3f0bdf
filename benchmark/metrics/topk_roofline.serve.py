"""topk_roofline.serve: the least time of a call's needed work
(``run.work["call"]``, ``work.topk_work``) over the call's device time (the
union of its device operations), per traced call, in %."""

from benchmark import trace, work


def read(run):
    cap = run.capture
    need = run.work.get("call")
    if cap is None or need is None or not run.traced_units:
        return None
    ns = trace.busy_ns(cap, trace.call_windows(cap))
    if ns <= 0:
        return None
    return work.roofline_share(*need, ns / 1e9 / run.traced_units)
