"""idle_share.train: the device's idle share of the traced sweeps, in %: 1 − the
union of the intervals in which a device operation ran, over the traced
calls' wall time (one trace, not a sum of kernel times)."""

from benchmark import trace


def read(run):
    cap = run.capture
    if cap is None:
        return None
    win = trace.call_windows(cap)
    total = sum(e - s for s, e in win)
    busy = trace.busy_ns(cap, win)
    if total <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / total)
