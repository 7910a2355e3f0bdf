"""kernels_per_sweep.train: kernel records (copies and fills left out) in
the traced fit call, over its sweeps."""

from benchmark import trace


def read(run):
    cap = run.capture
    if cap is None or not run.traced_units:
        return None
    n = len(trace.ops_in(cap, trace.call_windows(cap), kernels_only=True))
    if n == 0:
        return None
    return n / run.traced_units
