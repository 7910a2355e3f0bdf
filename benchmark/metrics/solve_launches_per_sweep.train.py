"""solve_launches_per_sweep.train: the port's solve kernel launches
(``ops.cholesky.LAUNCHES``) over its ``als.sweep`` spans, both counted over
the whole process (every sweep in it has the cell's shape)."""

from benchmark import program_spans

PREFIX = "ops.cholesky.LAUNCHES."


def read(run):
    s = program_spans.totals()
    if s is None:
        return None
    sweeps = s["spans"].get("als.sweep", {}).get("count", 0)
    if not sweeps:
        return None
    launches = sum(n for name, n in s["counters"].items()
                   if name.startswith(PREFIX))
    return launches / sweeps
