"""mfu.train: needed FLOP of a sweep (``work.sweep_flops``) over the run's
own ``sweep_s`` over the peak FLOP rate, in %."""

from benchmark import work


def read(run):
    w = run.window
    flops = run.work.get("sweep_flops")
    if flops is None or not w.get("sweeps"):
        return None
    return work.mfu(flops, w["seconds"] / w["sweeps"])
