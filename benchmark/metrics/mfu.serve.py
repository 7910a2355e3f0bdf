"""mfu.serve: a call's needed FLOP (2 · users · items · rank) over the
window's mean call time (host clock) over the peak FLOP rate, in %."""

from benchmark import work


def read(run):
    need = run.work.get("call")
    lat = run.window.get("latencies")
    if need is None or not lat:
        return None
    return work.mfu(need[0], sum(lat) / len(lat))
