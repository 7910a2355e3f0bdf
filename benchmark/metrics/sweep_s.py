"""sweep_s: the window's wall time, from its start to the end of its last
completed fit call, over the sweeps of its calls."""


def read(run):
    w = run.window
    if not w.get("sweeps"):
        return None
    return w["seconds"] / w["sweeps"]
