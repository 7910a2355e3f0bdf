"""train_ratings_per_s: ratings swept per second over the window: the
configuration's ratings times the sweeps of the window's completed fit
calls, over the window's wall time (the rate ``sweep_s`` gives, under a
bound of its own for the cells where the card sets the pace)."""


def read(run):
    w = run.window
    if not w.get("sweeps"):
        return None
    return int(run.config["n_ratings"]) * w["sweeps"] / w["seconds"]
