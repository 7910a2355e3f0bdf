"""recommend_users_per_s: users served in the window over the window's
time, up to the end of its last completed ``recommend`` call."""


def read(run):
    w = run.window
    if not w.get("users"):
        return None
    return w["users"] / w["seconds"]
