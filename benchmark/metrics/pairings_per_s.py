"""pairings_per_s: n pairings times the aggregations completed in the window,
over the window's seconds."""


def read(run):
    w = run.window
    return run.config["n"] * w.completed / w.seconds if w.completed else None
