"""prove_ms: the window's milliseconds over the proofs completed in it."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.completed if w.completed else None
