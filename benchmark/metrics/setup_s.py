"""setup_s: seconds from the process's start to the window's start (imports,
the kernels' build or load, the instances, their upload, the warm-up)."""


def read(run):
    return run.setup_s
