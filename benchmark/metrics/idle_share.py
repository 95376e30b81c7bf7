"""idle_share.<mix>: the share of the traced window in which no kernel,
copy or set ran on the device (torch.profiler), in percent."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
