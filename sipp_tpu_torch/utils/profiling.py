"""Timing and tracing for the port (sipp_tpu/utils/profiling.py's
counterpart): torch.profiler traces with the card's activity, and
steady-state timing that synchronizes the card around the timed calls."""

import contextlib
import json
import os
import sys
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block, the card's kernels and
    copies included where there is a card, and write it to
    log_dir/trace.json (Chrome trace format: chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_fn(fn, *args, reps: int = 3, warmup: int = 1, label: str = None):
    """Steady-state wall time of fn(*args): seconds per call, the card
    synchronized before the clock starts and after the last call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.time()
    for _ in range(reps):
        fn(*args)
    _sync()
    dt = (time.time() - t0) / reps
    if label:
        print(json.dumps({"label": label, "sec_per_call": dt}), file=sys.stderr)
    return dt
