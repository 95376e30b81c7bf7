"""The traced slice of a `--trace 1` run: torch.profiler over the window's
trailing `trace_seconds`, reduced in memory (nothing is written to disk) to
the device's busy time, the device time by kernel, the idle gaps labelled by
what the host was doing, and the program's counters over the slice.

The host's spans are the benchmark's own record_function spans around each
call into the program and each fetch of its output (`<entry>.call`,
`<entry>.fetch`), inside WINDOW; no span sits inside the program.
"""

import collections
import contextlib
import sys
import warnings

WINDOW = "sippbench.window"


def program_counters():
    """Every int attribute named `*launches` on a function of a loaded
    sipp_tpu_torch module: the kernel wrappers' launch counts."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] != "sipp_tpu_torch" or mod is None:
            continue
        for fname, fn in vars(mod).items():
            if not callable(fn) or getattr(fn, "__module__", None) != name:
                continue
            for attr, v in getattr(fn, "__dict__", {}).items():
                if attr.endswith("launches") and isinstance(v, int):
                    out[f"{name}.{fname}.{attr}"] = v
    return out


def short_name(name):
    """A kernel's name without its return type and parameters: up to the
    first "(" outside template brackets."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name if len(name) <= 80 else name.split("<")[0] + "<...>"


class Tracer:
    def __init__(self, seconds, spans, device):
        import torch
        from torch.profiler import ProfilerActivity

        self.seconds, self.spans, self.device = seconds, set(spans) | {WINDOW}, device
        self.activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self.torch = torch
        self.first = None

    def warm(self, fn):
        """Profile fn once, so that the profiler's own start-up falls in the
        set-up."""
        from torch.profiler import profile

        with profile(activities=self.activities):
            fn()
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def start(self, op_index):
        from torch.profiler import profile, record_function

        self.first = op_index
        self.counters = program_counters()
        self.prof = profile(activities=self.activities)
        self.prof.start()
        self.span = record_function(WINDOW)
        self.span.__enter__()

    def stop(self):
        self._sync()
        self.span.__exit__(None, None, None)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Warning: Profiler clears events")
            self.prof.stop()
        after = program_counters()
        self.counters = {k: v - self.counters.get(k, 0) for k, v in after.items()
                         if v != self.counters.get(k, 0)}

    def result(self, records):
        """The Trace of the traced ops (records[self.first:])."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        window = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if not window:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        device, host = [], []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA and e.name not in self.spans:
                if t > w0 and s < w1:
                    device.append((short_name(e.name), max(s, w0), min(t, w1)))
            elif e.device_type == DeviceType.CPU and e.name != WINDOW:
                host.append((e.name, s, t))
        ops = [r for r in records[self.first:] if r.out is not None]
        return Trace(w0, w1, device, host, ops, self.counters, self.spans)


class Trace:
    """Times in the profiler's microseconds; *_s in seconds."""

    def __init__(self, w0, w1, device, host, ops, counters, spans):
        self.w0, self.w1, self.device, self.host = w0, w1, device, host
        self.ops, self.counters, self.spans = ops, counters, spans
        self.window_s = (w1 - w0) / 1e6
        self.busy = self._merge(sorted((s, t) for _, s, t in device))
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6

    @staticmethod
    def _merge(intervals):
        out = []
        for s, t in intervals:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def device_seconds(self, names):
        """Device seconds of the kernels whose names start with one of names."""
        return sum(t - s for n, s, t in self.device if n.startswith(tuple(names))) / 1e6

    def gaps(self):
        """The idle intervals of the device inside the window."""
        out, at = [], self.w0
        for s, t in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.w1 > at:
            out.append((at, self.w1))
        return out

    def breakdown(self, top=10):
        """The device operations that took most time, and the device's idle
        time summed by what the host was doing in the middle of each gap:
        the benchmark's span ("harness" outside them), then the innermost
        operation the profiler saw on the host, if any."""
        by_op = collections.Counter()
        for name, s, t in self.device:
            by_op[name] += (t - s) / 1e6
        by_host = collections.Counter()
        events = sorted(self.host, key=lambda e: e[1])
        active, i = [], 0
        for s, t in self.gaps():
            mid = (s + t) / 2
            while i < len(events) and events[i][1] <= mid:
                active.append(events[i])
                i += 1
            active = [e for e in active if e[2] >= mid]
            spans = [e for e in active if e[0] in self.spans]
            ops = [e for e in active if e[0] not in self.spans]
            label = spans[0][0] if spans else "harness"
            if ops:
                label += "/" + max(ops, key=lambda e: e[1])[0]
            by_host[label] += (t - s) / 1e6
        return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


def span(name, on):
    """record_function(name) when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
