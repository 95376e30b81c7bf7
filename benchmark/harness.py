"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
traced slice, the check against the plain reference, the metrics.

Everything that belongs to a configuration, a traffic mix, an entry of the
program, a loop or a metric sits in a file of its own, found by the name
that BENCHMARK.json or the traffic file gives:

  <paths[0]>/configs/<file of the config>   the deployment (n, guarantees)
  <paths[0]>/traffic/<traffic>.json         the mix, as data (TRAFFIC_KEYS)
  <paths[0]>/entries/<entry>.py             the program's call and its check
  <paths[0]>/loops/<loop>.py                how the window drives the calls
  <paths[0]>/metrics/<name or family>.py    a metric's reader

An entry file gives load() (the program's callable (a, b) -> output), and
may give program(pool, device, traffic, spans_on) where a call is more
than that callable on a resident instance: an object with run(j), close()
and spans, as Program below is.
"""

import gc
import importlib.util
import itertools
import json
import math
import pathlib
import random
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np

from . import instances, tracing
from .reference import sipp

ROOT = pathlib.Path(__file__).resolve().parent.parent

# a traffic file's keys: "entry", "ceiling_ops_per_s" (the most calls a
# second that the pool is sized for, over all clients), "warmup_ops",
# "check_sample", "trace_seconds"; these have defaults ("about" is free text):
TRAFFIC_DEFAULTS = {"loop": "closed", "clients": 1, "placement": "device", "about": ""}


def load_module(path):
    name = f"sippbench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json at `root` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name):
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell):
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell):
        data = json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())
        return dict(TRAFFIC_DEFAULTS, **data)

    def entry(self, traffic):
        return load_module(self.dir / "entries" / f"{traffic['entry']}.py")

    def loop(self, traffic):
        return load_module(self.dir / "loops" / f"{traffic['loop']}.py")

    def metrics(self, cell, kind):
        """[(metric entry, reader module)] of the cell's end_to_end or
        per_layer metrics.  An end-to-end metric without `workloads` is
        every cell's; a per-layer one has to list its cells."""
        out = []
        for m in self.bench[kind]:
            if kind == "per_layer" and "workloads" not in m:
                raise ValueError(f"per-layer metric {m['name']!r} lists no workloads")
            if cell["name"] in m.get("workloads", [cell["name"]]):
                out.append((m, self.reader(m["name"])))
        return out

    def reader(self, name):
        for stem in (name, name.split(".")[0]):
            path = self.dir / "metrics" / f"{stem}.py"
            if path.exists():
                return load_module(path)
        raise FileNotFoundError(f"no reader for metric {name!r} under {self.dir / 'metrics'}")


class Window:
    def __init__(self, records, t0, t1):
        self.seconds = t1 - t0
        done = [r for r in records if r.out is not None]
        self.completed = len(done)
        self.latencies = [r.t1 - r.t0 for r in done]


class Program:
    """The timed path: the pool's j-th draw (p, q, c, k) -> the entry's output
    in host memory, G1 walk p against G2 walk q gathered by i -> c i + k
    mod n.  Placement "device": the walks live on the device and the
    gather's indices are worked out there BATCH draws at a time (a batch a
    client thread, on its stream); "host": the instance is gathered in host
    memory and uploaded inside the call."""

    BATCH = 256

    def __init__(self, fn, pool, device, traffic, spans_on):
        import torch

        if traffic["placement"] not in ("device", "host"):
            raise ValueError(f"placement is device or host: {traffic['placement']!r}")
        self.torch, self.fn, self.pool, self.device = torch, fn, pool, device
        self.spans_on, self.on_host = spans_on, traffic["placement"] == "host"
        a, b = pool.limbs()
        if self.on_host:
            self.a, self.b, self.ar = a, b, np.arange(pool.n)
        else:
            self.a, self.b = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
            self.ar = torch.arange(pool.n, device=device)
        self.local = threading.local()
        self.spans = (f"{traffic['entry']}.call", f"{traffic['entry']}.fetch")

    def _index(self, j):
        at, local = j - j % self.BATCH, self.local
        if getattr(local, "at", None) != at:
            ck = self.torch.tensor([self.pool.draw(t)[2:] for t in range(at, at + self.BATCH)],
                                   device=self.device)
            local.idx = (ck[:, :1] * self.ar + ck[:, 1:]).remainder_(self.pool.n)
            local.at = at
        return local.idx[j - at]

    def _instance(self, j):
        p, q, c, k = self.pool.draw(j)
        if not self.on_host:
            return self.a[p], self.b[q].index_select(0, self._index(j))
        to = self.torch.from_numpy
        return (to(self.a[p]).to(self.device),
                to(self.b[q][(c * self.ar + k) % self.pool.n]).to(self.device))

    def run(self, j):
        with tracing.span(self.spans[0], self.spans_on):
            out = self.fn(*self._instance(j))
        with tracing.span(self.spans[1], self.spans_on):
            return out.cpu().numpy()

    def close(self):
        del self.a, self.b, self.ar, self.local


class Control:
    """The control in the program's place: the entry's control reference."""

    spans = ()

    def __init__(self, entry, pool):
        self.entry, self.pool, self.ref = entry, pool, entry.control()

    def run(self, j):
        return self.entry.expect(self.ref, self.pool, self.pool.draw(j))[0]

    def close(self):
        pass


def read_peak(kind):
    """The card's peak from metrics/peaks.json and its SM clock from
    nvidia-smi, or None."""
    peaks = json.loads((pathlib.Path(__file__).parent / "metrics" / "peaks.json").read_text())
    if kind not in peaks:
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    mhz, watts = (float(v) for v in out.split(","))
    p = peaks[kind]
    return {"sm_mhz": mhz, "power_limit_w": watts,
            "imul_per_s": p["sm_count"] * p["imul32_per_sm_per_clock"] * mhz * 1e6,
            "hbm_bytes_per_s": p["hbm_bytes_per_s"]}


def check(entry, pool, records, traced, sample_size, seed):
    """Compare with the reference a sample of the completed calls drawn from
    the seed, the slowest call and every traced call.  Returns (the number
    of wrong outputs, {op index: what the reference worked out})."""
    ref = sipp.Reference()
    done = [r for r in records if r.out is not None]
    rng = random.Random(f"check-{seed}")
    sample = set(rng.sample(range(len(done)), min(sample_size, len(done))))
    if done:
        sample.add(max(range(len(done)), key=lambda i: done[i].t1 - done[i].t0))
    picked = {done[i].index for i in sample} | {op.index for op in (traced.ops if traced else ())}
    wrong, checked = 0, {}
    for r in records:
        if r.index in picked:
            want, info = entry.expect(ref, pool, r.inst)
            checked[r.index] = info
            wrong += not (r.out.shape == want.shape and (r.out == want).all())
    return wrong, checked


def run(cell_name, seed, seconds, trace, device="cuda", spec=None, t_start=None,
        control=False, config=None, traffic=None):
    """One run; returns (result, lines for standard error).  t_start: the
    process's start on the host clock (time.perf_counter); control: the
    entry's control in the program's place; config and traffic override the
    cell's (the tests run at a small n on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    phases, mark = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        phases[name], mark[0] = now - mark[0], now

    spec = spec or Spec()
    cell = spec.cell(cell_name)
    config = config or spec.config(cell)
    traffic = dict(TRAFFIC_DEFAULTS, **(traffic or spec.traffic(cell)))
    entry, loop = spec.entry(traffic), spec.loop(traffic)
    readers = spec.metrics(cell, "per_layer" if trace else "end_to_end")

    import torch

    dev = torch.device(device)
    lap("start")
    draws = (math.ceil(traffic["ceiling_ops_per_s"] * seconds) + traffic["warmup_ops"] + 1
             + traffic["clients"])     # the traced warm-up, a call a client at least
    pool = instances.Pool(config["n"], draws, seed)
    lap("instances")
    if control:
        program = Control(entry, pool)
    elif hasattr(entry, "program"):
        program = entry.program(pool, dev, traffic, bool(trace))
    else:
        fn = entry.load()
        lap("program_import")
        program = Program(fn, pool, dev, traffic, bool(trace))
    lap("upload")
    counter, used, lock = itertools.count(), [], threading.Lock()

    def take():
        with lock:
            j = next(counter)
            used.append(pool.draw(j))
            return j, used[-1]

    for _ in range(traffic["warmup_ops"]):
        program.run(take()[0])
    tracer = tracing.Tracer(traffic["trace_seconds"], program.spans, dev) if trace else None
    if tracer:
        j = take()[0]
        tracer.warm(lambda: program.run(j))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()                 # what set-up made is not scanned again
    lap("warmup")
    setup_s = time.perf_counter() - t_start

    gc.disable()                # no collection pauses inside the window
    try:
        records, t0, t1 = loop.drive(program, take, seconds, tracer, traffic["clients"], dev)
    finally:
        gc.enable()
    window = Window(records, t0, t1)
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = tracer.result(records) if tracer else None
    program.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    wrong, checked = check(entry, pool, records, traced, traffic["check_sample"], seed)
    raised = sum(r.error is not None for r in records)
    checks = {"wrong_outputs": {"value": wrong, "limit": 0},
              "raised": {"value": raised, "limit": 0},
              "repeated_instances": {"value": instances.repeats(used), "limit": 0},
              "checked_outputs": {"value": len(checked), "minimum": 1}}
    correct = all(v["value"] <= v["limit"] if "limit" in v else v["value"] >= v["minimum"]
                  for v in checks.values())

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    # what the readers see (checked: op index -> what the reference worked out)
    state = types.SimpleNamespace(config=config, traffic=traffic, setup_s=setup_s, window=window,
                trace=traced, checked=checked,
                peak=read_peak(kind) if dev.type == "cuda" else None)
    metrics = {}
    for m, reader in readers:
        value = reader.read(state)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(records), "failed": raised + wrong,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                         "count": cell["chips"], "memory_peak_bytes": peak_bytes}}
    if traced:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    if state.peak:
        result["device"].update(state.peak)
    result["checks"] = checks
    lines = sorted({r.error for r in records if r.error})
    lines += [f"setup {k} {v:.3f} s" for k, v in phases.items()]
    lines.append(f"pool {pool.walks} walks a group, {pool.size} instances, {len(used)} drawn")
    if window.latencies:
        q = statistics.quantiles(window.latencies, n=20, method="inclusive") \
            if len(window.latencies) > 1 else window.latencies * 19
        lines.append(f"window {window.completed} calls by {traffic['clients']} client(s) in "
                     f"{window.seconds:.3f} s; latency ms p5 {1e3 * q[0]:.4f} p50 "
                     f"{1e3 * q[9]:.4f} p95 {1e3 * q[18]:.4f} max "
                     f"{1e3 * max(window.latencies):.4f}")
    if traced:
        lines.append(f"traced {len(traced.ops)} ops over {traced.window_s:.4f} s")
    lines += [f"check {k} {v['value']} " + (f"limit {v['limit']}" if "limit" in v
                                             else f"minimum {v['minimum']}")
              for k, v in checks.items()]
    return result, lines
