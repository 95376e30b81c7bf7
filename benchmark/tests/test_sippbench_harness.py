"""The harness on the CPU: resolution by name, a metric and a traffic mix
added as new files with no edit, the result line's keys, repeated instances
refused, the pool sized for its ceiling rate, no fallback to the CPU without
a card.  The controls and the planted faults come out not correct.
Runs are at n = 2 or 4, the program's plain versions on the CPU."""

import json
import pathlib
import shutil
import subprocess
import sys
import threading

import pytest
import torch

from benchmark import faults, harness, instances

ROOT = pathlib.Path(__file__).resolve().parents[2]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def spec():
    return harness.Spec()


def small(spec, cell, warmup=0, sample=2, **more):
    return dict(spec.traffic(spec.cell(cell)), ceiling_ops_per_s=0, warmup_ops=warmup,
                check_sample=sample, **more)


def copy_bench(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's files under tmp_path."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_workload_resolves(spec):
    names = {c["name"] for c in spec.bench["configs"]}
    for cell in spec.bench["workloads"]:
        assert cell["config"] in names
        assert spec.config(cell)["n"] in (128, 4096)
        traffic = spec.traffic(cell)
        assert set(traffic) == set(harness.TRAFFIC_DEFAULTS) | {
            "entry", "ceiling_ops_per_s", "warmup_ops", "check_sample", "trace_seconds"}
        entry = spec.entry(traffic)
        assert callable(entry.load) and callable(entry.expect) and callable(entry.control)
        assert callable(spec.loop(traffic).drive)
        for kind in ("end_to_end", "per_layer"):
            metrics = spec.metrics(cell, kind)
            assert metrics and all(callable(reader.read) for _, reader in metrics)
        assert "setup_s" in {m["name"] for m, _ in spec.metrics(cell, "end_to_end")}


def test_metric_added_as_a_file_and_an_entry(tmp_path, spec):
    """A new metric is one file under metrics/ and one entry in
    BENCHMARK.json: the harness reads it with no other edit."""
    bench = copy_bench(tmp_path)
    bench["per_layer"].append({"name": "answer.prove", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "prove_ms", "workloads": ["n128.prove"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "metrics" / "answer.py").write_text(
        "def read(run):\n    return 42.0 + 0 * run.window.completed\n")
    tmp_spec = harness.Spec(tmp_path)
    names = [m["name"] for m, _ in tmp_spec.metrics(tmp_spec.cell("n128.prove"), "per_layer")]
    assert "answer.prove" in names
    result, _ = harness.run("n128.prove", 3, 0.0, 1, device="cpu", spec=tmp_spec,
                            config={"n": 2}, traffic=small(spec, "n128.prove"), control=True)
    assert result["metrics"]["answer.prove"] == {"value": 42.0, "unit": "count"}


def test_per_layer_metric_lists_its_cells(tmp_path, spec):
    bench = copy_bench(tmp_path)
    del bench["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tmp_spec = harness.Spec(tmp_path)
    with pytest.raises(ValueError, match="lists no workloads"):
        tmp_spec.metrics(tmp_spec.cell("n128.prove"), "per_layer")


COUNTED_ENTRY = """
from benchmark import harness
from benchmark.entries.aggregate import control, expect, load

calls = []


class Counted(harness.Program):
    def run(self, j):
        calls.append(j)
        return super().run(j)


def program(pool, device, traffic, spans_on):
    return Counted(load(), pool, device, traffic, spans_on)
"""

TWICE_LOOP = """
from benchmark.loops import closed


def drive(program, take, seconds, tracer, clients, device):
    return closed.drive(program, take, seconds, tracer, 2 * clients, device)
"""


@pytest.mark.parametrize("added", ["data", "code"])
def test_traffic_added_as_files(tmp_path, spec, added):
    """A new traffic mix is new files and a new cell: "data", a traffic file
    alone (two clients, the instance uploaded from host memory each call);
    "code", a traffic file naming a new entry file (its own program) and a
    new loop file.  The harness runs it with no other edit."""
    bench = copy_bench(tmp_path)
    traffic = small(spec, "n128.aggregate", sample=4, clients=2)
    if added == "data":
        traffic["placement"] = "host"
    else:
        traffic.update(entry="counted", loop="twice", clients=1)
        (tmp_path / "benchmark" / "entries" / "counted.py").write_text(COUNTED_ENTRY)
        (tmp_path / "benchmark" / "loops" / "twice.py").write_text(TWICE_LOOP)
    (tmp_path / "benchmark" / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "n128.new_mix", "config": "sipp-n128",
                               "traffic": "new_mix", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"][:1] + bench["per_layer"]:
        if "aggregate" in m["name"] or m["name"] == "pairings_per_s":
            m["workloads"].append("n128.new_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(1)
    tmp_spec = harness.Spec(tmp_path)
    result, lines = harness.run("n128.new_mix", 29, 0.0, 0, device="cpu", spec=tmp_spec,
                                config={"n": 2})
    assert result["correct"], lines
    assert result["attempted"] >= 1 and "pairings_per_s" in result["metrics"]
    assert any("by 2 client(s)" in ln for ln in lines) == (added == "data")
    if added == "code":
        counted = sys.modules["sippbench_entries_counted"].calls
        assert len(counted) == result["attempted"] and len(set(counted)) == len(counted)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(spec, trace):
    result, lines = harness.run("n128.aggregate", 2**31 + 11, 0.0, trace, device="cpu",
                                config={"n": 2}, traffic=small(spec, "n128.aggregate"),
                                control=True)
    want = RESULT_KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert [ln.split()[1] for ln in lines if ln.startswith("check ")] == list(result["checks"])
    json.dumps(result)


def test_repeated_instance_refused(spec, monkeypatch):
    draw = instances.Pool.draw
    monkeypatch.setattr(instances.Pool, "draw", lambda pool, j: draw(pool, 1 if j == 3 else j))
    result, _ = harness.run("n128.aggregate", 5, 0.0, 0, device="cpu", config={"n": 4},
                            traffic=small(spec, "n128.aggregate", warmup=4), control=True)
    assert result["checks"]["repeated_instances"]["value"] == 1
    assert not result["correct"]
    assert instances.repeats([(0, 1, 2), (0, 1, 3), (0, 1, 2)]) == 1


def test_pool_runs_out(spec, monkeypatch):
    """The pool holds the draws its ceiling rate allows distinct, and repeats
    past its size; a run that draws past it is not correct."""
    pool = instances.Pool(4, 50, 2**31 + 3)
    assert pool.size >= 50 and pool.walks == 3
    drawn = [pool.draw(j) for j in range(pool.size + 1)]
    assert instances.repeats(drawn) == 1 and drawn[-1] == drawn[0]
    for cell in ("n128.aggregate", "n128.prove"):
        traffic = spec.traffic(spec.cell(cell))
        need = traffic["ceiling_ops_per_s"] * spec.bench["run_seconds"]
        assert need >= 500 * spec.bench["run_seconds"]
    made = instances.Pool

    def small_pool(n, draws, seed):
        pool = made(n, draws, seed)
        pool.size = 2
        return pool

    monkeypatch.setattr(instances, "Pool", small_pool)
    result, _ = harness.run("n128.aggregate", 5, 0.0, 0, device="cpu", config={"n": 2},
                            traffic=small(spec, "n128.aggregate", warmup=3), control=True)
    assert result["checks"]["repeated_instances"]["value"] >= 2 and not result["correct"]


def test_no_card_no_fallback(spec):
    """Without CUDA the command exits non-zero and prints no result, and the
    timed path asked for the card raises instead of running on the CPU."""
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "n128.prove",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run("n128.aggregate", 1, 0.0, 0, device="cuda", config={"n": 2},
                    traffic=small(spec, "n128.aggregate"))


@pytest.mark.parametrize("cell", ["n128.aggregate", "n128.prove"])
def test_control_not_correct(spec, cell):
    result, _ = harness.run(cell, 17, 0.0, 0, device="cpu", config={"n": 4},
                            traffic=small(spec, cell, sample=3), control=True)
    assert not result["correct"]
    assert result["checks"]["wrong_outputs"]["value"] == result["checks"]["checked_outputs"]["value"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["n128.aggregate", "n128.prove"])
def test_fault_not_correct(spec, cell, fault):
    torch.set_num_threads(1)
    entry = spec.traffic(spec.cell(cell))["entry"]
    with faults.planted(fault, entry):
        result, _ = harness.run(cell, 23, 0.0, 0, device="cpu", config={"n": 4},
                                traffic=small(spec, cell, sample=1))
    assert not result["correct"]
    assert result["checks"]["wrong_outputs"]["value"] >= 1


def test_closed_loop_many_clients():
    """More client threads than cores, switching often: every call is one
    record with its own index and its own draw, none lost or repeated."""
    from benchmark.loops import closed

    class Echo:
        spans = ()

        def run(self, j):
            return j

    counter, lock = iter(range(10**9)), threading.Lock()

    def take():
        with lock:
            j = next(counter)
        return j, (j,)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        records, t0, t1 = closed.drive(Echo(), take, 0.3, None, 32, torch.device("cpu"))
    finally:
        sys.setswitchinterval(interval)
    assert t1 - t0 < 30 and len(records) >= 32
    assert sorted(r.index for r in records) == list(range(len(records)))
    assert sorted(r.out for r in records) == sorted(r.inst[0] for r in records)
    assert len({r.out for r in records}) == len(records) and all(r.error is None for r in records)
