"""The benchmark's plain reference against the program on the CPU, against
itself, and what it and the harness import.

    python -m pytest benchmark/tests -p no:cacheprovider
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import instances
from benchmark.reference import bn254, sipp

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sipp_tpu"}


@pytest.fixture(scope="module")
def pool():
    return instances.Pool(4, 20, 2**33 + 5)     # two walks a group


@pytest.fixture(scope="module")
def ref():
    return sipp.Reference()


def _crossed(pool, skip):
    """A draw after the first `skip` whose G1 and G2 walks differ."""
    return [inst for inst in map(pool.draw, range(pool.size)) if inst[0] != inst[1]][skip]


def _device_instance(pool, inst):
    a, b = pool.limbs()
    perm = torch.tensor(pool.perm(inst))
    return torch.from_numpy(a[inst[0]]), torch.from_numpy(b[inst[1]])[perm]


def test_aggregate_matches_port(pool, ref):
    from sipp_tpu_torch.pairing import inner_product

    torch.set_num_threads(1)
    inst = _crossed(pool, 3)
    a, b = _device_instance(pool, inst)
    assert np.array_equal(inner_product(a, b).numpy(), sipp.limbs(ref.z(*pool.logs(inst))))


def test_proof_matches_port(pool, ref):
    from sipp_tpu_torch.protocol import sipp_prove_onchip

    torch.set_num_threads(1)
    inst = _crossed(pool, 5)
    a, b = _device_instance(pool, inst)
    want, xs = ref.proof(*pool.points(inst), *pool.logs(inst))
    assert len(xs) == 2
    assert np.array_equal(sipp_prove_onchip(a, b).numpy(), want)


def test_pool_points_have_their_logs(pool):
    for p in range(pool.walks):
        for pt, k in zip(pool.a_pts[p], pool.a_logs[p]):
            assert bn254.g1_mul(bn254.G1_GEN, k) == pt
        for pt, k in zip(pool.b_pts[p], pool.b_logs[p]):
            assert bn254.g2_mul(bn254.G2_GEN, k) == pt


def test_exponent_shortcut_is_the_pairing_product(pool, ref):
    """Z by Miller loops, their product and the plain final exponentiation
    equals g^(sum a_i b_i); a fold of points equals the fold of their logs."""
    inst = pool.draw(0)
    a_pts, b_pts = pool.points(inst)
    a_logs, b_logs = pool.logs(inst)
    t = bn254.Tower()
    direct = t.final_exp(t.miller_product(a_pts, b_pts))
    assert direct == ref.z(a_logs, b_logs)
    x = 0x1234567890ABCDEF1234567890ABCDEF
    assert t.fold("g1", a_pts[0], a_pts[2], x) == bn254.g1_mul(bn254.G1_GEN, a_logs[0] + x * a_logs[2])
    assert t.fold("g2", b_pts[1], b_pts[3], x) == bn254.g2_mul(bn254.G2_GEN, b_logs[1] + x * b_logs[3])


def test_controls_differ_from_reference(pool, ref):
    from benchmark.entries import aggregate, prove

    inst = pool.draw(1)
    assert not np.array_equal(aggregate.expect(aggregate.control(), pool, inst)[0],
                              aggregate.expect(ref, pool, inst)[0])
    assert not np.array_equal(prove.expect(prove.control(), pool, inst)[0],
                              prove.expect(ref, pool, inst)[0])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"sipp_tpu_torch", "torch", "benchmark"}), path
    code = ("import sys, benchmark.reference.sipp, benchmark.reference.transcript; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"sipp_tpu_torch", "torch"})


def test_run_loads_no_jax_nor_sipp_tpu():
    """A whole run of the harness (n = 2 on the CPU, the program's plain
    versions), then the top-level names of every loaded module, compared
    whole: sipp_tpu_torch is allowed, sipp_tpu and jax are not."""
    code = """
import json, sys
from benchmark import harness, run
spec = harness.Spec()
traffic = dict(spec.traffic(spec.cell("n128.aggregate")), ceiling_ops_per_s=0, warmup_ops=0,
               check_sample=1)
result, _ = harness.run("n128.aggregate", 7, 0.0, 0, device="cpu", config={"n": 2},
                        traffic=traffic)
print(json.dumps([result["correct"], run.forbidden_modules(),
                  sorted({m.split(".")[0] for m in sys.modules})]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.splitlines()[-1]
    correct, forbidden, loaded = json.loads(out)
    assert correct and forbidden == []
    assert "sipp_tpu_torch" in loaded and not set(loaded) & FORBIDDEN
