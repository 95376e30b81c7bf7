"""The benchmark on a card: every cell runs and is correct, and its control
at the cell's own size is not.  Marked `cuda`; skips where torch sees no
card.

    python3 -m pytest benchmark/tests/test_sippbench_card.py -o addopts= -p no:cacheprovider
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def _last_line(args):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_correct(card, cell, trace):
    result = json.loads(_last_line(["benchmark.run", "--workload", cell, "--seed", "4000000007",
                                    "--seconds", "3", "--trace", str(trace)])[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size(card, cell):
    lines = _last_line(["benchmark.control", "--workload", cell, "--seconds", "3",
                        "--seeds", "4100000001", "4100000002", "4100000003"])
    assert [json.loads(ln)["correct"] for ln in lines] == [False] * 3
