"""K7, one step of the Miller loop, and the per-step engine
(SIPP_WHOLE_LOOP=0): the plain version (pairing/ate.py miller_step_plain,
which the wrapper ops/miller.py miller_step runs for CPU tensors) against
the golden stage
`miller_step` of tools/make_torch_golden.py, which runs the JAX package's
own Pallas step kernel pallas_miller.miller_step in interpret mode for
digits 0, 1 and 2 at B = 3 (lane 1 P = O, lane 2 Q = O) on a carry three
digits into the loop.  The carry goes both ways through the JAX kernel's
transposed layout (convert.from_transposed / to_transposed).  Exact
equality: tolerance 0, every value is a canonical field element.
Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernel itself is compared with this plain version on the card by
chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert
from sipp_tpu_torch.ops import miller
from sipp_tpu_torch.pairing import ate

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files if k.startswith("step_") or k in ("a4", "b4", "z4")}


def _t(arr):
    return convert.from_reference(arr, device="cpu")


def _step_inputs(golden):
    p, q, qn = _t(golden["step_p"]), _t(golden["step_q"]), _t(golden["step_qn"])
    f = convert.from_transposed(golden["step_f"], device="cpu")
    t = convert.from_transposed(golden["step_t"], device="cpu")
    return q, qn, p, f, t


@pytest.mark.parametrize("digit", [0, 1, 2])
def test_step_matches_reference_kernel(golden, digit):
    q, qn, p, f, t = _step_inputs(golden)
    assert bool((p[1] == 0).all()) and bool((q[2] == 0).all())
    assert torch.equal(qn, ate._neg_y(q))
    f2, t2 = miller.miller_step_plain(digit, q, qn, p, f, t)
    assert np.array_equal(convert.to_transposed(f2), golden[f"step_f{digit}"])
    assert np.array_equal(convert.to_transposed(t2), golden[f"step_t{digit}"])


def test_wrapper_runs_plain_on_cpu_without_launching(golden):
    before = miller.miller_step.launches
    args = _step_inputs(golden)
    got = miller.miller_step(2, *args)
    want = miller.miller_step_plain(2, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert miller.miller_step.launches == before


def test_fused_loop_matches_miller_loop(golden):
    """miller_loop_fused (the wrapper per digit, the plain route here) equals
    miller_loop, infinity lanes included."""
    p, q = _t(golden["step_p"]), _t(golden["step_q"])
    assert torch.equal(ate.miller_loop_fused(p, q), ate.miller_loop(p, q))


def test_inner_product_per_step_engine(golden, monkeypatch):
    """SIPP_WHOLE_LOOP=0, read at call time, gives the golden n = 4 Z."""
    monkeypatch.setenv("SIPP_WHOLE_LOOP", "0")
    z = ate.inner_product(_t(golden["a4"]), _t(golden["b4"]))
    assert np.array_equal(convert.to_reference(z), golden["z4"])


def test_digits_are_the_reference_encoding():
    """DIGITS: the 65 NAF digits in the reference's step encoding, 21 of
    them non-zero (0 none, 1 add Q, 2 add -Q)."""
    assert len(ate.DIGITS) == 65 and set(ate.DIGITS) == {0, 1, 2}
    assert sum(d != 0 for d in ate.DIGITS) == 21


def test_step_rejects_bad_input(golden):
    q, qn, p, f, t = _step_inputs(golden)
    with pytest.raises(ValueError, match="digit"):
        miller.miller_step(-1, q, qn, p, f, t)
    with pytest.raises(ValueError, match="shapes"):
        miller.miller_step(1, q, qn, p, f, t[:2])
    with pytest.raises(ValueError, match="unsupported device"):
        miller.miller_step(1, *(x.to("meta") for x in (q, qn, p, f, t)))
