"""K2, the final exponentiation: its plain version (ops/fexp.py) against
golden vectors frozen from the JAX package's XLA final_exp (held
bit-identical to pallas_fexp.final_exp_fused by its own tests) and against
hostref's pairing.  Exact equality.  Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernel is compared with this plain version on the card by
chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, hostref
from sipp_tpu_torch.fields import tower
from sipp_tpu_torch.ops import fexp
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
        return {k: g[k] for k in g.files}


def test_final_exp_b2_matches_reference(golden):
    got = fexp.final_exp(convert.from_reference(golden["pair_f"], device="cpu"))
    assert np.array_equal(convert.to_reference(got), golden["pair_z"])


def test_final_exp_of_product_is_hostref_pairing_product(golden):
    """FE(prod Miller) at n = 2 equals hostref's e(A0, B0) e(A1, B1), and
    the reference's Z."""
    z = fexp.final_exp(convert.from_reference(golden["f2"], device="cpu")[None])[0]
    assert np.array_equal(convert.to_reference(z), golden["z2"])
    A = curves.g1_decode(convert.from_reference(golden["a2"], device="cpu"))
    B = curves.g2_decode(convert.from_reference(golden["b2"], device="cpu"))
    want = hostref.fq12_mul(hostref.pairing(A[0], B[0]), hostref.pairing(A[1], B[1]))
    assert tower.fq12_decode(z) == want


def test_lambda_tape_is_the_reference_tape():
    from sipp_tpu.pairing.ate import _TAPE

    assert tuple(map(tuple, np.asarray(_TAPE).tolist())) == ate.TAPE
