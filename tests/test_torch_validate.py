"""The port's asynchronous entry validation (protocol/validate.py
check_instance_async) and the plain version of X1, the G2 r-torsion
verdicts (ops/validate.py), on the CPU, tolerance 0 (booleans and strings),
against the JAX package's golden stage `torsion` (tools/make_torch_golden.py:
sipp_tpu's _g2_in_subgroup verdicts and check_instance_async's behaviour on
the same points), with no live JAX jit.  The emulated X1 and X2 kernels are
in tests/test_torch_schedule.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, params
from sipp_tpu_torch.apps.bls_aggregation import map_to_g2_without_cofactor_mul
from sipp_tpu_torch.curves import G1
from sipp_tpu_torch.ops import msm
from sipp_tpu_torch.ops import validate as x1
from sipp_tpu_torch.protocol import VerificationError, sipp_verify, validate

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
        return {k: g[k] for k in g.files if k.startswith(("torsion", "a4", "b4", "proof4"))}


def test_plain_torsion_verdicts_match_jax(golden):
    """g2_torsion_plain (and the wrapper, on CPU tensors) against the XLA
    _g2_in_subgroup on honest points, raw map points, a point of the
    cofactor's order and an infinity lane."""
    b = convert.from_reference(golden["torsion_b"], device="cpu")
    got = x1.g2_torsion(b[None])                        # a leading batch dim
    assert got.dtype == torch.int64 and got.shape == (1, 8)
    assert got[0].tolist() == golden["torsion_ok"].astype(np.int64).tolist()


def test_plain_torsion_prime_orders_match_jax(golden):
    """g2_torsion_plain (the endomorphism test) and the [r]Q ladder against
    the XLA _g2_in_subgroup on the points where the two tests could part:
    one of each prime order of r h2 (r first) and one of order r l for
    each prime l of h2."""
    b = convert.from_reference(golden["torsion_prime_b"], device="cpu")
    want = golden["torsion_prime_ok"].astype(np.int64).tolist()
    assert want == [1] + [0] * 8
    assert x1.g2_torsion_plain(b).tolist() == want
    assert x1.g2_torsion_r_ladder(b).tolist() == want


@pytest.mark.parametrize("case", range(6))
def test_check_instance_async_matches_jax(golden, case):
    """Limb faults raise at once; curve and subgroup faults only from
    finish(), A's before B's, with the JAX package's words: the golden
    stage's cases (fine, off-curve A, off-twist B, B outside the r-torsion,
    both, a non-16-bit limb of B)."""
    # (int64 as they are: the last case has a limb that is not 16-bit)
    a = torch.from_numpy(golden["torsion_case_a"][case].astype(np.int64))
    b = torch.from_numpy(golden["torsion_case_b"][case].astype(np.int64))
    want_when, want_msg = str(golden["torsion_when"][case]), str(golden["torsion_msgs"][case])
    try:
        finish = validate.check_instance_async(a, b)
    except VerificationError as e:
        assert (want_when, want_msg) == ("now", str(e))
        return
    assert callable(finish) and want_when != "now"
    if want_when == "none":
        assert finish() is None
    else:
        with pytest.raises(VerificationError) as e:
            finish()
        assert str(e.value) == want_msg


def test_infinity_lanes_pass_with_subgroup(golden):
    a = convert.from_reference(golden["a4"], device="cpu")
    b = convert.from_reference(golden["b4"], device="cpu")
    a[0], b[0], a[3], b[2] = 0, 0, 0, 0
    stream, verdicts = validate.queue_verdicts(a, b)
    assert stream is None and [v.tolist() for v in verdicts] == [[True] * 4] * 3
    assert validate.check_instance_async(a, b)() is None


@pytest.mark.parametrize("tamper", ["proof_limb", "proof_value"])
def test_verify_order_of_faults(golden, tamper):
    """The JAX package's order: a bad proof limb is reported before B's
    subgroup fault (check_proof raises at once), and B's subgroup fault
    before the final comparison of a tampered proof (finish() comes
    first)."""
    a = convert.from_reference(golden["a4"], device="cpu")
    b = convert.from_reference(golden["b4"], device="cpu")
    proof = convert.from_reference(golden["proof4"], device="cpu")
    b[1] = curves.g2_encode([map_to_g2_without_cofactor_mul((1234, 5678))])[0]
    if tamper == "proof_limb":
        proof[0, 0, 0, 0, 3] = 1 << 16
        want = "proof: non-16-bit limb"
    else:
        proof[1, 0, 0, 0, 0] = (proof[1, 0, 0, 0, 0] + 1) % 0xFFFF
        want = "B: point outside the r-torsion subgroup at index 1"
    with pytest.raises(VerificationError) as e:
        sipp_verify(a, b, proof)
    assert str(e.value) == want


@pytest.mark.parametrize("call", ["torsion_shape", "torsion_device", "msm_device"])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        if call == "torsion_shape":
            x1.g2_torsion(torch.zeros(4, 2, 16, dtype=torch.int64))
        elif call == "torsion_device":
            x1.g2_torsion(torch.zeros(4, 2, 2, 16, dtype=torch.int64, device="meta"))
        else:
            msm.msm_finish(G1, torch.zeros(4, 2, 16, dtype=torch.int64, device="meta"))


def test_r_bits_are_the_scalar():
    assert int("".join(map(str, x1.R_BITS)), 2) == params.R
