"""The port's on-chip prover and MSM-finals verifier (plain versions on the
CPU) against the JAX package: sipp_prove_onchip at n = 4 must give the
golden proof byte for byte, frozen from sipp_tpu's sipp_prove and
sipp_prove_onchip (its XLA path, tests/test_onchip.py), with the golden
final transcript state, which the port's host-spine sipp_prove must end in
too (tests/test_torch_protocol.py); sipp_verify with SIPP_VERIFY_MSM=1 must
return the golden statement and reject a tampered proof.  Regenerate the
golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py"""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert
from sipp_tpu_torch.protocol import VerificationError, sipp_prove_onchip, sipp_verify, verifier

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


@pytest.fixture(scope="module")
def inst(golden):
    return tuple(convert.from_reference(golden[k], device="cpu") for k in ("a4", "b4"))


def test_onchip_prover_matches_reference(golden, inst):
    round_times = []
    proof, tr = sipp_prove_onchip(*inst, return_transcript=True, round_times=round_times)
    assert np.array_equal(convert.to_reference(proof), golden["proof4"])
    assert np.array_equal(golden["onchip_proof4"], golden["proof4"])
    assert tr.state == [int(v) for v in golden["onchip_state4"]]
    assert len(round_times) == 2 and min(round_times) > 0


def test_msm_verifier_returns_reference_statement(golden, inst, monkeypatch):
    monkeypatch.setenv("SIPP_VERIFY_MSM", "1")
    stmt = sipp_verify(*inst, convert.from_reference(golden["proof4"], device="cpu"))
    assert np.array_equal(np.asarray(stmt.to_vec(), np.uint32), golden["stmt4"])


def test_msm_verifier_rejects_tampered_proof(golden, inst, monkeypatch):
    monkeypatch.setenv("SIPP_VERIFY_MSM", "1")
    bad = convert.from_reference(golden["proof4"], device="cpu")
    bad[3, 1, 0, 1, 2] = (bad[3, 1, 0, 1, 2] + 1) % 0xFFFF
    with pytest.raises(VerificationError, match="Verification failed"):
        sipp_verify(*inst, bad)


@pytest.mark.parametrize("mode,cpu,cuda", [("auto", False, True), ("1", True, True),
                                           ("0", False, False)])
def test_msm_mode(monkeypatch, mode, cpu, cuda):
    """SIPP_VERIFY_MSM: auto takes the MSM finals for CUDA tensors only."""
    monkeypatch.setenv("SIPP_VERIFY_MSM", mode)
    assert verifier._use_msm(torch.device("cpu")) is cpu
    assert verifier._use_msm(torch.device("cuda")) is cuda


def test_msm_mode_rejects_unknown(monkeypatch):
    monkeypatch.setenv("SIPP_VERIFY_MSM", "yes")
    with pytest.raises(ValueError, match="SIPP_VERIFY_MSM"):
        verifier._use_msm(torch.device("cpu"))
