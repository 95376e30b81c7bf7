"""The port's host-spine prover and fold-ladder verifier (plain versions on
the CPU) against the JAX package: the n = 4 golden proof and statement,
frozen from sipp_tpu's sipp_prove / sipp_verify, must come out byte for
byte, and tampered inputs must raise VerificationError as in
tests/test_validate.py.  Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The live comparison against JAX's own sipp_prove is marked slow."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, hostref, native, params
from sipp_tpu_torch.fields import FQ, bigint, poseidon
from sipp_tpu_torch.protocol import (SIPPStatement, Transcript, VerificationError,
                                     sipp_prove, sipp_verify, transcript, validate)

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


@pytest.fixture(scope="module")
def proof(golden):
    """The reference's proof: the verifier tests need no prover run (each
    xdist worker would repeat it)."""
    return convert.from_reference(golden["proof4"], device="cpu")


def test_prove_matches_reference_bytes(golden, inst):
    """The proof bytes, and the final transcript state, which is the one the
    JAX package's on-chip prover ends in."""
    proof, tr = sipp_prove(*inst, return_transcript=True)
    assert np.array_equal(convert.to_reference(proof), golden["proof4"])
    assert tr.state == [int(v) for v in golden["onchip_state4"]]


def test_verify_returns_reference_statement(golden, inst, proof):
    stmt = sipp_verify(*inst, proof)
    assert np.array_equal(np.asarray(stmt.to_vec(), np.uint32), golden["stmt4"])
    assert SIPPStatement.from_vec(4, stmt.to_vec()) == stmt


def test_tampered_proof_rejected(inst, proof):
    bad = proof.clone()
    bad[1, 0, 0, 0, 0] = (bad[1, 0, 0, 0, 0] + 1) % 0xFFFF
    with pytest.raises(VerificationError, match="Verification failed"):
        sipp_verify(*inst, bad)


def _plus_one(limbs):
    """y -> y + 1 (mod p) in Montgomery limb form: adds R mod p."""
    v = bigint.limbs_to_int(limbs.numpy())
    return torch.as_tensor(bigint.int_to_limbs((v + FQ.R) % FQ.p, 16).astype(np.int64))


def test_off_curve_b_rejected(inst, proof):
    a, b = inst
    b = b.clone()
    b[0, 1, 0] = _plus_one(b[0, 1, 0])
    with pytest.raises(VerificationError, match="B: point off twist"):
        sipp_verify(a, b, proof)


def test_b_outside_subgroup_rejected(inst, proof):
    """On the twist but outside the r-torsion (the BLS map before cofactor
    clearing): only the complete-add ladder catches it."""
    from sipp_tpu.apps.bls_aggregation import map_to_g2_without_cofactor_mul

    raw = map_to_g2_without_cofactor_mul((1234, 5678))
    assert hostref.g2_mul_raw(raw, params.R) is not None
    a, b = inst
    b = b.clone()
    b[1] = curves.g2_encode([raw])[0]
    validate.check_instance(a, b, subgroup=False)
    with pytest.raises(VerificationError, match="subgroup"):
        sipp_verify(a, b, proof)


@pytest.mark.parametrize("what", ["non-16-bit", "non-canonical", "off-curve-a"])
def test_instance_limbs_and_curve_rejected(inst, what):
    a, b = inst
    a = a.clone()
    if what == "non-16-bit":
        a[0, 0, 3] = 1 << 16
    elif what == "non-canonical":
        a[0, 0] = torch.as_tensor(bigint.int_to_limbs(
            bigint.limbs_to_int(a[0, 0].numpy()) + FQ.p, 16).astype(np.int64))
    else:
        a[2, 1] = _plus_one(a[2, 1])
    with pytest.raises(VerificationError):
        validate.check_instance(a, b, subgroup=False)


def test_infinity_lanes_pass_validation(inst):
    a, b = (x.clone() for x in inst)
    a[1] = 0
    b[2] = 0
    validate.check_instance(a, b, subgroup=False)


# --------------------------------------------------------------- transcript

def test_native_chain_matches_python_poseidon():
    rng = np.random.default_rng(3)
    msgs = [[int(v) for v in rng.integers(0, 2**63, size=k)] for k in (16, 32, 96, 5)]
    state = [0, 0, 0, 0]
    for m in msgs:
        state = poseidon.hash_no_pad(state + m)
    assert native.transcript_absorb([0, 0, 0, 0], msgs) == state
    assert native.hash_no_pad(state) == poseidon.hash_no_pad(state)


def test_challenge_digit_quirk():
    """BigUint::to_u32_digits drops leading zero limbs: a digest element
    below 2^32 contributes one digit, and zero contributes none."""
    digest = [5, 0, 2**40 + 7, 3]
    x = 5 + ((2**40 + 7) << 32) + (3 << 96)
    assert transcript.challenge_from_digest(digest) == x % params.R


def test_transcript_matches_reference_transcript(golden):
    from sipp_tpu.protocol.transcript import Transcript as JTranscript
    from sipp_tpu import curves as jcurves

    ours, ref = Transcript(), JTranscript()
    pts = (curves.g1_decode(convert.from_reference(golden["a4"], device="cpu")),
           curves.g2_decode(convert.from_reference(golden["b4"], device="cpu")))
    assert pts == (jcurves.g1_decode(golden["a4"]), jcurves.g2_decode(golden["b4"]))
    ours.append_points(*pts)
    ref.append_points(*pts)
    z = hostref.pairing(pts[0][0], pts[1][0])
    ours.append_fq12(z)
    ref.append_fq12(z)
    assert ours.state == ref.state and ours.get_challenge() == ref.get_challenge()


def test_native_fq12_pow_matches_hostref():
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12)]
    f = tuple(tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1]) for j in range(3))
              for i in range(2))
    from sipp_tpu_torch.fields import tower

    u = native.fq12_limbs16_to_u64(convert.to_reference(tower.fq12_encode(f)))
    e = 0xDEADBEEF12345
    assert native.fq12_u64_to_tower_ints(native.fq12_pow(u, e)) == hostref.fq12_pow(f, e)
    assert native.fq12_u64_to_tower_ints(native.fq12_mul(u, u)) == hostref.fq12_mul(f, f)
    assert np.array_equal(native.u64_to_fq12_limbs16(u), convert.to_reference(tower.fq12_encode(f)))


def test_rc_file_hook(tmp_path):
    """SIPP_POSEIDON_RC_FILE swaps the round constants of the port's
    Poseidon and of the native chain, as in the JAX package."""
    alt = [(0x9E3779B97F4A7C15 * (i + 1)) % 2**64 for i in range(360)]
    rc = tmp_path / "rc.txt"
    rc.write_text(" ".join(hex(v) for v in alt))
    child = (
        "from sipp_tpu_torch.fields import poseidon\n"
        "from sipp_tpu_torch import native\n"
        f"assert [v for r in poseidon.ROUND_CONSTANTS for v in r] == "
        f"[v % poseidon.P for v in {alt!r}]\n"
        "assert native.hash_no_pad(list(range(1, 9))) == poseidon.hash_no_pad(list(range(1, 9)))\n"
        "print('ok')\n")
    env = dict(os.environ, SIPP_POSEIDON_RC_FILE=str(rc))
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", child], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.slow
def test_live_jax_prove_matches_port():
    """JAX's own sipp_prove (minutes of XLA compiles on the CPU) and the
    port's on the same n = 4 instance give the same proof bytes."""
    from sipp_tpu.protocol import sipp_prove as jax_prove
    from sipp_tpu.utils.testing import random_instance as jax_instance

    ja, jb = jax_instance(4, seed=21)
    want = np.asarray(jax_prove(ja, jb), dtype=np.uint32)
    got = sipp_prove(*(convert.from_reference(np.asarray(x), device="cpu") for x in (ja, jb)))
    assert np.array_equal(convert.to_reference(got), want)
