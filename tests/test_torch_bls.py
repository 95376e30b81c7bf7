"""The port's BLS aggregation app (sipp_tpu_torch/apps/bls_aggregation.py)
on the CPU, mirroring tests/test_bls.py: the hash to G2 against hostref and
the pinned D9 vectors, the port's map and hash against the JAX package's
own (live: both are framework-free), the n = 4 aggregate's proof against
the JAX package's bytes (golden stage `bls` of tools/make_torch_golden.py),
the tamper cases and the demo's JSON line.  Tolerance 0 throughout.  The
n = 128 demo is marked slow."""

import json
import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu.apps import bls_aggregation as JBLS
from sipp_tpu_torch import cli, convert, curves, hostref as H, params
from sipp_tpu_torch.apps import bls_aggregation as BLS

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """tests/test_bls.py's three signatures from default_rng(7)."""
    rng = np.random.default_rng(7)
    keys = [BLS.keygen(rng) for _ in range(3)]
    msgs = [
        (int.from_bytes(rng.bytes(31), "little"),
         int.from_bytes(rng.bytes(31), "little"))
        for _ in range(3)
    ]
    sigs = [BLS.sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    return keys, msgs, sigs


def test_hash_to_g2_torsion():
    h = BLS.hash_to_g2((424242, 171717))
    assert H.g2_is_on_curve(h)
    assert H.g2_mul_raw(h, params.R) is None  # r-torsion after cofactor mul
    assert BLS.hash_to_g2((424242, 171717)) == h
    assert BLS.hash_to_g2((424243, 171717)) != h


def test_single_sig_verifies(setup):
    keys, msgs, sigs = setup
    assert H.pairing(keys[0][1], BLS.hash_to_g2(msgs[0])) == H.pairing(params.G1_GEN, sigs[0])


@pytest.mark.parametrize("u", [(424242, 171717), (1, 5), (0, 0), (params.P - 1, 3)])
def test_map_and_hash_match_the_jax_package(u):
    """The port's copy against sipp_tpu's own functions, live: the
    increment schedule, the root's sign and the cofactor clearing."""
    assert BLS.map_to_g2_without_cofactor_mul(u) == JBLS.map_to_g2_without_cofactor_mul(u)
    assert BLS.hash_to_g2(u) == JBLS.hash_to_g2(u)
    assert BLS.fq2_sqrt(u) == JBLS.fq2_sqrt(u)


def test_keygen_sign_aggregate_match_the_jax_package(setup):
    keys, msgs, sigs = setup
    rng = np.random.default_rng(7)
    assert [JBLS.keygen(rng) for _ in range(3)] == keys
    assert [JBLS.sign(sk, m) for (sk, _), m in zip(keys, msgs)] == sigs
    assert JBLS.aggregate(sigs) == BLS.aggregate(sigs)


def test_aggregate_proof_is_the_jax_packages(setup):
    """The n = 4 instance and the proof of verify_bls_aggregation on the
    CPU (the host-spine prover, as the JAX package proves on the CPU) are
    the JAX package's bytes."""
    keys, msgs, sigs = setup
    pks = [pk for _, pk in keys]
    with np.load(GOLDEN) as g:
        a, b, want = g["bls4_a"], g["bls4_b"], g["bls4_proof"]
    assert np.array_equal(convert.to_reference(curves.g1_encode(pks + [H.g1_neg(params.G1_GEN)])), a)
    hs = [BLS.hash_to_g2(m) for m in msgs]
    assert np.array_equal(convert.to_reference(curves.g2_encode(hs + [BLS.aggregate(sigs)])), b)
    ok, proof = BLS.verify_bls_aggregation(pks, msgs, BLS.aggregate(sigs), prove=True,
                                           device="cpu")
    assert ok and proof.shape[0] == 5  # n=4: 2*2+1
    assert np.array_equal(convert.to_reference(proof), want)


def test_aggregate_rejects_tamper(setup):
    keys, msgs, sigs = setup
    pks = [pk for _, pk in keys]
    bad_sigma = H.g2_add(BLS.aggregate(sigs), BLS.hash_to_g2(msgs[0]))
    assert BLS.verify_bls_aggregation(pks, msgs, bad_sigma, prove=False, device="cpu") == \
        (False, None)
    # wrong message order
    assert BLS.verify_bls_aggregation(pks, [msgs[1], msgs[0], msgs[2]], BLS.aggregate(sigs),
                                      prove=False, device="cpu") == (False, None)


def test_main_demo_json_line(capsys):
    """The demo through the CLI's bls command on the CPU ends with the JAX
    demo's machine-readable line (default_rng(0), n = 4)."""
    cli.main(["bls", "--n", "4", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["app"] == "bls_aggregation" and line["n"] == 4 and line["ok"]
    assert "verify_s" in line and "setup_s" in line


def test_entry_points_need_a_card_unless_told(setup, monkeypatch):
    """The app's entry points default to the card and raise without one;
    they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, msgs, sigs = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BLS.verify_bls_aggregation([pk for _, pk in keys], msgs, BLS.aggregate(sigs))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BLS.main(4)


@pytest.mark.slow
def test_main_demo_n128():
    """Reference-scale demo (bls_aggregation.rs:93, n=128) end-to-end on the
    CPU: tens of minutes of plain PyTorch."""
    assert BLS.main(128, device="cpu")


def test_hash_to_g2_golden_vectors():
    """The pinned map and hash of tests/test_bls.py (the framework's frozen
    D9 spec): the port's copy must give the same points."""
    assert BLS.map_to_g2_without_cofactor_mul((424242, 171717)) == (
        (424242, 171717),
        (14533135048247166816662746940351115004154206998895184992191964500777306337298,
         6927733764469717901706130463663809783588109733081879454760528268559800081477))
    assert BLS.map_to_g2_without_cofactor_mul((1, 5)) == (
        (7, 5),
        (13446273044329525207908541639776820132028895439906921804613236302072209388092,
         12822884805728629867366488150791365044713730121427552893754797786287711335390))
    assert BLS.hash_to_g2((424242, 171717)) == (
        (19170719052565652154447469664303652338513199378041865428231434696830676564243,
         2104591922849897917930930180913875583441567315072185351341706218297450814499),
        (12290232940521137734014779511379184910923668477806375983086734784005275617393,
         6670842489739523968356116559478095671067762444518985432452872514278139308987))
