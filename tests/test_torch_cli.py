"""The port's CLI and proof files on the CPU, mirroring tests/test_cli.py
(prove -> save -> verify -> statement file), with the files crossing
between the two packages both ways: the JAX package's io loads what the
port writes, and the port verifies what the JAX package writes.  The n = 4
seed-7 instance is the golden file's (a4, b4, proof4, stmt4), so every
array and byte is held to the JAX package's, tolerance 0."""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu import io as jio
from sipp_tpu.protocol.statements import SIPPStatement as JStatement
from sipp_tpu.protocol.verifier import VerificationError as JVerificationError
from sipp_tpu_torch import cli, convert, io
from sipp_tpu_torch.protocol import SIPPStatement, VerificationError

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
        return {k: g[k] for k in ("a4", "b4", "proof4", "stmt4")}


def test_cli_prove_verify(tmp_path, golden, capsys):
    """The CLI's prove command: the proof file loads through
    sipp_tpu.io.load_proof as the golden arrays, the proof that
    test_jax_written_proof_verifies_in_port verifies through the CLI's
    verify command (one verify of the n = 4 golden instance for both)."""
    proof = str(tmp_path / "p.npz")
    cli.main(["prove", "--n", "4", "--seed", "7", "--out", proof, "--device", "cpu"])
    assert proof in capsys.readouterr().out
    for got, name in zip(jio.load_proof(proof), ("a4", "b4", "proof4")):
        got = np.asarray(got)
        assert got.dtype == np.uint32 and np.array_equal(got, golden[name])


def test_jax_written_proof_verifies_in_port(tmp_path, golden, capsys):
    """A proof file written by sipp_tpu.io.save_proof loads in the port,
    verifies through the CLI's verify command on the CPU, and gives a
    statement file of the wire size 48n+240 u32 with the golden
    statement's bytes."""
    proof, stmt = tmp_path / "jax.npz", tmp_path / "s.u32"
    jio.save_proof(str(proof), golden["a4"], golden["b4"], golden["proof4"])
    a, b, p = io.load_proof(str(proof), device="cpu")
    assert a.dtype == torch.int64 and a.device.type == "cpu"
    for got, name in zip((a, b, p), ("a4", "b4", "proof4")):
        assert np.array_equal(convert.to_reference(got), golden[name])
    cli.main(["verify", "--proof", str(proof), "--statement", str(stmt), "--device", "cpu"])
    assert "OK" in capsys.readouterr().out
    assert os.path.getsize(stmt) == 4 * (48 * 4 + 240)
    assert stmt.read_bytes() == golden["stmt4"].tobytes()
    assert io.load_statement(str(stmt), 4).to_vec() == [int(v) for v in golden["stmt4"]]


def test_port_written_files_match_the_jax_packages(tmp_path, golden):
    """save_proof and save_statement of both packages write the same
    arrays and bytes from the same values."""
    a, b, p = (convert.from_reference(golden[k], "cpu") for k in ("a4", "b4", "proof4"))
    io.save_proof(str(tmp_path / "port.npz"), a, b, p)
    jio.save_proof(str(tmp_path / "jax.npz"), golden["a4"], golden["b4"], golden["proof4"])
    with np.load(tmp_path / "port.npz") as x, np.load(tmp_path / "jax.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    vec = [int(v) for v in golden["stmt4"]]
    io.save_statement(str(tmp_path / "s.u32"), SIPPStatement.from_vec(4, vec))
    jio.save_statement(str(tmp_path / "j.u32"), JStatement.from_vec(4, vec))
    assert (tmp_path / "s.u32").read_bytes() == golden["stmt4"].tobytes()
    assert (tmp_path / "j.u32").read_bytes() == golden["stmt4"].tobytes()


@pytest.mark.parametrize("array", ["a", "b", "proof"])
def test_load_rejects_wide_limbs_naming_the_array(tmp_path, golden, array):
    """A limb above 0xFFFF is refused before any tensor is made, and the
    message names the array; a proof value >= p is refused too."""
    arrays = {"a": golden["a4"].copy(), "b": golden["b4"].copy(), "proof": golden["proof4"].copy()}
    arrays[array].flat[5] = 0x10000
    np.savez(tmp_path / "bad.npz", version=np.uint32(1), **arrays)
    with pytest.raises(VerificationError, match=f"^{array}: non-16-bit limb"):
        io.load_proof(str(tmp_path / "bad.npz"), device="cpu")


def test_load_rejects_non_canonical_proof(tmp_path, golden):
    proof = golden["proof4"].copy()
    proof[0, 0, 0, 0] = 0xFFFF            # every limb 0xFFFF: a value above p
    np.savez(tmp_path / "bad.npz", a=golden["a4"], b=golden["b4"], proof=proof,
             version=np.uint32(1))
    with pytest.raises(VerificationError, match="proof: non-canonical"):
        io.load_proof(str(tmp_path / "bad.npz"), device="cpu")
    with pytest.raises(JVerificationError, match="proof: non-canonical"):
        jio.load_proof(str(tmp_path / "bad.npz"))


def test_sharded_prover_writes_the_same_file(tmp_path, golden, capsys):
    """prove --devices 2 --device cpu runs the sharded prover on two CPU
    shards and writes the file that --devices 1 writes: the golden arrays,
    which test_cli_prove_verify holds the --devices 1 file to (and which
    the JAX package's verifier accepts: golden stage verify)."""
    proof = str(tmp_path / "p2.npz")
    cli.main(["prove", "--n", "4", "--seed", "7", "--devices", "2", "--out", proof,
              "--device", "cpu"])
    assert proof in capsys.readouterr().out
    with np.load(proof) as got:
        assert sorted(got.files) == ["a", "b", "proof", "version"]
        for key, name in (("a", "a4"), ("b", "b4"), ("proof", "proof4")):
            assert got[key].dtype == np.uint32 and np.array_equal(got[key], golden[name])


def test_sharded_prover_needs_distinct_cards(monkeypatch):
    """--devices 4 where one card is visible exits non-zero with the mesh's
    message, before any instance is built: it never proves on one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"4 CUDA card\(s\) from cuda:0 asked for, 1 visible"):
        cli.main(["prove", "--n", "4", "--devices", "4"])


@pytest.mark.parametrize("kwargs", [{"n": 3}, {"n": 0}, {"num_devices": 0}])
def test_config_rejects_bad_sizes(kwargs):
    """SippConfig holds n (a power of two), num_devices and seed, and
    refuses an n that is not a power of two or a mesh of no devices."""
    from sipp_tpu_torch.config import SippConfig

    assert [f.name for f in dataclasses.fields(SippConfig)] == ["n", "num_devices", "seed"]
    with pytest.raises(AssertionError):
        SippConfig(**kwargs)


def test_cli_defaults_to_the_card(monkeypatch):
    """Without --device the CLI asks for the card, and without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["prove", "--n", "4"])


def test_profiling_trace_and_time_fn(tmp_path, capsys):
    """utils/profiling: trace writes a Chrome trace of the block, time_fn
    returns seconds a call and prints the JAX version's JSON line."""
    import json

    from sipp_tpu_torch.fields import FQ
    from sipp_tpu_torch.utils import profiling

    a = FQ.encode([3, 5, 7])
    with profiling.trace(str(tmp_path)):
        FQ.mul(a, a)
    assert "traceEvents" in json.loads((tmp_path / "trace.json").read_text())
    dt = profiling.time_fn(FQ.mul, a, a, reps=2, label="fq_mul")
    assert dt > 0
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line == {"label": "fq_mul", "sec_per_call": dt}
