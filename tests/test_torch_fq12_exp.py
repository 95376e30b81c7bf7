"""K8, the per-lane Fq12 exp, and the verifier without the C++ library
(SIPP_TPU_NO_NATIVE=1): the plain version (ops/exp.py fq12_exp_plain =
tower.fq12_exp_with_offset, which the wrapper runs for CPU tensors) against
the JAX package's tower.fq12_exp_with_offset on four lanes, frozen as golden
stage fq12_exp (the JAX package holds it bit-identical to its Pallas kernel
pallas_exp.fq12_exp_fused); edge lanes with all-zero bits, an offset of one
and x = 1;
the no-native verifier against the n = 4 golden statement, its device Z'
chain against the C++ chain, and the pure-Python transcript against the
native one.  Exact equality (tolerance 0, canonical values).  The CUDA
kernel is compared with the plain version on the card by chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, hostref, native, params
from sipp_tpu_torch.curves import scalar_to_bits
from sipp_tpu_torch.fields import tower
from sipp_tpu_torch.ops import exp
from sipp_tpu_torch.protocol import Transcript, sipp_verify, verifier

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


def _fq12(rng):
    v = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12)]
    return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3))
                 for i in range(2))


def test_plain_matches_jax_with_edge_lanes():
    """Lane 0 generic, lane 1 all-zero bits (the offset comes back), lane 2
    an offset of one (x^k), lane 3 x = 1 (the offset comes back)."""
    rng = np.random.default_rng(1177)
    xs = [_fq12(rng) for _ in range(4)]
    offs = [_fq12(rng) for _ in range(4)]
    xs[3], offs[2] = hostref.FQ12_ONE, hostref.FQ12_ONE
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(4)]
    ks[1] = 0
    bits = np.stack([scalar_to_bits(k) for k in ks], axis=1)
    x, off = tower.fq12_encode(xs), tower.fq12_encode(offs)
    with np.load(GOLDEN) as g:
        want = {k: g[f"fq12_exp_{k}"] for k in ("x", "off", "bits", "out")}
    assert np.array_equal(convert.to_reference(x), want["x"])
    assert np.array_equal(convert.to_reference(off), want["off"])
    assert np.array_equal(bits, want["bits"])
    before = exp.fq12_exp.launches
    got = exp.fq12_exp(x, off, torch.as_tensor(bits.astype(np.int64)))
    assert exp.fq12_exp.launches == before          # the plain version on a CPU tensor
    assert np.array_equal(convert.to_reference(got), want["out"])
    host = tower.fq12_decode(got)
    assert host[1] == offs[1] and host[3] == offs[3]


def test_shared_bits_equal_per_lane_bits():
    """fq12_pow_bits with one exponent for every lane, a (k,) tensor, equals
    the same exponent given per lane, and hostref's power."""
    rng = np.random.default_rng(7)
    xs = [_fq12(rng) for _ in range(2)]
    x = tower.fq12_encode(xs)
    e = 0xC0FFEE1234
    bits = np.asarray([int(c) for c in bin(e)[2:]], np.int64)
    got = tower.fq12_pow_bits(x, torch.as_tensor(bits))
    assert torch.equal(got, tower.fq12_pow_bits(x, torch.as_tensor(np.stack([bits, bits], 1))))
    assert tower.fq12_decode(got) == [hostref.fq12_pow(v, e) for v in xs]


def test_verify_without_native_library(golden, monkeypatch):
    """SIPP_TPU_NO_NATIVE=1: the n = 4 golden proof verifies to the golden
    statement, and the C++ library is never called."""
    def no_library():
        raise AssertionError("the C++ library was called with SIPP_TPU_NO_NATIVE set")

    monkeypatch.setenv("SIPP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "get_lib", no_library)
    a, b, proof = (convert.from_reference(golden[k], device="cpu")
                   for k in ("a4", "b4", "proof4"))
    stmt = sipp_verify(a, b, proof)
    assert np.array_equal(np.asarray(stmt.to_vec(), np.uint32), golden["stmt4"])


def test_device_z_chain_equals_native_chain(golden):
    """z_chain_device (one fq12_exp over the proof rows, then the product
    tree) against the C++ chain, with the proof's own challenges."""
    a, b = (convert.from_reference(golden[k], device="cpu") for k in ("a4", "b4"))
    proof = convert.from_reference(golden["proof4"], device="cpu")
    proof_u = native.fq12_limbs16_to_u64(golden["proof4"])
    tr = Transcript()
    tr.append_points(curves.g1_decode(a), curves.g2_decode(b))
    tr.append_fq12(tower.fq12_decode(proof[-1]))
    rows, z_u = [], proof_u[-1]
    for idx in (3, 1):
        tr.append_fq12(tower.fq12_decode(proof[idx]))
        tr.append_fq12(tower.fq12_decode(proof[idx - 1]))
        x = tr.get_challenge()
        rows += [(idx, x), (idx - 1, pow(x, -1, params.R))]
        z_u = native.fq12_mul(native.fq12_mul(native.fq12_pow(proof_u[idx], x), z_u),
                              native.fq12_pow(proof_u[idx - 1], rows[-1][1]))
    got = verifier.z_chain_device(proof, rows)
    assert tower.fq12_decode(got) == native.fq12_u64_to_tower_ints(z_u)


def test_transcript_without_native_equals_native(golden, monkeypatch):
    """The same messages give the same states and challenge whether the
    chain runs in the C++ library or in the pure-Python Poseidon."""
    a, b = (convert.from_reference(golden[k], device="cpu") for k in ("a4", "b4"))
    pts = curves.g1_decode(a), curves.g2_decode(b)
    z = tower.fq12_decode(convert.from_reference(golden["proof4"][-1], device="cpu"))
    runs = []
    for mode in (None, "1"):
        if mode is None:
            monkeypatch.delenv("SIPP_TPU_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("SIPP_TPU_NO_NATIVE", mode)
        assert native.enabled() is (mode is None)
        tr = Transcript()
        tr.append_points(*pts)
        tr.append_fq12(z)
        tr.append([1, 2, 3])
        runs.append((tr.state, tr.get_challenge()))
    assert runs[0] == runs[1]


def test_fq12_exp_rejects_bad_input():
    x = tower.fq12_one((3,)).contiguous()
    with pytest.raises(ValueError, match="bad shapes"):
        exp.fq12_exp(x, x, torch.zeros((254, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        exp.fq12_exp(x.to("meta"), x.to("meta"), torch.zeros((254, 3), device="meta",
                                                             dtype=torch.int64))
