"""K6 (per-lane exp ladders) and the MSM finals of the port: the plain
versions (ops/exp.py, curves' scalar_mul_per_lane / exp_with_offset / add,
ops/msm.py) against golden vectors frozen from the JAX package, with an x at
infinity, an offset at infinity and an offset equal to [k]x, and against
hostref sums.  Exact equality.  The golden values are the JAX package's
per-lane ladder followed by pallas_exp's own complete offset add (see
tools/make_torch_golden.py).  Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernels are compared with these plain versions on the card by
chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, hostref, params
from sipp_tpu_torch.curves import G1, G2, scalar_to_bits
from sipp_tpu_torch.ops import exp, fold, msm
from sipp_tpu_torch.protocol import verifier
from sipp_tpu_torch.utils.testing import random_points

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"
GROUPS = {"g1": (G1, exp.exp_g1, curves.g1_encode, curves.g1_decode, hostref.g1_add,
                 hostref.g1_mul),
          "g2": (G2, exp.exp_g2, curves.g2_encode, curves.g2_decode, hostref.g2_add,
                 hostref.g2_mul)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files if k.startswith(("exp_", "msm_inf_"))}


def _bits(ks):
    return torch.as_tensor(np.stack([scalar_to_bits(k) for k in ks], 1).astype(np.int64))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_exp_matches_reference(golden, group):
    """Lane 0 generic, lane 1 x = O, lane 2 offset = O, lane 3 offset == [k]x."""
    curve, k6, _, dec, add, mul = GROUPS[group]
    x = convert.from_reference(golden[f"exp_{group}_x"], device="cpu")
    off = convert.from_reference(golden[f"exp_{group}_off"], device="cpu")
    bits = torch.as_tensor(golden["exp_bits"].astype(np.int64))
    before = k6.launches
    out = k6(x, off, bits)
    assert k6.launches == before          # the plain version on a CPU tensor
    assert np.array_equal(convert.to_reference(out), golden[f"exp_{group}_out"])
    ks = [int("".join(map(str, col)), 2) for col in golden["exp_bits"].T]
    assert dec(x)[1] is None and dec(off)[2] is None and dec(off)[3] == mul(dec(x)[3], ks[3])
    assert dec(out) == [add(o, mul(p, k) if p is not None else None)
                        for p, o, k in zip(dec(x), dec(off), ks)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_hostref(group):
    curve, _, enc, dec, add, mul = GROUPS[group]
    A, B = random_points(3, seed=61)
    pts = A if group == "g1" else B
    rng = np.random.default_rng(62)
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in pts]
    got = dec(curve.to_affine(msm.msm(curve, enc(pts), _bits(ks))[None]))[0]
    want = None
    for p, k in zip(pts, ks):
        want = add(want, mul(p, k))
    assert got == want


def test_complete_add_cases():
    """P + Q, P + P, P + (-P), O + P, P + O against hostref."""
    A, _ = random_points(2, seed=63)
    p, q = G1.jac_from_affine(curves.g1_encode(A))
    pd = G1.dbl(p)                       # a Jacobian point with Z != 1
    inf = G1.jac_infinity()
    lhs = torch.stack([pd, pd, pd, inf, pd])
    rhs = torch.stack([q, pd, G1.neg(pd), pd, inf])
    got = curves.g1_decode(G1.to_affine(G1.add(lhs, rhs)))
    P2 = hostref.g1_add(A[0], A[0])
    assert got == [hostref.g1_add(P2, A[1]), hostref.g1_add(P2, P2), None, P2, P2]


def test_msm_finals_equal_fold_ladders_with_infinity_lane():
    """The verifier's MSM finals and its fold ladders give the same finals,
    also for an instance with a point at infinity (its K6 lane is (0, 0),
    which the tree must take as O)."""
    A, B = random_points(4, seed=64)
    A[1], B[2] = None, None
    a, b = curves.g1_encode(A), curves.g2_encode(B)
    xs = [params.R - 777, 123456789]
    fa, fb = verifier._finals_msm(a, b, [(x, pow(x, -1, params.R)) for x in xs])
    la, lb = a, b
    for x, m in zip(xs, (2, 1)):
        la = fold.fold_g1(la[:m], la[m:], scalar_to_bits(x))
        lb = fold.fold_g2(lb[:m], lb[m:], scalar_to_bits(pow(x, -1, params.R)))
    assert torch.equal(fa, la) and torch.equal(fb, lb)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_finals_with_infinity_lane_against_reference(golden, group):
    """A_1 = O, B_2 = O (tools/make_torch_golden.py, stage msm_inf).  The
    port's K6 lanes equal the JAX K6's, and its finals (lift, tree,
    to_affine) equal the hostref sum.  The JAX fused path lifts the (0, 0)
    lane with jac_from_affine to the point (0, 0, 1), which its complete add
    takes for a real point, so its finals miss the sum; its XLA branch ends
    an infinity lane's ladder at (0, 0, 1) too where the lane's scalar is
    odd, and gets the sum exactly where it is even."""
    curve, k6, _, dec, add, mul = GROUPS[group]
    side = "a" if group == "g1" else "b"
    xs = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in golden["msm_inf_x"]]
    xs = [(x, pow(x, -1, params.R)) for x in xs]
    pts = {s: convert.from_reference(golden[f"msm_inf_{s}"], device="cpu") for s in "ab"}
    bits = torch.as_tensor(verifier.msm_bits(xs, 4)[group == "g2"])
    lanes = k6(pts[side], torch.zeros_like(pts[side]), bits)
    assert np.array_equal(convert.to_reference(lanes), golden[f"msm_inf_lanes_{side}"])
    ks = [int("".join(map(str, col)), 2) for col in bits.T.tolist()]
    want = None
    for p, k in zip(dec(pts[side]), ks):
        want = add(want, mul(p, k) if p is not None else None)
    got = msm.msm_finish(curve, lanes)
    assert dec(got)[0] == want
    assert torch.equal(verifier._finals_msm(pts["a"], pts["b"], xs)[group == "g2"], got)
    assert dec(convert.from_reference(golden[f"msm_inf_fused_{side}"], device="cpu"))[0] != want
    k_inf = ks[dec(pts[side]).index(None)]
    xla = dec(convert.from_reference(golden[f"msm_inf_xla_{side}"], device="cpu"))[0]
    assert (xla == want) == (k_inf % 2 == 0)


def test_exp_rejects_bad_shapes():
    x = torch.zeros((3, 2, 16), dtype=torch.int64)
    with pytest.raises(ValueError):
        exp.exp_g1(x, x, torch.zeros((254, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        exp.exp_g1(x, x[:2], torch.zeros((254, 3), dtype=torch.int64))
