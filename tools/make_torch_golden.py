"""Freeze golden vectors from the JAX reference for the PyTorch port's tests.

Runs the unmodified `sipp_tpu` package on the CPU (its XLA paths, which the
package's own tests hold bit-identical to the Pallas kernels) and writes
tests/golden/torch_port.npz, a few KB of uint32 arrays in the reference
device format (16 x 16-bit Montgomery limbs):

  a4, b4           random_instance(4, seed=7)
  a2, b2           random_instance(2, seed=8)
  f4, f2           _product_tree(miller_loop(A, B))             (pre-FE)
  pair_p, pair_q   pair-mode Miller inputs (even lanes: A_hi x B_lo, odd
                   lanes: A_lo x B_hi), lane 2 set to the point at infinity
  pair_f           (2, ...) = _inner_f(A_hi, B_lo), _inner_f(A_lo, B_hi)
  pair_z           final_exp(pair_f)                              (B = 2)
  z4, z2           final_exp(f4), final_exp(f2)
  fold_x           the fixed G1 fold challenge (as 16-bit limbs; x^-1 for G2)
  fold_g1_lo/hi/out, fold_g2_lo/hi/out
                   G1/G2.to_affine(fold(lo, hi, bits)), lane 3 dead in both
  proof4           sipp_prove(a4, b4)
  stmt4            sipp_verify(a4, b4, proof4).to_vec() as uint32
  perm_in/out      poseidon.permute_device on a seeded (12, 5) state
  td_state, td_f1, td_f2
                   a seeded (4, 5) Goldilocks transcript state and two
                   seeded Fq12 values (canonical coefficients, Montgomery)
  td_append        transcript_device.append_fq12(td_state, td_f1)
  td_tail_state, td_tail_bits, td_tail_x, td_tail_xinv
                   the XLA twin of transcript_round_tail: both appends,
                   get_challenge, and FR.from_mont(FR.inv(FR.to_mont(x)))
  exp_bits         (254, 4) per-lane scalar bits; lane 1's scalar is even
  exp_g1_x/off/out, exp_g2_x/off/out
                   offset + [k]x per lane, affine, at B = 4: lane 0 generic,
                   lane 1 x at infinity, lane 2 offset at infinity, lane 3
                   offset == [k]x.  The ladder is the XLA
                   scalar_mul_per_lane; the offset add is pallas_exp's own
                   _add_mixed_complete, run in interpret mode, because the
                   XLA add_mixed has no affine-infinity select for the
                   offset (verifier.py:55-56); then XLA to_affine.  On
                   lanes 0 and 3 this equals G1/G2.exp_with_offset (checked)
  onchip_proof4, onchip_state4
                   sipp_prove_onchip(a4, b4, return_transcript=True) on the
                   XLA path (tests/test_onchip.py), proof and the transcript
                   state as four uint64
  msm_inf_a, msm_inf_b, msm_inf_x
                   the MSM finals at n = 4 on points with A_1 = O and B_2 = O,
                   with two seeded challenges (16-bit limbs) that give A_1 an
                   odd scalar and B_2 an even one
  msm_inf_lanes_a/b  exp_g1_fused / exp_g2_fused with a zero offset (K6,
                   interpret mode), per-lane affine products
  msm_inf_fused_a/b  the verifier's fused-path finals from those lanes:
                   to_affine(_tree_sum(jac_from_affine(lanes)))
  msm_inf_xla_a/b    _finals_msm_dev on the CPU (its XLA branch,
                   scalar_mul_per_lane then _tree_sum)
  step_p, step_q, step_qn
                   B = 3 lanes of (a4, b4) with P = O in lane 1 and Q = O in
                   lane 2, and -Q (standard layout)
  step_f, step_t   the Miller carry (f, T) after the first three digits of
                   _DIGITS (the XLA step body of ate.miller_loop), in the
                   step kernel's transposed layout (2, 3, 2, 16, B) and
                   (3, 2, 16, B)
  step_f{d}, step_t{d}
                   pallas_miller.miller_step(d, ...) on that carry, d = 0, 1,
                   2, in interpret mode (K7's own Pallas kernel)
  bls4_a, bls4_b, bls4_proof
                   the BLS aggregation instance of tests/test_bls.py (3
                   signatures from default_rng(7), then -G1 and sigma: n = 4)
                   and the proof of verify_bls_aggregation on the CPU
  bls128_instance_sha256, bls128_proof_sha256
                   SHA-256 (hex) of the BLS demo's n = 128 instance
                   (bls_aggregation.main's default_rng(0) stream; the bytes
                   of A then B, C-order uint32) and of sipp_prove's proof of
                   it on the CPU, which chip_smoke.py checks on the card
  torsion_a, torsion_b, torsion_ok
                   random_instance(8, seed=23) with B_1, B_4, B_6 raw map
                   points (map_to_g2_without_cofactor_mul((1234 + i, 5678)),
                   off the r-torsion), B_5 = [r] B_1 (of the cofactor's
                   order) and B_3 = O; torsion_ok: validate._g2_in_subgroup
                   of torsion_b (the XLA program that X1 replaces)
  torsion_prime_b, torsion_prime_ok
                   [r h2 / q] T for T = map_to_g2_without_cofactor_mul((1234,
                   5678)), of order r h2, and each prime q of r h2 (r first,
                   then h2's four primes: points of prime order q), then
                   [h2 / l] T for each prime l of h2 (order r l), and
                   _g2_in_subgroup's verdicts on them
  torsion_cases, torsion_case_a, torsion_case_b, torsion_when, torsion_msgs
                   instances from torsion_a and an honest B (lane 3 at
                   infinity), one per case (fine; A off the curve; B off
                   the twist; B outside the r-torsion; A off the curve and B
                   outside the r-torsion; a non-16-bit limb of B), and what
                   validate.check_instance_async does with each: "now" (it
                   raised), "finish" (its closure raised) or "none", with
                   the VerificationError's words
  sharded8_a, sharded8_b, sharded8_proof
                   random_instance(8, seed=5) (the instance of
                   tests/test_sharding.py) and its proof: sipp_prove's;
                   stages sharded8_d2 and sharded8_d4 check that
                   sipp_prove_sharded on make_mesh(2) and make_mesh(4), over
                   forced host devices, gives the same proof
  instance4096_digest
                   the port's utils/testing.points_digest (instance_digest's
                   layout) of random_points(4096, seed=1177), the JAX
                   package's host draw (~3 min of pure-Python multiplies);
                   chip_smoke.py holds the port's draw on the card to it
  fq12_exp_x, fq12_exp_off, fq12_exp_bits, fq12_exp_out
                   tower.fq12_exp_with_offset on four lanes from
                   default_rng(1177) (the inputs of
                   tests/test_torch_fq12_exp.py): lane 0 generic, lane 1
                   all-zero bits, lane 2 an offset of one, lane 3 x = 1

Each stage runs in its own process, two at a time.  Usage (about half an
hour on the CPU, most of it the XLA compiles of the on-chip stage and of
the n = 128 prove):

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py [--only STAGE ...]

--only runs the named stages and keeps every other array of the existing
file as it is.
"""

import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# host devices for the sharded stage's meshes (as tests/conftest.py forces)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sipp_tpu import params  # noqa: E402
from sipp_tpu.curves import G1, G2, scalar_to_bits  # noqa: E402
from sipp_tpu.fields import bigint  # noqa: E402
from sipp_tpu.pairing.ate import (_inner_f, _product_tree, final_exp,  # noqa: E402
                                  miller_loop)
from sipp_tpu.protocol import sipp_prove, sipp_verify  # noqa: E402
from sipp_tpu.utils.testing import random_instance  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden" / "torch_port.npz"

# fold challenge with its top (254th) bit set, so the ladder's start at
# [bit0]base takes the base; its inverse exercises an arbitrary top bit
FOLD_X = params.R - 12345


def u32(x):
    return np.asarray(jax.device_get(x), dtype=np.uint32)


def log(msg, t0=[time.time()]):
    print(f"[{time.time() - t0[0]:7.1f}s] {msg}", flush=True)


def stage_inputs(g):
    a4, b4 = random_instance(4, seed=7)
    a2, b2 = random_instance(2, seed=8)
    g.update(a4=u32(a4), b4=u32(b4), a2=u32(a2), b2=u32(b2))


def stage_miller(g):
    stage_inputs(g)
    g["f4"] = u32(_product_tree(miller_loop(g["a4"], g["b4"])))
    g["f2"] = u32(_product_tree(miller_loop(g["a2"], g["b2"])))


def _pair_inputs(A, B):
    # pair mode at W = 4, m = 2: lanes interleave (A_hi, B_lo) on even lanes
    # and (A_lo, B_hi) on odd lanes; lane 2 (A_hi[1] x B_lo[1]) is dead
    a_lo, a_hi, b_lo, b_hi = A[:2].copy(), A[2:].copy(), B[:2], B[2:]
    a_hi[1] = 0
    p = np.stack([a_hi, a_lo], axis=1).reshape(4, 2, 16)
    q = np.stack([b_lo, b_hi], axis=1).reshape(4, 2, 2, 16)
    return a_lo, a_hi, b_lo, b_hi, p, q


def stage_pair(g):
    stage_inputs(g)
    a_lo, a_hi, b_lo, b_hi, p, q = _pair_inputs(g["a4"], g["b4"])
    fl = _inner_f(a_hi, b_lo, None)
    fr = _inner_f(a_lo, b_hi, None)
    g.update(pair_p=p, pair_q=q, pair_f=np.stack([u32(fl), u32(fr)]))


def stage_fexp(g, pair_f, f4, f2):
    g["pair_z"] = u32(final_exp(pair_f))
    g["z4"] = u32(final_exp(f4[None]))[0]
    g["z2"] = u32(final_exp(f2[None]))[0]


def stage_fold(g):
    stage_inputs(g)
    A, B = g["a4"], g["b4"]
    xinv = pow(FOLD_X, -1, params.R)
    g["fold_x"] = bigint.int_to_limbs(FOLD_X, 16)
    lo1, hi1 = A.copy(), np.roll(A, 1, axis=0)
    lo2, hi2 = B.copy(), np.roll(B, 1, axis=0)
    for arr in (lo1, hi1, lo2, hi2):
        arr[3] = 0
    g.update(fold_g1_lo=lo1, fold_g1_hi=hi1, fold_g2_lo=lo2, fold_g2_hi=hi2)
    g["fold_g1_out"] = u32(G1.to_affine(G1.fold(lo1, hi1, scalar_to_bits(FOLD_X))))
    g["fold_g2_out"] = u32(G2.to_affine(G2.fold(lo2, hi2, scalar_to_bits(xinv))))


def stage_prove(g):
    stage_inputs(g)
    g["proof4"] = u32(sipp_prove(g["a4"], g["b4"]))


def stage_verify(g, proof4):
    stage_inputs(g)
    stmt = sipp_verify(g["a4"], g["b4"], proof4)
    g["stmt4"] = np.asarray(stmt.to_vec(), dtype=np.uint32)


def stage_transcript(g):
    from sipp_tpu.fields import FGL, FQ, FR, poseidon, tower
    from sipp_tpu.protocol import transcript_device as td

    rng = np.random.default_rng(2024)

    def gl(k):
        return FGL.encode([int.from_bytes(rng.bytes(8), "little") % FGL.p
                           for _ in range(k)])

    def fq12():
        vals = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12)]
        return tower.fq12_encode(tuple(tuple((vals[6 * i + 2 * j], vals[6 * i + 2 * j + 1])
                                             for j in range(3)) for i in range(2)))

    perm_in = gl(12)
    g["perm_in"], g["perm_out"] = u32(perm_in), u32(poseidon.permute_device(perm_in))
    state, f1, f2 = gl(4), fq12(), fq12()
    g.update(td_state=u32(state), td_f1=u32(f1), td_f2=u32(f2))
    g["td_append"] = u32(td.append_fq12(state, f1))
    st = td.append_fq12(td.append_fq12(state, f1), f2)
    bits, x = td.get_challenge(st)
    g.update(td_tail_state=u32(st), td_tail_bits=u32(bits), td_tail_x=u32(x),
             td_tail_xinv=u32(FR.from_mont(FR.inv(FR.to_mont(x)))))
    assert FQ.L == FR.L == 16


def _exp_complete(curve, ad, coeff, x, off, bits):
    """to_affine(pallas_exp._add_mixed_complete(scalar_mul_per_lane(x, bits),
    off)), the complete add in an interpret-mode pallas_call."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from sipp_tpu.ops import pallas_exp as pe
    from sipp_tpu.ops import tmul

    acc = curve.scalar_mul_per_lane(x, bits)
    nd = acc.ndim
    perm = tuple(range(1, nd)) + (0,)

    def kernel(c_ref, p_ref, q_ref, o_ref):
        with tmul.bound_consts(c_ref[:]):
            o_ref[:] = pe._add_mixed_complete(p_ref[:], q_ref[:], ad)

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((3,) + coeff + (16, x.shape[0]), jnp.uint32),
        interpret=True,
    )(jnp.asarray(tmul.CONSTS_NP), jnp.transpose(acc, perm), jnp.transpose(off, perm))
    inv = (nd - 1,) + tuple(range(nd - 1))
    return curve.to_affine(jnp.transpose(out, inv))


def stage_exp(g):
    import jax.numpy as jnp

    from sipp_tpu import hostref
    from sipp_tpu.curves import g1_encode, g2_encode
    from sipp_tpu.ops import pallas_fold as pf
    from sipp_tpu.utils.testing import random_points

    rng = np.random.default_rng(4242)
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(4)]
    ks[1] &= ~1                      # even: see the module docstring
    bits = np.stack([scalar_to_bits(k) for k in ks], axis=1)
    g["exp_bits"] = bits.astype(np.uint32)
    xa, xb = random_points(4, seed=51)
    oa, ob = random_points(4, seed=52)
    xa[1] = xb[1] = None             # x at infinity
    oa[2] = ob[2] = None             # offset at infinity
    oa[3] = hostref.g1_mul(xa[3], ks[3])
    ob[3] = hostref.g2_mul(xb[3], ks[3])
    for name, curve, ad, coeff, x, off in (
            ("g1", G1, pf._FqAd, (), g1_encode(xa), g1_encode(oa)),
            ("g2", G2, pf._Fq2Ad, (2,), g2_encode(xb), g2_encode(ob))):
        out = _exp_complete(curve, ad, coeff, x, off, jnp.asarray(bits))
        xla = curve.to_affine(curve.exp_with_offset(x, off, jnp.asarray(bits)))
        assert np.array_equal(u32(out)[[0, 3]], u32(xla)[[0, 3]])
        g[f"exp_{name}_x"], g[f"exp_{name}_off"] = u32(x), u32(off)
        g[f"exp_{name}_out"] = u32(out)


def stage_msm_inf(g):
    import jax.numpy as jnp

    from sipp_tpu.curves import g1_encode, g2_encode
    from sipp_tpu.ops.msm import _tree_sum
    from sipp_tpu.ops.pallas_exp import exp_g1_fused, exp_g2_fused
    from sipp_tpu.protocol.verifier import _finals_msm_dev
    from sipp_tpu.utils.testing import random_points

    rng = np.random.default_rng(4344)   # c_1 odd, d_2 even
    xs = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(2)]
    bits_a = np.empty((254, 4), np.uint32)
    bits_b = np.empty((254, 4), np.uint32)
    for j in range(4):                  # as sipp_tpu/protocol/verifier.py:167-174
        c = d = 1
        for k, x in enumerate(xs):
            if (j >> (1 - k)) & 1:
                c = c * x % params.R
                d = d * pow(x, -1, params.R) % params.R
        bits_a[:, j], bits_b[:, j] = scalar_to_bits(c), scalar_to_bits(d)
    pa, pb = random_points(4, seed=53)
    pa[1] = pb[2] = None
    a, b = g1_encode(pa), g2_encode(pb)
    g.update(msm_inf_a=u32(a), msm_inf_b=u32(b),
             msm_inf_x=np.stack([bigint.int_to_limbs(x, 16) for x in xs]))
    for name, curve, k6, pts, bits in (("a", G1, exp_g1_fused, a, bits_a),
                                       ("b", G2, exp_g2_fused, b, bits_b)):
        lanes = k6(pts, jnp.zeros_like(pts), jnp.asarray(bits), interpret=True)
        g[f"msm_inf_lanes_{name}"] = u32(lanes)
        g[f"msm_inf_fused_{name}"] = u32(
            curve.to_affine(_tree_sum(curve, curve.jac_from_affine(lanes))[None]))
    xla_a, xla_b = _finals_msm_dev(a, b, jnp.asarray(bits_a), jnp.asarray(bits_b))
    g.update(msm_inf_xla_a=u32(xla_a), msm_inf_xla_b=u32(xla_b))


def stage_miller_step(g):
    import jax.numpy as jnp

    from sipp_tpu.fields import FQ, tower
    from sipp_tpu.ops import pallas_miller, tmul
    from sipp_tpu.pairing import ate

    stage_inputs(g)
    p, q = g["a4"][:3].copy(), g["b4"][:3].copy()
    p[1] = 0
    q[2] = 0
    qn = jnp.asarray(q).at[:, 1].set(FQ.neg(q[:, 1]))

    @jax.jit
    def prefix(p, q, qn):
        """f, T after the first three digits (ate.miller_loop's scan body)."""
        xp, yp = p[:, 0], p[:, 1]
        f = tower.fq12_ones((3,))
        t = jnp.concatenate([q, jnp.broadcast_to(tower.fq2_encode((1, 0)), (3, 1, 2, 16))], 1)
        for digit in ate._DIGITS[:3]:
            f = tower.fq12_sqr(f)
            t, line = ate._dbl_step(t, xp, yp)
            f = tower.fq12_mul_line(f, *line)
            if digit:
                t, line = ate._add_step(t, q if digit == 1 else qn, xp, yp)
                f = tower.fq12_mul_line(f, *line)
        return f, t

    f, t = prefix(p, q, qn)
    carry = (jnp.transpose(f, (1, 2, 3, 4, 0)), jnp.transpose(t, (1, 2, 3, 0)))
    qp_t, qn_t = jnp.transpose(q, (1, 2, 3, 0)), jnp.transpose(qn, (1, 2, 3, 0))
    p_t = jnp.transpose(p, (1, 2, 0))
    g.update(step_p=p, step_q=q, step_qn=u32(qn), step_f=u32(carry[0]), step_t=u32(carry[1]))
    for d in (0, 1, 2):
        fo, to = pallas_miller.miller_step(d, jnp.asarray(tmul.CONSTS_NP), qp_t, qn_t, p_t,
                                           carry, True)
        g[f"step_f{d}"], g[f"step_t{d}"] = u32(fo), u32(to)


def stage_onchip(g):
    from sipp_tpu.protocol.prover import sipp_prove_onchip

    stage_inputs(g)
    proof, tr = sipp_prove_onchip(g["a4"], g["b4"], return_transcript=True)
    g["onchip_proof4"] = u32(proof)
    g["onchip_state4"] = np.asarray(tr.state, dtype=np.uint64)


def bls_instance(n, rng):
    """The BLS demo's instance of n - 1 signatures from rng (keys, then
    messages, as bls_aggregation.main and tests/test_bls.py draw them):
    A = pks || -G1, B = H(m) || sigma, as uint32 limb arrays."""
    from sipp_tpu import hostref
    from sipp_tpu.apps import bls_aggregation as BLS
    from sipp_tpu.curves import g1_encode, g2_encode

    keys = [BLS.keygen(rng) for _ in range(n - 1)]
    msgs = [(int.from_bytes(rng.bytes(31), "little"), int.from_bytes(rng.bytes(31), "little"))
            for _ in range(n - 1)]
    sigma = BLS.aggregate([BLS.sign(sk, m) for (sk, _), m in zip(keys, msgs)])
    a = g1_encode([pk for _, pk in keys] + [hostref.g1_neg(params.G1_GEN)])
    b = g2_encode([BLS.hash_to_g2(m) for m in msgs] + [sigma])
    return keys, msgs, sigma, u32(a), u32(b)


def stage_bls(g):
    from sipp_tpu.apps import bls_aggregation as BLS

    keys, msgs, sigma, a, b = bls_instance(4, np.random.default_rng(7))
    ok, proof = BLS.verify_bls_aggregation([pk for _, pk in keys], msgs, sigma)
    assert ok
    g.update(bls4_a=a, bls4_b=b, bls4_proof=u32(proof))


def stage_bls128(g):
    import hashlib

    _, _, _, a, b = bls_instance(128, np.random.default_rng(0))
    log("bls128 instance built")
    proof = u32(sipp_prove(a, b))
    g["bls128_instance_sha256"] = np.array(hashlib.sha256(a.tobytes() + b.tobytes()).hexdigest())
    g["bls128_proof_sha256"] = np.array(hashlib.sha256(proof.tobytes()).hexdigest())


def _plus_one(limbs):
    """y -> y + 1 (mod p) of 16 Montgomery limbs (uint32): adds R mod p."""
    v = sum(int(x) << (16 * i) for i, x in enumerate(limbs))
    v = (v + (1 << 256) % params.P) % params.P
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)], np.uint32)


def stage_torsion(g):
    from sipp_tpu import hostref
    from sipp_tpu.apps.bls_aggregation import map_to_g2_without_cofactor_mul
    from sipp_tpu.curves import g2_encode
    from sipp_tpu.protocol import validate
    from sipp_tpu.protocol.verifier import VerificationError

    from sipp_tpu_torch.params import G2_COFACTOR, G2_COFACTOR_PRIMES

    a, b_honest = (u32(x).copy() for x in random_instance(8, seed=23))
    raw = [map_to_g2_without_cofactor_mul((1234 + i, 5678)) for i in range(3)]
    b = b_honest.copy()
    b[[1, 4, 6]] = u32(g2_encode(raw))
    b[5] = u32(g2_encode([hostref.g2_mul_raw(raw[0], params.R)]))[0]
    b[3] = 0
    b_honest[3] = 0
    g.update(torsion_a=a, torsion_b=b,
             torsion_ok=np.asarray(jax.device_get(validate._g2_in_subgroup(b)), bool))
    order = params.R * G2_COFACTOR
    scalars = [order // q for q in (params.R, *G2_COFACTOR_PRIMES)] + [
        G2_COFACTOR // q for q in G2_COFACTOR_PRIMES]
    prime_b = u32(g2_encode([hostref.g2_mul_raw(raw[0], k) for k in scalars]))
    g.update(torsion_prime_b=prime_b, torsion_prime_ok=np.asarray(
        jax.device_get(validate._g2_in_subgroup(prime_b)), bool))
    log(f"torsion_prime_ok {g['torsion_prime_ok'].tolist()}")
    off_a, off_b, limb_b, outside = a.copy(), b_honest.copy(), b_honest.copy(), b_honest.copy()
    off_a[2, 1] = _plus_one(off_a[2, 1])
    off_b[6, 1, 0] = _plus_one(off_b[6, 1, 0])
    limb_b[0, 0, 0, 3] = 1 << 16
    outside[4] = b[4]
    cases = {"fine": (a, b_honest), "off_curve_a": (off_a, b_honest),
             "off_twist_b": (a, off_b), "outside_subgroup_b": (a, outside),
             "off_curve_a_outside_subgroup_b": (off_a, outside), "limb_b": (a, limb_b)}
    when, msgs = [], []
    for case_a, case_b in cases.values():
        try:
            finish = validate.check_instance_async(case_a, case_b)
        except VerificationError as e:
            when.append("now")
            msgs.append(str(e))
            continue
        try:
            finish()
            when.append("none")
            msgs.append("")
        except VerificationError as e:
            when.append("finish")
            msgs.append(str(e))
    log(f"torsion: {list(zip(when, msgs))}")
    g.update(torsion_cases=np.array(list(cases)),
             torsion_case_a=np.stack([c[0] for c in cases.values()]),
             torsion_case_b=np.stack([c[1] for c in cases.values()]),
             torsion_when=np.array(when), torsion_msgs=np.array(msgs))


def stage_sharded8(g):
    a, b = random_instance(8, seed=5)
    g.update(sharded8_a=u32(a), sharded8_b=u32(b), sharded8_proof=u32(sipp_prove(a, b)))


def stage_instance4096(g):
    from sipp_tpu.utils.testing import random_points

    from sipp_tpu_torch.utils.testing import points_digest

    g["instance4096_digest"] = np.array(points_digest(*random_points(4096, seed=1177)))
    log(f"instance4096_digest {g['instance4096_digest']}")


def stage_fq12_exp(g):
    from sipp_tpu import hostref
    from sipp_tpu.fields import tower

    rng = np.random.default_rng(1177)

    def fq12():
        v = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12)]
        return tuple(tuple((v[6 * i + 2 * j], v[6 * i + 2 * j + 1]) for j in range(3))
                     for i in range(2))

    xs = [fq12() for _ in range(4)]
    offs = [fq12() for _ in range(4)]
    xs[3], offs[2] = hostref.FQ12_ONE, hostref.FQ12_ONE
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(4)]
    ks[1] = 0
    bits = np.stack([scalar_to_bits(k) for k in ks], axis=1)
    x, off = tower.fq12_encode(xs), tower.fq12_encode(offs)
    g.update(fq12_exp_x=u32(x), fq12_exp_off=u32(off), fq12_exp_bits=bits,
             fq12_exp_out=u32(tower.fq12_exp_with_offset(x, off, bits)))


def stage_sharded8_mesh(d, deps):
    """Checks, writes nothing: the JAX sharded prover on d forced host
    devices gives stage sharded8's proof."""
    from sipp_tpu.parallel import make_mesh, sipp_prove_sharded

    proof = sipp_prove_sharded(deps["sharded8_a"], deps["sharded8_b"], make_mesh(d))
    assert np.array_equal(u32(proof), deps["sharded8_proof"]), d


# Each stage runs in its own process: XLA:CPU runs out of memory maps when
# one process compiles every program of the list.  (stage, inputs it needs)
STAGES = [("onchip", ()), ("miller", ()), ("pair", ()), ("fold", ()), ("prove", ()),
          ("fexp", ("pair", "miller")), ("verify", ("prove",)), ("transcript", ()),
          ("exp", ()), ("msm_inf", ()), ("miller_step", ()), ("bls", ()), ("bls128", ()),
          ("sharded8", ()), ("sharded8_d2", ("sharded8",)), ("sharded8_d4", ("sharded8",)),
          ("torsion", ()), ("instance4096", ()), ("fq12_exp", ())]


def run_stage(name, tmp):
    g = {}
    deps = {}
    for dep in dict(STAGES)[name]:
        with np.load(tmp / f"{dep}.npz") as d:
            deps.update({k: d[k] for k in d.files})
    if name == "fexp":
        stage_fexp(g, deps["pair_f"], deps["f4"], deps["f2"])
    elif name == "verify":
        stage_verify(g, deps["proof4"])
    elif name.startswith("sharded8_d"):
        stage_sharded8_mesh(int(name[len("sharded8_d"):]), deps)
    else:
        globals()[f"stage_{name}"](g)
    np.savez(tmp / f"{name}.npz", **g)
    log(f"stage {name} done")


def main(only=()):
    import subprocess
    import tempfile

    todo = [(name, deps) for name, deps in STAGES if not only or name in only]
    if only and (set(only) - {name for name, _ in todo}
                 or any(set(deps) - set(only) for _, deps in todo)):
        raise SystemExit(f"--only: unknown stages, or stages whose inputs are not listed: {only}")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = pathlib.Path(tmpdir)
        done, running = set(), {}
        while len(done) < len(todo):
            for name, deps in todo:
                if (name not in done and name not in running and len(running) < 2
                        and set(deps) <= done):
                    running[name] = subprocess.Popen(
                        [sys.executable, __file__, "--stage", name, str(tmp)])
            for name, proc in list(running.items()):
                if proc.poll() is not None:
                    if proc.returncode != 0:
                        raise SystemExit(f"stage {name} failed ({proc.returncode})")
                    done.add(name)
                    del running[name]
            time.sleep(1)
        g = {}
        if only:
            with np.load(OUT) as d:
                g.update({k: d[k] for k in d.files})
        for name, _ in todo:
            with np.load(tmp / f"{name}.npz") as d:
                g.update({k: d[k] for k in d.files})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **g)
    log(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--stage":
        run_stage(sys.argv[2], pathlib.Path(sys.argv[3]))
    elif len(sys.argv) > 2 and sys.argv[1] == "--only":
        main(sys.argv[2:])
    else:
        main()
