"""SIPP verifier (port of sipp_tpu/protocol/verifier.py).

The JAX package's order: entry validation (validate.check_instance_async)
first, which raises at once on a bad limb of A or B and queues the curve
and r-torsion verdicts (X1) without a host sync; then the proof's limb
check, and the host replays the transcript and the Z' chain
Z' = Z_L^x * Z * Z_R^(x^-1) on the native C++ Fq12 pow/mul, popping the
proof from the back, while the card runs the verdicts.  So a bad proof limb
is reported before a curve or subgroup fault of the instance.  The finals
final_A, final_B come from one of two forms of the same group elements (so
the same canonical bytes):

- fold ladders: the device folds A and B with the challenges, one K3 launch
  per group and round;
- MSM finals: final_A = sum_j [c_j] A_j with c_j = prod_k x_k^bit_k(j)
  (bit_1 the MSB of j), final_B the x^-1 twin: one K6 launch per group with a
  zero offset (the per-lane ladders), then one X2 launch per group, the sum
  of the lanes as canonical affine (ops/msm.py msm_finish), where the JAX
  package runs XLA's tree and to_affine.

SIPP_VERIFY_MSM picks the form as in the JAX package: "auto" (the default)
takes MSM finals for CUDA tensors and fold ladders for CPU tensors, "1"
always MSM finals, "0" never.  Finally e(final_A, final_B) is computed with
one K1 + K2 aggregation, the validation verdicts are fetched (finish(),
which raises for a fault of the instance), and the pairing is compared
with final_Z.

With SIPP_TPU_NO_NATIVE set (native.enabled(), read per call) the verifier
uses no C++ library, as the JAX verifier without its library: the
transcript runs the pure-Python Poseidon, and the Z' chain runs on the
device as one K8 launch over the 2 log2(n) proof rows (z_chain_device).
"""

import os
import time

import numpy as np
import torch

from .. import curves, native, params
from ..curves import scalar_to_bits
from ..fields import tower
from ..ops import exp, fold, msm
from ..pairing import ate
from . import validate
from .prover import check_shapes
from .statements import SIPPStatement
from .transcript import Transcript
from .validate import VerificationError


def _use_msm(device) -> bool:
    """SIPP_VERIFY_MSM for points on `device`: "auto" (the default) takes
    the MSM finals for CUDA tensors only, "1" always, "0" never."""
    mode = os.environ.get("SIPP_VERIFY_MSM", "auto")
    if mode not in ("auto", "0", "1"):
        raise ValueError(f"SIPP_VERIFY_MSM must be auto, 0 or 1, got {mode!r}")
    return mode == "1" or (mode == "auto" and device.type == "cuda")


def msm_bits(xs, n: int):
    """The per-lane scalars of the MSM finals as (254, n) MSB-first bit
    planes for A and B: c_j = prod_k x_k^bit_k(j), d_j with x_k^-1, where
    xs = [(x_k, x_k^-1), ...] in round order and bit_1 is the MSB of j."""
    logn = len(xs)
    bits_a = np.empty((254, n), np.int64)
    bits_b = np.empty((254, n), np.int64)
    for j in range(n):
        c = d = 1
        for k, (x, x_inv) in enumerate(xs):
            if (j >> (logn - 1 - k)) & 1:
                c = c * x % params.R
                d = d * x_inv % params.R
        bits_a[:, j] = scalar_to_bits(c)
        bits_b[:, j] = scalar_to_bits(d)
    return bits_a, bits_b


def _finals_msm(a_g1, b_g2, xs):
    """final_A, final_B as (1, ...) affine: K6 with a zero offset, then the
    sum of the lanes (X2 on a card)."""
    finals = []
    for curve, k6, pts, bits in zip((curves.G1, curves.G2), (exp.exp_g1, exp.exp_g2),
                                    (a_g1, b_g2), msm_bits(xs, a_g1.shape[0])):
        lanes = k6(pts, torch.zeros_like(pts), torch.as_tensor(bits, device=pts.device))
        finals.append(msm.msm_finish(curve, lanes))
    return finals


def z_chain_device(proof, rows):
    """The final Z' = Z * prod_k Z_L,k^(x_k) * Z_R,k^(x_k^-1) on the proof's
    device (the per-round chain is a commutative product): one K8 launch
    with offset one over the proof rows [(row, exponent), ...], then the
    product tree of [Z, powers]; sipp_tpu/protocol/verifier.py:137-151."""
    z = proof[-1]
    if not rows:
        return z
    bases = torch.stack([proof[i] for i, _ in rows])
    bits = np.stack([scalar_to_bits(e) for _, e in rows], axis=1).astype(np.int64)
    powers = exp.fq12_exp(bases, tower.fq12_one(bases.shape[:1], proof.device),
                          torch.as_tensor(bits, device=proof.device))
    return ate.product_tree(torch.cat([z[None], powers]))


def _lap(split, name, t0, device, sync=False):
    """With a split dict: split[name] = the seconds since t0 (after a
    synchronize of the card where sync is set); returns the time now."""
    if split is None:
        return t0
    if sync and device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    split[name] = now - t0
    return now


def sipp_verify(a_g1, b_g2, proof, split=None) -> SIPPStatement:
    """proof: (2 log2(n) + 1, 2, 3, 2, 16) in the prover's reversed order.
    Returns the accepted SIPPStatement or raises VerificationError.

    split: None, or a dict that gets the wall seconds of the phases:
    validation_enqueue_s (the limb checks and the queued verdicts),
    replay_s (the proof's limb check, the host transcript and Z' chain),
    finals_s, aggregation_s (the final Z' and the pairing, read back) and
    finish_wait_s (the verdicts' fetch).  With a dict the finals end in a
    synchronize of the card, so finals_s also holds what the card still
    had queued; without one the verifier makes no extra host sync."""
    n = check_shapes(a_g1, b_g2)
    if tuple(proof.shape) != (2 * (n.bit_length() - 1) + 1, 2, 3, 2, 16):
        raise VerificationError(f"proof has shape {tuple(proof.shape)} for n = {n}")
    dev = a_g1.device
    t = time.perf_counter()
    finish = validate.check_instance_async(a_g1, b_g2)
    t = _lap(split, "validation_enqueue_s", t, dev)
    validate.check_proof(proof)

    use_native = native.enabled()
    a_host, b_host = curves.g1_decode(a_g1), curves.g2_decode(b_g2)
    tr = Transcript()
    tr.append_points(a_host, b_host)
    proof_u = native.fq12_limbs16_to_u64(proof.cpu().numpy())
    proof_ints = [native.fq12_u64_to_tower_ints(x) for x in proof_u]

    idx = len(proof_u) - 1
    z_u = proof_u[idx]
    tr.append_fq12(proof_ints[idx])
    idx -= 1
    sched, exp_rows = [], []
    n0 = n
    while n > 1:
        tr.append_fq12(proof_ints[idx])
        tr.append_fq12(proof_ints[idx - 1])
        x = tr.get_challenge()
        x_inv = pow(x, -1, params.R)
        if use_native:
            t_ = native.fq12_mul(native.fq12_pow(proof_u[idx], x), z_u)
            z_u = native.fq12_mul(t_, native.fq12_pow(proof_u[idx - 1], x_inv))
        else:
            exp_rows += [(idx, x), (idx - 1, x_inv)]
        idx -= 2
        n //= 2
        sched.append((n, x, x_inv))
    t = _lap(split, "replay_s", t, dev)

    a, b = a_g1, b_g2
    if n0 > 1 and _use_msm(dev):
        a, b = _finals_msm(a_g1, b_g2, [(x, x_inv) for _, x, x_inv in sched])
    else:
        for m, x, x_inv in sched:
            a = fold.fold_g1(a[:m], a[m:], scalar_to_bits(x))
            b = fold.fold_g2(b[:m], b[m:], scalar_to_bits(x_inv))
    t = _lap(split, "finals_s", t, dev, sync=True)

    if use_native:
        final_z = native.fq12_u64_to_tower_ints(z_u)
    else:
        final_z = tower.fq12_decode(z_chain_device(proof, exp_rows))
    stmt = SIPPStatement(A=a_host, B=b_host, Z=proof_ints[-1],
                         final_A=curves.g1_decode(a)[0], final_B=curves.g2_decode(b)[0],
                         final_Z=final_z)
    lhs = tower.fq12_decode(ate.inner_product(a, b))
    t = _lap(split, "aggregation_s", t, dev)
    finish()
    _lap(split, "finish_wait_s", t, dev)
    if lhs != final_z:
        raise VerificationError("Verification failed")
    return stmt
