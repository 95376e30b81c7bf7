"""SIPP verifier, fold-ladder finals (port of sipp_tpu/protocol/verifier.py
with SIPP_VERIFY_MSM=0).

Entry validation (validate.py) first; then the host replays the transcript
and the Z' chain Z' = Z_L^x * Z * Z_R^(x^-1) on the native C++ Fq12 pow/mul,
popping the proof from the back; the device folds A and B with the same
challenges (one K3 launch per group and round); finally
e(final_A, final_B) == final_Z is checked with one K1 + K2 aggregation.
The MSM-form finals of the JAX package (per-lane exp kernels) are not part
of this port yet.
"""

from .. import curves, native, params
from ..curves import scalar_to_bits
from ..fields import tower
from ..ops import fold
from ..pairing import ate
from . import validate
from .prover import check_shapes
from .statements import SIPPStatement
from .transcript import Transcript
from .validate import VerificationError


def sipp_verify(a_g1, b_g2, proof) -> SIPPStatement:
    """proof: (2 log2(n) + 1, 2, 3, 2, 16) in the prover's reversed order.
    Returns the accepted SIPPStatement or raises VerificationError."""
    n = check_shapes(a_g1, b_g2)
    if tuple(proof.shape) != (2 * (n.bit_length() - 1) + 1, 2, 3, 2, 16):
        raise VerificationError(f"proof has shape {tuple(proof.shape)} for n = {n}")
    validate.check_instance(a_g1, b_g2)
    validate.check_proof(proof)

    a_host, b_host = curves.g1_decode(a_g1), curves.g2_decode(b_g2)
    tr = Transcript()
    tr.append_points(a_host, b_host)
    proof_u = native.fq12_limbs16_to_u64(proof.cpu().numpy())
    proof_ints = [native.fq12_u64_to_tower_ints(x) for x in proof_u]

    idx = len(proof_u) - 1
    z_u = proof_u[idx]
    tr.append_fq12(proof_ints[idx])
    idx -= 1
    sched = []
    while n > 1:
        tr.append_fq12(proof_ints[idx])
        tr.append_fq12(proof_ints[idx - 1])
        x = tr.get_challenge()
        x_inv = pow(x, -1, params.R)
        t = native.fq12_mul(native.fq12_pow(proof_u[idx], x), z_u)
        z_u = native.fq12_mul(t, native.fq12_pow(proof_u[idx - 1], x_inv))
        idx -= 2
        n //= 2
        sched.append((n, x, x_inv))

    a, b = a_g1, b_g2
    for m, x, x_inv in sched:
        a = fold.fold_g1(a[:m], a[m:], scalar_to_bits(x))
        b = fold.fold_g2(b[:m], b[m:], scalar_to_bits(x_inv))

    final_z = native.fq12_u64_to_tower_ints(z_u)
    stmt = SIPPStatement(A=a_host, B=b_host, Z=proof_ints[-1],
                         final_A=curves.g1_decode(a)[0], final_B=curves.g2_decode(b)[0],
                         final_Z=final_z)
    if tower.fq12_decode(ate.inner_product(a, b)) != final_z:
        raise VerificationError("Verification failed")
    return stmt
