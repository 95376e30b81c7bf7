"""Entry validation of a SIPP instance and proof, in plain PyTorch on the
inputs' device (port of sipp_tpu/protocol/validate.py, which is XLA code in
the JAX package, not a kernel):

  * limbs canonical: every limb < 2^16 and every Fq value < p;
  * A on the curve y^2 = x^3 + 3 (G1 has cofactor 1, so this is also
    subgroup membership);
  * B on the twist y^2 = x^3 + 3/(9+u) AND in the r-torsion: [r]Q == O via
    the complete-add ladder (the incomplete fold ladder must not be trusted
    with adversarial points).

(0, 0) encodes the point at infinity and is accepted.  Each check raises
VerificationError.
"""

import torch

from .. import hostref, params
from ..curves import G2, scalar_to_bits
from ..fields import FQ, tower

F = FQ


class VerificationError(Exception):
    pass


def check_limbs(x, what: str):
    """Raise unless every (..., 16) limb vector of x is a canonical Fq value."""
    if x.numel() == 0:
        return
    if bool(((x < 0) | (x > 0xFFFF)).any()):
        raise VerificationError(f"{what}: non-16-bit limb")
    if not bool(F.below_p(x).all()):
        raise VerificationError(f"{what}: non-canonical Fq limb value (>= p)")


def _first_bad(ok):
    return int(torch.nonzero(~ok.flatten())[0])


def check_instance(a_g1, b_g2, subgroup: bool = True):
    """Validate (A, B): canonical limbs, on-curve, and (subgroup=True) the G2
    r-torsion.  Raises VerificationError."""
    check_limbs(a_g1, "A")
    check_limbs(b_g2, "B")
    x, y = a_g1[..., 0, :], a_g1[..., 1, :]
    y2, xx = F.mul(torch.stack([y, x]), torch.stack([y, x])).unbind(0)
    b1 = F.encode(params.B_G1, a_g1.device)
    ok_a = F.is_zero(F.sub(y2, F.add(F.mul(xx, x), b1))) | (a_g1 == 0).flatten(-2).all(-1)
    if not bool(ok_a.all()):
        raise VerificationError(f"A: point off curve at index {_first_bad(ok_a)}")

    inf_b = (b_g2 == 0).flatten(-3).all(-1)
    X, Y = b_g2[..., 0, :, :], b_g2[..., 1, :, :]
    Y2, XX = tower.fq2_mul(torch.stack([Y, X]), torch.stack([Y, X])).unbind(0)
    b2 = tower.fq2_encode(hostref.B2, b_g2.device)
    rhs = F.add(tower.fq2_mul(XX, X), b2)
    ok_b = tower.fq2_is_zero(F.sub(Y2, rhs)) | inf_b
    if not bool(ok_b.all()):
        raise VerificationError(f"B: point off twist curve at index {_first_bad(ok_b)}")
    if subgroup:
        rq = G2.mul_check_ladder(b_g2, scalar_to_bits(params.R))
        ok_s = G2.is_infinity(rq) | inf_b
        if not bool(ok_s.all()):
            raise VerificationError(
                f"B: point outside the r-torsion subgroup at index {_first_bad(ok_s)}")


def check_proof(proof):
    """Validate a proof's limbs ((2 log2(n) + 1, 2, 3, 2, 16) Fq12s)."""
    check_limbs(proof, "proof")
