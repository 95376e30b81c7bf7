"""Entry validation of a SIPP instance and proof (port of
sipp_tpu/protocol/validate.py, which is XLA code in the JAX package, not a
kernel):

  * limbs canonical: every limb < 2^16 and every Fq value < p;
  * A on the curve y^2 = x^3 + 3 (G1 has cofactor 1, so this is also
    subgroup membership);
  * B on the twist y^2 = x^3 + 3/(9+u) AND in the r-torsion, kernel X1 on
    a card (ops/validate.py): not [r]Q == O over r's 254 bits, as the JAX
    package checks it, but the endomorphism test of eprint 2022/348
    (sections 3 and 5.1) over x0's 63 bits with the complete additions (the
    incomplete fold ladder must not be trusted with adversarial points),
    which gives the same verdict on every point of the twist
    (tests/test_torch_torsion.py proves it).  Off the twist the torsion
    verdict means nothing: finish() reports an off-twist B before it reads
    any torsion verdict, so the words are the JAX package's on every input.

(0, 0) encodes the point at infinity and is accepted.  Each check raises
VerificationError.  check_instance_async runs the limb checks at once and
queues the curve and subgroup verdicts on the points' device without a
host sync (on a side stream), as the JAX package dispatches its two
programs; the verifier fetches them (finish()) just before its final
comparison, so they run while the host replays the transcript.
"""

import functools

import torch

from .. import hostref, params
from ..fields import FQ, tower
from ..ops import validate as x1

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


@functools.lru_cache(maxsize=None)
def _curve_constants(device):
    """b of G1 (3) and of the twist (3/(9+u)), Montgomery, on `device`: made
    once a device, so that a later check copies nothing to it (a copy
    from the host would sync)."""
    return F.encode(params.B_G1, device), tower.fq2_encode(hostref.B2, device)


def curve_verdicts(a_g1, b_g2):
    """(ok_a, ok_b) per lane, bool on the points' device, no host sync: A on
    the curve, B on the twist; (0, 0) infinity lanes pass."""
    b1, b2 = _curve_constants(a_g1.device)
    x, y = a_g1[..., 0, :], a_g1[..., 1, :]
    y2, xx = F.mul(torch.stack([y, x]), torch.stack([y, x])).unbind(0)
    ok_a = F.is_zero(F.sub(y2, F.add(F.mul(xx, x), b1))) | (a_g1 == 0).flatten(-2).all(-1)
    X, Y = b_g2[..., 0, :, :], b_g2[..., 1, :, :]
    Y2, XX = tower.fq2_mul(torch.stack([Y, X]), torch.stack([Y, X])).unbind(0)
    rhs = F.add(tower.fq2_mul(XX, X), b2)
    ok_b = tower.fq2_is_zero(F.sub(Y2, rhs)) | (b_g2 == 0).flatten(-3).all(-1)
    return ok_a, ok_b


@functools.lru_cache(maxsize=None)
def _side_stream(device):
    return torch.cuda.Stream(device)


def queue_verdicts(a_g1, b_g2, subgroup: bool = True):
    """The device part of check_instance_async: (stream, verdicts), the
    bool verdicts [ok_a, ok_b(, ok_subgroup)] per lane queued with no host
    sync.  On a card they run on a side stream of the points' device, after
    what the current stream has queued, so that a host read on the current
    stream (the verifier's decode of the points and the proof) does not
    wait for them, as JAX's asynchronous dispatch does not; stream is None
    on the CPU."""
    side = _side_stream(a_g1.device) if a_g1.device.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(a_g1.device))
        for t in (a_g1, b_g2):
            t.record_stream(side)       # the caller's points stay until side has read them
    with torch.cuda.stream(side):       # (None: a no-op)
        ok = [*curve_verdicts(a_g1, b_g2)]
        if subgroup:
            ok.append(x1.g2_torsion(b_g2) != 0)
    return side, ok


def check_instance_async(a_g1, b_g2, subgroup: bool = True):
    """Validate (A, B) as the JAX package's check_instance_async: the limb
    checks run now and raise at once; the on-curve checks and (subgroup=True)
    the G2 r-torsion verdicts (X1) are queued with no host sync
    (queue_verdicts).  Returns finish(), which fetches the verdicts in one
    transfer and raises VerificationError for the first fault: A off the
    curve, then B off the twist, then B outside the r-torsion.  Call it
    before trusting the instance."""
    check_limbs(a_g1, "A")
    check_limbs(b_g2, "B")
    stream, verdicts = queue_verdicts(a_g1, b_g2, subgroup)

    def finish():
        with torch.cuda.stream(stream):     # the verdicts are that stream's
            host = torch.cat([v.flatten() for v in verdicts]).cpu()
        host = host.split([v.numel() for v in verdicts])
        for ok, msg in zip(host, ("A: point off curve",
                                  "B: point off twist curve",
                                  "B: point outside the r-torsion subgroup")):
            if not bool(ok.all()):
                raise VerificationError(f"{msg} at index {int(torch.nonzero(~ok)[0])}")

    return finish


def check_instance(a_g1, b_g2, subgroup: bool = True):
    """Validate (A, B): canonical limbs, on-curve, and (subgroup=True) the G2
    r-torsion.  Raises VerificationError."""
    check_instance_async(a_g1, b_g2, subgroup)()


def check_proof(proof):
    """Validate a proof's limbs ((2 log2(n) + 1, 2, 3, 2, 16) Fq12s)."""
    check_limbs(proof, "proof")
