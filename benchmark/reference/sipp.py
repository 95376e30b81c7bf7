"""SIPP's outputs worked out from the integers the benchmark made.

Every instance is A_i = [a_i] G1 and B_i = [b_i] G2 with the a_i and b_i
known, so by bilinearity Z = prod_i e(A_i, B_i) = g^(sum_i a_i b_i) with
g = e(G1, G2), which this module computes once (a Miller loop and a plain
final exponentiation, bn254.py).  A fold round's Z_L = <A_hi, B_lo> and
Z_R = <A_lo, B_hi> are powers of g in the same way, and the folds
A' = A_lo + [x] A_hi, B' = B_lo + [x^-1] B_hi act on the exponents mod r.
The transcript (transcript.py) hashes the instance's affine coordinates,
which the benchmark made, and the Fq12 values.  The proof is
[Z, Z_L1, Z_R1, ..., Z_Lk, Z_Rk] reversed (the verifier pops from the
back).  Outputs are in the program's layout: Fq12 values as (2, 3, 2, 16)
16-bit Montgomery limbs.
"""

import numpy as np

from . import bn254
from .bn254 import G1_GEN, G2_GEN, R, X
from .transcript import Transcript

# The power of the pairing that a cheaper hard part of the final
# exponentiation gives (Fuentes-Castaneda, Knapp and Rodriguez-Henriquez:
# 2x(6x^2 + 3x + 1) times (p^4 - p^2 + 1) / r): a bilinear pairing, but not
# the bytes of the one the configuration states.
HARD_PART_MULTIPLE = 2 * X * (6 * X * X + 3 * X + 1)


def limbs(f):
    """Tower Fq12 -> (2, 3, 2, 16) int64 Montgomery limbs."""
    return np.array([bn254.fq_limbs(c) for c in bn254.fq12_values(f)],
                    dtype=np.int64).reshape(2, 3, 2, 16)


class Reference:
    """power: Z's are g^(power e) (1: the pairing the configuration states);
    challenge_bits: the challenges are cut to their low bits (None: whole)."""

    def __init__(self, power=1, challenge_bits=None):
        self.tower = bn254.Tower()
        g = self.tower.final_exp(self.tower.miller_loop(G1_GEN, G2_GEN))
        if power != 1:
            g = self.tower.f12_pow(g, power % R)
        self.base = bn254.FixedBase(self.tower, g)
        self.challenge_bits = challenge_bits

    def gt(self, e):
        return self.base.pow(e)

    def z(self, a_logs, b_logs):
        """Z of the instance whose logarithms are a_logs, b_logs."""
        return self.gt(sum(a * b for a, b in zip(a_logs, b_logs)))

    def proof(self, a_pts, b_pts, a_logs, b_logs):
        """(the proof as (2 log2 n + 1, 2, 3, 2, 16) limbs in pop order, the
        challenges x of the rounds)."""
        tr = Transcript()
        tr.append_points(a_pts, b_pts)
        z = self.z(a_logs, b_logs)
        tr.append_fq12(z)
        out, xs = [z], []
        a, b = list(a_logs), list(b_logs)
        while len(a) > 1:
            m = len(a) // 2
            z_l = self.gt(sum(x * y for x, y in zip(a[m:], b[:m])))
            z_r = self.gt(sum(x * y for x, y in zip(a[:m], b[m:])))
            tr.append_fq12(z_l)
            tr.append_fq12(z_r)
            x = tr.challenge()
            if self.challenge_bits is not None:
                x &= (1 << self.challenge_bits) - 1
            xi = pow(x, -1, R)
            a = [(lo + x * hi) % R for lo, hi in zip(a[:m], a[m:])]
            b = [(lo + xi * hi) % R for lo, hi in zip(b[:m], b[m:])]
            out += [z_l, z_r]
            xs.append(x)
        out.reverse()
        return np.stack([limbs(f) for f in out]), xs
