"""SIPP prover, host spine (port of sipp_tpu/protocol/prover.py:sipp_prove).

log2(n) Fiat-Shamir fold rounds.  Z = FE(prod_i Miller(A_i, B_i)) is one K1
launch and one K2 launch; each round's (Z_L, Z_R) is one pair-mode K1 launch
and one K2 launch at B = 2; the folds A' = A_lo + x A_hi and
B' = B_lo + x^-1 B_hi are one K3 launch each.  The hash chain and the
challenges run on the host (the native transcript).

With (lo, hi) = split_at(m): Z_L = <A_hi, B_lo>, Z_R = <A_lo, B_hi>, and the
proof [Z, Z_L1, Z_R1, ...] is REVERSED so the verifier pops from the back.
The JAX package keeps a fixed lane width with masked dead lanes to bound
XLA recompiles; eager PyTorch has no such cost, so rounds halve by slicing
(dead lanes contribute 1 and fold to O, so the proof bytes are the same).
"""

import torch

from .. import curves, params
from ..curves import scalar_to_bits
from ..fields import tower
from ..ops import fold
from ..pairing import ate
from .transcript import Transcript


def check_shapes(a_g1, b_g2):
    n = a_g1.shape[0]
    if (a_g1.shape[1:] != (2, 16) or b_g2.shape[1:] != (2, 2, 16)
            or b_g2.shape[0] != n or n < 1 or n & (n - 1)):
        raise ValueError(f"SIPP instance must be (n, 2, 16) x (n, 2, 2, 16) with n a "
                         f"power of two, got {tuple(a_g1.shape)} x {tuple(b_g2.shape)}")
    return n


def sipp_prove(a_g1, b_g2):
    """a_g1: (n, 2, 16) G1 affine; b_g2: (n, 2, 2, 16) G2 twist affine (int64
    limbs, one device).  Returns the proof (2 log2(n) + 1, 2, 3, 2, 16) in
    verifier pop order, on the inputs' device."""
    n = check_shapes(a_g1, b_g2)
    tr = Transcript()
    tr.append_points(curves.g1_decode(a_g1), curves.g2_decode(b_g2))

    z = ate.inner_product(a_g1, b_g2)
    proof = [z]
    tr.append_fq12(tower.fq12_decode(z))

    a, b = a_g1, b_g2
    while n > 1:
        m = n // 2
        zs = ate.cross_products(a[:m], a[m:], b[:m], b[m:])
        z_l, z_r = tower.fq12_decode(zs)
        proof += [zs[0], zs[1]]
        tr.append_fq12(z_l)
        tr.append_fq12(z_r)
        x = tr.get_challenge()
        x_inv = pow(x, -1, params.R)
        a = fold.fold_g1(a[:m], a[m:], scalar_to_bits(x))
        b = fold.fold_g2(b[:m], b[m:], scalar_to_bits(x_inv))
        n = m

    proof.reverse()
    return torch.stack(proof)
