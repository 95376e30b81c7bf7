"""X1: the G2 r-torsion verdict per lane (csrc/validate.cu), replacing the
XLA program sipp_tpu/protocol/validate.py:_g2_in_subgroup, which has no
Pallas counterpart.

The verdict is the BN endomorphism test of eprint 2022/348 (sections 3 and
5.1), [x0 + 1]Q + psi([x0]Q) + psi^2([x0]Q) == psi^3([2 x0]Q), with psi
the twist's Frobenius and x0 = params.X (63 bits), in place of the JAX
package's [r]Q == O over r's 254 bits.  On every point of the twist
E'(Fq2) the two agree: tests/test_torch_torsion.py proves it (the group is
cyclic of squarefree order r h2, and the test is the kernel of an
endomorphism).  Off the twist the verdict means nothing;
protocol/validate.py reports an off-twist B before any torsion verdict.

g2_torsion(b) launches the kernel for CUDA tensors and runs
g2_torsion_plain for CPU tensors; there is no other route.  Bound on the
H100 and design: see the note at the top of csrc/validate.cu.
"""

import torch

from .. import params
from ..curves import G2, scalar_to_bits
from ..fields import tower
from ..pairing import ate
from . import _build

X_BITS = scalar_to_bits(params.X, params.X.bit_length())
R_BITS = scalar_to_bits(params.R)


def psi(p):
    """The twist's Frobenius on Jacobian G2 points (..., 3, 2, 16):
    (conj(X) gx, conj(Y) gy, conj(Z)), infinity (Z = 0) kept."""
    return torch.cat([ate.twist_frob(p[..., :2, :, :]), tower.fq2_conj(p[..., 2:, :, :])],
                     dim=-3)


def g2_torsion_plain(b):
    """1 where Q is in the r-torsion or is the all-zero infinity, else 0,
    for Q on the twist (off it the verdict means nothing); b: (..., 2, 2,
    16) -> (...,) int64.  The kernel's chain: T = [x0]Q (the complete-add
    ladder over x0's bits), U = psi(T), V = psi(U), W = [2] psi(V), and
    D = T + Q + U + V - W with the complete additions; Q passes where D is
    at infinity."""
    dbl_q = G2.dbl(G2.jac_from_affine(b))
    t = G2.mul_check_ladder(b, X_BITS, dbl_q)
    u = psi(t)
    v = psi(u)
    w = G2.neg(G2.dbl(psi(v)))
    d = G2.add_mixed(t, b, dbl_q)
    for q in (u, v, w):
        d = G2.add(d, q)
    return (G2.is_infinity(d) | G2.is_affine_infinity(b)).to(torch.int64)


def g2_torsion_r_ladder(b):
    """[r]Q == O (or Q all-zero) by the complete-add ladder over r's 254
    bits, the JAX package's form of the check (_g2_in_subgroup): the
    tests' and chip_smoke.py's yardstick for g2_torsion_plain, no route of
    g2_torsion."""
    rq = G2.mul_check_ladder(b, R_BITS)
    return (G2.is_infinity(rq) | G2.is_affine_infinity(b)).to(torch.int64)


def g2_torsion(b):
    """The r-torsion verdicts of (..., 2, 2, 16) affine G2 points, (...,)
    int64 (meaningful for points on the twist); queued on the points'
    stream, no host sync."""
    if b.dim() < 3 or tuple(b.shape[-3:]) != (2, 2, 16):
        raise ValueError(f"g2_torsion: expected (..., 2, 2, 16) points, got {tuple(b.shape)}")
    if b.device.type == "cpu":
        return g2_torsion_plain(b)
    if b.device.type != "cuda":
        raise ValueError(f"g2_torsion: unsupported device {b.device}")
    flat = _build.check_cuda_input(b, "b", (2, 2, 16)).reshape(-1, 2, 2, 16)
    out = torch.empty(flat.shape[0], dtype=torch.int64, device=b.device)
    if flat.shape[0]:
        lib = _build.cuda_library()
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            err = lib.sipp_g2_torsion(flat.data_ptr(), out.data_ptr(), flat.shape[0], stream)
        _build.check_launch(lib, err, "g2_torsion")
        g2_torsion.launches += 1
    return out.reshape(b.shape[:-3])


g2_torsion.launches = 0
