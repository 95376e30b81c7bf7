"""G1 (over Fq) and G2 (over Fq2) curve ops and host codecs (port of
sipp_tpu/curves/__init__.py).  Points are int64 16-bit-limb Montgomery
tensors: G1 affine (n, 2, 16), G2 affine (n, 2, 2, 16), (0, 0) = infinity."""

import numpy as np
import torch

from ..fields import FQ, bigint, tower
from .weierstrass import CurveOps

F = FQ


class _FqAdapter:
    ndim = 1
    mul = staticmethod(F.mul)
    inv = staticmethod(F.inv)
    is_zero = staticmethod(F.is_zero)
    one_like = staticmethod(F.one_like)


class _Fq2Adapter:
    ndim = 2
    mul = staticmethod(tower.fq2_mul)
    inv = staticmethod(tower.fq2_inv)
    is_zero = staticmethod(tower.fq2_is_zero)

    @staticmethod
    def one_like(x):
        one = F.one_like(x[..., 0, :])
        return torch.stack([one, torch.zeros_like(one)], dim=-2)


G1 = CurveOps(_FqAdapter(), F, "G1")
G2 = CurveOps(_Fq2Adapter(), F, "G2")


# ------------------------------------------------------------- host codecs

def _mont_limbs(vals, shape, device):
    arr = bigint.ints_to_limbs([v * F.R % F.p for v in vals], F.L)
    return torch.as_tensor(arr.astype(np.int64).reshape(*shape, F.L), device=device)


def g1_encode(points, device="cpu"):
    """Host affine points [(x, y) or None, ...] -> (n, 2, 16) tensor."""
    vals = []
    for pt in points:
        vals += list(pt) if pt is not None else [0, 0]
    return _mont_limbs(vals, (len(points), 2), device)


def g2_encode(points, device="cpu"):
    """Host affine G2 points [((x0, x1), (y0, y1)) or None, ...] ->
    (n, 2, 2, 16) tensor."""
    vals = []
    for pt in points:
        (x0, x1), (y0, y1) = pt if pt is not None else ((0, 0), (0, 0))
        vals += [x0, x1, y0, y1]
    return _mont_limbs(vals, (len(points), 2, 2), device)


def _decode_fq_ints(x):
    """(..., 16) Montgomery tensor -> flat list of canonical ints (one
    transfer, bulk byte repack)."""
    arr = x.detach().cpu().numpy().astype(np.uint32)
    rinv = pow(F.R, -1, F.p)
    return [v * rinv % F.p for v in bigint.limbs16_to_ints_fast(arr.reshape(-1, F.L))]


def g1_decode(x):
    """(n, 2, 16) tensor -> [(x, y) or None, ...]."""
    flat = _decode_fq_ints(x)
    pts = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    return [None if pt == (0, 0) else pt for pt in pts]


def g2_decode(x):
    """(n, 2, 2, 16) tensor -> [((x0, x1), (y0, y1)) or None, ...]."""
    flat = _decode_fq_ints(x)
    out = []
    for i in range(0, len(flat), 4):
        pt = ((flat[i], flat[i + 1]), (flat[i + 2], flat[i + 3]))
        out.append(None if pt == ((0, 0), (0, 0)) else pt)
    return out


def scalar_to_bits(k: int, width: int = 254) -> np.ndarray:
    """Scalar -> MSB-first uint32 bit array of fixed width (the fold
    challenge format of the JAX package)."""
    if not 0 <= k < (1 << width):
        raise ValueError(f"scalar out of range for {width} bits")
    return np.array([(k >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=np.uint32)
