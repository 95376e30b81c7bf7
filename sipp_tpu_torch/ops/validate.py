"""X1: the G2 r-torsion verdict per lane (csrc/validate.cu), replacing the
XLA program sipp_tpu/protocol/validate.py:_g2_in_subgroup, which has no
Pallas counterpart.

g2_torsion(b) launches the kernel for CUDA tensors and runs
g2_torsion_plain for CPU tensors; there is no other route.  Bound on the
H100 and design: see the note at the top of csrc/validate.cu.
"""

import torch

from .. import params
from ..curves import G2, scalar_to_bits
from . import _build

R_BITS = scalar_to_bits(params.R)


def g2_torsion_plain(b):
    """1 where [r]Q == O (the complete-add ladder) or Q is the all-zero
    infinity, else 0; b: (..., 2, 2, 16) -> (...,) int64."""
    rq = G2.mul_check_ladder(b, R_BITS)
    return (G2.is_infinity(rq) | G2.is_affine_infinity(b)).to(torch.int64)


def g2_torsion(b):
    """The r-torsion verdicts of (..., 2, 2, 16) affine G2 points, (...,)
    int64; queued on the points' stream, no host sync."""
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
