"""K6: offset + [k_i] x_i per lane -> affine, and K8: off_i * x_i^(k_i)
per lane in Fq12 (csrc/exp.cu), replacing sipp_tpu/ops/pallas_exp.py:
exp_g1_fused, exp_g2_fused and fq12_exp_fused.

exp_g1 / exp_g2 / fq12_exp launch their kernels for CUDA tensors and run the
plain ladders for CPU tensors; there is no other route.  Bound on the H100
and design: see the notes in csrc/exp.cu.
"""

import torch

from ..curves import G1, G2
from ..fields import tower
from . import _build


def exp_g1_plain(x, off, bits):
    return G1.to_affine(G1.exp_with_offset(x, off, bits))


def exp_g2_plain(x, off, bits):
    return G2.to_affine(G2.exp_with_offset(x, off, bits))


def fq12_exp_plain(x, off, bits):
    return tower.fq12_exp_with_offset(x, off, bits)


def _exp(wrapper, x, off, bits, plain, tail):
    """x, off: (B, *tail) int64 limbs; bits: (254, B) int64 MSB-first
    per-lane bits on the same device.  Counts the launch on `wrapper`."""
    which = wrapper.__name__
    if x.shape != off.shape or tuple(bits.shape) != (254, x.shape[0]):
        raise ValueError(f"{which}: bad shapes {tuple(x.shape)}, {tuple(off.shape)}, "
                         f"bits {tuple(bits.shape)}")
    if x.device.type == "cpu":
        return plain(x, off, bits)
    if x.device.type != "cuda":
        raise ValueError(f"{which}: unsupported device {x.device}")
    x = _build.check_cuda_input(x, "x", tail)
    off = _build.check_cuda_input(off, "off", tail, x.device)
    bits = _build.check_cuda_input(bits, "bits", (x.shape[0],), x.device)
    lib = _build.cuda_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"sipp_{which}")(x.data_ptr(), off.data_ptr(), bits.data_ptr(),
                                            out.data_ptr(), x.shape[0], stream)
    _build.check_launch(lib, err, which)
    wrapper.launches += 1
    return out


def exp_g1(x, off, bits):
    """offset + [k_i] x_i for G1 (B, 2, 16)."""
    return _exp(exp_g1, x, off, bits, exp_g1_plain, (2, 16))


def exp_g2(x, off, bits):
    """offset + [k_i] x_i for G2 (B, 2, 2, 16)."""
    return _exp(exp_g2, x, off, bits, exp_g2_plain, (2, 2, 16))


def fq12_exp(x, off, bits):
    """off_i * x_i^(k_i) for Fq12 (B, 2, 3, 2, 16)."""
    return _exp(fq12_exp, x, off, bits, fq12_exp_plain, (2, 3, 2, 16))


exp_g1.launches = 0
exp_g2.launches = 0
fq12_exp.launches = 0
