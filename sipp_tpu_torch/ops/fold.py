"""K3: the SIPP fold ladders lo + [x] hi -> affine (csrc/fold.cu), replacing
sipp_tpu/ops/pallas_fold.py:fold_g1_fused and fold_g2_fused.

fold_g1 / fold_g2 launch the kernel for CUDA tensors and run the plain
ladder for CPU tensors; there is no other route.  Bound on the H100 and
design: see the note at the top of csrc/fold.cu.
"""

import torch

from ..curves import G1, G2
from . import _build


def fold_g1_plain(lo, hi, bits):
    return G1.to_affine(G1.fold(lo, hi, bits))


def fold_g2_plain(lo, hi, bits):
    return G2.to_affine(G2.fold(lo, hi, bits))


def _fold(wrapper, lo, hi, bits, plain, tail):
    """lo, hi: (n, *tail) affine int64 limbs; bits: (254,) MSB-first bits of
    the shared scalar, on the host or as an int64 tensor on the points'
    device (the on-chip prover's: then no host round trip).  Counts the
    launch on `wrapper`."""
    which = wrapper.__name__
    if lo.shape != hi.shape or len(bits) != 254:
        raise ValueError(f"{which}: bad shapes {tuple(lo.shape)}, {tuple(hi.shape)}, "
                         f"{len(bits)} bits")
    if lo.device.type == "cpu":
        return plain(lo, hi, bits)
    if lo.device.type != "cuda":
        raise ValueError(f"{which}: unsupported device {lo.device}")
    lo = _build.check_cuda_input(lo, "lo", tail)
    hi = _build.check_cuda_input(hi, "hi", tail, lo.device)
    lib = _build.cuda_library()
    if isinstance(bits, torch.Tensor) and bits.device.type == "cuda":
        bits_t = _build.check_cuda_input(bits, "bits", (254,), lo.device)
    else:
        bits_t = torch.as_tensor([int(b) for b in bits], dtype=torch.int64).to(lo.device)
    out = torch.empty_like(lo)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        err = getattr(lib, f"sipp_{which}")(lo.data_ptr(), hi.data_ptr(), bits_t.data_ptr(),
                                            out.data_ptr(), lo.shape[0], stream)
    _build.check_launch(lib, err, which)
    wrapper.launches += 1
    return out


def fold_g1(lo, hi, bits):
    """A' = A_lo + [x] A_hi for G1 (n, 2, 16)."""
    return _fold(fold_g1, lo, hi, bits, fold_g1_plain, (2, 16))


def fold_g2(lo, hi, bits):
    """B' = B_lo + [x] B_hi for G2 (n, 2, 2, 16)."""
    return _fold(fold_g2, lo, hi, bits, fold_g2_plain, (2, 2, 16))


fold_g1.launches = 0
fold_g2.launches = 0
