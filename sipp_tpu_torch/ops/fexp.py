"""K2: the final exponentiation (csrc/fexp.cu), replacing
sipp_tpu/ops/pallas_fexp.py:final_exp_fused.

final_exp(f) launches the kernel for CUDA tensors and runs final_exp_plain
for CPU tensors; there is no other route.  Bound on the H100 and design:
see the note at the top of csrc/fexp.cu.
"""

import torch

from ..pairing import ate
from . import _build


def final_exp_plain(f):
    """f^((p^12 - 1) / r) in plain PyTorch; f: (B, 2, 3, 2, 16)."""
    return ate.final_exp(f)


def final_exp(f):
    """f: (B, 2, 3, 2, 16) int64 limbs -> same shape."""
    if f.dim() != 5:
        raise ValueError(f"final_exp: expected (B, 2, 3, 2, 16), got {tuple(f.shape)}")
    if f.device.type == "cpu":
        return final_exp_plain(f)
    if f.device.type != "cuda":
        raise ValueError(f"final_exp: unsupported device {f.device}")
    f = _build.check_cuda_input(f, "f", (2, 3, 2, 16))
    lib = _build.cuda_library()
    out = torch.empty_like(f)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.sipp_final_exp(f.data_ptr(), out.data_ptr(), f.shape[0], stream)
    _build.check_launch(lib, err, "final_exp")
    final_exp.launches += 1
    return out


final_exp.launches = 0
