"""K1: the Miller product over lanes, and K7: one step of the Miller loop
(both csrc/miller.cu), replacing sipp_tpu/ops/pallas_miller.py:
miller_product_fused and miller_step.

miller_product(p, q, pair) and miller_step(digit, qp, qn, p, f, t) launch
their kernels for CUDA tensors and run their plain versions for CPU
tensors; there is no other route.  Bound on the H100 and design: see the
notes in csrc/miller.cu.
"""

import torch

from ..pairing import ate
from ..pairing.ate import miller_step_plain  # K7's plain version, beside its wrapper
from . import _build

BLOCK = 4     # lanes (warps) per block of K1; _build emits it as MILLER_BLOCK_LANES
PARTIAL_LIMBS = 48   # an Fq12 partial product of the kernel's scratch, in int64


def miller_step(digit: int, qp, qn, p, f, t):
    """The step of miller_step_plain for B lanes, as the JAX package's
    miller_step(digit, consts, qp, qn, p, (f, t)) in the port's layout:
    digit in {0, 1, 2} (a host int, passed to the kernel by value); qp, qn:
    (B, 2, 2, 16); p: (B, 2, 16); f: (B, 2, 3, 2, 16); t: (B, 3, 2, 16)
    Jacobian.  Returns the new (f, t)."""
    B = p.shape[0]
    if digit not in (0, 1, 2):
        raise ValueError(f"miller_step: digit must be 0, 1 or 2, got {digit!r}")
    if not (qp.shape == qn.shape == (B, 2, 2, 16) and tuple(p.shape) == (B, 2, 16)
            and tuple(f.shape) == (B, 2, 3, 2, 16) and tuple(t.shape) == (B, 3, 2, 16)):
        raise ValueError(f"miller_step: bad shapes {[tuple(x.shape) for x in (qp, qn, p, f, t)]}")
    if p.device.type == "cpu":
        return miller_step_plain(digit, qp, qn, p, f, t)
    if p.device.type != "cuda":
        raise ValueError(f"miller_step: unsupported device {p.device}")
    p = _build.check_cuda_input(p, "p", (2, 16))
    qp = _build.check_cuda_input(qp, "qp", (2, 2, 16), p.device)
    qn = _build.check_cuda_input(qn, "qn", (2, 2, 16), p.device)
    f = _build.check_cuda_input(f, "f", (2, 3, 2, 16), p.device)
    t = _build.check_cuda_input(t, "t", (3, 2, 16), p.device)
    lib = _build.cuda_library()
    f_out, t_out = torch.empty_like(f), torch.empty_like(t)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sipp_miller_step(digit, qp.data_ptr(), qn.data_ptr(), p.data_ptr(),
                                   f.data_ptr(), t.data_ptr(), f_out.data_ptr(),
                                   t_out.data_ptr(), B, stream)
    _build.check_launch(lib, err, "miller_step")
    miller_step.launches += 1
    return f_out, t_out


def miller_product_plain(p, q, pair: bool = False):
    """prod_i miller(P_i, Q_i) in plain PyTorch: (2, 3, 2, 16), or with
    pair=True the (2, 2, 3, 2, 16) stack [even-lane product, odd-lane
    product]."""
    f = ate.miller_loop(p, q)
    if pair:
        return torch.stack([ate.product_tree(f[0::2]), ate.product_tree(f[1::2])])
    return ate.product_tree(f)


def _lanes(n: int, pair: bool) -> int:
    """Launch width: whole blocks of BLOCK lanes (the kernel runs the lanes
    past n as lanes of f = 1)."""
    w = max(n, 2 if pair else 1)
    return -(-w // BLOCK) * BLOCK


def miller_product(p, q, pair: bool = False):
    """p: (n, 2, 16) G1 affine, q: (n, 2, 2, 16) G2 affine (int64 limbs);
    with pair=True, n is even and the even and odd lanes form two products."""
    if p.shape[0] != q.shape[0] or (pair and p.shape[0] % 2):
        raise ValueError(f"bad lane counts {tuple(p.shape)} x {tuple(q.shape)} (pair={pair})")
    if p.device.type == "cpu":
        return miller_product_plain(p, q, pair)
    if p.device.type != "cuda":
        raise ValueError(f"miller_product: unsupported device {p.device}")
    p = _build.check_cuda_input(p, "p", (2, 16))
    q = _build.check_cuda_input(q, "q", (2, 2, 16), p.device)
    lib = _build.cuda_library()
    n = p.shape[0]
    k = 2 if pair else 1
    partials = torch.empty((_lanes(n, pair) // BLOCK, k, PARTIAL_LIMBS), dtype=torch.int64,
                           device=p.device)
    out = torch.empty((k, 2, 3, 2, 16), dtype=torch.int64, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sipp_miller_product(p.data_ptr(), q.data_ptr(), partials.data_ptr(),
                                      out.data_ptr(), n, int(pair), stream)
    _build.check_launch(lib, err, "miller_product")
    if pair:
        miller_product.pair_launches += 1
        return out
    miller_product.launches += 1
    return out[0]


miller_product.launches = 0
miller_product.pair_launches = 0
miller_step.launches = 0
