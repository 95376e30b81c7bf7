"""K0: the batched Montgomery Fq product (csrc/fq.cu), replacing
sipp_tpu/ops/pallas_fq.py:fq_mul_pallas, and the field micro-benchmark of
that module.

fq_mul(a, b) launches the kernel for CUDA tensors and runs fq_mul_plain
(FQ.mul) for CPU tensors; there is no other route.  Bound on the H100 and
design: see the note at the top of csrc/fq.cu.

    python -m sipp_tpu_torch.ops.fq

times the plain version against the kernel on the card at B = 4096 and
prints whether they agree (it needs a card: there is no CPU route).
"""

import numpy as np
import torch

from ..fields import FQ
from . import _build


def fq_mul_plain(a, b):
    """a * b * R^-1 mod p for (B, 16) canonical limb tensors (FQ.mul)."""
    return FQ.mul(a, b)


def _operand(x):
    """x (contiguous) if it starts on a 16-byte boundary (the kernel reads
    limb pairs as 16-byte vectors), else a copy that does."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fq_mul(a, b):
    """Batched Montgomery product of (B, 16) int64 limb tensors.

    At the entry point's B the wrapper's host work is most of a call, so
    the launch takes the current stream's raw handle and enters no device
    context where the operands' device is the current one (else the call
    repeats itself under one)."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != FQ.L or a.shape[0] < 1:
        raise ValueError(f"fq_mul: expected two (B, {FQ.L}) tensors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return fq_mul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fq_mul: unsupported device {a.device}")
    a = _operand(_build.check_cuda_input(a, "a", (FQ.L,)))
    b = _operand(_build.check_cuda_input(b, "b", (FQ.L,), a.device))
    dev = a.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fq_mul(a, b)
    lib = _build.cuda_library()
    out = torch.empty_like(a)
    err = lib.sipp_fq_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                          torch._C._cuda_getCurrentRawStream(dev))
    _build.check_launch(lib, err, "fq_mul")
    fq_mul.launches += 1
    return out


fq_mul.launches = 0


def random_batch(batch: int, seed: int, device):
    """Two (batch, 16) tensors of seeded canonical Montgomery values, drawn
    as the JAX module's bench_compare draws them (31 random bytes mod p)."""
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(31), "little") % FQ.p for _ in range(batch)]
    ys = [int.from_bytes(rng.bytes(31), "little") % FQ.p for _ in range(batch)]
    return FQ.encode(xs, device), FQ.encode(ys, device)


def uniform_batch(batch: int, seed: int, device):
    """Two (batch, 16) tensors of canonical values drawn on `device` by a
    torch.Generator seeded with `seed` (a batch of millions in milliseconds,
    where random_batch's Python ints take minutes): 16-bit limbs with a top
    limb below p's (0x3064), so every value is below p; rows 0, 1 and 2 of
    each are the values 0, 1 and p - 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    top = FQ.p >> (16 * (FQ.L - 1))
    out = []
    for _ in range(2):
        x = torch.randint(0, 1 << 16, (batch, FQ.L), generator=gen, device=device)
        x[:, -1] = torch.randint(0, top, (batch,), generator=gen, device=device)
        edge = torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(FQ.L)]
                             for v in (0, 1, FQ.p - 1)], device=device)
        x[:min(batch, 3)] = edge[:batch]
        out.append(x)
    return tuple(out)


def bench_compare(batch: int = 4096, reps: int = 10):
    """Time the plain version (FQ.mul) against the kernel on the card with
    CUDA events, print both and their equality, and return
    {"plain": seconds, "kernel": seconds, "equal": bool}.  Raises without
    a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_compare times the CUDA kernel: no CUDA device is available")
    a, b = random_batch(batch, 0, torch.device("cuda"))
    results = {}
    for name, fn in (("plain", fq_mul_plain), ("kernel", fq_mul)):
        fn(a, b)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(a, b)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
        results[name] = dt
        print(f"{name}: {dt * 1e6:.1f} us / {batch} muls ({batch / dt / 1e6:.2f} M muls/s)")
    results["equal"] = torch.equal(fq_mul(a, b), fq_mul_plain(a, b))
    print("kernel == plain:", results["equal"])
    return results


if __name__ == "__main__":
    bench_compare()
