"""Carry values across between the JAX package and the port.

The JAX package holds field elements as uint32 arrays of 16-bit limbs in
Montgomery form (R = 2^256); the port holds the same limbs as torch.int64
(CPU torch has no uint32 add or shift).  Both sides keep every value
canonical, so the conversion is exact both ways.
"""

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for.  The port's entry points run
    on the card unless the caller names another device (the tests pass
    device="cpu"); asking for CUDA where there is none raises, it never falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to run the "
                           "port's plain PyTorch versions on the CPU")
    return device


def from_reference(arr, device=torch.device("cuda")):
    """numpy uint32 limb array (an instance A or B, a proof, Fq12 values)
    -> int64 tensor on `device` (the card unless asked otherwise)."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype != np.uint32 or (arr.size and int(arr.max()) > 0xFFFF):
        raise ValueError("expected a uint32 array of 16-bit limbs")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def to_reference(x) -> np.ndarray:
    """int64 limb tensor -> the numpy uint32 array the JAX package holds."""
    arr = x.detach().cpu().numpy()
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
        raise ValueError("tensor holds values that are not 16-bit limbs")
    return arr.astype(np.uint32)


def from_transposed(arr, device=torch.device("cuda")):
    """A lanes-last uint32 array of the JAX kernels' transposed layout (the
    step kernel's carry f (2, 3, 2, 16, B) and T (3, 2, 16, B), its P
    (2, 16, B) and Q (2, 2, 16, B)) -> the port's lanes-first (B, ...) int64
    tensor on `device`."""
    return from_reference(np.ascontiguousarray(np.moveaxis(np.asarray(arr), -1, 0)), device)


def to_transposed(x) -> np.ndarray:
    """The port's (B, ...) int64 tensor -> the JAX kernels' lanes-last
    uint32 layout (..., B); the inverse of from_transposed."""
    return np.ascontiguousarray(np.moveaxis(to_reference(x), 0, -1))
