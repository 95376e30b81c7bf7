"""Proof and statement files in the JAX package's format (sipp_tpu/io.py),
so that a file written by either package loads in the other:

* a proof file is an npz of uint32 arrays of 16-bit Montgomery limbs, the
  instance under `a` and `b` and the proof under `proof`, with
  version=uint32(1);
* a statement file is the reference's flat wire layout of 48n + 240
  little-endian u32 values (statements.rs:24-54).

The port's int64 tensors go through convert.to_reference / from_reference.
"""

import numpy as np
import torch

from . import convert
from .protocol import validate
from .protocol.statements import SIPPStatement


def save_proof(path: str, a_g1, b_g2, proof):
    """Write instance + proof as an npz of uint32 limb arrays."""
    np.savez_compressed(
        path, a=convert.to_reference(a_g1), b=convert.to_reference(b_g2),
        proof=convert.to_reference(proof), version=np.uint32(1))


def load_proof(path: str, device=torch.device("cuda")):
    """Load an instance + proof npz as (a, b, proof) int64 tensors on
    `device` (the card unless asked otherwise).  Every array must hold
    uint32 16-bit limbs, and the proof canonical Fq values, before any
    tensor is made: VerificationError names the array at fault (sipp_verify
    checks the instance's points on entry)."""
    device = convert.resolve_device(device)
    with np.load(path) as z:
        arrays = {name: z[name] for name in ("a", "b", "proof")}
    for name, arr in arrays.items():
        if arr.dtype != np.uint32:
            raise validate.VerificationError(f"{name}: expected uint32 limbs, got {arr.dtype}")
        if arr.size and int(arr.max()) > 0xFFFF:
            raise validate.VerificationError(f"{name}: non-16-bit limb")
    validate.check_limbs(convert.from_reference(arrays["proof"], "cpu"), "proof")
    return tuple(convert.from_reference(arrays[name], device) for name in ("a", "b", "proof"))


def save_statement(path: str, stmt: SIPPStatement):
    """Write the statement in the reference's flat u32 wire layout."""
    np.asarray(stmt.to_vec(), dtype=np.uint32).tofile(path)


def load_statement(path: str, n: int) -> SIPPStatement:
    vec = np.fromfile(path, dtype=np.uint32)
    return SIPPStatement.from_vec(n, [int(v) for v in vec])
