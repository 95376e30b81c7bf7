"""Deterministic random SIPP instances: the same points as
sipp_tpu.utils.testing for the same (n, seed)."""

import numpy as np
import torch

from .. import curves, hostref, params
from ..convert import resolve_device


def random_points(n: int, seed: int = 0):
    """n random (G1, G2) host point pairs from a seeded generator."""
    rng = np.random.default_rng(seed)

    def rs():
        return int.from_bytes(rng.bytes(40), "little") % params.R

    A = [hostref.g1_mul(params.G1_GEN, rs()) for _ in range(n)]
    B = [hostref.g2_mul(params.G2_GEN, rs()) for _ in range(n)]
    return A, B


def random_instance(n: int, seed: int = 0, device=torch.device("cuda")):
    """(A, B) as (n, 2, 16) and (n, 2, 2, 16) int64 limb tensors on `device`
    (the card unless asked otherwise)."""
    device = resolve_device(device)
    A, B = random_points(n, seed)
    return curves.g1_encode(A, device), curves.g2_encode(B, device)
