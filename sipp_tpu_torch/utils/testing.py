"""Deterministic random SIPP instances: the same points as
sipp_tpu.utils.testing for the same (n, seed)."""

import numpy as np

from .. import curves, hostref, params


def random_points(n: int, seed: int = 0):
    """n random (G1, G2) host point pairs from a seeded generator."""
    rng = np.random.default_rng(seed)

    def rs():
        return int.from_bytes(rng.bytes(40), "little") % params.R

    A = [hostref.g1_mul(params.G1_GEN, rs()) for _ in range(n)]
    B = [hostref.g2_mul(params.G2_GEN, rs()) for _ in range(n)]
    return A, B


def random_instance(n: int, seed: int = 0, device="cpu"):
    """(A, B) as (n, 2, 16) and (n, 2, 2, 16) int64 limb tensors."""
    A, B = random_points(n, seed)
    return curves.g1_encode(A, device), curves.g2_encode(B, device)
