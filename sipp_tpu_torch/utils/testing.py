"""Deterministic random SIPP instances: the same points as
sipp_tpu.utils.testing for the same (n, seed)."""

import hashlib

import numpy as np
import torch

from .. import curves, hostref, params
from ..convert import resolve_device


def random_scalars(n: int, seed: int = 0):
    """The scalars of random_points: n for A, then n for B, each 40 bytes
    of one default_rng(seed) stream reduced mod r."""
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(2 * n)]
    return ks[:n], ks[n:]


def random_points(n: int, seed: int = 0):
    """n random (G1, G2) host point pairs from a seeded generator."""
    ka, kb = random_scalars(n, seed)
    A = [hostref.g1_mul(params.G1_GEN, k) for k in ka]
    B = [hostref.g2_mul(params.G2_GEN, k) for k in kb]
    return A, B


def scalar_bits(ks, device):
    """(254, len(ks)) int64 MSB-first bits of scalars below 2^254, lanes
    last (K6's bits layout)."""
    raw = np.frombuffer(b"".join(k.to_bytes(32, "big") for k in ks), np.uint8)
    bits = np.unpackbits(raw.reshape(len(ks), 32), axis=1)[:, 256 - 254:]
    return torch.as_tensor(np.ascontiguousarray(bits.T).astype(np.int64), device=device)


def ladder_instance(n: int, seed: int = 0, device=torch.device("cuda")):
    """random_points(n, seed) encoded, computed on `device` by K6
    (ops/exp.py exp_g1 / exp_g2): every lane holds the generator, the offset
    is infinity (all-zero) and the bits are the lane's scalar.  K6's
    canonical affine output is the host encoding bit for bit.  On a CPU
    tensor the wrappers run K6's plain ladders."""
    from ..ops import exp

    device = resolve_device(device)
    ka, kb = random_scalars(n, seed)
    g1 = curves.g1_encode([params.G1_GEN], device).expand(n, 2, 16).contiguous()
    g2 = curves.g2_encode([params.G2_GEN], device).expand(n, 2, 2, 16).contiguous()
    return (exp.exp_g1(g1, torch.zeros_like(g1), scalar_bits(ka, device)),
            exp.exp_g2(g2, torch.zeros_like(g2), scalar_bits(kb, device)))


def random_instance(n: int, seed: int = 0, device=torch.device("cuda")):
    """(A, B) as (n, 2, 16) and (n, 2, 2, 16) int64 limb tensors on `device`
    (the card unless asked otherwise): on the card drawn by K6
    (ladder_instance, seconds at n = 4096), on the CPU by hostref's host
    multiplies (random_points).  The same bytes either way."""
    device = resolve_device(device)
    if device.type != "cpu":
        return ladder_instance(n, seed, device)
    A, B = random_points(n, seed)
    return curves.g1_encode(A, device), curves.g2_encode(B, device)


def _coords_digest(ints):
    return hashlib.sha256(b"".join(v.to_bytes(32, "big") for v in ints)).hexdigest()


def points_digest(A, B):
    """instance_digest of host points [(x, y) or None], [((x0, x1), (y0,
    y1)) or None] (None hashes as all-zero coordinates)."""
    flat = [v for pt in A for v in (pt or (0, 0))]
    flat += [v for pt in B for c in (pt or ((0, 0), (0, 0))) for v in c]
    return _coords_digest(flat)


def instance_digest(a, b):
    """SHA-256 (hex) of an instance's canonical affine coordinates, each a
    32-byte big-endian integer out of Montgomery form: A's lanes in order,
    x then y each, then B's lanes in order, x.c0, x.c1, y.c0, y.c1 each; a
    lane at infinity hashes as zeros.  a: (n, 2, 16), b: (n, 2, 2, 16)
    limb tensors on any device."""
    return _coords_digest(curves._decode_fq_ints(a) + curves._decode_fq_ints(b))
