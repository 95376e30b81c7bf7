"""The port's bucket MSMs (sipp_tpu_torch/ops/msm.py msm_bucket,
msm_bucket_sharded) on the CPU, mirroring tests/test_msm_bucket.py and
tests/test_msm_sharded.py: the same instances, each result held to the
oracle those tests use (sipp_tpu.hostref's g1_mul/g1_add, g2_*) and to the
port's ladder msm, as affine points (tolerance 0).  12-bit scalars and
4-bit windows give three full windows with real collisions; a zero scalar
and a duplicate digit are in each instance."""

import torch

from sipp_tpu import hostref as H
from sipp_tpu_torch import curves as C
from sipp_tpu_torch.ops import msm
from sipp_tpu_torch.parallel import make_mesh
from sipp_tpu_torch.utils.testing import random_points


def _bits_short(ks, nbits):
    """(nbits, n) MSB-first bit planes of small scalars."""
    return torch.tensor([[(k >> (nbits - 1 - i)) & 1 for k in ks] for i in range(nbits)],
                        dtype=torch.int64)


def _oracle(add, mul, pts, ks):
    want = None
    for p, k in zip(pts, ks):
        want = add(want, mul(p, k))
    return want


def _scalars(rng, n):
    ks = [int(rng.integers(1 << 12)) for _ in range(n - 1)] + [0]
    ks[1] = ks[0] ^ 0x00F                 # the top two windows' digits repeat
    return ks


def test_msm_bucket_g1(rng):
    n = 6
    A, _ = random_points(n, seed=47)
    ks = _scalars(rng, n)
    bits, pts = _bits_short(ks, 12), C.g1_encode(A)
    got = C.g1_decode(C.G1.to_affine(msm.msm_bucket_g1(pts, bits, c=4)[None]))[0]
    ladder = C.g1_decode(C.G1.to_affine(msm.msm_g1(pts, bits)[None]))[0]
    want = _oracle(H.g1_add, H.g1_mul, A, ks)
    assert got == want
    assert ladder == want
    # one window's buckets alone are that window's row of the batched form
    dig = msm._digits(bits, 4)
    assert torch.equal(msm._window_buckets(C.G1, pts, dig[1], 4),
                       msm._window_buckets(C.G1, pts, dig, 4)[1])


def test_msm_bucket_g2(rng):
    n = 6
    _, B = random_points(n, seed=53)
    ks = _scalars(rng, n)
    bits, pts = _bits_short(ks, 12), C.g2_encode(B)
    got = C.g2_decode(C.G2.to_affine(msm.msm_bucket_g2(pts, bits, c=4)[None]))[0]
    ladder = C.g2_decode(C.G2.to_affine(msm.msm_g2(pts, bits)[None]))[0]
    want = _oracle(H.g2_add, H.g2_mul, B, ks)
    assert got == want
    assert ladder == want


def test_msm_bucket_sharded_g1(rng):
    """Eight CPU shards of two points each: per-shard buckets, the gathered
    bucket-wise tree, the window combine."""
    n = 16
    A, _ = random_points(n, seed=61)
    ks = _scalars(rng, n)
    bits, pts = _bits_short(ks, 12), C.g1_encode(A)
    shard = C.g1_decode(C.G1.to_affine(
        msm.msm_bucket_sharded(C.G1, pts, bits, make_mesh(8, "cpu"), c=4)[None]))[0]
    single = C.g1_decode(C.G1.to_affine(msm.msm_bucket(C.G1, pts, bits, c=4)[None]))[0]
    ladder = C.g1_decode(C.G1.to_affine(msm.msm_g1(pts, bits)[None]))[0]
    want = _oracle(H.g1_add, H.g1_mul, A, ks)
    assert shard == want
    assert single == want
    assert ladder == want
