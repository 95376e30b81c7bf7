"""Multi-scalar multiplication sum_i [k_i] P_i, ladder form (port of
sipp_tpu/ops/msm.py:_tree_sum, msm): one 254-step per-lane ladder over all n
points at once (curves' scalar_mul_per_lane), then a log2(n) tree of
complete additions.  Plain PyTorch; the verifier's MSM finals run the ladder
as kernel K6 (ops/exp.py) and finish with msm_finish.  The bucket
(Pippenger) forms of the JAX module are not ported yet.
"""

import torch


def tree_sum(curve, pts):
    """Complete-addition tree over the leading axis of Jacobian points."""
    n = pts.shape[0]
    while n > 1:
        half = n // 2
        head = curve.add(pts[:half], pts[half:2 * half])
        pts = torch.cat([head, pts[2 * half:n]]) if n % 2 else head
        n = half + n % 2
    return pts[0]


def msm(curve, points_aff, bits):
    """points_aff: (n, ...) affine; bits: (254, n) MSB-first per-lane scalar
    bits.  Returns the Jacobian sum."""
    return tree_sum(curve, curve.scalar_mul_per_lane(points_aff, bits))


def msm_finish(curve, lanes):
    """Per-lane affine products (K6's output) -> their sum, (1, ...) affine."""
    return curve.to_affine(tree_sum(curve, curve.lift(lanes))[None])
