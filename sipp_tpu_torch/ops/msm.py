"""Multi-scalar multiplication sum_i [k_i] P_i (port of sipp_tpu/ops/msm.py),
in plain PyTorch, and X2, the sum of the MSM finals' lanes (csrc/msm.cu).

Ladder form (tree_sum, msm): one 254-step per-lane ladder over all n
points at once (curves' scalar_mul_per_lane), then a log2(n) tree of
complete additions.  The verifier's MSM finals run the ladder as kernel K6
(ops/exp.py) and finish with msm_finish: kernel X2 (msm_sum_g1,
msm_sum_g2) for CUDA tensors, replacing the XLA _tree_sum + to_affine of
sipp_tpu/protocol/verifier.py:_finals_msm_dev (no Pallas counterpart), and
msm_finish_plain, the complete-add tree and to_affine, for CPU tensors;
there is no other route.  X2 is two launches of one kernel: a chunk launch
whose lane groups chain a few lanes each and add pairwise inside their
block, writing a Jacobian partial a block to a scratch tensor that the
wrapper allocates, then a tree launch of one block that sums the partials
the same way and converts to affine; one block's lanes need the chunk
launch alone.  Bound on the H100 and design: see the note at the top of
csrc/msm.cu.

Fixed-window bucket form (msm_bucket, msm_bucket_sharded): per c-bit window
the points are sorted by digit, a segmented scan sums each bucket, and the
windows combine by suffix sums and Horner's rule.  The JAX module runs these
as XLA scans and reaches no kernel; here every window is handled at once
(a batch dimension) and each scan is a Hillis-Steele scan of log2 depth,
every level one batched complete addition.  Jacobian addition is exact, so
any bracketing gives the same group element as the ladder.  Points at
infinity are the all-zero affine encoding and enter through curves' lift
(Z = 0), never as the point (0, 0).
"""

import torch

from ..curves import G1, G2
from . import _build


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


def msm_g1(points_aff, bits):
    return msm(G1, points_aff, bits)


def msm_g2(points_aff, bits):
    return msm(G2, points_aff, bits)


def msm_finish_plain(curve, lanes):
    """Per-lane affine products (K6's output) -> their sum, (1, ...) affine."""
    return curve.to_affine(tree_sum(curve, curve.lift(lanes))[None])


def _msm_sum(wrapper, lanes, tail):
    """lanes: (n, *tail) affine int64 limbs on a card, n >= 1 -> (1, *tail)
    canonical affine.  Counts one launch a call on `wrapper` (the chunk
    launch and, past one block, the tree launch)."""
    which = wrapper.__name__
    lanes = _build.check_cuda_input(lanes, "lanes", tail)
    if lanes.dim() != len(tail) + 1 or lanes.shape[0] < 1:
        raise ValueError(f"{which}: expected (n, {', '.join(map(str, tail))}) lanes, "
                         f"got {tuple(lanes.shape)}")
    lib = _build.cuda_library()
    n = lanes.shape[0]
    out = lanes.new_empty((1, *tail))
    # the chunk launch's Jacobian partials, which the tree launch sums
    # (none where one block holds every lane)
    blocks = lib.sipp_msm_blocks(n)
    partials = lanes.new_empty((blocks, 3, *tail[1:])) if blocks > 1 else None
    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream(lanes.device).cuda_stream
        err = getattr(lib, f"sipp_{which}")(lanes.data_ptr(),
                                            None if partials is None else partials.data_ptr(),
                                            out.data_ptr(), n, stream)
    _build.check_launch(lib, err, which)
    wrapper.launches += 1
    return out


def msm_sum_g1(lanes):
    """X2 for G1: (n, 2, 16) affine lanes on a card -> their sum (1, 2, 16)."""
    return _msm_sum(msm_sum_g1, lanes, (2, 16))


def msm_sum_g2(lanes):
    """X2 for G2: (n, 2, 2, 16) affine lanes on a card -> their sum (1, 2, 2, 16)."""
    return _msm_sum(msm_sum_g2, lanes, (2, 2, 16))


msm_sum_g1.launches = 0
msm_sum_g2.launches = 0


def msm_finish(curve, lanes):
    """Per-lane affine products (K6's output) -> their sum, (1, ...) affine:
    X2 for CUDA tensors, msm_finish_plain for CPU tensors."""
    if lanes.device.type == "cpu":
        return msm_finish_plain(curve, lanes)
    if lanes.device.type != "cuda":
        raise ValueError(f"msm_finish: unsupported device {lanes.device}")
    return (msm_sum_g1 if curve is G1 else msm_sum_g2)(lanes)


# --------------------------------------------------- fixed-window bucket MSM

def _segment_scan_points(curve, keys, jac):
    """Inclusive segmented sum over axis 0, keys sorted along it: position i
    holds the Jacobian sum of the points j <= i with keys[j] == keys[i].
    keys: (n, *batch); jac: (n, *batch, 3, ...).  At level s each position
    adds the one s back when both carry the same key (on sorted keys, then
    the whole range between them does)."""
    n, s = keys.shape[0], 1
    while s < n:
        same = curve._expand(keys[s:] == keys[:-s])
        jac = torch.cat([jac[:s], torch.where(same, curve.add(jac[:-s], jac[s:]), jac[s:])])
        s *= 2
    return jac


def _digits(bits, c: int):
    """(nbits, n) MSB-first bits (a tensor) -> (w, n) int64 c-bit window
    digits, MSB window first (the first window zero-padded when c does not
    divide nbits)."""
    nbits, n = bits.shape
    w = -(-nbits // c)
    bits = torch.cat([bits.new_zeros((w * c - nbits, n)), bits]).to(torch.int64)
    digits = torch.zeros((w, n), dtype=torch.int64, device=bits.device)
    for j in range(c):
        digits = (digits << 1) + bits[j::c]
    return digits


def _window_buckets(curve, points_aff, dig, c: int):
    """Bucket sums B_k = sum of the points with digit k (k = 1..2^c - 1) of
    one window, dig (n,) -> (2^c - 1, ...) Jacobian, or of w windows at once,
    dig (w, n) -> (w, 2^c - 1, ...): a stable sort by digit, the sorted
    points (zero digits masked to infinity, so they add nothing), the
    segmented scan, and each bucket read at its segment's end
    (searchsorted(right) - 1); empty buckets are infinity."""
    n = dig.shape[-1]
    dig2 = dig.reshape(-1, n)
    d_s, perm = torch.sort(dig2, dim=-1, stable=True)
    jac = curve.lift(points_aff[perm])                          # (w, n, 3, ...)
    jac = torch.where(curve._expand(d_s == 0), 0, jac)
    sums = _segment_scan_points(curve, d_s.T, jac.transpose(0, 1)).transpose(0, 1)
    ks = torch.arange(1, 1 << c, device=dig.device).expand(dig2.shape[0], -1).contiguous()
    pos = (torch.searchsorted(d_s, ks, right=True) - 1).clamp(0, n - 1)
    rows = torch.arange(dig2.shape[0], device=dig.device)[:, None]
    out = torch.where(curve._expand(d_s[rows, pos] == ks), sums[rows, pos], 0)
    return out.reshape(*dig.shape[:-1], *out.shape[1:])


def _suffix_sums(curve, pts):
    """Reverse inclusive scan over axis 0: position k holds sum_{j >= k}."""
    n, s = pts.shape[0], 1
    while s < n:
        pts = torch.cat([curve.add(pts[:-s], pts[s:]), pts[-s:]])
        s *= 2
    return pts


def _horner_windows(curve, buckets_all, c: int):
    """Per-window buckets (w, 2^c - 1, ...) -> the MSM's Jacobian sum: per
    window sum_k k B_k as the tree sum of the suffix sums (every window at
    once), then the windows MSB first by Horner's rule, c doublings each."""
    t = tree_sum(curve, _suffix_sums(curve, buckets_all.transpose(0, 1)))   # (w, 3, ...)
    acc = torch.zeros_like(t[0])
    for t_w in t.unbind(0):
        for _ in range(c):
            acc = curve.dbl(acc)
        acc = curve.add(acc, t_w)
    return acc


def msm_bucket(curve, points_aff, bits, c: int = 8):
    """sum_i [k_i] P_i by fixed-window buckets: the digits, every window's
    bucket sums (_window_buckets), then _horner_windows.  points_aff:
    (n, ...) affine; bits: (nbits, n) MSB-first, a tensor on the points'
    device.  Returns a Jacobian point, the group element of msm()."""
    return _horner_windows(curve, _window_buckets(curve, points_aff, _digits(bits, c), c), c)


def msm_bucket_sharded(curve, points_aff, bits, mesh, c: int = 8):
    """msm_bucket over a device mesh (parallel.Mesh): shard k buckets only
    its block of n/d points, on its own device, for every window; the
    (w, 2^c - 1) bucket tables, gathered onto the lead device, are added
    bucket-wise by a tree in device order (the one collective moves
    O(w 2^c) points, whatever n), and the window combine runs there.
    points_aff: (n, ...) affine with d | n; bits: (nbits, n) MSB-first.
    Returns the Jacobian point on the lead device (on every process)."""
    n, d = points_aff.shape[0], mesh.size
    assert n % d == 0, f"n={n} not divisible by mesh size {d}"
    digits, per = _digits(bits, c), n // d
    local = []
    for j, dev in enumerate(mesh.devices):
        blk = slice((mesh.offset + j) * per, (mesh.offset + j + 1) * per)
        local.append(_window_buckets(curve, points_aff[blk].to(dev), digits[:, blk].to(dev), c))
    return _horner_windows(curve, tree_sum(curve, torch.stack(mesh.all_gather(local))), c)


def msm_bucket_g1(points_aff, bits, c: int = 8):
    return msm_bucket(G1, points_aff, bits, c)


def msm_bucket_g2(points_aff, bits, c: int = 8):
    return msm_bucket(G2, points_aff, bits, c)
