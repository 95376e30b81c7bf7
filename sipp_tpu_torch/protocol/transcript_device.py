"""On-device Fiat-Shamir transcript (port of
sipp_tpu/protocol/transcript_device.py): the state is four Goldilocks
elements as (4, 5) Montgomery limbs on the device, appends run the plain
PyTorch Poseidon chain (fields/poseidon.py), and the challenge is reduced into
Fr on the device, so a fold round never leaves the card.  The host transcript
(transcript.py) stays the prologue; both give the same bytes.

The challenge reproduces the variable-length `to_u32_digits` quirk of the
host transcript exactly: each digest element contributes its little-endian
u32 digits with leading zero digits dropped, which shifts the later
elements' positions (hit with probability about 2^-32 per challenge).
`_digest_to_challenge_limbs` computes the digit counts and scatters the
limbs by their offsets without branching on values.

These are plain versions: the fused round tail and Z append of the on-chip
prover are the CUDA kernels of ops/transcript.py, checked against them.
"""

import functools

import torch

from ..fields import FGL, FQ, FR, poseidon, tower


@functools.lru_cache(maxsize=None)
def _lane_index(device):
    """(16,) limb positions and (254,) MSB-first bit positions on `device`."""
    i = torch.arange(254, device=device)
    return torch.arange(16, device=device), (253 - i) // 16, (253 - i) % 16


def _u32s_to_goldilocks(u32s):
    """(..., K) values below 2^32 -> (..., K, 5) Montgomery Goldilocks limbs."""
    limbs = torch.stack([u32s & 0xFFFF, u32s >> 16], dim=-1)
    return FGL.to_mont(torch.cat([limbs, limbs.new_zeros((*limbs.shape[:-1], FGL.L - 2))], -1))


def _fq_limbs_to_u32(limbs):
    """(..., 16) canonical 16-bit limbs -> (..., 8) little-endian u32 digits."""
    return limbs[..., 0::2] | (limbs[..., 1::2] << 16)


def new_state(device="cpu"):
    """Initial transcript state: four zero Goldilocks elements (4, 5)."""
    return torch.zeros((4, FGL.L), dtype=torch.int64, device=device)


def fq12_message(f):
    """(..., 2, 3, 2, 16) Montgomery Fq12 -> (..., 96, 5): the 12 direct-basis
    coefficients, 8 u32 digits each, as Goldilocks elements."""
    u32s = _fq_limbs_to_u32(tower.fq12_to_direct(f))          # (..., 12, 8)
    return _u32s_to_goldilocks(u32s.reshape(*u32s.shape[:-2], 96))


def _append(state, msg):
    return poseidon.hash_no_pad_device(torch.cat([state, msg], dim=-2))


def append_fq12(state, f):
    """state' = hash_no_pad(state || MyFq12-direct(f) as 96 elements)."""
    return _append(state, fq12_message(f))


def append_g1(state, p_aff):
    """p_aff: (2, 16) Montgomery affine G1 -> a 16-element append."""
    return _append(state, _u32s_to_goldilocks(_fq_limbs_to_u32(FQ.from_mont(p_aff)).reshape(16)))


def append_g2(state, q_aff):
    """q_aff: (2, 2, 16) -> a 32-element append (x0 || x1 || y0 || y1)."""
    return _append(state, _u32s_to_goldilocks(_fq_limbs_to_u32(FQ.from_mont(q_aff)).reshape(32)))


def _digest_to_challenge_limbs(canon):
    """(4, 5) canonical Goldilocks digest limbs -> (16,) 16-bit limbs of the
    quirk-exact concatenated integer.

    Element k contributes len_k in {0, 1, 2} u32 digits (2, minus one if its
    high u32 is zero, minus one more if the whole value is zero), landing at
    u32 offset c_k = sum_{j<k} len_j; scattered with one-hot compares."""
    pos, _, _ = _lane_index(canon.device)
    l = canon[..., :4]                                   # (4 elements, 4 limbs)
    lo_zero = (l[..., 0] | l[..., 1]) == 0
    hi_zero = (l[..., 2] | l[..., 3]) == 0
    lens = 2 - hi_zero.long() - (hi_zero & lo_zero).long()
    offs = 2 * (torch.cumsum(lens, 0) - lens)            # 16-bit limb offsets
    out = torch.zeros_like(pos)
    for k in range(4):
        for t in range(4):
            present = lens[k] >= (1 if t < 2 else 2)
            out = out + torch.where((pos == offs[k] + t) & present, l[k, t], 0)
    return out


def bits_msb(fr_limbs):
    """(..., 16) canonical Fr limbs -> (..., 254) MSB-first bits."""
    _, idx, sh = _lane_index(fr_limbs.device)
    return (fr_limbs[..., idx] >> sh) & 1


def get_challenge(state):
    """The Fr challenge as (254,) MSB-first bits and (16,) canonical limbs;
    equal to the host Transcript.get_challenge.  Does not change the state."""
    canon = FGL.from_mont(poseidon.hash_no_pad_device(state))
    fr = FR.from_mont(FR.to_mont(_digest_to_challenge_limbs(canon)))  # mod r
    return bits_msb(fr), fr


def fr_inverse(x):
    """Canonical Fr limbs -> canonical limbs of x^-1 (Fermat, x^(r-2))."""
    return FR.from_mont(FR.inv(FR.to_mont(x)))
