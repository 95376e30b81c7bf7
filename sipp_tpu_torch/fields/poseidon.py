"""Poseidon permutation over Goldilocks (width 12, rate 8, capacity 4): port
of sipp_tpu/fields/poseidon.py, host half carried over unchanged, device half
in plain PyTorch over FGL.

plonky2's Hades structure: x^7 S-box, 4 + 4 full rounds around 22 partial
rounds, constants added before each S-box layer, then plonky2's circulant MDS
(+8 on the (0,0) entry).  The round constants are the repo-pinned table
(SHA-256 counter mode, see the JAX module's docstring for why plonky2's own
table is not used), and SIPP_POSEIDON_RC_FILE swaps in an external table of
360 u64s (JSON list, or whitespace/comma-separated decimal/hex ints,
row-major round-then-lane) exactly as the JAX package reads it.  The native
transcript (native.py) and the CUDA transcript kernels (ops/transcript.py)
take their constants from here; this pure-Python permutation is their test
oracle.

The device half (permute_device, hash_no_pad_device) works on (..., 12, 5)
Montgomery Goldilocks limbs, the format of sipp_tpu's FGL; every step is
canonical, so its values equal the JAX package's limb for limb.
"""

import functools
import hashlib
import os

import torch

from .. import params
from . import FGL

P = params.GOLDILOCKS_P
WIDTH = 12
RATE = 8
N_FULL = 4      # full rounds on each side
N_PARTIAL = 22
N_ROUNDS = 2 * N_FULL + N_PARTIAL

MDS_CIRC = [17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20]
MDS_DIAG0 = 8
# MDS[r][c] = CIRC[(c - r) mod 12] (+ 8 at r == c == 0)
MDS = [
    [MDS_CIRC[(c - r) % WIDTH] + (MDS_DIAG0 if r == 0 and c == 0 else 0)
     for c in range(WIDTH)]
    for r in range(WIDTH)
]


def _gen_round_constants():
    out = []
    ctr = 0
    while len(out) < N_ROUNDS * WIDTH:
        h = hashlib.sha256(b"sipp-tpu poseidon goldilocks rc %d" % ctr).digest()
        ctr += 1
        for off in range(0, 32, 8):
            v = int.from_bytes(h[off : off + 8], "little")
            if v < P:  # rejection sampling: uniform in the field
                out.append(v)
    return [out[r * WIDTH : (r + 1) * WIDTH] for r in range(N_ROUNDS)]


def _load_round_constants(path):
    """External table hook (see module docstring): 360 u64s, row-major
    round-then-lane.  Accepts a JSON list or whitespace/comma-separated
    decimal/0x-hex integers."""
    with open(path) as f:
        text = f.read()
    try:
        import json

        vals = [int(v) for v in json.loads(text)]
    except ValueError:
        vals = [int(tok, 0) for tok in text.replace(",", " ").split()]
    if len(vals) != N_ROUNDS * WIDTH:
        raise ValueError(
            f"SIPP_POSEIDON_RC_FILE {path}: expected {N_ROUNDS * WIDTH} "
            f"constants, got {len(vals)}")
    bad = [v for v in vals if not 0 <= v < 2**64]
    if bad:
        raise ValueError(f"SIPP_POSEIDON_RC_FILE {path}: out-of-range {bad[:3]}")
    # plonky2 adds constants as unreduced u64s into Goldilocks arithmetic;
    # reduce on load so all three engines see canonical field elements
    vals = [v % P for v in vals]
    return [vals[r * WIDTH : (r + 1) * WIDTH] for r in range(N_ROUNDS)]


_RC_FILE = os.environ.get("SIPP_POSEIDON_RC_FILE")
ROUND_CONSTANTS = (
    _load_round_constants(_RC_FILE) if _RC_FILE else _gen_round_constants()
)


# ------------------------------------------------------------------- host

def _sbox(x):
    x2 = (x * x) % P
    x4 = (x2 * x2) % P
    return (x4 * x2 % P) * x % P


def permute(state):
    """One Poseidon permutation on a 12-list of ints."""
    s = [x % P for x in state]
    for r in range(N_ROUNDS):
        s = [(x + c) % P for x, c in zip(s, ROUND_CONSTANTS[r])]
        if N_FULL <= r < N_FULL + N_PARTIAL:
            s[0] = _sbox(s[0])
        else:
            s = [_sbox(x) for x in s]
        s = [sum(MDS[i][j] * s[j] for j in range(WIDTH)) % P for i in range(WIDTH)]
    return s


def hash_no_pad(inputs):
    """plonky2 hash_n_to_hash_no_pad: overwrite-absorb in rate-8 chunks,
    output = first 4 state elements (reference transcript_native.rs:27)."""
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i : i + RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    return state[:4]


# ------------------------------------------------------------------ device

@functools.lru_cache(maxsize=None)
def _tables(device):
    """(_RC_MONT (30, 12, 5), _MDS_MONT (12, 12, 5)) on `device`, built from
    ROUND_CONSTANTS (so the SIPP_POSEIDON_RC_FILE hook reaches them)."""
    rc = FGL.encode([c for row in ROUND_CONSTANTS for c in row], device)
    mds = FGL.encode([v for row in MDS for v in row], device)
    return rc.reshape(N_ROUNDS, WIDTH, FGL.L), mds.reshape(WIDTH, WIDTH, FGL.L)


def _sbox_dev(x):
    x2 = FGL.mul(x, x)
    x4 = FGL.mul(x2, x2)
    return FGL.mul(FGL.mul(x4, x2), x)


def permute_device(state):
    """One permutation of (..., 12, 5) Montgomery Goldilocks limbs."""
    rc, mds = _tables(state.device)
    s = state
    for r in range(N_ROUNDS):
        s = FGL.add(s, rc[r])
        if N_FULL <= r < N_FULL + N_PARTIAL:
            s = torch.cat([_sbox_dev(s[..., :1, :]), s[..., 1:, :]], dim=-2)
        else:
            s = _sbox_dev(s)
        # out[i] = sum_j MDS[i][j] s[j]: one stacked product, then a lazy sum
        # of 12 canonical values (< 12 p, limbs < 2^20) and one reduction
        s = FGL.reduce(FGL.mul(mds, s[..., None, :, :]).sum(dim=-2), WIDTH)
    return s


def hash_no_pad_device(inputs):
    """hash_no_pad on (..., K, 5) Montgomery limbs -> (..., 4, 5)."""
    K = inputs.shape[-2]
    state = inputs.new_zeros((*inputs.shape[:-2], WIDTH, FGL.L))
    for i in range(0, K, RATE):
        chunk = inputs[..., i:i + RATE, :]
        state = permute_device(torch.cat([chunk, state[..., chunk.shape[-2]:, :]], dim=-2))
    return state[..., :4, :]
