"""Fiat-Shamir transcript: Poseidon-Goldilocks hash chain (port of
sipp_tpu/protocol/transcript.py, same bytes).

- state: 4 Goldilocks elements, initially zero.
- append(msg): state = hash_no_pad(state[4] || msg), a hash chain.
- Fq encoding: canonical value -> 8 little-endian u32 digits -> 8 elements.
- G1 = x||y (16 elements); G2 = x.c0||x.c1||y.c0||y.c1 (32); Fq12 = the 12
  direct-basis (MyFq12) coefficients in order (96).
- challenge: digest = hash_no_pad(state[4]); the VARIABLE-length u32 digits
  of the 4 digest elements (Rust BigUint::to_u32_digits drops leading zero
  limbs, reproduced exactly) read as one little-endian integer, mod r.
  get_challenge does not mutate the state.

The chain runs in the repo's C++ library (native.py), which is required,
unless SIPP_TPU_NO_NATIVE is set when the Transcript is made (once per prove
or verify call): then it runs fields/poseidon.hash_no_pad, the pure-Python
Poseidon, as the JAX package does without its library.  Both give the same
states.
"""

import numpy as np

from .. import hostref, native, params
from ..fields import bigint, poseidon


def fq_to_elements(x: int) -> list:
    """Fq canonical int -> 8 little-endian u32 digits as Goldilocks elements."""
    if not 0 <= x < params.P:
        raise ValueError("Fq value out of range")
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def fq12_to_elements(f) -> list:
    """f (host tower tuple) -> 96 elements (12 direct-basis coeffs x 8)."""
    return [e for c in hostref.fq12_to_direct(f) for e in fq_to_elements(c)]


def u32_digits_var(v: int) -> list:
    """Rust BigUint::to_u32_digits: little-endian, no leading zero limbs
    (empty for zero)."""
    out = []
    while v:
        out.append(v & 0xFFFFFFFF)
        v >>= 32
    return out


def challenge_from_digest(digest) -> int:
    digits = [d for e in digest for d in u32_digits_var(e)]
    return sum(d << (32 * i) for i, d in enumerate(digits)) % params.R


class Transcript:
    def __init__(self):
        self.state = [0, 0, 0, 0]
        self._native = native.enabled()

    def _absorb_flat(self, flat, lens):
        if self._native:
            self.state = native.transcript_absorb_flat(self.state, flat, lens)
            return
        at = 0
        for k in lens:
            msg = [int(v) for v in flat[at:at + k]]
            self.state = poseidon.hash_no_pad(self.state + msg)
            at += k

    def append(self, msg):
        msg = list(msg)
        self._absorb_flat(msg, [len(msg)])

    def append_fq12(self, f):
        self.append(fq12_to_elements(f))

    def append_points(self, a_pts, b_pts):
        """Interleaved (A_i, B_i) prologue, built as one bulk u32-digit array
        and absorbed in one native call; None (infinity) encodes as zeros."""
        coords = []
        for a, b in zip(a_pts, b_pts):
            x, y = a if a is not None else (0, 0)
            (x0, x1), (y0, y1) = b if b is not None else ((0, 0), (0, 0))
            coords += [x, y, x0, x1, y0, y1]
        flat = bigint.ints_to_u32x8_array(coords).reshape(-1)
        lens = np.tile(np.asarray([16, 32], np.uintp), len(a_pts))
        self._absorb_flat(flat, lens)

    def get_challenge(self) -> int:
        """Fr challenge; does not mutate the state."""
        hash_no_pad = native.hash_no_pad if self._native else poseidon.hash_no_pad
        return challenge_from_digest(hash_no_pad(list(self.state)))
