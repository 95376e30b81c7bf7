"""The SIPP Fiat-Shamir transcript in plain Python: a frozen copy of the
Poseidon-Goldilocks hash chain that the program states (width 12, rate 8,
x^7 S-box, 4 + 22 + 4 rounds, plonky2's circulant MDS with 8 more on the
(0, 0) entry, the round constants of SHA-256 in counter mode over
b"sipp-tpu poseidon goldilocks rc %d", rejection-sampled below p).

- state: 4 Goldilocks elements, zero at the start; append(msg) sets
  state = hash_no_pad(state || msg).
- an Fq value is 8 little-endian u32 digits; G1 = x || y, G2 = x.c0 || x.c1
  || y.c0 || y.c1; an Fq12 the 12 direct-basis coefficients in order.
- the prologue appends every (A_i, B_i), A_i then B_i.
- challenge: hash_no_pad(state), its 4 elements' u32 digits with leading
  zero digits dropped (Rust's BigUint::to_u32_digits), read as one
  little-endian integer mod r; the state is not changed.
"""

import hashlib
import operator

from .bn254 import R, fq12_direct

GL = 2**64 - 2**32 + 1
WIDTH, RATE, N_FULL, N_PARTIAL = 12, 8, 4, 22
N_ROUNDS = 2 * N_FULL + N_PARTIAL
_CIRC = (17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20)
MDS = tuple(tuple(_CIRC[(c - r) % WIDTH] + (8 if r == c == 0 else 0) for c in range(WIDTH))
            for r in range(WIDTH))


def _round_constants():
    out, ctr = [], 0
    while len(out) < N_ROUNDS * WIDTH:
        h = hashlib.sha256(b"sipp-tpu poseidon goldilocks rc %d" % ctr).digest()
        ctr += 1
        out += [v for v in (int.from_bytes(h[i:i + 8], "little") for i in range(0, 32, 8))
                if v < GL]
    return tuple(tuple(out[r * WIDTH:(r + 1) * WIDTH]) for r in range(N_ROUNDS))


RC = _round_constants()


def _sbox(x):
    x2 = x * x % GL
    return x2 * x2 % GL * x2 % GL * x % GL


def permute(s):
    mul = operator.mul
    for r in range(N_ROUNDS):
        s = [x + c for x, c in zip(s, RC[r])]
        if N_FULL <= r < N_FULL + N_PARTIAL:
            s[0] = _sbox(s[0])
        else:
            s = [_sbox(x) for x in s]
        s = [sum(map(mul, row, s)) % GL for row in MDS]
    return s


def hash_no_pad(inputs):
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE):
        chunk = inputs[i:i + RATE]
        state[:len(chunk)] = [x % GL for x in chunk]
        state = permute(state)
    return state[:4]


def fq_elements(v):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


class Transcript:
    def __init__(self):
        self.state = [0, 0, 0, 0]

    def append(self, msg):
        self.state = hash_no_pad(self.state + list(msg))

    def append_points(self, a_pts, b_pts):
        for (x, y), ((x0, x1), (y0, y1)) in zip(a_pts, b_pts):
            self.append(fq_elements(x) + fq_elements(y))
            self.append([e for v in (x0, x1, y0, y1) for e in fq_elements(v)])

    def append_fq12(self, f):
        self.append([e for c in fq12_direct(f) for e in fq_elements(c)])

    def challenge(self):
        digits = []
        for e in hash_no_pad(list(self.state)):
            while e:
                digits.append(e & 0xFFFFFFFF)
                e >>= 32
        return sum(d << (32 * i) for i, d in enumerate(digits)) % R
