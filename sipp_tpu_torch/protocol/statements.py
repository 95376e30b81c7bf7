"""SIPP statement type and the flat u32 public-input codec (carried over
unchanged from sipp_tpu/protocol/statements.py).

Bit-exact wire layout of the Rust statements.rs (SURVEY.md §2.4 item 8):
[A (16n u32) || B (32n) || Z (96) || final_A (16) || final_B (32) ||
 final_Z (96)] = 48n + 240 little-endian u32 values, 8 per Fq, Fq12 in
MyFq12 direct-basis coefficient order.
"""

from dataclasses import dataclass

from .. import hostref, params


def _fq_to_u32(x):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _u32_to_fq(d):
    v = 0
    for i, w in enumerate(d):
        v |= int(w) << (32 * i)
    assert v < params.P
    return v


def u32_array_to_g1(d):
    """16 u32 -> G1 affine point (statements.rs:90-101)."""
    return (_u32_to_fq(d[0:8]), _u32_to_fq(d[8:16]))


def u32_array_to_g2(d):
    """32 u32 -> G2 affine point."""
    return (
        (_u32_to_fq(d[0:8]), _u32_to_fq(d[8:16])),
        (_u32_to_fq(d[16:24]), _u32_to_fq(d[24:32])),
    )


def u32_array_to_fq12(d):
    """96 u32 -> Fq12 (tower) via 12 direct-basis coeffs (statements.rs:118-131)."""
    coeffs = [_u32_to_fq(d[8 * i : 8 * i + 8]) for i in range(12)]
    return hostref.direct_to_fq12(coeffs)


@dataclass
class SIPPStatement:
    """Host statement: original vectors + folded finals (statements.rs:81-88)."""

    A: list          # n G1 affine points
    B: list          # n G2 affine points
    Z: tuple         # Fq12 (tower)
    final_A: tuple   # G1 affine
    final_B: tuple   # G2 affine
    final_Z: tuple   # Fq12 (tower)

    def to_vec(self) -> list:
        out = []
        for p in self.A:
            out += _fq_to_u32(p[0]) + _fq_to_u32(p[1])
        for q in self.B:
            (x0, x1), (y0, y1) = q
            out += _fq_to_u32(x0) + _fq_to_u32(x1) + _fq_to_u32(y0) + _fq_to_u32(y1)
        for f in (self.Z,):
            for c in hostref.fq12_to_direct(f):
                out += _fq_to_u32(c)
        out += _fq_to_u32(self.final_A[0]) + _fq_to_u32(self.final_A[1])
        (x0, x1), (y0, y1) = self.final_B
        out += _fq_to_u32(x0) + _fq_to_u32(x1) + _fq_to_u32(y0) + _fq_to_u32(y1)
        for c in hostref.fq12_to_direct(self.final_Z):
            out += _fq_to_u32(c)
        assert len(out) == 48 * len(self.A) + 240
        return out

    @classmethod
    def from_vec(cls, n: int, vec: list):
        assert len(vec) == 48 * n + 240
        pos = 0
        A = []
        for _ in range(n):
            A.append(u32_array_to_g1(vec[pos : pos + 16]))
            pos += 16
        B = []
        for _ in range(n):
            B.append(u32_array_to_g2(vec[pos : pos + 32]))
            pos += 32
        Z = u32_array_to_fq12(vec[pos : pos + 96]); pos += 96
        final_A = u32_array_to_g1(vec[pos : pos + 16]); pos += 16
        final_B = u32_array_to_g2(vec[pos : pos + 32]); pos += 32
        final_Z = u32_array_to_fq12(vec[pos : pos + 96]); pos += 96
        return cls(A, B, Z, final_A, final_B, final_Z)
