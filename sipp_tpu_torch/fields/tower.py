"""Plain PyTorch BN254 tower fields Fq2/Fq6/Fq12 (port of fields/tower.py).

Layouts (int64 16-bit limbs, L = 16, arbitrary leading batch dims), as in the
JAX package:
    Fq2  : (..., 2, L)        c0 + c1*u,         u^2 = -1
    Fq6  : (..., 3, 2, L)     c0 + c1*v + c2*v^2, v^3 = xi = 9+u
    Fq12 : (..., 2, 3, 2, L)  c0 + c1*w,         w^2 = v

Each tower multiply stacks its independent Fq products into one batched
Fq.mul call (3 for Fq2, 18 for Fq6, 54 for Fq12 via Karatsuba), and forms
its linear combinations lazily (fields/fq.py) with one carry pass per
stage, which keeps the number of tensor ops per call small.  Frobenius
constants are derived from hostref.
"""

import functools

import torch

from .. import hostref, params
from . import FQ

F = FQ
L = F.L


def _xi_lazy(a):
    """(9+u) a = (9 a0 - a1) + (9 a1 + a0) u for canonical a, lazy (< 11p)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([F.subs(9 * a0, a1), 9 * a1 + a0], dim=-2)


# ------------------------------------------------------------------------ Fq2

def fq2_encode(vals, device="cpu"):
    """Host (c0, c1) tuple, or nested lists of them -> (..., 2, L) tensor."""
    if isinstance(vals, tuple) and isinstance(vals[0], int):
        return F.encode(list(vals), device)
    return torch.stack([fq2_encode(v, device) for v in vals])


def fq2_mul(a, b):
    """Karatsuba over one stacked Fq multiply; a, b canonical or lazy sums
    below 2p per coefficient."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    v0, v1, t = F.mul(torch.stack([a0, a1, a0 + a1]),
                      torch.stack([b0, b1, b0 + b1])).unbind(0)
    return F.reduce(torch.stack([F.subs(v0, v1), F.subs(t, v0, v1)], dim=-2), 5)


def fq2_conj(a):
    return torch.stack([a[..., 0, :], F.neg(a[..., 1, :])], dim=-2)


def fq2_mul_xi(a):
    """(9+u) * a."""
    return F.reduce(_xi_lazy(a), 11)


def fq2_scale(a, s):
    """Both coefficients times an Fq element s (..., L)."""
    return F.mul(a, s[..., None, :])


def fq2_inv(a):
    """Inversion through the norm map (one Fermat Fq inversion)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    sq = F.mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    ninv = F.inv(F.add(sq[0], sq[1]))
    return torch.stack([F.mul(a0, ninv), F.neg(F.mul(a1, ninv))], dim=-2)


def fq2_is_zero(a):
    return (a == 0).all(dim=-1).all(dim=-1)


# ------------------------------------------------------------------------ Fq6

def fq6_mul(a, b):
    """Karatsuba/Toom over six stacked Fq2 products; a, b canonical."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    x = torch.stack([a0, a1, a2, a1 + a2, a0 + a1, a0 + a2])
    y = torch.stack([b0, b1, b2, b1 + b2, b0 + b1, b0 + b2])
    v0, v1, v2, t12, t01, t02 = fq2_mul(x, y).unbind(0)
    w12, w01, w02 = F.reduce(torch.stack(
        [F.subs(t12, v1, v2), F.subs(t01, v0, v1), F.subs(t02, v0, v2)]), 5).unbind(0)
    # c0 = v0 + xi w12 ; c1 = w01 + xi v2 ; c2 = w02 + v1
    return F.reduce(torch.stack([v0 + _xi_lazy(w12), w01 + _xi_lazy(v2), w02 + v1],
                                dim=-3), 12)


def _mul_by_v_lazy(a):
    """v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2, lazy (< 11p)."""
    return torch.cat([_xi_lazy(a[..., 2, :, :])[..., None, :, :], a[..., 0:2, :, :]], dim=-3)


def fq6_mul_by_v(a):
    return F.reduce(_mul_by_v_lazy(a), 11)


def fq6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    # A = a0^2 - xi a1 a2 ; B = xi a2^2 - a0 a1 ; C = a1^2 - a0 a2
    s0, s1, s2, p12, p01, p02 = fq2_mul(
        torch.stack([a0, a1, a2, a1, a0, a0]),
        torch.stack([a0, a1, a2, a2, a1, a2])).unbind(0)
    A = F.sub(s0, fq2_mul_xi(p12))
    B = F.sub(fq2_mul_xi(s2), p01)
    C = F.sub(s1, p02)
    # t = a0 A + xi (a2 B + a1 C)
    u = fq2_mul(torch.stack([a0, a2, a1]), torch.stack([A, B, C]))
    t = F.add(u[0], fq2_mul_xi(F.add(u[1], u[2])))
    out = fq2_mul(torch.stack([A, B, C]), fq2_inv(t)[None])
    return torch.movedim(out, 0, -3)


# ----------------------------------------------------------------------- Fq12

def fq12_encode(vals, device="cpu"):
    """Host tower tuple (or a list of them) -> (..., 2, 3, 2, L)."""
    if isinstance(vals[0][0][0], int):
        return torch.stack([torch.stack([fq2_encode(c, device) for c in half])
                            for half in vals])
    return torch.stack([fq12_encode(v, device) for v in vals])


def fq12_decode(x):
    """(..., 2, 3, 2, L) -> host tower tuple (or nested lists of them)."""
    if x.dim() > 4:
        return [fq12_decode(v) for v in x]
    flat = F.decode(x.reshape(-1, L))
    return tuple(tuple((flat[6 * i + 2 * j], flat[6 * i + 2 * j + 1])
                       for j in range(3)) for i in range(2))


@functools.lru_cache(maxsize=None)
def _fq12_one_on(device):
    return fq12_encode(hostref.FQ12_ONE, device)


def fq12_one(batch_shape=(), device="cpu"):
    """The Fq12 one, expanded to batch_shape (a read-only view of a constant
    cached per device, so a call makes no host-to-device copy)."""
    one = _fq12_one_on(torch.device(device))
    return one.expand(*batch_shape, *one.shape)


def fq12_mul(a, b):
    """Karatsuba over three stacked Fq6 products; a, b canonical."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
    sa, sb = F.reduce(torch.stack([a0 + a1, b0 + b1]), 2).unbind(0)
    v0, v1, t = fq6_mul(torch.stack([a0, a1, sa]), torch.stack([b0, b1, sb])).unbind(0)
    # c0 = v0 + v v1 ; c1 = t - v0 - v1
    return F.reduce(torch.stack([v0 + _mul_by_v_lazy(v1), F.subs(t, v0, v1)], dim=-4), 12)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_cyclo_sqr(g):
    """Granger-Scott squaring, valid for g in the cyclotomic subgroup (every
    final-exponentiation intermediate after the easy part)."""
    z0, z4, z3 = g[..., 0, 0, :, :], g[..., 0, 1, :, :], g[..., 0, 2, :, :]
    z2, z1, z5 = g[..., 1, 0, :, :], g[..., 1, 1, :, :], g[..., 1, 2, :, :]
    v = fq2_mul(torch.stack([z0, z1, z0, z2, z3, z2, z4, z5, z4]),
                torch.stack([z0, z1, z1, z2, z3, z3, z4, z5, z5]))
    # Fp4 squarings of (z0, z1), (z2, z3), (z4, z5): t = a^2 + xi b^2, u = 2ab
    t = torch.stack([v[0] + _xi_lazy(v[1]), v[3] + _xi_lazy(v[4]), v[6] + _xi_lazy(v[7]),
                     2 * v[2], 2 * v[5], 2 * v[8]])
    t0, u0, s0, t1, u1, s1 = F.reduce(t, 12).unbind(0)
    # 3t - 2z for the c0 half (z0, z4, z3), 3t + 2z for the c1 half (z2, z1, z5)
    lo = torch.stack([t0, u0, s0])
    zl = torch.stack([z0, z4, z3])
    hi = torch.stack([fq2_mul_xi(s1), t1, u1])
    zh = torch.stack([z2, z1, z5])
    out = F.reduce(torch.stack([F.subs(3 * lo, zl, zl), 3 * hi + 2 * zh]), 7)
    return torch.movedim(torch.movedim(out, 1, -3), 0, -4)


def fq12_mul_line(f, a, b, c):
    """f * (a + b*w + c*v*w) with a, b, c in Fq2: the Miller-loop sparse
    multiply (15 stacked Fq2 products)."""
    f00, f01, f02 = f[..., 0, 0, :, :], f[..., 0, 1, :, :], f[..., 0, 2, :, :]
    f10, f11, f12 = f[..., 1, 0, :, :], f[..., 1, 1, :, :], f[..., 1, 2, :, :]
    s0, s1, s2 = f00 + f10, f01 + f11, f02 + f12
    ab = a + b
    x = torch.stack([f00, f01, f02, f10, f11, f12, f10, f11, f12,
                     s0, s1, s2, s0, s1, s2])
    y = torch.stack(torch.broadcast_tensors(a, a, a, b, b, b, c, c, c,
                                            ab, ab, ab, c, c, c))
    v = fq2_mul(x, y)
    # r = f1 (b + c v), t = (f0 + f1)(a + b + c v)
    r0, r1, r2, t0, t1, t2 = F.reduce(torch.stack([
        v[3] + _xi_lazy(v[8]), v[4] + v[6], v[5] + v[7],
        v[9] + _xi_lazy(v[14]), v[10] + v[12], v[11] + v[13]]), 12).unbind(0)
    # c0 = f0 a + v r ; c1 = t - f0 a - r
    lo = torch.stack([v[0] + _xi_lazy(r2), v[1] + r0, v[2] + r1], dim=-3)
    hi = torch.stack([F.subs(t0, v[0], r0), F.subs(t1, v[1], r1), F.subs(t2, v[2], r2)], dim=-3)
    return F.reduce(torch.stack([lo, hi], dim=-4), 12)


def fq12_pow_bits(a, bits):
    """a^e with e as MSB-first bits on a's device: a (k,) tensor (one
    exponent for every element) or (k, ...batch) (per-lane exponents).
    Both branches are computed, then selected, as in the JAX package's
    scan (sipp_tpu/fields/tower.py:fq12_pow_bits), so no step reads a bit
    back to the host."""
    acc = fq12_one(a.shape[:-4], a.device)
    for bit in bits:
        acc = fq12_sqr(acc)
        acc = torch.where(bit[..., None, None, None, None] != 0, fq12_mul(acc, a), acc)
    return acc


def fq12_exp_with_offset(x, offset, bits):
    """offset * x^e per lane (the starky Fq12ExpInput statement); the
    offset's product comes last, as in the JAX package."""
    return fq12_mul(offset, fq12_pow_bits(x, bits))


def fq12_conj(a):
    """a^(p^6): negate the w half."""
    return torch.stack([a[..., 0, :, :, :], F.neg(a[..., 1, :, :, :])], dim=-4)


def fq12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    sq = fq6_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    t = fq6_inv(F.sub(sq[0], fq6_mul_by_v(sq[1])))
    return torch.stack([fq6_mul(a0, t), F.neg(fq6_mul(a1, t))], dim=-4)


def frob_consts_ints(k: int):
    """Frobenius pi^k multipliers for coefficient (i, j) (w^i v^j), in i-major
    order: xi^((p^k - 1)(2j+i)/6), host ints."""
    return [hostref.fq2_pow(params.XI, (params.P**k - 1) * (2 * j + i) // 6)
            for i in range(2) for j in range(3)]


@functools.lru_cache(maxsize=None)
def _frob_table(k: int, device):
    return fq2_encode(frob_consts_ints(k), device).reshape(2, 3, 2, L)


def fq12_frob(a, k: int = 1):
    """a^(p^k) for k in {1, 2, 3}."""
    coeffs = a if k % 2 == 0 else fq2_conj(a)
    return fq2_mul(coeffs, _frob_table(k, a.device))


def fq12_to_direct(a):
    """Tower -> 12 direct-basis Fq coefficients (..., 12, L), canonical (not
    Montgomery), in the order of the Rust MyFq12 transcript encoding:
    direct[2j+i] = c0 - 9 c1, direct[2j+i+6] = c1 for tower coeff (w^i v^j)."""
    flat = a.transpose(-4, -3).reshape(*a.shape[:-4], 6, 2, L)
    c0, c1 = flat[..., 0, :], flat[..., 1, :]
    return F.from_mont(torch.cat([F.reduce(F.subs(c0, c1, c1, c1, c1, c1, c1, c1, c1, c1), 19), c1], dim=-2))
