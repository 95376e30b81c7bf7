"""BN254 optimal-ate pairing in plain PyTorch, and the SIPP aggregations that
run through the CUDA kernels (port of pairing/ate.py).

Plain versions (any device; the CPU tests and the kernels' comparisons use
them):
- miller_loop: batched over lanes, NAF(6x+2) digits MSB-1 first (one
  miller_step_plain per digit, then miller_tail), G2 in
  Jacobian coordinates with the denominator-cleared lines of the reference
      dbl:  L = 2YZ^3*yp  - 3X^2Z^2*xp w  + (3X^3 - 2Y^2) vw
      add:  L = Z3*yp     - theta*xp w    + (theta*x2 - Z3*y2) vw,
            theta = y2 Z^3 - Y,  Z3 = Z*(x2 Z^2 - X)
  then the Frobenius correction lines (+pi(Q), -pi^2(Q)) and infinity lanes
  masked to 1.  The line scaling fixes the pre-final-exp value, so the
  kernel and this code use the same formulas and agree bit for bit.
- final_exp: easy part (conj(f) * f^-1)^(p^2+1), then the hard part as three
  x-power chains and the lambda tape TAPE.
- product_tree over the leading axis.

Kernel paths: inner_product (K1 miller_product + K2 final_exp; with
SIPP_WHOLE_LOOP=0, miller_loop_fused's 65 K7 step launches + the plain tail
and product tree + K2) and cross_products (cross_miller's one K1 launch in
pair mode + one K2 launch at B = 2, whatever SIPP_WHOLE_LOOP says, as in the
JAX package).
"""

import functools
import os

import torch

from .. import hostref, params
from ..fields import FQ, tower as T

F = FQ

# NAF digits of 6x+2 from the second most significant down, in the
# reference's step encoding (ate.py _DIGITS): 0, 1 (add Q), 2 (add -Q).
DIGITS = tuple({0: 0, 1: 1, -1: 2}[d] for d in reversed(params.ATE_NAF[:-1]))

X_BITS = tuple(int(b) for b in bin(params.X)[2:])

# The lambda addition chain over a 12-slot Fq12 register file, as in the
# reference (ate.py _TAPE): rows (dst, s1, s2, post) compute
# R[dst] = post(R[s1] * R[s2]), post 0 = none, 1 = conj, 2 = frob1,
# 3 = frob2.  Registers 0..3 hold f, f^x, f^(x^2), f^(x^3).
POST_NONE, POST_CONJ, POST_FROB1, POST_FROB2 = 0, 1, 2, 3
TAPE = (
    (4, 3, 3, 0), (5, 4, 4, 0), (6, 5, 5, 0), (6, 6, 6, 0), (6, 6, 6, 0),
    (6, 6, 5, 0),                                     # c36 = c^36 in r6
    (4, 2, 2, 0), (5, 4, 4, 0), (7, 5, 5, 0), (8, 7, 7, 0), (9, 8, 7, 0),
    (10, 5, 4, 0), (9, 9, 10, 0), (8, 8, 4, 0),       # b30 r9, b18 r8, b6 r10
    (4, 1, 1, 0), (5, 4, 4, 0), (7, 5, 5, 0), (11, 7, 7, 0), (11, 11, 4, 0),
    (7, 7, 5, 0),                                     # a18 r11, a12 r7
    (4, 0, 0, 0),                                     # f2
    (5, 6, 9, 0), (5, 5, 11, 0), (5, 5, 4, POST_CONJ),  # lam0
    (9, 6, 8, 0), (9, 9, 7, POST_CONJ), (9, 9, 0, POST_FROB1),  # frob1(lam1)
    (10, 10, 0, POST_FROB2),                          # frob2(lam2)
    (5, 5, 9, 0), (5, 5, 10, 0),                      # lam0 frob1 frob2
)


@functools.lru_cache(maxsize=None)
def _twist_frob_consts(device):
    return (T.fq2_encode(hostref.TWIST_FROB_X, device),
            T.fq2_encode(hostref.TWIST_FROB_Y, device))


def _scale2(u, v, xp, yp):
    """(u * yp, v * xp) for Fq2 u, v and Fq xp, yp: one stacked Fq multiply."""
    return F.mul(torch.stack([u, v]), torch.stack([yp, xp])[..., None, :]).unbind(0)


def _dbl_step(t, xp, yp):
    """Jacobian doubling of T (..., 3, 2, L) + its scaled line at P, with
    Y3 = 3 M S - M^3 - 8C (= M (S - X3) - 8C) as in the reference kernel."""
    X, Y, Z = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    A, B, ZZ, YZ = T.fq2_mul(torch.stack([X, Y, Z, Y]),
                             torch.stack([X, Y, Z, Z])).unbind(0)
    M = F.reduce(3 * A, 3)                              # 3 X^2
    XB = X + B
    C, D, T1, T2, T3, W = T.fq2_mul(torch.stack([B, XB, YZ, A, X, M]),
                                    torch.stack([B, XB, ZZ, ZZ, A, M])).unbind(0)
    S = F.reduce(2 * F.subs(D, A, C), 10)               # 4 X Y^2
    M3, MS = T.fq2_mul(torch.stack([M, M]), torch.stack([W, S])).unbind(0)
    t2 = F.reduce(torch.stack([F.subs(W, S, S), F.subs(3 * MS, M3, *([C] * 8)), 2 * YZ],
                              dim=-3), 21)
    # line: a = 2YZ^3 * yp ; b = -3X^2 Z^2 * xp ; c = 3X^3 - 2Y^2
    a, b = _scale2(2 * T1, 3 * T2, xp, yp)
    b, c = F.reduce(torch.stack([F.subs(torch.zeros_like(b), b), F.subs(3 * T3, B, B)]),
                    7).unbind(0)
    return t2, (a, b, c)


def _add_step(t, q, xp, yp):
    """Mixed addition T + Q + the scaled line through T and Q at P."""
    X, Y, Z = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    x2, y2 = q[..., 0, :, :], q[..., 1, :, :]
    ZZ, Y2Z = T.fq2_mul(torch.stack([Z, y2]), torch.stack([Z, Z])).unbind(0)
    U2, S2 = T.fq2_mul(torch.stack([x2, Y2Z]), torch.stack([ZZ, ZZ])).unbind(0)
    H, R = F.reduce(torch.stack([F.subs(U2, X), F.subs(S2, Y)]), 3).unbind(0)   # beta, theta
    HH, RR = T.fq2_mul(torch.stack([H, R]), torch.stack([H, R])).unbind(0)
    HHH, V, Z3 = T.fq2_mul(torch.stack([H, X, Z]),
                           torch.stack([HH, HH, H])).unbind(0)
    X3 = F.reduce(F.subs(RR, HHH, V, V), 7)
    v = T.fq2_mul(torch.stack([R, Y, R, Z3]),
                  torch.stack([F.reduce(F.subs(V, X3), 3), HHH, x2, y2]))
    Y3, c = F.reduce(torch.stack([F.subs(v[0], v[1]), F.subs(v[2], v[3])]), 3).unbind(0)
    # line: a = Z3 * yp ; b = -theta * xp ; c = theta*x2 - Z3*y2
    a, b = _scale2(Z3, R, xp, yp)
    return torch.stack([X3, Y3, Z3], dim=-3), (a, F.neg(b), c)


def miller_step_plain(digit: int, qp, qn, p, f, t):
    """One Miller step (the plain version of K7, ops/miller.miller_step):
    f <- f^2 * line_dbl(T, P), T <- 2T, then for digit 1 (2)
    f <- f * line_add(T, Q, P), T <- T + Q (with qn = -Q).  Any leading
    batch dims; returns (f, t)."""
    xp, yp = p[..., 0, :], p[..., 1, :]
    f = T.fq12_sqr(f)
    t, line = _dbl_step(t, xp, yp)
    f = T.fq12_mul_line(f, *line)
    if digit:
        t, line = _add_step(t, qp if digit == 1 else qn, xp, yp)
        f = T.fq12_mul_line(f, *line)
    return f, t


def _neg_y(q):
    return torch.stack([q[..., 0, :, :], F.neg(q[..., 1, :, :])], dim=-3)


def twist_frob(q):
    """G2 Frobenius on twist affine coordinates."""
    cx, cy = _twist_frob_consts(q.device)
    return torch.stack([T.fq2_mul(T.fq2_conj(q[..., 0, :, :]), cx),
                        T.fq2_mul(T.fq2_conj(q[..., 1, :, :]), cy)], dim=-3)


def miller_start(p_aff, q_aff):
    """The loop's carry at its start, f = 1 and T = (Q, 1), and -Q."""
    one2 = T.fq12_one((), q_aff.device)[0, 0]            # the Fq2 one
    t = torch.cat([q_aff, one2.expand_as(q_aff[..., :1, :, :])], dim=-3)
    return T.fq12_one(p_aff.shape[:-2], p_aff.device), t, _neg_y(q_aff)


def miller_tail(f, t, p_aff, q_aff):
    """After the last step: the Frobenius correction lines (+pi(Q),
    -pi^2(Q)), and infinity lanes ((0, 0) encodings) masked to f = 1."""
    xp, yp = p_aff[..., 0, :], p_aff[..., 1, :]
    q1 = twist_frob(q_aff)
    nq2 = _neg_y(twist_frob(q1))
    t, line = _add_step(t, q1, xp, yp)
    f = T.fq12_mul_line(f, *line)
    _, line = _add_step(t, nq2, xp, yp)
    f = T.fq12_mul_line(f, *line)
    inf = (p_aff == 0).flatten(-2).all(-1) | (q_aff == 0).flatten(-3).all(-1)
    return torch.where(inf[..., None, None, None, None],
                       T.fq12_one(p_aff.shape[:-2], p_aff.device), f)


def _miller_loop(p_aff, q_aff, step):
    f, t, q_neg = miller_start(p_aff, q_aff)
    for digit in DIGITS:
        f, t = step(digit, q_aff, q_neg, p_aff, f, t)
    return miller_tail(f, t, p_aff, q_aff)


def miller_loop(p_aff, q_aff):
    """Per-lane Miller function f_{6x+2,Q}(P) times the Frobenius lines.
    p_aff (..., 2, L) G1 affine, q_aff (..., 2, 2, L) G2 twist affine;
    infinity lanes ((0, 0) encodings) give f = 1."""
    return _miller_loop(p_aff, q_aff, miller_step_plain)


def miller_loop_fused(p_aff, q_aff):
    """miller_loop with one K7 launch per digit (ops/miller.miller_step: 65
    launches, queued with no host sync), then the plain miller_tail.
    p_aff (B, 2, L), q_aff (B, 2, 2, L)."""
    from ..ops import miller

    return _miller_loop(p_aff, q_aff, miller.miller_step)


def product_tree(f):
    """Product over the leading axis of a (n, ...) Fq12 batch."""
    while f.shape[0] > 1:
        half = f.shape[0] // 2
        prod = T.fq12_mul(f[:half], f[half:2 * half])
        f = torch.cat([prod, f[2 * half:]]) if f.shape[0] % 2 else prod
    return f[0]


def _powx(v):
    """v^x (x = BN parameter) by cyclotomic square-and-multiply."""
    acc = T.fq12_one(v.shape[:-4], v.device)
    for bit in X_BITS:
        acc = T.fq12_cyclo_sqr(acc)
        if bit:
            acc = T.fq12_mul(acc, v)
    return acc


def easy_part(f):
    """f^((p^6-1)(p^2+1)): lands in the cyclotomic subgroup."""
    g = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))
    return T.fq12_mul(T.fq12_frob(g, 2), g)


def hard_part(f):
    """f^((p^4-p^2+1)/r) for f in the cyclotomic subgroup, through the
    lambda decomposition (conj is the inverse in that subgroup)."""
    regs = [f]
    for _ in range(3):
        regs.append(_powx(regs[-1]))
    regs += [None] * 8
    post = {POST_NONE: lambda x: x, POST_CONJ: T.fq12_conj,
            POST_FROB1: lambda x: T.fq12_frob(x, 1),
            POST_FROB2: lambda x: T.fq12_frob(x, 2)}
    for dst, s1, s2, op in TAPE:
        regs[dst] = post[op](T.fq12_mul(regs[s1], regs[s2]))
    return T.fq12_mul(regs[5], T.fq12_frob(f, 3))


def final_exp(f):
    """f^((p^12-1)/r), batched over leading dims."""
    return hard_part(easy_part(f))


# ------------------------------------------------------- kernel aggregations

def inner_product(a_g1, b_g2):
    """Z = prod_i e(A_i, B_i): one Miller-product launch (K1) and one final
    exponentiation (K2).  (2, 3, 2, L).  SIPP_WHOLE_LOOP=0, read at call
    time as in the JAX package, takes the per-step engine instead: the K7
    steps of miller_loop_fused, the plain product tree, then K2."""
    from ..ops import fexp, miller

    if os.environ.get("SIPP_WHOLE_LOOP") == "0":
        f = product_tree(miller_loop_fused(a_g1, b_g2))
    else:
        f = miller.miller_product(a_g1, b_g2)
    return fexp.final_exp(f[None])[0]


def cross_miller(a_lo, a_hi, b_lo, b_hi):
    """The Miller products (before the final exponentiation) of a fold
    round's cross pairs, (A_hi, B_lo) on even lanes and (A_lo, B_hi) on odd
    lanes of ONE pair-mode K1 launch.  (2, 2,3,2, L)."""
    from ..ops import miller

    m = a_lo.shape[0]
    p = torch.stack([a_hi, a_lo], dim=1).reshape(2 * m, *a_lo.shape[1:])
    q = torch.stack([b_lo, b_hi], dim=1).reshape(2 * m, *b_lo.shape[1:])
    return miller.miller_product(p, q, pair=True)


def cross_products(a_lo, a_hi, b_lo, b_hi):
    """A fold round's (Z_L, Z_R) = (e-prod(A_hi, B_lo), e-prod(A_lo, B_hi)):
    cross_miller's one pair-mode K1 launch, then both final exps in ONE K2
    launch at B = 2.  (2, 2,3,2, L)."""
    from ..ops import fexp

    return fexp.final_exp(cross_miller(a_lo, a_hi, b_lo, b_hi))
