"""The product schedules of the redesigned kernels K2 (csrc/fexp.cu) and K3
(csrc/fold.cu), as data that ops/_build.py writes into the kernels'
constants header, with plain PyTorch evaluators of the same data for the
CPU tests.

K2 spreads each Fq12-level operation over the threads of one warp: thread
k < nprod computes the Fq2 product x_k * y_k, where x_k (y_k) is the sum of
the input coefficients of A (B) that xmask[k] (ymask[k]) selects; then
thread q < nout combines output q as the linear form terms[q] over the
products and the inputs:

    out[q] = sum c * v + xi * sum c' * v'     (v a product or an input)

The forms are derived here symbolically from the tower formulas of
csrc/bn254.cuh (Karatsuba over Fq6 then Fq2, Granger-Scott squaring, the
tower inversion), so a test that evaluates a table against fields/tower.py
checks the kernel's own table.  POWX_TREE is the x-power's product tree
over the stored squarings (the TPU kernel's _powx_ref schedule).

K3 runs each Jacobian doubling and mixed addition as stages of
independent products, one per thread of a group of four; dbl_staged and
add_mixed_staged are the plain versions of those stages (same products,
same adds between them, same selects), which the tests hold against
curves' own dbl and add_mixed.
"""

import collections

import torch

from .. import params
from ..fields import FQ, tower

F = FQ

# ---------------------------------------------------------- linear forms

N_PROD = 18            # at most 18 products (an Fq12 multiply)
INPUT = N_PROD         # source index of input coefficient q: INPUT + q


class Lin:
    """A linear form over Fq2 sources: {(source, xi power): coefficient}."""

    def __init__(self, terms=None):
        self.t = collections.Counter(terms or {})

    @classmethod
    def src(cls, s):
        return cls({(s, 0): 1})

    def _combine(self, other, sign):
        out = collections.Counter(self.t)
        for k, c in other.t.items():
            out[k] += sign * c
        return Lin({k: c for k, c in out.items() if c})

    def __add__(self, other):
        return self._combine(other, 1)

    def __sub__(self, other):
        return self._combine(other, -1)

    def __neg__(self):
        return Lin({k: -c for k, c in self.t.items()})

    def __rmul__(self, c: int):
        return Lin({k: c * v for k, v in self.t.items()})

    def xi(self):
        if any(x for _, x in self.t):
            raise ValueError("xi^2 term: the kernel's forms hold xi^0 and xi^1 only")
        return Lin({(s, 1): c for (s, _), c in self.t.items()})

    def terms(self):
        return tuple(sorted((s, c, x) for (s, x), c in self.t.items()))


Op = collections.namedtuple("Op", "name xmask ymask terms")

# Fq6 Karatsuba/Toom (bn254.cuh fq6_mul): the six products' coefficient sets
FQ6_SETS = ((0,), (1,), (2,), (1, 2), (0, 1), (0, 2))


def _mask(idx):
    return sum(1 << i for i in idx)


def _fq6_comb(v):
    """bn254.cuh fq6_mul's combine of (v0, v1, v2, t12, t01, t02)."""
    v0, v1, v2, t12, t01, t02 = v
    return [v0 + (t12 - v1 - v2).xi(), t01 - v0 - v1 + v2.xi(), t02 - v0 - v2 + v1]


def _mul_by_v(c):
    return [c[2].xi(), c[0], c[1]]


def _prods(n):
    return [Lin.src(k) for k in range(n)]


def _op_mul():
    """Fq12 product: three Fq6 products (a0 b0, a1 b1, (a0+a1)(b0+b1)) of
    six Fq2 products each; c0 = V0 + v V1, c1 = T - V0 - V1."""
    halves = ((0,), (1,), (0, 1))
    masks = [_mask(3 * h + j for h in hs for j in s) for hs in halves for s in FQ6_SETS]
    p = _prods(18)
    v0, v1, t = _fq6_comb(p[0:6]), _fq6_comb(p[6:12]), _fq6_comb(p[12:18])
    vv1 = _mul_by_v(v1)
    out = [v0[i] + vv1[i] for i in range(3)] + [t[i] - v0[i] - v1[i] for i in range(3)]
    return Op("mul", masks, masks, [o.terms() for o in out])


def _op_cyclo():
    """Granger-Scott squaring (bn254.cuh fq12_cyclo_sqr).  Coefficient
    index q = 3 i + j of (w^i v^j): z0 = 0, z4 = 1, z3 = 2, z2 = 3, z1 = 4,
    z5 = 5; for each pair (a, b) = (z0, z1), (z2, z3), (z4, z5) the products
    a^2, b^2, ab give t = a^2 + xi b^2 and u = 2ab; the outputs are 3t - 2z
    on the c0 half and 3t + 2z on the c1 half."""
    z0, z1, z2, z3, z4, z5 = 0, 4, 3, 2, 1, 5
    pairs = [(z0, z0), (z1, z1), (z0, z1), (z2, z2), (z3, z3), (z2, z3),
             (z4, z4), (z5, z5), (z4, z5)]
    p = _prods(9)
    z = [Lin.src(INPUT + q) for q in range(6)]
    t0, t1 = p[0] + p[1].xi(), 2 * p[2]
    u0, u1 = p[3] + p[4].xi(), 2 * p[5]
    s0, s1 = p[6] + p[7].xi(), (2 * p[8]).xi()
    out = [3 * t0 - 2 * z[z0], 3 * u0 - 2 * z[z4], 3 * s0 - 2 * z[z3],
           3 * s1 + 2 * z[z2], 3 * t1 + 2 * z[z1], 3 * u1 + 2 * z[z5]]
    return Op("cyclo", [_mask((a,)) for a, _ in pairs], [_mask((b,)) for _, b in pairs],
              [o.terms() for o in out])


def _op_inv_sq():
    """Easy part's inversion, step 1: t0 = a0^2 - v a1^2 (two Fq6 squarings)."""
    masks = [_mask(3 * h + j for j in s) for h in (0, 1) for s in FQ6_SETS]
    p = _prods(12)
    s0, s1 = _fq6_comb(p[0:6]), _mul_by_v(_fq6_comb(p[6:12]))
    return Op("inv_sq", masks, masks, [(s0[i] - s1[i]).terms() for i in range(3)])


def _op_inv6_abc():
    """Fq6 inversion of t0, step 1: A = t0^2 - xi t1 t2, B = xi t2^2 - t0 t1,
    C = t1^2 - t0 t2."""
    pairs = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 1), (0, 2)]
    p = _prods(6)
    out = [p[0] - p[3].xi(), p[2].xi() - p[4], p[1] - p[5]]
    return Op("inv6_abc", [_mask((a,)) for a, _ in pairs], [_mask((b,)) for _, b in pairs],
              [o.terms() for o in out])


def _op_inv6_norm():
    """Fq6 inversion, step 2 (A = t0, B = (A, B, C)): the Fq2 norm
    n = t0 A + xi (t2 B + t1 C)."""
    pairs = [(0, 0), (2, 1), (1, 2)]
    p = _prods(3)
    return Op("inv6_norm", [_mask((a,)) for a, _ in pairs], [_mask((b,)) for _, b in pairs],
              [(p[0] + (p[1] + p[2]).xi()).terms()])


def _op_inv6_out():
    """Fq6 inversion, step 3 (A = (A, B, C), B = (n^-1,)): each times n^-1."""
    return Op("inv6_out", [_mask((q,)) for q in range(3)], [_mask((0,))] * 3,
              [Lin.src(q).terms() for q in range(3)])


def _op_inv_out():
    """Easy part's inversion, last step (A = f, B = t0^-1):
    f^-1 = (a0 t0^-1, -a1 t0^-1), two Fq6 products."""
    xm = [_mask(3 * h + j for j in s) for h in (0, 1) for s in FQ6_SETS]
    ym = [_mask(s) for _ in (0, 1) for s in FQ6_SETS]
    p = _prods(12)
    c0, c1 = _fq6_comb(p[0:6]), _fq6_comb(p[6:12])
    return Op("inv_out", xm, ym, [c.terms() for c in c0] + [(-c).terms() for c in c1])


OPS = (_op_mul(), _op_cyclo(), _op_inv_sq(), _op_inv6_abc(), _op_inv6_norm(),
       _op_inv6_out(), _op_inv_out())
OP_ID = {op.name: i for i, op in enumerate(OPS)}
MAX_TERMS = max(len(t) for op in OPS for t in op.terms)

# ------------------------------------------------------------ the x-power

X_NBITS = params.X.bit_length()
# chain index j holds v^(2^j); the set bits of x, MSB first
X_SET = tuple(X_NBITS - 1 - k for k, b in enumerate(bin(params.X)[2:]) if b == "1")


def _powx_tree():
    """Levels of (dst, src) pairs over chain indices, as the TPU kernel's
    _powx_ref pairs them: halves multiplied pairwise into the first half,
    an odd one carried; returns (levels, index of the result)."""
    vals, levels = list(X_SET), []
    while len(vals) > 1:
        h = len(vals) // 2
        levels.append(tuple((vals[i], vals[i + h]) for i in range(h)))
        vals = vals[:h] + vals[2 * h:]
    return tuple(levels), vals[0]


POWX_TREE, POWX_OUT = _powx_tree()

# ------------------------------------------------------- plain evaluators


def _sum(coeffs, mask):
    """Sum of the selected Fq2 coefficients of (..., n, 2, L)."""
    sel = [coeffs[..., q, :, :] for q in range(coeffs.shape[-3]) if mask >> q & 1]
    acc = sel[0]
    for c in sel[1:]:
        acc = F.add(acc, c)
    return acc


def _scaled(v, c):
    acc = v
    for _ in range(abs(c) - 1):
        acc = F.add(acc, v)
    return acc


def apply_op(op, a, b=None):
    """Evaluate a schedule table in plain PyTorch: a, b (..., n, 2, L)
    canonical Fq2 coefficients (b defaults to a) -> (..., nout, 2, L)."""
    b = a if b is None else b
    x = torch.stack([_sum(a, m) for m in op.xmask])
    y = torch.stack([_sum(b, m) for m in op.ymask])
    prods = tower.fq2_mul(x, y)
    zero = torch.zeros_like(a[..., 0, :, :])
    outs = []
    for terms in op.terms:
        acc = [zero, zero]                       # xi^0 part, xi^1 part
        for src, c, xi in terms:
            v = _scaled(prods[src] if src < INPUT else a[..., src - INPUT, :, :], c)
            acc[xi] = F.add(acc[xi], v) if c > 0 else F.sub(acc[xi], v)
        outs.append(F.add(acc[0], tower.fq2_mul_xi(acc[1])))
    return torch.stack(outs, dim=-3)


def _coeffs(f):
    return f.reshape(*f.shape[:-4], 6, 2, F.L)


def _fq12(c):
    return c.reshape(*c.shape[:-3], 2, 3, 2, F.L)


def fq12_mul(a, b):
    return _fq12(apply_op(OPS[OP_ID["mul"]], _coeffs(a), _coeffs(b)))


def fq12_cyclo_sqr(a):
    return _fq12(apply_op(OPS[OP_ID["cyclo"]], _coeffs(a)))


def fq12_inv(f):
    """The easy part's inversion as the kernel's chain of five tables and
    one Fq2 inversion."""
    t0 = apply_op(OPS[OP_ID["inv_sq"]], _coeffs(f))
    abc = apply_op(OPS[OP_ID["inv6_abc"]], t0)
    n = apply_op(OPS[OP_ID["inv6_norm"]], t0, abc)
    t0inv = apply_op(OPS[OP_ID["inv6_out"]], abc, tower.fq2_inv(n))
    return _fq12(apply_op(OPS[OP_ID["inv_out"]], _coeffs(f), t0inv))


def powx(v):
    """v^x as the kernel computes it: the squaring chain stored, then the
    set-bit powers multiplied by the levels of POWX_TREE."""
    chain = [v]
    for _ in range(X_NBITS - 1):
        chain.append(fq12_cyclo_sqr(chain[-1]))
    for level in POWX_TREE:
        for dst, src in level:
            chain[dst] = fq12_mul(chain[dst], chain[src])
    return chain[POWX_OUT]


# ------------------------------------------------------ K3's curve stages


def dbl_staged(C, p):
    """Jacobian doubling (a = 0) in fold.cu's three stages:
    {X^2, Y^2, Y Z}, {B^2, (X + B)^2, M^2} with M = 3 X^2, {M (S - X3)}."""
    f, F_ = C.f, C.F
    X, Y, Z = C._c(p, 0), C._c(p, 1), C._c(p, 2)
    A, B, YZ = f.mul(torch.stack([X, Y, Y]), torch.stack([X, Y, Z])).unbind(0)
    M = F_.add(F_.add(A, A), A)
    XB = F_.add(X, B)
    Cc, D, W = f.mul(torch.stack([B, XB, M]), torch.stack([B, XB, M])).unbind(0)
    S = F_.sub(F_.sub(D, A), Cc)
    S = F_.add(S, S)                                       # 4 X Y^2
    X3 = F_.sub(W, F_.add(S, S))
    P = f.mul(M, F_.sub(S, X3))
    C8 = F_.add(Cc, Cc)
    C8 = F_.add(C8, C8)
    return C._pt(X3, F_.sub(P, F_.add(C8, C8)), F_.add(YZ, YZ))


def add_mixed_staged(C, p, q_aff):
    """p + q (affine), incomplete, in fold.cu's five stages: {Z^2, y2 Z},
    {x2 ZZ, y2 Z ZZ}, {H^2, R^2, Z H}, {H HH, X HH}, {R (V - X3), Y HHH};
    then the selects: p at infinity gives q, q at infinity leaves p."""
    f, F_ = C.f, C.F
    X, Y, Z = C._c(p, 0), C._c(p, 1), C._c(p, 2)
    x2, y2 = C._c(q_aff, 0), C._c(q_aff, 1)
    ZZ, T1 = f.mul(torch.stack([Z, y2]), torch.stack([Z, Z])).unbind(0)
    U2, S2 = f.mul(torch.stack([x2, T1]), torch.stack([ZZ, ZZ])).unbind(0)
    H, R = F_.sub(U2, X), F_.sub(S2, Y)
    HH, RR, Z3 = f.mul(torch.stack([H, R, Z]), torch.stack([H, R, H])).unbind(0)
    HHH, V = f.mul(torch.stack([H, X]), torch.stack([HH, HH])).unbind(0)
    X3 = F_.sub(F_.sub(F_.sub(RR, HHH), V), V)
    Ya, Yb = f.mul(torch.stack([R, Y]), torch.stack([F_.sub(V, X3), HHH])).unbind(0)
    out = C._pt(X3, F_.sub(Ya, Yb), Z3)
    out = torch.where(C._expand(f.is_zero(Z)), C.jac_from_affine(q_aff), out)
    return torch.where(C._expand(C.is_affine_infinity(q_aff)), p, out)
