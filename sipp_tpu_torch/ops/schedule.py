"""The product schedules of the redesigned kernels K1 and K7
(csrc/miller.cu), K2 and K8 (csrc/fexp.cu, csrc/exp.cu) and K3/K6
(csrc/ladder.cuh), as data that ops/_build.py
writes into the kernels' constants header, with plain PyTorch evaluators
of the same data for the CPU tests.

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

K3 and K6 run each Jacobian doubling and mixed addition as stages of
independent products, one per thread of a group of four; dbl_staged and
add_mixed_staged are the plain versions of those stages (same products,
same adds between them, same selects), which the tests hold against
curves' own dbl and add_mixed.

K1 runs a Miller lane on one warp as a program of the same kind of table
operations over the lane's slots (M_OPS, PROGRAM; see that section); K7
runs one digit's slice of it (STEP_PROGRAM).  K8 runs K2's Fq12 multiply
table for every squaring and multiply of its ladder.
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


def add_jacobian_staged(C, p, q):
    """p + q (both Jacobian), complete, in ladder.cuh's five stages (X2's
    tree): {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1 = X1 Z2^2, U2 = X2 Z1^2,
    S1 = Y1 Z2 Z2^2, S2 = Y2 Z1 Z1^2}, {H^2, R^2, Z1 Z2}, {H HH, U1 HH,
    Z1Z2 H}, {R (V - X3), S1 HHH}; then the selects: P == Q (both finite,
    H = R = 0) gives the staged doubling of p, p at infinity gives q, q at
    infinity leaves p (P == -Q gives Z3 = 0 by itself)."""
    f, F_ = C.f, C.F
    X1, Y1, Z1 = C._c(p, 0), C._c(p, 1), C._c(p, 2)
    X2, Y2, Z2 = C._c(q, 0), C._c(q, 1), C._c(q, 2)
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = f.mul(torch.stack([Z1, Z2, Y1, Y2]),
                                   torch.stack([Z1, Z2, Z2, Z1])).unbind(0)
    U1, U2, S1, S2 = f.mul(torch.stack([X1, X2, Y1Z2, Y2Z1]),
                           torch.stack([Z2Z2, Z1Z1, Z2Z2, Z1Z1])).unbind(0)
    H, R = F_.sub(U2, U1), F_.sub(S2, S1)
    HH, RR, Z1Z2 = f.mul(torch.stack([H, R, Z1]), torch.stack([H, R, Z2])).unbind(0)
    HHH, V, Z3 = f.mul(torch.stack([H, U1, Z1Z2]), torch.stack([HH, HH, H])).unbind(0)
    X3 = F_.sub(F_.sub(F_.sub(RR, HHH), V), V)
    Ya, Yb = f.mul(torch.stack([R, S1]), torch.stack([F_.sub(V, X3), HHH])).unbind(0)
    out = C._pt(X3, F_.sub(Ya, Yb), Z3)
    same = f.is_zero(H) & f.is_zero(R) & ~f.is_zero(Z1) & ~f.is_zero(Z2)
    out = torch.where(C._expand(same), dbl_staged(C, p), out)
    out = torch.where(C._expand(f.is_zero(Z1)), q, out)
    return torch.where(C._expand(f.is_zero(Z2)), p, out)


# ------------------------------------------------- K1's Miller program
#
# K1 (csrc/miller.cu) runs each Miller lane on one warp as a program of
# table operations over the lane's slots: Fq2 values in shared memory
# (SLOTS).  An operation is up to M_PROD independent Fq2 products, product
# k = x_k * y_k on thread k (split into its Karatsuba parts over two or
# three threads where there are few), then output j on thread j: slot
# dst[j] = the linear form terms[j] over the products and the slots, all
# outputs written after every read.  An operand is a short signed sum of
# slots, a term of it optionally times xi; a form's terms are
# (source, coefficient, power of xi), with source k < M_PROD the product k
# and M_PROD + s the slot s.  The stages below are derived from the
# reference's formulas (pairing/ate.py: _dbl_step, _add_step with its
# denominator-cleared lines, the Fq12 complex squaring, the sparse line
# multiply); the program (PROGRAM) strings them along the NAF of 6x+2 and
# runs the Fq12 squaring and the line multiply on the threads a curve stage
# leaves idle.

M_PROD = 32                    # products of one operation: a warp's threads
M_OPND = 4                     # terms of an operand
M_SPLIT2 = 16                  # up to this many products run on 2 threads each
SLOTS = ("f0", "f1", "f2", "f3", "f4", "f5",          # f, coefficient 3 i + j of w^i v^j
         "X", "Y", "Z", "XP", "YP",                    # T (Jacobian), P as Fq2 (x, 0)
         "QX", "QY", "NQY", "Q1X", "Q1Y", "Q2X", "NQ2Y",  # Q, -Q, pi(Q), -pi^2(Q)
         "AX", "AY",                                   # the addition's addend
         "LA", "LB", "LC",                             # the line a + b w + c v w
         "A", "B", "ZZ", "YZ", "M", "XB", "C", "S", "T1", "T2",        # doubling
         "AT1", "ZYP", "H", "R", "HH", "RR", "HHH", "V")               # addition
SLOT = {name: i for i, name in enumerate(SLOTS)}
ADDENDS = {1: ("QX", "QY"), 2: ("QX", "NQY"), "frob1": ("Q1X", "Q1Y"),
           "frob2": ("Q2X", "NQ2Y")}

MillerOp = collections.namedtuple("MillerOp", "name x y dst terms")


def _opnd(*names):
    """An operand: slot names, '-' negates, 'xi:' multiplies by xi."""
    out = []
    for n in names:
        neg, n = n.startswith("-"), n.lstrip("-")
        xi, n = n.startswith("xi:"), n.split(":")[-1]
        out.append((SLOT[n], int(xi), int(neg)))
    return tuple(out)


def _v(name):
    return Lin.src(M_PROD + SLOT[name])


class _Stage:
    """A list of products and output forms, built symbolically."""

    def __init__(self):
        self.prods, self.outs = [], []

    def mul(self, x, y):
        self.prods.append((_opnd(*x), _opnd(*y)))
        return Lin.src(len(self.prods) - 1)

    def out(self, dst, form):
        self.outs.append((SLOT[dst], form))


def _shift(form, off):
    return Lin({(s + off if s < M_PROD else s, x): c for (s, x), c in form.t.items()})


def _merge(name, *stages):
    """One operation of the stages' products and outputs (which must not
    write a slot twice)."""
    prods, outs = [], []
    for st in stages:
        off = len(prods)
        prods += st.prods
        outs += [(d, _shift(f, off)) for d, f in st.outs]
    dsts = [d for d, _ in outs]
    if len(prods) > M_PROD or len(set(dsts)) != len(dsts) or len(outs) > M_PROD:
        raise ValueError(f"{name}: {len(prods)} products, outputs {dsts}")
    terms = [tuple(sorted(f.terms(), key=lambda t: (t[2], abs(t[1]), t[0]))) for _, f in outs]
    return MillerOp(name, tuple(x for x, _ in prods), tuple(y for _, y in prods),
                    tuple(dsts), tuple(terms))


def _sqr():
    """f <- f^2, complex squaring: t = c0 c1, u = (c0 + c1)(c0 + v c1),
    c0' = u - t - v t, c1' = 2 t (12 Fq2 products, 36 Fq products)."""
    st = _Stage()
    f = [f"f{q}" for q in range(6)]
    c0c1 = [(f[j], f[3 + j]) for j in range(3)]
    vc1 = [("xi:f5",), ("f3",), ("f4",)]                   # v c1 = (xi c12, c10, c11)
    t = _fq6_comb([st.mul([f[j] for j in s], [f[3 + j] for j in s]) for s in FQ6_SETS])
    u = _fq6_comb([st.mul([x for j in s for x in c0c1[j]],
                          [x for j in s for x in (f[j], *vc1[j])]) for s in FQ6_SETS])
    vt = _mul_by_v(t)
    for i in range(3):
        st.out(f[i], u[i] - t[i] - vt[i])
        st.out(f[3 + i], 2 * t[i])
    return st


def _mul_line():
    """f <- f (a + b w + c v w): 15 Fq2 products (the reference's
    tower.fq12_mul_line)."""
    st = _Stage()
    f0, f1 = ["f0", "f1", "f2"], ["f3", "f4", "f5"]
    v = [st.mul([f0[j]], ["LA"]) for j in range(3)]
    v += [st.mul([f1[j]], ["LB"]) for j in range(3)]
    v += [st.mul([f1[j]], ["LC"]) for j in range(3)]
    v += [st.mul([f0[j], f1[j]], ["LA", "LB"]) for j in range(3)]
    v += [st.mul([f0[j], f1[j]], ["LC"]) for j in range(3)]
    r = [v[3] + v[8].xi(), v[4] + v[6], v[5] + v[7]]          # f1 (b + c v)
    t = [v[9] + v[14].xi(), v[10] + v[12], v[11] + v[13]]     # (f0 + f1)(a + b + c v)
    st.out("f0", v[0] + r[2].xi())
    st.out("f1", v[1] + r[0])
    st.out("f2", v[2] + r[1])
    for j in range(3):
        st.out(f1[j], t[j] - v[j] - r[j])
    return st


def _dbl(stage):
    """T <- 2T with the line 2 Y Z^3 yp - 3 X^2 Z^2 xp w + (3 X^3 - 2 Y^2) v w,
    in three stages of products."""
    st = _Stage()
    if stage == 1:
        A, B = st.mul(["X"], ["X"]), st.mul(["Y"], ["Y"])
        ZZ, YZ = st.mul(["Z"], ["Z"]), st.mul(["Y"], ["Z"])
        for name, form in (("A", A), ("B", B), ("ZZ", ZZ), ("YZ", YZ), ("M", 3 * A),
                           ("XB", _v("X") + B), ("Z", 2 * YZ)):
            st.out(name, form)
    elif stage == 2:
        C, D = st.mul(["B"], ["B"]), st.mul(["XB"], ["XB"])
        T1, T2 = st.mul(["YZ"], ["ZZ"]), st.mul(["A"], ["ZZ"])
        T3, W = st.mul(["X"], ["A"]), st.mul(["M"], ["M"])
        S = 2 * (D - _v("A") - C)                                  # 4 X Y^2
        for name, form in (("C", C), ("S", S), ("X", W - 2 * S), ("LC", 3 * T3 - 2 * _v("B")),
                           ("T1", T1), ("T2", T2)):
            st.out(name, form)
    else:
        P = st.mul(["M"], ["S", "-X"])                             # M (S - X3)
        a, b = st.mul(["T1"], ["YP"]), st.mul(["T2"], ["XP"])
        st.out("Y", P - 8 * _v("C"))
        st.out("LA", 2 * a)
        st.out("LB", -3 * b)
    return st


def _add(stage):
    """T <- T + (AX, AY) with the line Z3 yp - R xp w + (R x2 - Z3 y2) v w,
    in five stages of products (the line after the third)."""
    st = _Stage()
    if stage == 1:
        st.out("ZZ", st.mul(["Z"], ["Z"]))
        st.out("AT1", st.mul(["AY"], ["Z"]))                      # y2 Z
        st.out("ZYP", st.mul(["Z"], ["YP"]))
    elif stage == 2:
        U2, S2 = st.mul(["AX"], ["ZZ"]), st.mul(["AT1"], ["ZZ"])
        st.out("H", U2 - _v("X"))
        st.out("R", S2 - _v("Y"))
    elif stage == 3:
        HH, RR, Z3 = st.mul(["H"], ["H"]), st.mul(["R"], ["R"]), st.mul(["Z"], ["H"])
        RX, HT1 = st.mul(["R"], ["AX"]), st.mul(["H"], ["AT1"])
        a, b = st.mul(["H"], ["ZYP"]), st.mul(["R"], ["XP"])      # Z3 yp, R xp
        for name, form in (("HH", HH), ("RR", RR), ("Z", Z3), ("LC", RX - HT1), ("LA", a),
                           ("LB", -b)):
            st.out(name, form)
    elif stage == 4:
        HHH, V = st.mul(["H"], ["HH"]), st.mul(["X"], ["HH"])
        st.out("X", _v("RR") - HHH - 2 * V)
        st.out("HHH", HHH)
        st.out("V", V)
    else:
        Y1, Y2 = st.mul(["R"], ["V", "-X"]), st.mul(["Y"], ["HHH"])
        st.out("Y", Y1 - Y2)
    return st


def _fq12_mul():
    """The lane product's Fq12 multiply over slots 0..5 (x operands from one
    lane, y operands from the other): K2's table as operand lists."""
    op = OPS[OP_ID["mul"]]
    st = _Stage()
    for xm, ym in zip(op.xmask, op.ymask):
        st.mul([f"f{q}" for q in range(6) if xm >> q & 1], [f"f{q}" for q in range(6) if ym >> q & 1])
    for q, terms in enumerate(op.terms):
        st.out(f"f{q}", Lin({(s, x): c for s, c, x in terms}))
    return st


M_OPS = (_merge("dbl1", _dbl(1)), _merge("dbl1_ml", _dbl(1), _mul_line()),
         _merge("dbl2_sqr", _dbl(2), _sqr()), _merge("dbl3", _dbl(3)),
         _merge("add1", _add(1)), _merge("add1_ml", _add(1), _mul_line()),
         _merge("add2", _add(2)), _merge("add3", _add(3)),
         _merge("add4_ml", _add(4), _mul_line()), _merge("add5", _add(5)),
         _merge("ml", _mul_line()), _merge("mul", _fq12_mul()))
M_OP_ID = {op.name: i for i, op in enumerate(M_OPS)}
M_MAX_OUT = max(len(op.dst) for op in M_OPS)
M_MAX_TERMS = max(len(t) for op in M_OPS for t in op.terms)


def _steps(digits):
    """(operation, addend) per step along `digits`: each doubling's three
    stages with the squaring beside the second; a digit's line multiply
    beside the next stage that does not write f (the next doubling's first,
    or the addition's first); an addition's line multiply beside its fourth
    stage.  Returns the steps and whether a line multiply is still
    pending."""
    prog, pending = [], False
    for d in digits:
        prog += [("dbl1_ml" if pending else "dbl1", None), ("dbl2_sqr", None), ("dbl3", None)]
        pending = True
        if d:
            prog += [("add1_ml", ADDENDS[d]), ("add2", None), ("add3", None),
                     ("add4_ml", None), ("add5", None)]
            pending = False
    return prog, pending


def _program():
    """K1's program: the steps along the digits, then the Frobenius lines,
    +pi(Q) and -pi^2(Q) (the last needs its line only)."""
    from ..pairing.ate import DIGITS

    prog, pending = _steps(DIGITS)
    prog += [("add1_ml" if pending else "add1", ADDENDS["frob1"]), ("add2", None),
             ("add3", None), ("add4_ml", None), ("add5", None),
             ("add1", ADDENDS["frob2"]), ("add2", None), ("add3", None), ("ml", None)]
    return tuple(prog)


def _step_program(digit):
    """K7's program for one digit: the steps of that digit alone, the
    pending line multiply flushed at the end.  The addend (AX, AY) is the
    digit's own tensor, qp or qn, which the kernel loads; so only the
    operations are kept."""
    prog, pending = _steps((digit,))
    return tuple(name for name, _ in prog) + (("ml",) if pending else ())


PROGRAM = _program()
STEP_PROGRAM = tuple(_step_program(d) for d in (0, 1, 2))


# the plain evaluators of the Miller program (the CPU tests' view of the
# kernel's tables)

def _operand(slots, terms):
    acc = None
    for s, xi, neg in terms:
        v = slots[..., s, :, :]
        if xi:
            v = tower.fq2_mul_xi(v)
        acc = (F.neg(v) if neg else v) if acc is None else (F.sub(acc, v) if neg else F.add(acc, v))
    return acc


def run_miller_op(op, slots, yslots=None):
    """One table operation on slots (..., n, 2, L); y operands from yslots
    (default: slots).  Returns the new slots."""
    yslots = slots if yslots is None else yslots
    x = torch.stack([_operand(slots, t) for t in op.x])
    y = torch.stack([_operand(yslots, t) for t in op.y])
    prods = tower.fq2_mul(x, y)
    zero = torch.zeros_like(slots[..., 0, :, :])
    out = slots.clone()
    for dst, terms in zip(op.dst, op.terms):
        acc = zero
        for src, c, xi in terms:
            v = _scaled(prods[src] if src < M_PROD else slots[..., src - M_PROD, :, :], c)
            v = tower.fq2_mul_xi(v) if xi else v
            acc = F.add(acc, v) if c > 0 else F.sub(acc, v)
        out[..., dst, :, :] = acc
    return out


def miller_slots(p_aff, q_aff):
    """The kernel's slots at the start of a lane: f = 1, T = (Q, 1), P as
    Fq2 (x, 0), Q, -Q, pi(Q), -pi^2(Q)."""
    from ..pairing import ate

    slots = torch.zeros((*p_aff.shape[:-2], len(SLOTS), 2, F.L), dtype=torch.int64,
                        device=p_aff.device)
    one = tower.fq12_one((), p_aff.device)[0, 0, 0]        # the Fq one
    q1 = ate.twist_frob(q_aff)
    q2 = ate.twist_frob(q1)
    vals = {"f0": torch.stack([one, torch.zeros_like(one)]), "X": q_aff[..., 0, :, :],
            "Y": q_aff[..., 1, :, :], "Z": torch.stack([one, torch.zeros_like(one)]),
            "XP": torch.stack([p_aff[..., 0, :], torch.zeros_like(p_aff[..., 0, :])], -2),
            "YP": torch.stack([p_aff[..., 1, :], torch.zeros_like(p_aff[..., 1, :])], -2),
            "QX": q_aff[..., 0, :, :], "QY": q_aff[..., 1, :, :],
            "NQY": F.neg(q_aff[..., 1, :, :]), "Q1X": q1[..., 0, :, :], "Q1Y": q1[..., 1, :, :],
            "Q2X": q2[..., 0, :, :], "NQ2Y": F.neg(q2[..., 1, :, :])}
    for name, v in vals.items():
        slots[..., SLOT[name], :, :] = v
    return slots


def miller_program(p_aff, q_aff):
    """Each lane's Miller value as the kernel computes it: PROGRAM's
    operations on miller_slots, then f (..., 2, 3, 2, L); infinity lanes are
    not masked here (the kernel skips them)."""
    slots = miller_slots(p_aff, q_aff)
    for name, addend in PROGRAM:
        if addend:
            slots = slots.clone()
            slots[..., SLOT["AX"], :, :] = slots[..., SLOT[addend[0]], :, :]
            slots[..., SLOT["AY"], :, :] = slots[..., SLOT[addend[1]], :, :]
        slots = run_miller_op(M_OPS[M_OP_ID[name]], slots)
    return _fq12(slots[..., :6, :, :])


def miller_step_program(digit, qp, qn, p, f, t):
    """One Miller step as K7 computes it: STEP_PROGRAM[digit]'s operations
    on slots holding f, T, P as Fq2 (x, 0) and the addend from the digit's
    own tensor (qp for 1, qn for 2).  Same arguments and result as
    ate.miller_step_plain."""
    S = SLOT
    slots = torch.zeros((*p.shape[:-2], len(SLOTS), 2, F.L), dtype=torch.int64, device=p.device)
    slots[..., :6, :, :] = _coeffs(f)
    slots[..., S["X"]:S["Z"] + 1, :, :] = t
    for name, k in (("XP", 0), ("YP", 1)):
        slots[..., S[name], 0, :] = p[..., k, :]
    if digit:
        q = qp if digit == 1 else qn
        slots[..., S["AX"], :, :], slots[..., S["AY"], :, :] = q[..., 0, :, :], q[..., 1, :, :]
    for name in STEP_PROGRAM[digit]:
        slots = run_miller_op(M_OPS[M_OP_ID[name]], slots)
    return _fq12(slots[..., :6, :, :]), slots[..., S["X"]:S["Z"] + 1, :, :]
