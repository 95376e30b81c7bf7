"""Pure-Python reference implementation of BN254 arithmetic (the host oracle).

Carried over unchanged from sipp_tpu/hostref.py.  It defines the semantics
that the port's plain PyTorch ops and CUDA kernels must match, playing the
role ark-bn254 plays for the Rust SIPP implementation: the tests check the
port against these functions (SURVEY.md §4), and tower/Frobenius constants
for the plain ops and the kernels are derived from here.

Representations: Fq = int; Fq2 = (int, int) for c0 + c1*u; Fq6 = 3-tuple of
Fq2 for c0 + c1*v + c2*v^2; Fq12 = 2-tuple of Fq6 for c0 + c1*w.
Tower: u^2 = -1, v^3 = xi = 9 + u, w^2 = v  (matches ark-bn254).
Points: affine tuples, None = point at infinity.
"""

from . import params

P = params.P
R = params.R

# ----------------------------------------------------------------------- Fq2

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = params.XI


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def fq2_smul(a, s: int):
    return ((a[0] * s) % P, (a[1] * s) % P)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, -1, P)
    return ((a[0] * ninv) % P, (-a[1] * ninv) % P)


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_mul(base, base)
        e >>= 1
    return result


# ----------------------------------------------------------------------- Fq6

FQ6_ZERO = (FQ2_ZERO,) * 3
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    # schoolbook with v^3 = xi reduction
    c = [FQ2_ZERO] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] = fq2_add(c[i + j], fq2_mul(a[i], b[j]))
    return (
        fq2_add(c[0], fq2_mul(XI, c[3])),
        fq2_add(c[1], fq2_mul(XI, c[4])),
        c[2],
    )


def fq6_mul_by_v(a):
    return (fq2_mul(XI, a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    A = fq2_sub(fq2_sqr(a0), fq2_mul(XI, fq2_mul(a1, a2)))
    B = fq2_sub(fq2_mul(XI, fq2_sqr(a2)), fq2_mul(a0, a1))
    C = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul(a0, A), fq2_mul(XI, fq2_add(fq2_mul(a2, B), fq2_mul(a1, C))))
    tinv = fq2_inv(t)
    return (fq2_mul(A, tinv), fq2_mul(B, tinv), fq2_mul(C, tinv))


# ---------------------------------------------------------------------- Fq12

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    v0 = fq6_mul(a[0], b[0])
    v1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(v0, fq6_mul_by_v(v1))
    t = fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1]))
    c1 = fq6_sub(fq6_sub(t, v0), v1)
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    t = fq6_inv(fq6_sub(fq6_mul(a[0], a[0]), fq6_mul_by_v(fq6_mul(a[1], a[1]))))
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_pow(a, e: int):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_mul(base, base)
        e >>= 1
    return result


# Frobenius constants (computed, not hard-coded):
#   gamma_6[k] multiplies the v^k coefficient under the Fq6 Frobenius,
#   gamma_w multiplies the whole c1 (w) part under the Fq12 Frobenius.
GAMMA_V = fq2_pow(XI, (P - 1) // 3)       # v^p = gamma_v * v
GAMMA_V2 = fq2_pow(XI, 2 * (P - 1) // 3)  # (v^2)^p = gamma_v2 * v^2
GAMMA_W = fq2_pow(XI, (P - 1) // 6)       # w^p = gamma_w * w
# Twist Frobenius constants (G2 endomorphism on twist coordinates):
TWIST_FROB_X = fq2_pow(XI, (P - 1) // 3)
TWIST_FROB_Y = fq2_pow(XI, (P - 1) // 2)


def fq6_frob(a):
    return (
        fq2_conj(a[0]),
        fq2_mul(fq2_conj(a[1]), GAMMA_V),
        fq2_mul(fq2_conj(a[2]), GAMMA_V2),
    )


def fq12_frob(a):
    c0 = fq6_frob(a[0])
    c1 = fq6_frob(a[1])
    c1 = tuple(fq2_mul(x, GAMMA_W) for x in c1)
    return (c0, c1)


# ------------------------------------------------------- MyFq12 direct basis
# Direct basis: Fq12 = Fq[z]/(z^12 - 18 z^6 + 82), embedding u = z^6 - 9,
# v = z^2, w = z (py_ecc-style; matches plonky2-bn254 MyFq12 used for the
# transcript encoding, reference transcript_native.rs:32-40 / SURVEY.md D11).


def fq12_to_direct(a):
    """Tower Fq12 -> 12 Fq coefficients in the direct basis."""
    coeffs = [0] * 12
    for i in range(2):        # w exponent
        for j in range(3):    # v exponent
            c0, c1 = a[i][j]
            m = 2 * j + i
            coeffs[m] = (coeffs[m] + c0 - 9 * c1) % P
            coeffs[m + 6] = (coeffs[m + 6] + c1) % P
    return coeffs


def direct_to_fq12(coeffs):
    """Inverse of fq12_to_direct."""
    a = [[[0, 0] for _ in range(3)] for _ in range(2)]
    for i in range(2):
        for j in range(3):
            m = 2 * j + i
            c1 = coeffs[m + 6] % P
            c0 = (coeffs[m] + 9 * c1) % P
            a[i][j] = [c0, c1]
    return tuple(tuple(tuple(x) for x in row) for row in a)


def direct_mul(a, b):
    """Polynomial multiplication in Fq[z]/(z^12 - 18 z^6 + 82)."""
    c = [0] * 23
    for i in range(12):
        for j in range(12):
            c[i + j] = (c[i + j] + a[i] * b[j]) % P
    for k in range(22, 11, -1):
        # z^k = 18 z^(k-6) - 82 z^(k-12)
        c[k - 6] = (c[k - 6] + 18 * c[k]) % P
        c[k - 12] = (c[k - 12] - 82 * c[k]) % P
        c[k] = 0
    return c[:12]


# --------------------------------------------------------------------- curves


def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - params.B_G1) % P == 0


B2 = fq2_mul((params.B_G1, 0), fq2_inv(XI))  # twist coefficient b' = 3/xi


def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), B2)
    return lhs == rhs


def _ec_add(p1, p2, fadd, fsub, fmul, fsqr, finv):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fadd(y1, y2) == (0 if isinstance(y1, int) else FQ2_ZERO):
            return None
        # doubling: lam = 3x^2 / 2y
        lam = fmul(fsqr(x1), 3 if isinstance(x1, int) else (3, 0))
        lam = fmul(lam, finv(fadd(y1, y1)))
    else:
        lam = fmul(fsub(y2, y1), finv(fsub(x2, x1)))
    x3 = fsub(fsub(fsqr(lam), x1), x2)
    y3 = fsub(fmul(lam, fsub(x1, x3)), y1)
    return (x3, y3)


def _int_add(a, b):
    return (a + b) % P


def _int_sub(a, b):
    return (a - b) % P


def _int_mul(a, b):
    return (a * b) % P


def _int_sqr(a):
    return (a * a) % P


def _int_inv(a):
    return pow(a, -1, P)


def g1_add(p1, p2):
    def mul3(a, s):
        return (a * s) % P if isinstance(s, int) else (a * 3) % P
    return _ec_add(p1, p2, _int_add, _int_sub, _int_mul, _int_sqr, _int_inv)


def g1_neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % P)


def g1_mul(pt, k: int):
    k %= params.R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g2_add(p1, p2):
    def fmul(a, b):
        return fq2_mul(a, b if isinstance(b, tuple) else (b, 0))
    return _ec_add(p1, p2, fq2_add, fq2_sub, fmul, fq2_sqr, fq2_inv)


def g2_neg(pt):
    return None if pt is None else (pt[0], fq2_neg(pt[1]))


def g2_mul(pt, k: int):
    k %= params.R  # valid for points in the r-torsion subgroup G2
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


def g2_mul_raw(pt, k: int):
    """Scalar mul without reduction mod r (for cofactor clearing)."""
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


# -------------------------------------------------------------------- pairing
# Optimal ate pairing e(P, Q): Miller loop over NAF(6x+2) with affine G2 steps.
# Untwist psi(x', y') = (x'*v, y'*v*w): the line through psi(T) with slope
# lam = lam' * w (lam' the affine slope on the twist) evaluated at P=(xp,yp) is
#   l = yp - lam'*xp*w + (lam'*x_t - y_t)*v*w
# (all three coefficients Fq2; the sparse element is built below).


def _sparse_line(a_fq, b_fq2, c_fq2):
    """Fq12 element  a + b*w + c*v*w  with a in Fq."""
    c0 = ((a_fq % P, 0), FQ2_ZERO, FQ2_ZERO)
    c1 = (b_fq2, c_fq2, FQ2_ZERO)
    return (c0, c1)


def _line_dbl(t, p):
    """Doubling step: returns (2T, line(T,T)(P)). t affine on twist, p on G1."""
    xt, yt = t
    lam = fq2_mul(fq2_smul(fq2_sqr(xt), 3), fq2_inv(fq2_add(yt, yt)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_add(xt, xt))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
    xp, yp = p
    line = _sparse_line(
        yp,
        fq2_neg(fq2_smul(lam, xp)),
        fq2_sub(fq2_mul(lam, xt), yt),
    )
    return (x3, y3), line


def _line_add(t, q, p):
    """Addition step: returns (T+Q, line(T,Q)(P))."""
    x1, y1 = t
    x2, y2 = q
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    xp, yp = p
    line = _sparse_line(
        yp,
        fq2_neg(fq2_smul(lam, xp)),
        fq2_sub(fq2_mul(lam, x1), y1),
    )
    return (x3, y3), line


def twist_frob(q):
    """G2 Frobenius endomorphism on twist coordinates."""
    x, y = q
    return (fq2_mul(fq2_conj(x), TWIST_FROB_X), fq2_mul(fq2_conj(y), TWIST_FROB_Y))


def miller_loop(p, q):
    """f_{6x+2,Q}(P) * l_{[6x+2]Q, pi(Q)}(P) * l_{[6x+2]Q+pi(Q), -pi^2(Q)}(P)."""
    if p is None or q is None:
        return FQ12_ONE
    naf = params.ATE_NAF
    t = q
    nq = g2_neg(q)
    f = FQ12_ONE
    for digit in reversed(naf[:-1]):
        f = fq12_sqr(f)
        t, line = _line_dbl(t, p)
        f = fq12_mul(f, line)
        if digit == 1:
            t, line = _line_add(t, q, p)
            f = fq12_mul(f, line)
        elif digit == -1:
            t, line = _line_add(t, nq, p)
            f = fq12_mul(f, line)
    q1 = twist_frob(q)
    nq2 = g2_neg(twist_frob(q1))
    t, line = _line_add(t, q1, p)
    f = fq12_mul(f, line)
    _, line = _line_add(t, nq2, p)
    f = fq12_mul(f, line)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part then (naive, always-correct) hard part."""
    # easy: f^(p^6-1) then ^(p^2+1)
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    f = fq12_mul(fq12_frob(fq12_frob(f)), f)
    # hard: exponent (p^4 - p^2 + 1) // r
    e = (P**4 - P**2 + 1) // params.R
    return fq12_pow(f, e)


def pairing(p, q):
    """Optimal ate pairing e(P, Q), P in G1, Q in G2 (twist affine coords).

    Matches the value of plonky2-bn254-pairing's `pairing` (used by the
    Rust prover_native.rs:20) = ark Bn254::pairing.
    """
    return final_exponentiation(miller_loop(p, q))
