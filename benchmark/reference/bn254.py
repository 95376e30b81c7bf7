"""Plain BN254 arithmetic on Python integers: the benchmark's reference.

Standard library only; it imports nothing of the program under test.

Fq = int; Fq2 = (c0, c1) for c0 + c1 u; Fq6 = three Fq2 for c0 + c1 v + c2 v^2;
Fq12 = two Fq6 for c0 + c1 w.  Tower u^2 = -1, v^3 = xi = 9 + u, w^2 = v
(ark-bn254's).  Points are affine tuples, None at infinity; the ladders and
the Miller loop keep Jacobian (X, Y, Z) points.

`Tower` counts every Fq product it makes (Karatsuba Fq2 products at 3,
squarings at 2, products by an Fq element at 2; Fq6 Karatsuba at 6 Fq2
products; an Fq12 product at 18, a squaring at 12, a product by a line at
13).  Sums, products by small constants and by xi, and inversions in Fq
(extended Euclid) make no product.  benchmark/metrics/counts.py freezes the
counts of the Miller product and the fold ladders as functions of shapes;
the CPU tests hold them to what this code counts.
"""

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
X = 4965661367192848881                     # the BN parameter
assert P == 36 * X**4 + 36 * X**3 + 24 * X**2 + 6 * X + 1
assert R == 36 * X**4 + 36 * X**3 + 18 * X**2 + 6 * X + 1

B_G1 = 3
G1_GEN = (1, 2)
XI = (9, 1)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
MONT = 1 << 256                             # the program's Montgomery radix


def naf(k):
    """Non-adjacent form of k, least significant digit first."""
    out = []
    while k > 0:
        d = 2 - k % 4 if k & 1 else 0
        out.append(d)
        k = (k - d) >> 1
    return out


# the Miller loop's digits of 6x + 2, most significant but one first
MILLER_DIGITS = tuple(reversed(naf(6 * X + 2)[:-1]))

# --------------------------------------------------------------- Fq2 (free)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_small(a, k):
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_xi(a):
    """xi a = (9 + u) a: small constants only."""
    return ((9 * a[0] - a[1]) % P, (9 * a[1] + a[0]) % P)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_v(a):
    """v a: (xi a2, a0, a1)."""
    return (f2_xi(a[2]), a[0], a[1])


F2_ZERO, F2_ONE = (0, 0), (1, 0)
F6_ZERO = (F2_ZERO,) * 3
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f2_pow_plain(a, e):
    out = F2_ONE
    while e:
        if e & 1:
            out = ((out[0] * a[0] - out[1] * a[1]) % P, (out[0] * a[1] + out[1] * a[0]) % P)
        a = ((a[0] * a[0] - a[1] * a[1]) % P, 2 * a[0] * a[1] % P)
        e >>= 1
    return out


GAMMA_V = f2_pow_plain(XI, (P - 1) // 3)        # v^p = GAMMA_V v
GAMMA_V2 = f2_pow_plain(XI, 2 * (P - 1) // 3)
GAMMA_W = f2_pow_plain(XI, (P - 1) // 6)        # w^p = GAMMA_W w
TWIST_FROB_X = GAMMA_V                          # the twist's Frobenius
TWIST_FROB_Y = f2_pow_plain(XI, (P - 1) // 2)


class Tower:
    """Fq to Fq12 arithmetic and the curve formulas, counting its Fq
    products in `products`."""

    def __init__(self):
        self.products = 0

    # ------------------------------------------------------------- Fq, Fq2
    def mul(self, a, b):
        self.products += 1
        return a * b % P

    def f2_mul(self, a, b):
        self.products += 3
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    def f2_sqr(self, a):
        self.products += 2
        return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)

    def f2_scale(self, a, s):
        """a times the Fq element s."""
        self.products += 2
        return (a[0] * s % P, a[1] * s % P)

    def f2_inv(self, a):
        self.products += 4
        ninv = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * ninv % P, -a[1] * ninv % P)

    # ------------------------------------------------------------- Fq6, Fq12
    def f6_mul(self, a, b):
        m = self.f2_mul
        t0, t1, t2 = m(a[0], b[0]), m(a[1], b[1]), m(a[2], b[2])
        c0 = f2_add(t0, f2_xi(f2_sub(f2_sub(m(f2_add(a[1], a[2]), f2_add(b[1], b[2])), t1), t2)))
        c1 = f2_add(f2_sub(f2_sub(m(f2_add(a[0], a[1]), f2_add(b[0], b[1])), t0), t1), f2_xi(t2))
        c2 = f2_add(f2_sub(f2_sub(m(f2_add(a[0], a[2]), f2_add(b[0], b[2])), t0), t2), t1)
        return (c0, c1, c2)

    def f6_mul_01(self, a, b0, b1):
        """a (b0 + b1 v): 5 Fq2 products."""
        m = self.f2_mul
        t0, t1 = m(a[0], b0), m(a[1], b1)
        c0 = f2_add(t0, f2_xi(m(a[2], b1)))
        c1 = f2_sub(f2_sub(m(f2_add(a[0], a[1]), f2_add(b0, b1)), t0), t1)
        c2 = f2_add(t1, m(a[2], b0))
        return (c0, c1, c2)

    def f6_inv(self, a):
        a0, a1, a2 = a
        m, s = self.f2_mul, self.f2_sqr
        c0 = f2_sub(s(a0), f2_xi(m(a1, a2)))
        c1 = f2_sub(f2_xi(s(a2)), m(a0, a1))
        c2 = f2_sub(s(a1), m(a0, a2))
        t = f2_add(m(a0, c0), f2_xi(f2_add(m(a2, c1), m(a1, c2))))
        ti = self.f2_inv(t)
        return (m(c0, ti), m(c1, ti), m(c2, ti))

    def f12_mul(self, a, b):
        v0, v1 = self.f6_mul(a[0], b[0]), self.f6_mul(a[1], b[1])
        c1 = f6_sub(f6_sub(self.f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), v0), v1)
        return (f6_add(v0, f6_v(v1)), c1)

    def f12_sqr(self, a):
        """Complex squaring: 2 Fq6 products."""
        t = self.f6_mul(a[0], a[1])
        c0 = self.f6_mul(f6_add(a[0], a[1]), f6_add(a[0], f6_v(a[1])))
        return (f6_sub(f6_sub(c0, t), f6_v(t)), f6_add(t, t))

    def f12_mul_line(self, f, a, b, c):
        """f (a + b w + c v w), a, b, c in Fq2: 13 Fq2 products."""
        f0, f1 = f
        t0 = tuple(self.f2_mul(x, a) for x in f0)
        t1 = self.f6_mul_01(f1, b, c)
        s = self.f6_mul_01(f6_add(f0, f1), f2_add(a, b), c)
        return (f6_add(t0, f6_v(t1)), f6_sub(f6_sub(s, t0), t1))

    def f12_inv(self, a):
        t = self.f6_inv(f6_sub(self.f6_mul(a[0], a[0]), f6_v(self.f6_mul(a[1], a[1]))))
        c1 = self.f6_mul(a[1], t)
        return (self.f6_mul(a[0], t), tuple(f2_neg(x) for x in c1))

    def f12_frob(self, a):
        def f6(x):
            return (f2_conj(x[0]), self.f2_mul(f2_conj(x[1]), GAMMA_V),
                    self.f2_mul(f2_conj(x[2]), GAMMA_V2))
        return (f6(a[0]), tuple(self.f2_mul(x, GAMMA_W) for x in f6(a[1])))

    def f12_pow(self, a, e):
        out = F12_ONE
        for bit in bin(e)[2:]:
            out = self.f12_sqr(out)
            if bit == "1":
                out = self.f12_mul(out, a)
        return out

    # ------------------------------------------------------------ pairing
    def dbl_line(self, t, xp, yp):
        """2T (Jacobian, on the twist) and the tangent at T evaluated at
        P = (xp, yp), scaled by 2 Y Z^3: (2YZ^3 yp, -3X^2Z^2 xp, 3X^3 - 2Y^2)
        at (1, w, v w)."""
        X_, Y_, Z_ = t
        s, m = self.f2_sqr, self.f2_mul
        A, B, ZZ = s(X_), s(Y_), s(Z_)
        C = s(B)
        D = f2_small(f2_sub(f2_sub(s(f2_add(X_, B)), A), C), 2)      # 4 X Y^2
        E = f2_small(A, 3)
        X3 = f2_sub(s(E), f2_small(D, 2))
        Y3 = f2_sub(m(E, f2_sub(D, X3)), f2_small(C, 8))
        Z3 = f2_small(m(Y_, Z_), 2)
        a = self.f2_scale(m(Z3, ZZ), yp)
        b = f2_neg(self.f2_scale(m(E, ZZ), xp))
        c = f2_sub(m(E, X_), f2_small(B, 2))
        return (X3, Y3, Z3), (a, b, c)

    def add_line(self, t, q, xp, yp):
        """T + Q (Q affine) and the line through them at P, scaled by
        Z3 = Z H: (Z3 yp, -R xp, R x2 - Z3 y2)."""
        X_, Y_, Z_ = t
        x2, y2 = q
        s, m = self.f2_sqr, self.f2_mul
        ZZ = s(Z_)
        H = f2_sub(m(x2, ZZ), X_)
        Rr = f2_sub(m(y2, m(Z_, ZZ)), Y_)
        HH = s(H)
        HHH, V = m(H, HH), m(X_, HH)
        X3 = f2_sub(f2_sub(s(Rr), HHH), f2_small(V, 2))
        Y3 = f2_sub(m(Rr, f2_sub(V, X3)), m(Y_, HHH))
        Z3 = m(Z_, H)
        a = self.f2_scale(Z3, yp)
        b = f2_neg(self.f2_scale(Rr, xp))
        c = f2_sub(m(Rr, x2), m(Z3, y2))
        return (X3, Y3, Z3), (a, b, c)

    def twist_frob(self, q):
        return (self.f2_mul(f2_conj(q[0]), TWIST_FROB_X),
                self.f2_mul(f2_conj(q[1]), TWIST_FROB_Y))

    def miller_loop(self, p, q):
        """f_{6x+2,Q}(P) l_{[6x+2]Q,pi(Q)}(P) l_{..,-pi^2(Q)}(P), up to
        factors that the final exponentiation removes.  p in G1, q in G2,
        affine, neither at infinity."""
        xp, yp = p
        t, nq, f = (q[0], q[1], F2_ONE), (q[0], f2_neg(q[1])), F12_ONE
        for digit in MILLER_DIGITS:
            f = self.f12_sqr(f)
            t, line = self.dbl_line(t, xp, yp)
            f = self.f12_mul_line(f, *line)
            if digit:
                t, line = self.add_line(t, q if digit == 1 else nq, xp, yp)
                f = self.f12_mul_line(f, *line)
        q1 = self.twist_frob(q)
        q2 = self.twist_frob(q1)
        t, line = self.add_line(t, q1, xp, yp)
        f = self.f12_mul_line(f, *line)
        _, line = self.add_line(t, (q2[0], f2_neg(q2[1])), xp, yp)
        return self.f12_mul_line(f, *line)

    def miller_product(self, ps, qs):
        """prod_i miller_loop(P_i, Q_i): n loops and n - 1 Fq12 products."""
        f = None
        for p, q in zip(ps, qs):
            g = self.miller_loop(p, q)
            f = g if f is None else self.f12_mul(f, g)
        return f

    def final_exp(self, f):
        """f^((p^12 - 1) / r): the easy part, then the hard part as one plain
        power (always right, slow)."""
        f = self.f12_mul((f[0], tuple(f2_neg(x) for x in f[1])), self.f12_inv(f))
        f = self.f12_mul(self.f12_frob(self.f12_frob(f)), f)
        return self.f12_pow(f, (P**4 - P**2 + 1) // R)

    # ------------------------------------------------------ fold ladders
    def fold(self, group, lo, hi, k):
        """lo + [k] hi for affine points of `group` ("g1" or "g2"), neither at
        infinity, k > 0: the MSB-first double-and-add ladder from the leading
        set bit in Jacobian coordinates, the mixed addition of lo, then the
        affine result (one inversion)."""
        K = _FQ if group == "g1" else _FQ2
        acc = (hi[0], hi[1], K.one)
        for bit in bin(k)[3:]:
            acc = self._dbl(K, acc)
            if bit == "1":
                acc = self._madd(K, acc, hi)
        return self._affine(K, self._madd(K, acc, lo))

    def _dbl(self, K, pt):
        X_, Y_, Z_ = pt
        A, B = K.sqr(self, X_), K.sqr(self, Y_)
        C = K.sqr(self, B)
        D = K.small(K.sub(K.sub(K.sqr(self, K.add(X_, B)), A), C), 2)
        E = K.small(A, 3)
        X3 = K.sub(K.sqr(self, E), K.small(D, 2))
        Y3 = K.sub(K.mul(self, E, K.sub(D, X3)), K.small(C, 8))
        return (X3, Y3, K.small(K.mul(self, Y_, Z_), 2))

    def _madd(self, K, pt, q):
        X_, Y_, Z_ = pt
        ZZ = K.sqr(self, Z_)
        H = K.sub(K.mul(self, q[0], ZZ), X_)
        Rr = K.sub(K.mul(self, q[1], K.mul(self, Z_, ZZ)), Y_)
        HH = K.sqr(self, H)
        HHH, V = K.mul(self, H, HH), K.mul(self, X_, HH)
        X3 = K.sub(K.sub(K.sqr(self, Rr), HHH), K.small(V, 2))
        Y3 = K.sub(K.mul(self, Rr, K.sub(V, X3)), K.mul(self, Y_, HHH))
        return (X3, Y3, K.mul(self, Z_, H))

    def _affine(self, K, pt):
        zi = K.inv(self, pt[2])
        zi2 = K.sqr(self, zi)
        return (K.mul(self, pt[0], zi2), K.mul(self, pt[1], K.mul(self, zi2, zi)))


class _FQ:
    one = 1
    mul = staticmethod(Tower.mul)
    sqr = staticmethod(lambda t, a: t.mul(a, a))
    inv = staticmethod(lambda t, a: pow(a, -1, P))
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    small = staticmethod(lambda a, k: a * k % P)


class _FQ2:
    one = F2_ONE
    mul = staticmethod(Tower.f2_mul)
    sqr = staticmethod(Tower.f2_sqr)
    inv = staticmethod(Tower.f2_inv)
    add = staticmethod(f2_add)
    sub = staticmethod(f2_sub)
    small = staticmethod(f2_small)


# ----------------------------------------------- affine points (uncounted)

def _affine_add(p, q, add, sub, mul, inv, zero, three):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if add(p[1], q[1]) == zero:
            return None
        lam = mul(mul(mul(p[0], p[0]), three), inv(add(p[1], p[1])))
    else:
        lam = mul(sub(q[1], p[1]), inv(sub(q[0], p[0])))
    x3 = sub(sub(mul(lam, lam), p[0]), q[0])
    return (x3, sub(mul(lam, sub(p[0], x3)), p[1]))


def _f2_mul_plain(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _f2_inv_plain(a):
    ninv = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def g1_add(p, q):
    return _affine_add(p, q, lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
                       lambda a, b: a * b % P, lambda a: pow(a, -1, P), 0, 3)


def g2_add(p, q):
    return _affine_add(p, q, f2_add, f2_sub, _f2_mul_plain, _f2_inv_plain, F2_ZERO, (3, 0))


def _mul(add, pt, k):
    out = None
    for bit in bin(k % R)[2:]:
        out = add(out, out)
        if bit == "1":
            out = add(out, pt)
    return out


def g1_mul(pt, k):
    return _mul(g1_add, pt, k)


def g2_mul(pt, k):
    return _mul(g2_add, pt, k)


# ------------------------------------------------------- fixed-base powers

class FixedBase:
    """g^e for e mod r by a table of g^(j 16^i): at most 64 Fq12 products a
    power."""

    def __init__(self, tower, g):
        self.t, self.table = tower, []
        base = g
        for _ in range(64):
            row = [F12_ONE, base]
            for _ in range(14):
                row.append(tower.f12_mul(row[-1], base))
            self.table.append(row)
            base = tower.f12_mul(row[-1], base)

    def pow(self, e):
        e %= R
        out = None
        for row in self.table:
            d = e & 15
            if d:
                out = row[d] if out is None else self.t.f12_mul(out, row[d])
            e >>= 4
        return F12_ONE if out is None else out


# ------------------------------------------------------------ limb layout

def fq_limbs(v):
    """v in Montgomery form as 16 little-endian 16-bit limbs."""
    m = v * MONT % P
    return [(m >> (16 * i)) & 0xFFFF for i in range(16)]


def fq12_values(f):
    """The 12 Fq coefficients of a tower Fq12 in the program's (2, 3, 2)
    order."""
    return [c for half in f for c2 in half for c in c2]


def fq12_direct(f):
    """Tower Fq12 -> the 12 coefficients of the direct basis
    Fq[z]/(z^12 - 18 z^6 + 82) (u = z^6 - 9, v = z^2, w = z), the
    transcript's encoding."""
    out = [0] * 12
    for i in range(2):
        for j in range(3):
            c0, c1 = f[i][j]
            m = 2 * j + i
            out[m] = (out[m] + c0 - 9 * c1) % P
            out[m + 6] = (out[m + 6] + c1) % P
    return out
