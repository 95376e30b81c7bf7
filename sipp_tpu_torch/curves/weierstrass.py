"""Plain PyTorch short-Weierstrass (a = 0) Jacobian arithmetic over Fq or Fq2
(port of curves/weierstrass.py, with the ladders of ops/pallas_fold.py and
ops/pallas_exp.py).

Representations (int64 limb tensors, arbitrary leading batch dims):
    affine:   (..., 2, *coeff)   [x, y], the point at infinity is all-zero
    jacobian: (..., 3, *coeff)   [X, Y, Z], infinity iff Z == 0
where *coeff = (L,) for Fq and (2, L) for Fq2.  Edge cases are handled with
selects, never data-dependent Python branches; independent field products
are stacked into one batched multiply.
"""

import torch


class CurveOps:
    def __init__(self, field, base, name: str):
        """field: adapter with mul/inv/is_zero/one_like and ndim (trailing
        coefficient dims: 1 for Fq, 2 for Fq2); base: the Fq Field, whose
        lazy reduce/subs act coefficient-wise on either."""
        self.f = field
        self.F = base
        self.name = name

    def _c(self, p, i):
        return p.select(-1 - self.f.ndim, i)

    def _pt(self, *coords):
        return torch.stack(coords, dim=-1 - self.f.ndim)

    def _expand(self, cond):
        """(...,) bool -> broadcastable over (..., 3, *coeff)."""
        return cond.reshape(*cond.shape, *([1] * (self.f.ndim + 1)))

    def is_infinity(self, p):
        return self.f.is_zero(self._c(p, 2))

    def is_affine_infinity(self, p):
        return self.f.is_zero(self._c(p, 0)) & self.f.is_zero(self._c(p, 1))

    def jac_from_affine(self, p):
        x = self._c(p, 0)
        return self._pt(x, self._c(p, 1), self.f.one_like(x))

    def lift(self, p):
        """Affine -> Jacobian with the all-zero affine point mapped to Z = 0
        (jac_from_affine gives it Z = 1, which the complete add would take
        for the point (0, 0))."""
        return torch.where(self._expand(self.is_affine_infinity(p)), 0, self.jac_from_affine(p))

    def jac_infinity(self, batch_shape=(), device="cpu"):
        shape = (*batch_shape, 3) + (2,) * (self.f.ndim - 1) + (self.F.L,)
        return torch.zeros(shape, dtype=torch.int64, device=device)

    def neg(self, p):
        """Flip Y (affine or Jacobian)."""
        coords = list(p.unbind(-1 - self.f.ndim))
        coords[1] = self.F.neg(coords[1])
        return self._pt(*coords)

    # --------------------------------------------------------------- dbl/add

    def dbl(self, p):
        """Jacobian doubling, a = 0; infinity-safe (Z3 = 2YZ = 0).  Uses
        Y3 = 3 M S - M^3 - 8C, the identity the reference's fold kernel
        uses for M (S - X3) - 8C, so that W = M^2 joins a stacked product."""
        f, F = self.f, self.F
        X, Y, Z = self._c(p, 0), self._c(p, 1), self._c(p, 2)
        A, B, YZ = f.mul(torch.stack([X, Y, Y]), torch.stack([X, Y, Z])).unbind(0)
        M = F.reduce(3 * A, 3)                                   # 3 X^2
        XB = X + B
        C, D, W = f.mul(torch.stack([B, XB, M]), torch.stack([B, XB, M])).unbind(0)
        S = F.reduce(2 * F.subs(D, A, C), 10)                    # 4 X Y^2
        M3, MS = f.mul(torch.stack([M, M]), torch.stack([W, S])).unbind(0)
        return F.reduce(self._pt(F.subs(W, S, S), F.subs(3 * MS, M3, *([C] * 8)),
                                 2 * YZ), 21)

    def add_mixed(self, p, q_aff, dbl_q=None):
        """p (jacobian) + q (affine).  p at infinity gives q, q at infinity
        (all-zero affine) gives p, P == -Q gives infinity.  P == Q is handled
        only when dbl_q = dbl(q) is given (the complete add of the subgroup
        check); the fold ladder never meets it."""
        f, F = self.f, self.F
        X, Y, Z = self._c(p, 0), self._c(p, 1), self._c(p, 2)
        x2, y2 = self._c(q_aff, 0), self._c(q_aff, 1)
        ZZ, Y2Z = f.mul(torch.stack([Z, y2]), torch.stack([Z, Z])).unbind(0)
        U2, S2 = f.mul(torch.stack([x2, Y2Z]), torch.stack([ZZ, ZZ])).unbind(0)
        H, R = F.reduce(torch.stack([F.subs(U2, X), F.subs(S2, Y)]), 3).unbind(0)
        HH, RR = f.mul(torch.stack([H, R]), torch.stack([H, R])).unbind(0)
        HHH, V, Z3 = f.mul(torch.stack([H, X, Z]), torch.stack([HH, HH, H])).unbind(0)
        X3 = F.reduce(F.subs(RR, HHH, V, V), 7)
        t = f.mul(torch.stack([R, Y]), torch.stack([F.reduce(F.subs(V, X3), 3), HHH]))
        out = self._pt(X3, F.reduce(F.subs(t[0], t[1]), 3), Z3)
        if dbl_q is not None:
            dbl_case = f.is_zero(H) & f.is_zero(R) & ~f.is_zero(Z)
            out = torch.where(self._expand(dbl_case), dbl_q, out)
        out = torch.where(self._expand(f.is_zero(Z)), self.jac_from_affine(q_aff), out)
        return torch.where(self._expand(self.is_affine_infinity(q_aff)), p, out)

    def add(self, p, q):
        """Complete Jacobian + Jacobian: P == Q doubles, either side at
        infinity gives the other, P == -Q gives infinity (Z3 = 0)."""
        f, F = self.f, self.F
        X1, Y1, Z1 = self._c(p, 0), self._c(p, 1), self._c(p, 2)
        X2, Y2, Z2 = self._c(q, 0), self._c(q, 1), self._c(q, 2)
        Z1Z1, Z2Z2 = f.mul(torch.stack([Z1, Z2]), torch.stack([Z1, Z2])).unbind(0)
        U1, U2, S1p, S2p = f.mul(torch.stack([X1, X2, Y1, Y2]),
                                 torch.stack([Z2Z2, Z1Z1, Z2Z2, Z1Z1])).unbind(0)
        S1, S2 = f.mul(torch.stack([S1p, S2p]), torch.stack([Z2, Z1])).unbind(0)
        H, R = F.reduce(torch.stack([F.subs(U2, U1), F.subs(S2, S1)]), 3).unbind(0)
        HH, RR = f.mul(torch.stack([H, R]), torch.stack([H, R])).unbind(0)
        HHH, V, Z1Z2 = f.mul(torch.stack([H, U1, Z1]), torch.stack([HH, HH, Z2])).unbind(0)
        X3 = F.reduce(F.subs(RR, HHH, V, V), 7)
        t = f.mul(torch.stack([R, S1, Z1Z2]),
                  torch.stack([F.reduce(F.subs(V, X3), 3), HHH, H]))
        out = self._pt(X3, F.reduce(F.subs(t[0], t[1]), 3), t[2])
        dbl_case = f.is_zero(H) & f.is_zero(R) & ~f.is_zero(Z1) & ~f.is_zero(Z2)
        out = torch.where(self._expand(dbl_case), self.dbl(p), out)
        out = torch.where(self._expand(f.is_zero(Z1)), q, out)
        return torch.where(self._expand(f.is_zero(Z2)), p, out)

    def to_affine(self, p):
        """Jacobian -> affine; infinity maps to (0, 0)."""
        f = self.f
        X, Y, Z = self._c(p, 0), self._c(p, 1), self._c(p, 2)
        zinv = f.inv(Z)
        zinv2 = f.mul(zinv, zinv)
        x, zinv3 = f.mul(torch.stack([X, zinv2]), torch.stack([zinv2, zinv])).unbind(0)
        out = self._pt(x, f.mul(Y, zinv3))
        return torch.where(self._expand(f.is_zero(Z)), torch.zeros_like(out), out)

    # ---------------------------------------------------------- scalar muls

    def fold(self, lo_aff, hi_aff, bits):
        """SIPP fold lo + [x] hi for every lane with one shared scalar x,
        given as MSB-first host bits; returns jacobian.  The ladder of
        ops/pallas_fold.py: start at [bit0] hi, then double and add hi on
        set bits (skipped on zero bits, since the bits are shared), then the
        mixed add of the offset lo; points at infinity are all-zero affine
        on either side (dead lanes fold as O + x*O = O)."""
        bits = [int(b) for b in bits]
        jac = self.jac_from_affine(hi_aff)
        acc = jac if bits[0] else torch.zeros_like(jac)
        for bit in bits[1:]:
            acc = self.dbl(acc)
            if bit:
                acc = self.add_mixed(acc, hi_aff)
        return self.add_mixed(acc, lo_aff)

    def mul_check_ladder(self, q_aff, bits, dbl_q=None):
        """[k]Q per lane with the complete mixed add (doubling case
        handled; dbl_q = dbl(Q) when the caller has it), for adversarial
        points (the r-torsion check); zero bits skip the add, since the bits
        are shared, and the first doubling, of infinity, is skipped.
        Returns jacobian."""
        acc = torch.zeros_like(self.jac_from_affine(q_aff))
        if dbl_q is None:
            dbl_q = self.dbl(self.jac_from_affine(q_aff))
        for i, bit in enumerate(bits):
            if i:
                acc = self.dbl(acc)
            if bit:
                acc = self.add_mixed(acc, q_aff, dbl_q)
        return acc

    def scalar_mul_per_lane(self, q_aff, bits):
        """[k_i] Q_i with per-lane scalars: bits (254, *batch) MSB-first (a
        tensor on the points' device).  The ladder of ops/pallas_exp.py:
        from infinity, double, add Q (incomplete; infinity-safe on both
        sides) and select on the lane's bit.  Returns jacobian."""
        acc = self.jac_infinity(q_aff.shape[:-1 - self.f.ndim], q_aff.device)
        for bit in bits.unbind(0):
            acc = self.dbl(acc)
            acc = torch.where(self._expand(bit != 0), self.add_mixed(acc, q_aff), acc)
        return acc

    def exp_with_offset(self, x_aff, offset_aff, bits):
        """offset + [k_i] x_i per lane, jacobian: the per-lane ladder, then
        the complete mixed add of the offset (P == Q doubles; an offset at
        infinity leaves the ladder's point), as ops/pallas_exp.py does."""
        dbl_off = self.dbl(self.jac_from_affine(offset_aff))
        return self.add_mixed(self.scalar_mul_per_lane(x_aff, bits), offset_aff, dbl_off)
