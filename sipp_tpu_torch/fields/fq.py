"""Plain PyTorch prime-field arithmetic over 16-bit limbs (port of fields/fp.py).

A field element is a tensor of shape (..., L) holding L little-endian 16-bit
limbs as torch.int64, in Montgomery form with R = 2^(16 L): the reference
device format of sipp_tpu/fields/fp.py, held in int64 because CPU PyTorch has
no uint32 add or shift.  Every result is canonical (< p), so values equal the
JAX package's byte for byte.

These are the plain versions: any device, any batch shape, built from a few
dozen whole-tensor ops per call.  The CUDA kernels in ops/ compute the same
values with their own limb layout (8 x 32-bit) and are checked against these.

Multiplication is separated Montgomery (SOS) like the reference: a skewed
outer product gives the column sums of a*b (< 2^36), m = (T mod R) * N' mod R
is taken straight from those unnormalised columns (< 2^56, still exact in
int64), and one exact carry pass normalises T + m*p, stacked with the
conditional subtraction of p.  Carries are resolved without a per-limb loop:
a few carry-save rounds bring every limb to [0, 2^16], after which the carry
into limb i is decided by the nearest limb below it that is not 0xFFFF
(a cummax over positions).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as TF

from . import bigint

MASK = 0xFFFF
LIMB_BITS = 16


def _shift_up(x, k: int = 1):
    """Move limbs k places toward the top (multiply by 2^(16k)), dropping the
    top k limbs and filling zeros at the bottom."""
    return TF.pad(x[..., :-k], (k, 0))


def normalize(cols, rounds: int):
    """Exact carry propagation of non-negative limb columns (..., K) to
    canonical 16-bit limbs, modulo 2^(16K) (the carry out of the top limb is
    dropped; callers that need it append a zero limb first).

    rounds: carry-save rounds needed to bring every column to [0, 2^16]:
    2 for columns < 2^20, 3 for < 2^40, 4 for < 2^62."""
    x = cols
    for _ in range(rounds):
        x = (x & MASK) + _shift_up(x >> LIMB_BITS)
    # now every limb is in [0, 0x10000]: a limb carries out iff it is 0x10000,
    # or it is 0xFFFF and receives a carry.  The carry into limb i is set by
    # the nearest limb j < i that is not 0xFFFF: it carries iff x_j = 0x10000.
    K = x.shape[-1]
    pos = torch.arange(K, device=x.device).expand_as(x)
    last = torch.where(x != MASK, pos, -1).cummax(dim=-1).values
    gen = x >> LIMB_BITS
    carry_out = torch.gather(gen, -1, last.clamp(min=0)) * (last >= 0)
    return (x + _shift_up(carry_out)) & MASK


def prod_cols(a, b):
    """Column sums of the schoolbook product: (..., L) x (..., L) ->
    (..., 2L) with col[k] = sum_{i+j=k} a_i b_j.  Inputs may be unnormalised
    (columns stay exact in int64 while a_i * b_j * L < 2^63)."""
    a, b = torch.broadcast_tensors(a, b)
    L = a.shape[-1]
    prod = a[..., :, None] * b[..., None, :]                 # (..., L, L)
    # skew row i right by i: pad each row to 2L+1 and re-cut at width 2L
    sk = TF.pad(prod, (0, L + 1)).flatten(-2)[..., : 2 * L * L]
    return sk.unflatten(-1, (L, 2 * L)).sum(dim=-2)


class Field:
    """GF(p) with L 16-bit limbs in Montgomery form (R = 2^(16 L)).

    Canonical values have limbs in [0, 2^16) and value < p.  Lazy values
    (sums formed with plain tensor `+`, and differences formed with `subs`)
    have non-negative limbs below 2^24 and value below k p; `reduce` brings
    them back to canonical in one carry pass, and `mul` accepts lazy inputs
    below 4p.  Chaining lazy sums this way keeps the carry passes, which
    dominate the op count, to about one per tower step."""

    def __init__(self, p: int):
        self.p = p
        L = -(-p.bit_length() // LIMB_BITS)
        # mul's inputs may be lazy up to 4p: REDC then stays below 5p
        while p >= (1 << (LIMB_BITS * L)) // 4:
            L += 1
        self.L = L
        self.R = 1 << (LIMB_BITS * L)
        self.R2 = self.R * self.R % p
        self.n_prime = (-pow(p, -1, self.R)) % self.R
        self._pm2_bits = [int(c) for c in bin(p - 2)[2:]]
        # 2p with every limb but the top raised by a borrow from above, so
        # that m * D - (sum of m canonical values) has non-negative limbs
        c = bigint.int_to_limbs(2 * p, L).tolist()
        self._d = [c[0] + (1 << LIMB_BITS)] + [v + MASK for v in c[1:-1]] + [c[-1] - 1]
        assert sum(v << (LIMB_BITS * i) for i, v in enumerate(self._d)) == 2 * p
        assert min(self._d[:-1]) >= MASK and self._d[-1] >= p >> (LIMB_BITS * (L - 1))

    # ------------------------------------------------------------ constants

    @functools.lru_cache(maxsize=None)
    def _consts(self, device):
        def t(v):
            return torch.tensor(v, dtype=torch.int64, device=device)

        L, top = self.L, 1 << (LIMB_BITS * (self.L + 1))

        def cands(k, shift):
            # rows (2^(16(L+1)) - j p) << 16 shift, j = 0..k-1, over
            # shift + L + 2 limbs: row j carries into the top limb iff the
            # value it is added to is >= j p
            return t([[0] * shift + bigint.int_to_limbs(top - j * self.p, L + 2).tolist()
                      for j in range(k)])

        return {
            "p": t(bigint.int_to_limbs(self.p, L).tolist()),
            "np": t(bigint.int_to_limbs(self.n_prime, L).tolist()),
            "one": t(bigint.int_to_limbs(self.R % self.p, L).tolist()),
            "raw_one": t(bigint.int_to_limbs(1, L).tolist()),
            "r2": t(bigint.int_to_limbs(self.R2, L).tolist()),
            "d": t(self._d),
            # mul's candidates sit above the L low limbs of U = T + m p
            "mul_cands": cands(5, L),
            "cands": {k: cands(k, 0) for k in range(1, 33)},
        }

    def c(self, x, name):
        return self._consts(x.device)[name]

    def one_like(self, x):
        """Montgomery one, broadcast to the shape of x."""
        return self.c(x, "one").expand_as(x)

    # -------------------------------------------------------------- codecs

    def encode(self, values, device="cpu", mont: bool = True):
        """Python int or list of ints -> (L,) or (n, L) int64 limb tensor."""
        def conv(v):
            v %= self.p
            return v * self.R % self.p if mont else v

        if isinstance(values, int):
            arr = bigint.int_to_limbs(conv(values), self.L)
        else:
            arr = bigint.ints_to_limbs([conv(v) for v in values], self.L)
        return torch.as_tensor(arr.astype("int64"), device=device)

    def decode(self, x, mont: bool = True):
        """(..., L) limb tensor -> Python int (for (L,)) or nested lists."""
        arr = x.detach().cpu().numpy().astype(np.uint32)
        rinv = pow(self.R, -1, self.p)
        flat = bigint.limbs16_to_ints_fast(arr.reshape(-1, self.L))
        if mont:
            flat = [v * rinv % self.p for v in flat]
        if x.dim() == 1:
            return flat[0]
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        return out.reshape(tuple(x.shape[:-1])).tolist()

    # ------------------------------------------------------ lazy arithmetic

    def _pick(self, rows, lo, hi):
        """rows: (k, ..., K) candidates normalised, top limb = 1 iff x >= j p;
        returns rows[j*][..., lo:hi] for the largest such j."""
        j = rows[..., -1].sum(dim=0) - 1
        sel = torch.gather(rows[..., lo:hi], 0, j[None, ..., None].expand(1, *rows.shape[1:-1], hi - lo))
        return sel[0]

    def reduce(self, x, k: int):
        """Lazy x (limbs in [0, 2^24), value < k p) -> canonical."""
        cands = self.c(x, "cands")[k]
        ext = TF.pad(x, (0, 2))
        rows = normalize(ext + cands.reshape(k, *([1] * (x.dim() - 1)), -1), 3)
        return self._pick(rows, 0, self.L)

    def subs(self, x, *ys):
        """Lazy x - sum(ys) + 2p len(ys), ys canonical: non-negative limbs."""
        out = x + len(ys) * self.c(x, "d")
        for y in ys:
            out = out - y
        return out

    # ----------------------------------------------------------- field ops

    def add(self, a, b):
        return self.reduce(a + b, 2)

    def sub(self, a, b):
        return self.reduce(self.subs(a, b), 3)

    def neg(self, a):
        return self.reduce(self.subs(torch.zeros_like(a), a), 3)

    def double(self, a):
        return self.reduce(a + a, 2)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod p; a, b canonical or lazy
        below 4p (then U / R < 5p, and one of five candidates is the
        canonical result)."""
        L = self.L
        t = prod_cols(a, b)                                   # < 2^40
        m = normalize(prod_cols(t[..., :L], self.c(t, "np"))[..., :L], 4)
        u = t + prod_cols(m, self.c(t, "p"))                  # < 2^41
        cands = self.c(u, "mul_cands")
        u = TF.pad(u, (0, 2))
        rows = normalize(u + cands.reshape(5, *([1] * (u.dim() - 1)), -1), 3)
        return self._pick(rows, L, 2 * L)

    def to_mont(self, a):
        """a R mod p for canonical a, or for any a below R (a 16-bit-limb
        integer is reduced mod p on the way)."""
        return self.mul(a, self.c(a, "r2"))

    def from_mont(self, a):
        return self.mul(a, self.c(a, "raw_one"))

    def pow_bits(self, x, bits):
        """x^e for e given as an MSB-first list of bits (host ints)."""
        acc = self.one_like(x)
        for bit in bits:
            acc = self.mul(acc, acc)
            if bit:
                acc = self.mul(acc, x)
        return acc

    def inv(self, x):
        """Fermat inversion x^(p-2); 0 maps to 0."""
        return self.pow_bits(x, self._pm2_bits)

    def below_p(self, x):
        """For 16-bit limbs x: True where the value is < p."""
        row = normalize(TF.pad(x, (0, 2)) + self.c(x, "cands")[2][1], 2)
        return row[..., -1] == 0

    def is_zero(self, a):
        return (a == 0).all(dim=-1)
