"""X1's test (ops/validate.py g2_torsion_plain, the BN endomorphism test of
eprint 2022/348: [x0 + 1]Q + psi([x0]Q) + psi^2([x0]Q) == psi^3([2 x0]Q))
is [r]Q == O on every point of the twist E'(Fq2), on the CPU, with hostref
ints and the port only.

The argument: E'(Fq2) is cyclic of squarefree order r h2, so each of its
subgroups is the set of multiples of one prime-order product; the test is
the kernel of an endomorphism, hence such a subgroup, and it is the
r-torsion iff it holds on a point of order r and fails on one point of
each prime order dividing h2.  The tests below check each premise and
each of those five points.
"""

import math

import pytest
import torch

from sipp_tpu_torch import curves, hostref, params
from sipp_tpu_torch.apps.bls_aggregation import map_to_g2_without_cofactor_mul
from sipp_tpu_torch.ops import validate as x1

ORDER = params.R * params.G2_COFACTOR            # #E'(Fq2)
PRIMES = (params.R, *params.G2_COFACTOR_PRIMES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def is_prime(n):
    """Miller-Rabin on the first 40 primes as bases (deterministic far past
    2^64; for the 178-bit factor an error is below 4^-40)."""
    bases = [p for p in range(2, 200) if all(p % d for d in range(2, p))][:40]
    if n < 2:
        return False
    for p in bases:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@pytest.fixture(scope="module")
def generator():
    """A point of the twist off the r-torsion: the BLS map before cofactor
    clearing."""
    return map_to_g2_without_cofactor_mul((1234, 5678))


def test_cofactor_is_squarefree():
    assert math.prod(params.G2_COFACTOR_PRIMES) == params.G2_COFACTOR
    assert len(set(PRIMES)) == len(PRIMES)
    assert all(is_prime(q) for q in PRIMES)


def test_twist_is_cyclic_of_order_r_h2(generator):
    """The point has order exactly r h2 (so the group, of that order by
    Hasse's interval, is cyclic and the point generates it)."""
    p2 = params.P ** 2
    assert abs(p2 + 1 - ORDER) <= 2 * params.P
    assert hostref.g2_is_on_curve(generator)
    assert hostref.g2_mul_raw(generator, ORDER) is None
    assert all(hostref.g2_mul_raw(generator, ORDER // q) is not None for q in PRIMES)


def test_psi_is_additive(generator):
    """psi (hostref's twist_frob, and the port's on Jacobian points) is a
    homomorphism on pairs of points of the twist."""
    pts = [generator, hostref.g2_mul_raw(generator, 7), hostref.g2_mul_raw(generator, ORDER // 3)]
    for p, q in [(pts[0], pts[1]), (pts[1], pts[2]), (pts[0], pts[0])]:
        assert hostref.twist_frob(hostref.g2_add(p, q)) == hostref.g2_add(
            hostref.twist_frob(p), hostref.twist_frob(q))
    jac = curves.G2.dbl(curves.G2.jac_from_affine(curves.g2_encode(pts)))   # Z != 1
    got = curves.g2_decode(curves.G2.to_affine(x1.psi(jac)))
    assert got == [hostref.twist_frob(hostref.g2_mul_raw(p, 2)) for p in pts]


@pytest.mark.parametrize("q", PRIMES, ids=lambda q: f"order_{q.bit_length()}bit")
def test_endomorphism_test_equals_r_torsion(generator, q):
    """On [r h2 / q]T, a point of prime order q: g2_torsion_plain gives 1
    exactly for q = r, and equals the [r]Q ladder's verdict."""
    pt = hostref.g2_mul_raw(generator, ORDER // q)
    assert pt is not None and hostref.g2_mul_raw(pt, q) is None
    b = curves.g2_encode([pt])
    got = x1.g2_torsion_plain(b).tolist()
    assert got == [int(q == params.R)]
    assert got == x1.g2_torsion_r_ladder(b).tolist()


def test_x_bits_are_the_parameter():
    assert int("".join(map(str, x1.X_BITS)), 2) == params.X and len(x1.X_BITS) == 63
