"""The frozen roofline counts (benchmark/metrics/counts.py) against what the
reference's own plain arithmetic counts, at n = 2 and n = 4."""

import pytest

from benchmark import instances
from benchmark.metrics import counts
from benchmark.reference import bn254, sipp


@pytest.fixture(scope="module")
def ref():
    return sipp.Reference()


def test_miller_digits():
    assert len(bn254.MILLER_DIGITS) == counts.MILLER_STEPS
    assert sum(1 for d in bn254.MILLER_DIGITS if d) == counts.MILLER_ADDS


@pytest.mark.parametrize("n", [2, 4])
def test_k1_products(n):
    pool = instances.Pool(n, 1, 11 + n)
    a, b = pool.points(pool.draw(0))
    t = bn254.Tower()
    t.miller_product(a, b)
    assert t.products == counts.k1_products(n)


@pytest.mark.parametrize("n", [2, 4])
def test_k3_products(n, ref):
    """Each round's fold ladders on the proof's own challenges, G1 by x and
    G2 by x^-1, lane by lane, as the reference's Tower counts them."""
    pool = instances.Pool(n, 1, 21 + n)
    inst = pool.draw(0)
    a, b = pool.points(inst)
    _, xs = ref.proof(a, b, *pool.logs(inst))
    t = bn254.Tower()
    for x in xs:
        m = len(a) // 2
        a = [t.fold("g1", lo, hi, x) for lo, hi in zip(a[:m], a[m:])]
        b = [t.fold("g2", lo, hi, pow(x, -1, bn254.R)) for lo, hi in zip(b[:m], b[m:])]
    assert t.products == counts.k3_products(n, xs)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("k", [1, 2, 3, 0b1011, (1 << 253) + 12345, bn254.R - 2])
def test_fold_lane_products(group, k):
    t = bn254.Tower()
    gen, mul = ((bn254.G1_GEN, bn254.g1_mul) if group == "g1" else (bn254.G2_GEN, bn254.g2_mul))
    t.fold(group, mul(gen, 5), mul(gen, 7), k)
    assert t.products == counts.fold_lane_products(group, k)
