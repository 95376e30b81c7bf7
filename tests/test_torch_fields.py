"""The port's plain field and tower ops (sipp_tpu_torch.fields) against the
live JAX package (cheap jitted FQ.* / tower.* calls on the CPU, B <= 8) and
against hostref ints, on numpy-seeded inputs with the edge values 0 and
p - 1.  Exact equality: every value is canonical, so the limbs must match
byte for byte."""

import numpy as np
import pytest
import torch

from sipp_tpu.fields import FQ as JFQ, FR as JFR, tower as JT
from sipp_tpu_torch import convert, hostref, params
from sipp_tpu_torch.fields import FQ, FR, tower as T
from sipp_tpu_torch.pairing import ate

P = params.P


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, k, mod):
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(k)]


def _same(port, ref):
    return np.array_equal(convert.to_reference(port), np.asarray(ref, dtype=np.uint32))


@pytest.fixture(scope="module")
def fq_pair():
    rng = np.random.default_rng(1177)
    xs = _ints(rng, 8, P)
    ys = _ints(rng, 8, P)
    xs[0], ys[0] = 0, P - 1           # edge lanes
    xs[1], ys[1] = P - 1, P - 1
    xs[2], ys[2] = 1, 0
    return xs, ys


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg", "double"])
def test_fq_op_matches_jax(fq_pair, op):
    xs, ys = fq_pair
    ja, jb = JFQ.encode(xs), JFQ.encode(ys)
    a, b = (convert.from_reference(np.asarray(x), device="cpu") for x in (ja, jb))
    if op in ("neg", "double"):
        assert _same(getattr(FQ, op)(a), getattr(JFQ, op)(ja))
    else:
        assert _same(getattr(FQ, op)(a, b), getattr(JFQ, op)(ja, jb))


def test_fq_ops_match_hostref(fq_pair):
    xs, ys = fq_pair
    a, b = FQ.encode(xs), FQ.encode(ys)
    assert FQ.decode(FQ.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert FQ.decode(FQ.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert FQ.decode(FQ.inv(a[:4])) == [pow(x, P - 2, P) for x in xs[:4]]
    assert FQ.decode(FQ.from_mont(FQ.to_mont(a)), mont=True) == xs


def test_fq_lazy_forms(fq_pair):
    """mul accepts lazy sums below 4p; reduce/subs give canonical values."""
    xs, ys = fq_pair
    a, b = FQ.encode(xs), FQ.encode(ys)
    assert FQ.decode(FQ.mul(a + a + b + b, FQ.subs(a, b))) == \
        [(2 * x + 2 * y) * (x - y) % P for x, y in zip(xs, ys)]
    assert FQ.decode(FQ.reduce(FQ.subs(9 * a, b, b, b), 15)) == \
        [(9 * x - 3 * y) % P for x, y in zip(xs, ys)]
    assert FQ.below_p(a).all() and not FQ.below_p(FQ.encode([0]) + FQ.c(a, "p")).any()


def test_fr_mul_matches_jax(fq_pair):
    rng = np.random.default_rng(7)
    xs, ys = _ints(rng, 8, params.R), _ints(rng, 8, params.R)
    xs[0], ys[1] = params.R - 1, 0
    ja, jb = JFR.encode(xs), JFR.encode(ys)
    got = FR.mul(*(convert.from_reference(np.asarray(x), device="cpu") for x in (ja, jb)))
    assert _same(got, JFR.mul(ja, jb))
    assert FR.decode(got) == [x * y % params.R for x, y in zip(xs, ys)]


# -------------------------------------------------------------------- tower

def _fq12_pair(seed, batch=2):
    rng = np.random.default_rng(seed)
    vals = _ints(rng, 24 * batch, P)
    vals[0], vals[1] = 0, P - 1
    a = FQ.encode(vals[: 12 * batch]).reshape(batch, 2, 3, 2, 16)
    b = FQ.encode(vals[12 * batch:]).reshape(batch, 2, 3, 2, 16)
    return a, b


def _jax(x):
    return np.asarray(convert.to_reference(x))


@pytest.mark.parametrize("name", ["fq2_mul", "fq2_mul_xi"])
def test_fq2_op_matches_jax(name):
    a, b = _fq12_pair(3, batch=1)
    a2, b2 = a.reshape(6, 2, 16), b.reshape(6, 2, 16)
    args = (a2, b2) if name == "fq2_mul" else (a2,)
    got = getattr(T, name)(*args)
    want = getattr(JT, name)(*(_jax(x) for x in args))
    assert _same(got, want)


@pytest.mark.parametrize("name", ["fq12_mul", "fq12_conj", "frob1",
                                  "frob2", "frob3", "fq12_to_direct"])
def test_fq12_op_matches_jax(name):
    a, b = _fq12_pair(5)
    if name == "fq12_mul":
        got, want = T.fq12_mul(a, b), JT.fq12_mul(_jax(a), _jax(b))
    elif name.startswith("frob"):
        k = int(name[-1])
        got, want = T.fq12_frob(a, k), JT.fq12_frob(_jax(a), k)
    else:
        got, want = getattr(T, name)(a), getattr(JT, name)(_jax(a))
    assert _same(got, want)


def test_fq12_mul_line_matches_jax():
    a, b = _fq12_pair(9)
    la, lb, lc = b[:, 0, 0], b[:, 0, 1], b[:, 1, 2]
    got = T.fq12_mul_line(a, la, lb, lc)
    want = JT.fq12_mul_line(_jax(a), _jax(la), _jax(lb), _jax(lc))
    assert _same(got, want)


def test_fq12_cyclo_sqr_matches_jax():
    a, _ = _fq12_pair(11)
    g = ate.easy_part(a)          # cyclotomic: Granger-Scott applies
    assert _same(T.fq12_cyclo_sqr(g), JT.fq12_cyclo_sqr(_jax(g)))
    assert torch.equal(T.fq12_cyclo_sqr(g), T.fq12_mul(g, g))


def test_inversions_and_squaring_match_hostref():
    a, _ = _fq12_pair(13)
    host = T.fq12_decode(a)
    assert T.fq12_decode(T.fq12_inv(a)) == [hostref.fq12_inv(x) for x in host]
    assert T.fq12_decode(T.fq12_sqr(a)) == [hostref.fq12_mul(x, x) for x in host]
    a2 = a[:, 0, 1]
    assert [tuple(v) for v in FQ.decode(T.fq2_inv(a2))] == \
        [hostref.fq2_inv(tuple(x)) for x in FQ.decode(a2)]


def test_codecs_match_hostref():
    a, _ = _fq12_pair(13)
    host = T.fq12_decode(a)
    assert torch.equal(T.fq12_encode(host), a)
    assert FQ.decode(T.fq12_to_direct(a), mont=False) == [hostref.fq12_to_direct(x) for x in host]
    one = T.fq12_one((2,))
    assert torch.equal(T.fq12_mul(a, one), a)
