"""K3, the fold ladders: the plain versions (ops/fold.py) against golden
vectors frozen from the JAX package's G1/G2.to_affine(fold(lo, hi, bits))
(held bit-identical to pallas_fold.fold_g1_fused / fold_g2_fused by its own
tests), with one dead lane, and against hostref.  Exact equality.
Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernels are compared with these plain versions on the card by
chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, curves, hostref, params
from sipp_tpu_torch.fields import bigint
from sipp_tpu_torch.ops import fold

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def challenge(golden):
    x = bigint.limbs_to_int(golden["fold_x"])
    return x, pow(x, -1, params.R)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fold_matches_reference(golden, challenge, group):
    x = challenge[0] if group == "g1" else challenge[1]
    lo = convert.from_reference(golden[f"fold_{group}_lo"], device="cpu")
    hi = convert.from_reference(golden[f"fold_{group}_hi"], device="cpu")
    wrapper = getattr(fold, f"fold_{group}")
    before = wrapper.launches
    got = wrapper(lo, hi, curves.scalar_to_bits(x))
    assert wrapper.launches == before           # CPU tensors: plain version
    assert np.array_equal(convert.to_reference(got), golden[f"fold_{group}_out"])
    assert bool((got[3] == 0).all())            # dead lane: O + x O = O

    decode = curves.g1_decode if group == "g1" else curves.g2_decode
    add = hostref.g1_add if group == "g1" else hostref.g2_add
    mul = hostref.g1_mul if group == "g1" else hostref.g2_mul
    want = [add(p, mul(q, x)) for p, q in zip(decode(lo)[:3], decode(hi)[:3])]
    assert decode(got)[:3] == want


def test_fold_offset_at_infinity(golden, challenge):
    """A live hi with a dead lo folds to [x] hi (the kernel's infinity
    select on the offset)."""
    a = convert.from_reference(golden["a2"], device="cpu")
    lo = torch.zeros_like(a)
    got = fold.fold_g1(lo, a, curves.scalar_to_bits(challenge[0]))
    assert curves.g1_decode(got) == [hostref.g1_mul(p, challenge[0])
                                     for p in curves.g1_decode(a)]


def test_fold_rejects_bad_scalar_width(golden):
    a = convert.from_reference(golden["a2"], device="cpu")
    with pytest.raises(ValueError):
        fold.fold_g1(a, a, [1] * 253)
