"""K1, the Miller product: its plain version (ops/miller.py, which the
wrapper runs for CPU tensors) against golden vectors frozen from the JAX
package's XLA path (_product_tree(miller_loop) and _inner_f, which its own
tests hold bit-identical to pallas_miller.miller_product_fused).  Exact
equality.  Regenerate the golden file with

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py

The CUDA kernel itself is compared with this plain version on the card by
chip_smoke.py."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert
from sipp_tpu_torch.ops import miller

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


def _t(arr):
    return convert.from_reference(arr, device="cpu")


@pytest.mark.parametrize("n", [4, 2])
def test_miller_product_matches_reference(golden, n):
    got = miller.miller_product(_t(golden[f"a{n}"]), _t(golden[f"b{n}"]))
    assert np.array_equal(convert.to_reference(got), golden[f"f{n}"])


def test_pair_mode_matches_two_reference_products(golden):
    """Even lanes (A_hi x B_lo) and odd lanes (A_lo x B_hi) reduce
    separately; lane 2 is a point at infinity and contributes 1."""
    p, q = _t(golden["pair_p"]), _t(golden["pair_q"])
    assert bool((p[2] == 0).all())
    got = miller.miller_product(p, q, pair=True)
    assert np.array_equal(convert.to_reference(got), golden["pair_f"])


def test_wrapper_runs_plain_on_cpu_without_launching(golden):
    before = (miller.miller_product.launches, miller.miller_product.pair_launches)
    a, b = _t(golden["a2"]), _t(golden["b2"])
    assert torch.equal(miller.miller_product(a, b), miller.miller_product_plain(a, b))
    assert (miller.miller_product.launches, miller.miller_product.pair_launches) == before


def test_all_infinity_lanes_give_one(golden):
    from sipp_tpu_torch.fields import tower

    a = torch.zeros((2, 2, 16), dtype=torch.int64)
    b = _t(golden["b2"])
    assert torch.equal(miller.miller_product(a, b), tower.fq12_one())


@pytest.mark.parametrize("n,pair,width", [(1, False, 4), (3, False, 4), (2, True, 4),
                                          (64, True, 64), (128, False, 128),
                                          (130, False, 132), (384, True, 384)])
def test_launch_width(n, pair, width):
    """Kernel launch width: whole blocks of miller.BLOCK lanes, one warp a
    lane (the lanes past n contribute 1)."""
    assert miller._lanes(n, pair) == width


def test_kernel_header_carries_the_block_width():
    """The CUDA side's MILLER_BLOCK_LANES is generated from miller.BLOCK."""
    from sipp_tpu_torch.ops import _build

    assert f"#define MILLER_BLOCK_LANES {miller.BLOCK}\n" in _build.params_header()


def test_rejects_odd_pair_input(golden):
    with pytest.raises(ValueError):
        miller.miller_product(_t(golden["a2"])[:1], _t(golden["b2"])[:1], pair=True)
