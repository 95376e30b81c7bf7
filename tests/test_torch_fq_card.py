"""K0's wrapper on operands on a card that is not the current one (the
wrapper enters that card's context for the launch), which only a machine
with two cards can show.  The kernel's result is held to the plain
version on the same values, tolerance 0.  No JAX here, so that the file
runs on a machine with cards:

    python3 -m pytest tests/test_torch_fq_card.py -o addopts= --noconftest -p no:cacheprovider
"""

import pytest
import torch

from sipp_tpu_torch.ops import fq

pytestmark = pytest.mark.cuda


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards: operands on a card that is not the current one")
def test_kernel_on_a_card_that_is_not_current():
    a, b = fq.random_batch(1000, 6, "cpu")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    before = fq.fq_mul.launches
    got = fq.fq_mul(a.to(dev), b.to(dev))
    assert got.device == dev and fq.fq_mul.launches == before + 1
    assert torch.cuda.current_device() == 0
    assert torch.equal(got.cpu(), fq.fq_mul_plain(a, b))
