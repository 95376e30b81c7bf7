"""K0, the batched Fq multiply: the plain version (ops/fq.py fq_mul_plain =
FQ.mul, which the wrapper runs for CPU tensors) against the JAX package's
own Pallas kernel pallas_fq.fq_mul_pallas in interpret mode, on the same
seeded values; exact equality (tolerance 0, canonical values).  The CUDA
kernel is compared with the plain version on the card by chip_smoke.py and
by `python -m sipp_tpu_torch.ops.fq`."""

import numpy as np
import pytest
import torch

from sipp_tpu.fields import FQ as JFQ
from sipp_tpu.ops.pallas_fq import fq_mul_pallas
from sipp_tpu_torch import convert
from sipp_tpu_torch.ops import fq


@pytest.mark.parametrize("batch", [64, 37])
def test_plain_matches_pallas_interpret(batch):
    rng = np.random.default_rng(1177 + batch)
    xs = [int.from_bytes(rng.bytes(40), "little") % JFQ.p for _ in range(batch)]
    ys = [int.from_bytes(rng.bytes(40), "little") % JFQ.p for _ in range(batch)]
    want = np.asarray(fq_mul_pallas(JFQ.encode(xs), JFQ.encode(ys), interpret=True))
    a, b = fq.FQ.encode(xs), fq.FQ.encode(ys)
    assert np.array_equal(convert.to_reference(a), np.asarray(JFQ.encode(xs)))
    got = fq.fq_mul_plain(a, b)
    assert np.array_equal(convert.to_reference(got), want)


def test_wrapper_runs_plain_on_cpu_without_launching():
    a, b = fq.random_batch(5, 3, "cpu")
    before = fq.fq_mul.launches
    assert torch.equal(fq.fq_mul(a, b), fq.fq_mul_plain(a, b))
    assert fq.fq_mul.launches == before


def test_rejects_bad_input():
    a, b = fq.random_batch(4, 3, "cpu")
    with pytest.raises(ValueError, match="expected two"):
        fq.fq_mul(a, b[:3])
    with pytest.raises(ValueError, match="expected two"):
        fq.fq_mul(a[:, :8], b[:, :8])
    with pytest.raises(ValueError, match="unsupported device"):
        fq.fq_mul(a.to("meta"), b.to("meta"))


def test_bench_compare_needs_a_card(monkeypatch):
    """The entry point times the kernel: without a card it raises and takes
    no CPU route."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fq.bench_compare(batch=8, reps=1)


@pytest.mark.parametrize("batch", [2, 4096])
def test_uniform_batch_is_canonical_with_edge_rows(batch):
    """The generator-drawn inputs of the large-batch measurement: 16-bit
    limbs, every value below p, rows 0, 1 and p - 1 first, and a product
    the plain version computes as the host does."""
    a, b = fq.uniform_batch(batch, 11, "cpu")
    for x in (a, b):
        assert x.shape == (batch, 16) and x.dtype == torch.int64
        assert bool(((x >= 0) & (x <= 0xFFFF)).all()) and bool(fq.FQ.below_p(x).all())
        vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in x[:3]]
        assert vals == [0, 1, fq.FQ.p - 1][:batch]
    rinv = pow(1 << 256, -1, fq.FQ.p)
    got = fq.fq_mul_plain(a, b)
    for i in (0, 1, batch - 1):
        x, y, z = (sum(int(v) << (16 * k) for k, v in enumerate(t[i])) for t in (a, b, got))
        assert z == x * y * rinv % fq.FQ.p


def test_operand_copies_a_view_off_a_16_byte_boundary():
    """The kernel reads limb pairs as 16-byte vectors: an operand 8 bytes
    off a boundary is copied to one that starts on it, equal in value; an
    aligned operand is passed as it is."""
    a, _ = fq.random_batch(5, 3, "cpu")
    off = torch.empty(a.numel() + 1, dtype=torch.int64)[1:].view_as(a)
    off.copy_(a)
    assert off.data_ptr() % 16 == 8
    got = fq._operand(off)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, a)
    assert a.data_ptr() % 16 == 0 and fq._operand(a) is a
