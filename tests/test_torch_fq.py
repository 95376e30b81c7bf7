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
