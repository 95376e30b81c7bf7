"""The port's instance draw (utils/testing.py) against the JAX package's
sipp_tpu.utils.testing.random_points: the card's route (ladder_instance: K6
with the generator in every lane, an offset at infinity and the scalars'
bits), here through K6's plain ladders on CPU tensors, the scalar stream
both draws multiply, and instance_digest's layout.  Exact equality.

chip_smoke.py runs the route through K6 itself on the card: at n = 128
against the host draw, at n = 4096 against the digest frozen from the JAX
package by

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py --only instance4096
"""

import hashlib
import pathlib
import re

import numpy as np
import pytest
import torch

import sipp_tpu.hostref
from sipp_tpu.utils.testing import random_points as jax_random_points
from sipp_tpu_torch import curves
from sipp_tpu_torch.curves import scalar_to_bits
from sipp_tpu_torch.ops import exp
from sipp_tpu_torch.utils import testing

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1177, 7])
def test_ladder_route_equals_jax_points(seed):
    launches = exp.exp_g1.launches, exp.exp_g2.launches
    a, b = testing.ladder_instance(4, seed, device="cpu")
    A, B = jax_random_points(4, seed)
    assert torch.equal(a, curves.g1_encode(A)) and torch.equal(b, curves.g2_encode(B))
    assert (exp.exp_g1.launches, exp.exp_g2.launches) == launches   # plain: no kernel


def test_scalar_stream_equals_jax_draw(monkeypatch):
    seen = {"g1": [], "g2": []}
    monkeypatch.setattr(sipp_tpu.hostref, "g1_mul", lambda pt, k: seen["g1"].append(k))
    monkeypatch.setattr(sipp_tpu.hostref, "g2_mul", lambda pt, k: seen["g2"].append(k))
    jax_random_points(64, 1177)
    assert testing.random_scalars(64, 1177) == (seen["g1"], seen["g2"])


def test_scalar_bits_layout():
    ka, _ = testing.random_scalars(16, 3)
    ks = ka + [0, 1, (1 << 254) - 1]
    want = np.stack([scalar_to_bits(k) for k in ks], axis=1).astype(np.int64)
    got = testing.scalar_bits(ks, "cpu")
    assert got.dtype == torch.int64 and got.shape == (254, len(ks))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [1177, 7])
def test_instance_digest_layout(seed):
    a, b = testing.random_instance(4, seed, device="cpu")
    A, B = jax_random_points(4, seed)
    ints = [v for x, y in A for v in (x, y)]
    ints += [v for (x0, x1), (y0, y1) in B for v in (x0, x1, y0, y1)]
    want = hashlib.sha256(b"".join(v.to_bytes(32, "big") for v in ints)).hexdigest()
    assert testing.instance_digest(a, b) == want == testing.points_digest(A, B)
    # a lane at infinity hashes as zero coordinates
    a[1] = 0
    A[1] = None
    assert testing.instance_digest(a, b) == testing.points_digest(A, B) != want


def test_frozen_digest_in_chip_smoke():
    with np.load(GOLDEN) as g:
        frozen = str(g["instance4096_digest"])
    text = (ROOT / "chip_smoke.py").read_text()
    assert re.search(r'^INSTANCE_DIGEST_LARGE = "([0-9a-f]{64})"', text, re.M)[1] == frozen
