"""The port's sharded prover (sipp_tpu_torch/parallel/sharded.py) on CPU
meshes, mirroring tests/test_sharding.py: the cyclic layout, and proofs
byte-equal (tolerance 0) to the JAX package's, frozen by
tools/make_torch_golden.py: the n = 4 seed-7 proof (stage prove) and the
n = 8 seed-5 proof of tests/test_sharding.py (stage sharded8: the JAX
sipp_prove's, which the JAX sipp_prove_sharded reproduced on two and four
forced host devices).  Every round's (Z_L, Z_R) is a row of the proof, so
byte equality holds each round to the reference."""

import pathlib

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert
from sipp_tpu_torch.parallel import Mesh, make_mesh, shard_cyclic, sipp_prove_sharded, unshard
from sipp_tpu_torch.utils.testing import random_instance

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shard_cyclic_roundtrip():
    mesh = make_mesh(4, "cpu")
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4 and mesh.group is None
    x = torch.arange(8 * 3).reshape(8, 3)
    s = shard_cyclic(x, mesh)
    assert len(s) == 4 and all(part.shape == (2, 3) for part in s)
    assert torch.equal(unshard(mesh.all_gather(s)), x)
    # shard k holds global indices {l*d + k}
    assert torch.equal(s[2][1], x[6])
    with pytest.raises(AssertionError, match="not divisible"):
        shard_cyclic(x[:6], mesh)


@pytest.mark.parametrize("n,d", [(4, 2), (4, 4), (8, 2), (8, 4)])
def test_sharded_prove_matches_jax(n, d):
    """(4, 4) is the JAX function's n <= d start: the lead device
    aggregates, and the gathered tail runs every round."""
    with np.load(GOLDEN) as g:
        names = ("a4", "b4", "proof4") if n == 4 else ("sharded8_a", "sharded8_b",
                                                       "sharded8_proof")
        a_ref, b_ref, want = (g[k] for k in names)
    a, b = random_instance(n, seed=7 if n == 4 else 5, device="cpu")
    assert np.array_equal(convert.to_reference(a), a_ref)
    assert np.array_equal(convert.to_reference(b), b_ref)
    proof = sipp_prove_sharded(a, b, make_mesh(d, "cpu"))
    assert proof.shape == (2 * n.bit_length() - 1, 2, 3, 2, 16)
    assert np.array_equal(convert.to_reference(proof), want)


@pytest.mark.parametrize("d", [3, 8])
def test_sharded_prove_refuses_a_bad_mesh(d):
    """A mesh not a power of two, or wider than n, raises before any work."""
    with np.load(GOLDEN) as g:
        a, b = (convert.from_reference(g[k], "cpu") for k in ("a4", "b4"))
    with pytest.raises(ValueError, match=f"power of two <= n shards, got {d}"):
        sipp_prove_sharded(a, b, make_mesh(d, "cpu"))


def test_make_mesh_never_repeats_a_card(monkeypatch):
    """Fewer visible cards than shards raise (here, where there is no card,
    and on a one-card machine); a mesh that repeats a card is only built
    by naming it, and a named card alone is a mesh of one."""
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="never repeats a card"):
            make_mesh(4, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"4 CUDA card\(s\) from cuda:0 asked for, 1 visible"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="from cuda:1"):
        make_mesh(device="cuda:1")
    assert make_mesh().devices == (torch.device("cuda", 0),)
    assert Mesh((torch.device("cuda", 0),) * 4).size == 4
