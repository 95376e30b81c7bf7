"""The sharded path on several cards, which only a machine with them can
show: K1 (both modes), K2 and K3's wrappers on operands on a card that is
not the current one, bit-equal (tolerance 0) to their plain versions;
make_mesh over four distinct cards at n = 128, byte-equal to sipp_prove on
one card; and the launcher as four processes joined by NCCL, one card each,
all with the same proof, which rank 0 verifies.  No JAX here, so that the
file runs on a machine with cards:

    python3 -m pytest tests/test_torch_sharded_card.py -o addopts= --noconftest -p no:cacheprovider
"""

import functools
import hashlib
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from sipp_tpu_torch import convert, params
from sipp_tpu_torch.curves import scalar_to_bits
from sipp_tpu_torch.ops import fexp, fold, miller
from sipp_tpu_torch.parallel import make_mesh, sipp_prove_sharded
from sipp_tpu_torch.protocol import sipp_prove
from sipp_tpu_torch.utils.testing import random_instance

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parent.parent
N, SEED = 128, 1177


def _need_cards(k):
    """Skip, deciding inside the test, below k visible cards."""
    if torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} CUDA cards, {torch.cuda.device_count()} visible")


@functools.lru_cache(maxsize=None)
def _instance():
    return random_instance(N, seed=SEED, device="cpu")


def test_kernels_on_a_card_that_is_not_current():
    _need_cards(2)
    a, b = (x[:8] for x in _instance())
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    bits = scalar_to_bits(params.R - 12345)
    calls = [
        (miller.miller_product, "launches", lambda x, y: miller.miller_product(x, y),
         miller.miller_product_plain, (a, b)),
        (miller.miller_product, "pair_launches",
         lambda x, y: miller.miller_product(x, y, pair=True),
         lambda x, y: miller.miller_product_plain(x, y, pair=True), (a, b)),
        (fexp.final_exp, "launches", fexp.final_exp, fexp.final_exp_plain,
         (miller.miller_product_plain(a, b, pair=True),)),
        (fold.fold_g1, "launches", lambda lo, hi: fold.fold_g1(lo, hi, bits),
         lambda lo, hi: fold.fold_g1_plain(lo, hi, bits), (a[:4], a[4:])),
        (fold.fold_g2, "launches", lambda lo, hi: fold.fold_g2(lo, hi, bits),
         lambda lo, hi: fold.fold_g2_plain(lo, hi, bits), (b[:4], b[4:])),
    ]
    for counted, attr, kernel, plain, args in calls:
        before = getattr(counted, attr)
        got = kernel(*(x.to(dev) for x in args))
        assert got.device == dev and getattr(counted, attr) == before + 1
        assert torch.cuda.current_device() == 0
        assert torch.equal(got.cpu(), plain(*args)), kernel


def test_mesh_of_four_cards():
    _need_cards(4)
    a, b = (x.to("cuda:0") for x in _instance())
    mesh = make_mesh(4)
    assert mesh.devices == tuple(torch.device("cuda", k) for k in range(4))
    before = fold.fold_g1.launches
    proof = sipp_prove_sharded(a, b, mesh)
    # 5 sharded rounds of a launch a shard, then the tail's 2 on cuda:0
    assert fold.fold_g1.launches - before == 5 * 4 + 2
    assert proof.device == torch.device("cuda", 0)
    assert torch.equal(proof, sipp_prove(a, b))


def test_launcher_four_processes_nccl():
    _need_cards(4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sipp_tpu_torch.parallel.launcher", "--n", str(N), "--seed",
         str(SEED), "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "4", "--host-id",
         str(r), "--device", f"cuda:{r}"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(4)]
    outs = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{err[-3000:]}"
        outs.append((out, err))
    digests = [line.split()[-1] for _, err in outs for line in err.splitlines()
               if "proof sha256" in line]
    want = hashlib.sha256(convert.to_reference(
        sipp_prove(*(x.to("cuda:0") for x in _instance()))).tobytes()).hexdigest()
    assert digests == [want] * 4
    assert "verify OK" in outs[0][0]
    assert all("4 global devices" in err for _, err in outs)
