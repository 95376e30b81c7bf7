"""The port's multi-process launcher (sipp_tpu_torch/parallel/launcher.py)
wires a cluster, mirroring tests/test_launcher.py: two local processes join
a gloo process group through launcher.initialize, each with two CPU shards;
make_mesh spans the four shards in rank order, the mesh's gather returns
them in global shard order, and sipp_prove_sharded on that four-shard
cluster gives, on both ranks, the JAX package's n = 4 proof (golden arrays
a4, b4, proof4 of tests/golden/torch_port.npz, tolerance 0)."""

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "torch_port.npz"

_CHILD = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from sipp_tpu_torch.parallel.launcher import initialize

dist = initialize(coordinator=sys.argv[1], num_hosts=2, host_id=int(sys.argv[2]), device="cpu")
from sipp_tpu_torch import convert
from sipp_tpu_torch.parallel import make_mesh, sipp_prove_sharded

assert dist.get_world_size() == 2
mesh = make_mesh(4, "cpu")          # spans both processes' shards
assert (mesh.size, len(mesh.devices), mesh.offset) == (4, 2, 2 * dist.get_rank())
got = mesh.all_gather([torch.full((3,), 10 * mesh.rank + j) for j in range(2)])
assert [t.tolist() for t in got] == [[0] * 3, [1] * 3, [10] * 3, [11] * 3], got
with np.load(sys.argv[3]) as g:
    a, b = (convert.from_reference(g[k], "cpu") for k in ("a4", "b4"))
    want = g["proof4"]
proof = sipp_prove_sharded(a, b, mesh)
assert np.array_equal(convert.to_reference(proof), want)
dist.destroy_process_group()
print(f"proc {mesh.rank} OK", flush=True)
"""


def test_two_process_cluster(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), f"127.0.0.1:{port}", str(i),
                               str(GOLDEN)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=tmp_path)
             for i in range(2)]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{err[-2000:]}"
        outs.append(out)
    assert "proc 0 OK" in outs[0] and "proc 1 OK" in outs[1]
