"""Multi-process SPMD launcher (port of sipp_tpu/parallel/launcher.py).

Every process runs the same program.  initialize wires them with
torch.distributed (NCCL between cards, gloo on the CPU) from an address
given by hand; make_mesh() then spans every process's local devices in rank
order, each process keeps its own shards of the replicated instance, and
every rank finishes the gathered tail and so holds the same proof.  The
prover is stateless per round, so a failed run restarts from the inputs.

Usage (each process; on one host with one card a process, give each its
card with --device cuda:<rank>):

    python -m sipp_tpu_torch.parallel.launcher --n 65536 \\
        --coordinator host0:1234 --num-hosts 4 --host-id $ID [--device cuda:$ID]

One process needs no launcher: make_mesh() spans its visible cards.
"""

import argparse
import hashlib
import sys
import time

import torch


def initialize(coordinator: str = None, num_hosts: int = None, host_id: int = None,
               device="cuda"):
    """Join the process group at tcp://coordinator as rank host_id of
    num_hosts (nothing without a coordinator).  Returns torch.distributed."""
    import torch.distributed as dist

    if coordinator is not None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_hosts, rank=host_id)
    return dist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (every visible card), cuda:<i> (that card) or cpu")
    args = ap.parse_args(argv)

    dist = initialize(args.coordinator, args.num_hosts, args.host_id, args.device)
    from ..convert import resolve_device, to_reference
    from ..protocol import sipp_verify
    from ..utils.testing import random_instance
    from . import make_mesh, sipp_prove_sharded

    mesh = make_mesh(device=resolve_device(args.device))  # all processes' devices
    print(f"host {mesh.rank}/{mesh.world}: {mesh.size} global devices", file=sys.stderr)
    a, b = random_instance(args.n, seed=args.seed, device=mesh.lead)
    t0 = time.time()
    proof = sipp_prove_sharded(a, b, mesh)
    if mesh.lead.type == "cuda":
        torch.cuda.synchronize(mesh.lead)
    dt = time.time() - t0
    digest = hashlib.sha256(to_reference(proof).tobytes()).hexdigest()
    print(f"host {mesh.rank}: proof sha256 {digest}", file=sys.stderr)
    if mesh.rank == 0:
        print(f"n={args.n} sharded prove: {dt:.2f}s ({args.n/dt:.1f} pairings/s aggregate)")
        sipp_verify(a, b, proof)
        print("verify OK")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
