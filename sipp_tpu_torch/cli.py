"""CLI entry points of the port: prove / verify / bls, with the JAX CLI's
flags (sipp_tpu/cli.py) and --device (default cuda: the card).

    python -m sipp_tpu_torch.cli prove  --n 8 --out proof.npz [--device cpu]
    python -m sipp_tpu_torch.cli verify --proof proof.npz [--statement stmt.u32]
    python -m sipp_tpu_torch.cli bls    --n 8

Proof and statement files are the JAX package's (io.py), so either CLI
verifies the other's proofs.  prove --devices d (d > 1) runs the sharded
prover (parallel/sharded.py) on a mesh of d shards: d distinct cards from
--device's index on CUDA, or d CPU shards with --device cpu; too few cards
exit non-zero with the mesh's message.
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sipp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove", help="prove a random SIPP instance")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--out", type=str, default="proof.npz")

    v = sub.add_parser("verify", help="verify a saved proof")
    v.add_argument("--proof", type=str, default="proof.npz")
    v.add_argument("--statement", type=str, default=None,
                   help="also write the statement wire format here")

    b = sub.add_parser("bls", help="BLS aggregation demo")
    b.add_argument("--n", type=int, default=128)

    for parser in (p, v, b):
        parser.add_argument("--device", type=str, default="cuda",
                            help="cuda (the card, the default) or cpu")

    args = ap.parse_args(argv)
    import torch

    from .convert import resolve_device

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.cmd == "prove":
        from . import io
        from .config import SippConfig
        from .protocol import sipp_prove, sipp_prove_onchip
        from .utils.testing import random_instance

        cfg = SippConfig(n=args.n, num_devices=args.devices, seed=args.seed)
        if cfg.num_devices > 1:
            from .parallel import make_mesh, sipp_prove_sharded

            try:
                mesh = make_mesh(cfg.num_devices, device)
            except RuntimeError as e:
                sys.exit(str(e))

            def prove(a, b):
                return sipp_prove_sharded(a, b, mesh)
        else:
            prove = sipp_prove_onchip if device.type == "cuda" else sipp_prove
        a, b_ = random_instance(cfg.n, seed=cfg.seed, device=device)
        t0 = time.time()
        proof = prove(a, b_)
        sync()
        print(f"proved n={cfg.n} in {time.time()-t0:.2f}s", file=sys.stderr)
        io.save_proof(args.out, a, b_, proof)
        print(args.out)

    elif args.cmd == "verify":
        from . import io
        from .protocol import sipp_verify

        a, b_, proof = io.load_proof(args.proof, device)
        t0 = time.time()
        stmt = sipp_verify(a, b_, proof)
        sync()
        print(f"verified n={a.shape[0]} in {time.time()-t0:.2f}s", file=sys.stderr)
        if args.statement:
            io.save_statement(args.statement, stmt)
            print(args.statement)
        print("OK")

    elif args.cmd == "bls":
        from .apps.bls_aggregation import main as bls_main

        bls_main(args.n, device)


if __name__ == "__main__":
    main()
