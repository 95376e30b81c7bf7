"""The benchmark of sipp_tpu_torch, the PyTorch and CUDA port of SIPP.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  One run of one cell of BENCHMARK.json (benchmark/harness.py): set-up,
a window of --seconds, the check against the plain reference, then one JSON
line as the last line of standard output (with --trace 1 the cell's
per-layer metrics, else its end-to-end ones), the numbers compared beside
their limits as the last lines of standard error.  Exits non-zero with no
result line where CUDA or enough cards are missing, and where jax, jaxlib,
flax or sipp_tpu were loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sipp_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.Spec()
    chips = spec.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = harness.run(args.workload, args.seed, args.seconds, args.trace,
                                spec=spec, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process, which the benchmark forbids: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
