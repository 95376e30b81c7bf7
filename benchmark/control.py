"""The control and the planted faults of a cell, at the cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --seconds 2
    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --seconds 2 --fault half_batch

Without --fault, the entry's control (the reference one step below what
the configuration states: entries/<entry>.py control()) runs in the
program's place; with it, the program runs with that fault planted
(faults.py).  Each seed is a run of the harness, judged by its own check;
one JSON line a seed: the seed, what ran, `correct` and the numbers
compared.  Both have to come out not correct.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys

from benchmark import faults, harness


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = harness.Spec()
    entry = spec.traffic(spec.cell(args.workload))["entry"]
    for seed in args.seeds:
        if args.fault:
            with faults.planted(args.fault, entry):
                result, _ = harness.run(args.workload, seed, args.seconds, 0, device=args.device,
                                        spec=spec)
        else:
            result, _ = harness.run(args.workload, seed, args.seconds, 0, device=args.device,
                                    spec=spec, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "ran": args.fault or "control", "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
