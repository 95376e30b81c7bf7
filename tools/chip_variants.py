"""Time variants of the port's table-driven CUDA kernels on one card.

Each variant is a copy of sipp_tpu_torch/csrc/ under sipp_tpu_torch/build/
with one definition replaced, built into a library of its own and run
through the port's own wrappers (ops/miller.py, fexp.py, exp.py):

* ``words``: csrc/ as it is;
* ``bytes``: copy_table (bn254.cuh) moves every table a byte a thread, as
  the port did before K7's redesign, instead of a 32-bit word (K1 and K7
  copy K1's tables, K2 and K8 K2's);
* ``window1``: K8 (exp.cu) with FQ12_EXP_WINDOW 1, the TPU kernel's
  square-and-multiply, instead of its fixed window.

The variants run in turns (words, bytes, window1, window1, bytes, words) on
the same inputs: K1 at the aggregation's 128 lanes (seed 1177), K2 at B = 1,
K7 on the loop's first carry for digits 0 and 1, and K8 on 14 lanes of
seeded Fq12 values off the cyclotomic subgroup with seeded 254-bit
exponents.  Every output is compared with the plain version (tolerance 0).
A time is read as chip_smoke.py reads it: ``ms`` by CUDA events around one
wrapper call, ``device_ms`` over launches queued behind a sleep.

    python3 tools/chip_variants.py [--out FILE]

Needs a CUDA card and nvcc; prints one JSON line per variant (its ptxas
lines) and per (turn, variant, case), then the card's name and power limit.
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the timing helpers and the ptxas parser)

SEED = 1177
N = 128
K8_LANES = 14
PATCHES = {
    "words": [],
    "bytes": [("bn254.cuh", "if (sizeof(T) % 4 == 0 && ", "if (false && ")],
    "window1": [("exp.cu", "#define FQ12_EXP_WINDOW 4\n", "#define FQ12_EXP_WINDOW 1\n")],
}
TURNS = ["words", "bytes", "window1", "window1", "bytes", "words"]
KERNELS = ("miller_product_kernel", "final_exp_kernel", "miller_step_kernel",
           "fq12_exp_kernel")


def variant_source(name):
    """csrc/ with the variant's replacements, under sipp_tpu_torch/build/."""
    from sipp_tpu_torch.ops import _build

    dst = _build.BUILD_DIR / f"variant_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CUDA_SRC, dst)
    for fname, old, new in PATCHES[name]:
        text = (dst / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} is not once in {fname}")
        (dst / fname).write_text(text.replace(old, new))
    return dst


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=pathlib.Path, default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is False; this needs a GPU")
    from sipp_tpu_torch import params
    from sipp_tpu_torch.fields import tower
    from sipp_tpu_torch.curves import scalar_to_bits
    from sipp_tpu_torch.ops import _build, exp, fexp, miller
    from sipp_tpu_torch.pairing import ate
    from sipp_tpu_torch.utils.testing import random_instance

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sleep_cycles = int(chip_smoke.SLEEP_MS * sm_mhz * 1e3)
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    build = _build.cuda_library
    libs = {}
    for name in PATCHES:
        libs[name] = build(variant_source(name))
        ptxas = chip_smoke.ptxas_entries(_build.BUILD_INFO["log"])
        emit({"variant": name, "build_s": _build.BUILD_INFO["seconds"],
              "ptxas": {k: v for k, v in ptxas.items() if any(s in k for s in KERNELS)}})

    a, b = random_instance(N, seed=SEED, device=dev)
    f_one = miller.miller_product_plain(a, b)
    f0, t0, qn0 = ate.miller_start(a, b)
    f0 = f0.contiguous()
    rng = np.random.default_rng(SEED)
    v = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12 * K8_LANES)]
    x8 = tower.fq12_encode([tuple(tuple((v[12 * e + 6 * i + 2 * j], v[12 * e + 6 * i + 2 * j + 1])
                                        for j in range(3)) for i in range(2))
                            for e in range(K8_LANES)]).to(dev)
    off8 = torch.roll(x8, 1, 0).contiguous()
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(K8_LANES)]
    bits8 = torch.as_tensor(np.stack([scalar_to_bits(k) for k in ks], 1).astype(np.int64),
                            device=dev)
    cases = {
        "miller_product": (lambda: miller.miller_product(a, b), lambda: f_one),
        "final_exp_b1": (lambda: fexp.final_exp(f_one[None]),
                         lambda: fexp.final_exp_plain(f_one[None])),
        "miller_step_d0": (lambda: miller.miller_step(0, b, qn0, a, f0, t0),
                           lambda: miller.miller_step_plain(0, b, qn0, a, f0, t0)),
        "miller_step_d1": (lambda: miller.miller_step(1, b, qn0, a, f0, t0),
                           lambda: miller.miller_step_plain(1, b, qn0, a, f0, t0)),
        "fq12_exp_n14": (lambda: exp.fq12_exp(x8, off8, bits8),
                         lambda: exp.fq12_exp_plain(x8, off8, bits8)),
    }
    want = {case: plain() for case, (_, plain) in cases.items()}

    def flat(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    ok = True
    try:
        for turn, name in enumerate(TURNS):
            _build.cuda_library = lambda: libs[name]
            for case, (kern, _) in cases.items():
                got = flat(kern())
                equal = all(torch.equal(g, w) for g, w in zip(got, flat(want[case])))
                ok = ok and equal
                emit({"turn": turn, "variant": name, "case": case, "bit_equal": equal,
                      "ms": chip_smoke.kernel_ms(kern),
                      "device_ms": chip_smoke.device_ms(kern, sleep_cycles)})
    finally:
        _build.cuda_library = build
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    print(smi, flush=True)
    if not ok:
        raise SystemExit("a variant disagrees with its plain version")


if __name__ == "__main__":
    main()
