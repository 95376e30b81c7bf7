"""Time variants of the port's table-driven CUDA kernels on one card.

Each variant is a copy of sipp_tpu_torch/csrc/ under sipp_tpu_torch/build/
with one definition replaced, built into a library of its own and run
through the port's own wrappers (ops/miller.py, fexp.py, exp.py):

* ``words``: csrc/ as it is;
* ``bytes``: copy_table (bn254.cuh) moves every table a byte a thread, as
  the port did before K7's redesign, instead of a 32-bit word (K1 and K7
  copy K1's tables, K2 and K8 K2's);
* ``window1``: K8 (exp.cu) with FQ12_EXP_WINDOW 1, the TPU kernel's
  square-and-multiply, instead of its fixed window;
* ``fq_pr7``: K0 (fq.cu) launching PR 7's kernel (one thread an element
  reading its own 16 + 16 int64 limbs, 128 elements a block) instead of the
  shared-memory tile, called through PR 7's wrapper (fq_mul_pr7 below):
  the "before" of K0's redesign;
* ``tile256``: K0 with tiles of 256 elements (8 warps a block) instead of
  32 (a warp), the larger tile that a large B might have wanted;
* ``chunk2``, ``chunk8``, ``chunk16``: X2 (msm.cu) with MSM_CHUNK 2, 8 or
  16 lanes a group in its chunk launch instead of 4 (the wrapper reads the
  partials' count from the variant's own library);
* ``x1_r254``: X1 (validate.cu) as [r]Q == O, the complete-add ladder over
  r's 254 bits and no endomorphism test after it, instead of the test over
  x0's 63 bits: the "before" of X1's redesign (its first doubling, of
  infinity, skipped as the new chain skips it).

The chosen variants (all by default) run in turns, in order and then in
reverse (words, bytes, ..., chunk16, chunk16, ..., bytes, words), on the
same inputs: K0 at B = 4096 (random_batch, seed 1177) and B = 2^20
(uniform_batch), K1 at the aggregation's 128 lanes (seed 1177), K2 at B = 1,
K7 on the loop's first carry for digits 0 and 1, K8 on 14 lanes of
seeded Fq12 values off the cyclotomic subgroup with seeded 254-bit
exponents, X2 over the seed-1177 instance's A and B at n = 4096 and
their first 128 lanes, and X1 over that B and its first 128 lanes.
Every output is compared with the plain version (tolerance 0).
A time is read as chip_smoke.py reads it: ``ms`` by CUDA events around one
wrapper call, ``device_ms`` over launches queued behind a sleep.  With
``words`` and ``fq_pr7`` both chosen, K0's wrapper split follows: the
microseconds a call of each step of PR 7's wrapper (on fq_pr7's library)
and of ops/fq.py's (on words'), 1,000 calls a step at B = 4096.

    python3 tools/chip_variants.py [--variants NAME ...] [--out FILE]

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
from sipp_tpu_torch import params  # noqa: E402  (r for x1_r254)

SEED = 1177
N = 128
K8_LANES = 14
SPLIT_CALLS = 1000      # calls a step of K0's wrapper split
# K0 as PR 7 left it: one thread an element (sipp_fq_mul's first statement
# launches it, so the tile kernel below it is never reached)
FQ_PR7 = """
__global__ void __launch_bounds__(128)
fq_mul_pr7_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
                  long long* __restrict__ out, int n) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Fq x, y;
    fq_load(x, a + (size_t)e * 16);
    fq_load(y, b + (size_t)e * 16);
    fq_mul(x, x, y);
    fq_store(out + (size_t)e * 16, x);
}

"""
# r's bits for x1_r254, MSB first, in place of x0's
X1_R_BIT = f"""static __constant__ uint32_t R_WORDS[8] = {{{", ".join(
    f"0x{(params.R >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8))}}};
static __device__ __forceinline__ bool x_bit(int i) {{
    const int k = {params.R.bit_length() - 1} - i;
    return (R_WORDS[k / 32] >> (k % 32)) & 1;
}}"""
PATCHES = {
    "words": [],
    "bytes": [("bn254.cuh", "if (sizeof(T) % 4 == 0 && ", "if (false && ")],
    "window1": [("exp.cu", "#define FQ12_EXP_WINDOW 4\n", "#define FQ12_EXP_WINDOW 1\n")],
    "fq_pr7": [("fq.cu", "// An empty launch:", FQ_PR7 + "// An empty launch:"),
               ("fq.cu", "    const cudaStream_t s = (cudaStream_t)stream;\n",
                "    const cudaStream_t s = (cudaStream_t)stream;\n"
                "    fq_mul_pr7_kernel<<<(n + 127) / 128, 128, 0, s>>>(\n"
                "        (const long long*)a, (const long long*)b, (long long*)out, n);\n"
                "    return (int)cudaGetLastError();\n")],
    "tile256": [("fq.cu", "#define FQ_MUL_TILE 32 ", "#define FQ_MUL_TILE 256 ")],
    **{f"chunk{c}": [("msm.cu", "#define MSM_CHUNK 4 ", f"#define MSM_CHUNK {c} ")]
       for c in (2, 8, 16)},
    "x1_r254": [("validate.cu", "static __device__ __forceinline__ bool x_bit(int i) {      "
                 "// MSB first\n    return (BN_X >> (BN_X_NBITS - 1 - i)) & 1;\n}", X1_R_BIT),
                ("validate.cu", "i < BN_X_NBITS;", f"i < {params.R.bit_length()};"),
                ("validate.cu", "    if (sub == 0) {\n        S[0][0] = L.X;",
                 "    if (sub == 0 && live)\n        out[lane] = fq2_is_zero(L.Z) || "
                 "(fq2_is_zero(L.hx) && fq2_is_zero(L.hy));\n    return;\n"
                 "    if (sub == 0) {\n        S[0][0] = L.X;")],
}
KERNELS = ("miller_product_kernel", "final_exp_kernel", "miller_step_kernel",
           "fq12_exp_kernel", "fq_mul", "msm_sum_kernel", "g2_torsion_kernel")


def fq_mul_pr7(a, b):
    """K0's wrapper as PR 7 left it (ops/fq.py before its host work was
    cut): two check_cuda_input calls, a device context, the stream of the
    tensor's device; it counts no launch."""
    import torch
    from sipp_tpu_torch.fields import FQ
    from sipp_tpu_torch.ops import _build

    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != FQ.L or a.shape[0] < 1:
        raise ValueError("fq_mul_pr7: expected two (B, 16) tensors")
    if a.device.type != "cuda":
        raise ValueError(f"fq_mul_pr7: unsupported device {a.device}")
    a = _build.check_cuda_input(a, "a", (FQ.L,))
    b = _build.check_cuda_input(b, "b", (FQ.L,), a.device)
    lib = _build.cuda_library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.sipp_fq_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], stream)
    _build.check_launch(lib, err, "fq_mul")
    return out


def wrapper_split(a, b, lib_pr7, lib_now, calls=SPLIT_CALLS):
    """Microseconds a call of each step of K0's wrappers, PR 7's
    (fq_mul_pr7, launching from lib_pr7) and ops/fq.py's (fq.fq_mul, from
    lib_now), each step alone over `calls` calls on the host clock, the
    card synchronized before and after; the launches' own steps enqueue
    the kernel on the current stream."""
    import time

    import torch
    from sipp_tpu_torch.ops import _build, fq

    dev = a.device
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "shape_checks": lambda: (a.shape != b.shape or a.dim() != 2 or a.shape[1] != 16
                                 or a.shape[0] < 1 or a.device.type != "cuda"),
        "check_cuda_input_a": lambda: _build.check_cuda_input(a, "a", (16,)),
        "check_cuda_input_b": lambda: _build.check_cuda_input(b, "b", (16,), dev),
        "cuda_library": _build.cuda_library,
        "empty_like": lambda: torch.empty_like(a),
        "pr7_device_context": device_context,
        "pr7_current_stream_of_device": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_call_and_launch": lambda: lib_now.sipp_fq_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], stream),
        "check_launch": lambda: _build.check_launch(lib_now, 0, "fq_mul"),
        "now_aligned_operands": lambda: (fq._operand(a), fq._operand(b)),
        "now_current_device": torch.cuda.current_device,
        "now_raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "wrapper_pr7": lambda: fq_mul_pr7(a, b),
        "wrapper_now": lambda: fq.fq_mul(a, b),
    }
    library = {"wrapper_pr7": lib_pr7, "wrapper_now": lib_now}
    build = _build.cuda_library
    split = {}
    try:
        for name, fn in steps.items():
            if name in library:
                _build.cuda_library = lambda lib=library[name]: lib
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            split[name] = (time.perf_counter() - t) / calls * 1e6
            torch.cuda.synchronize()
    finally:
        _build.cuda_library = build
    return split


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
    parser.add_argument("--variants", nargs="+", choices=list(PATCHES), default=list(PATCHES),
                        help="the variants to build and time (default: all)")
    args = parser.parse_args()
    turns = args.variants + args.variants[::-1]
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: torch.cuda.is_available() is False; this needs a GPU")
    from sipp_tpu_torch.fields import tower
    from sipp_tpu_torch.curves import scalar_to_bits
    from sipp_tpu_torch.curves import G1, G2
    from sipp_tpu_torch.ops import _build, exp, fexp, fq, miller, msm
    from sipp_tpu_torch.ops import validate as x1
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
    for name in args.variants:
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
    x2 = dict(zip(("msm_sum_g1", "msm_sum_g2"), random_instance(4096, seed=SEED, device=dev)))
    k0 = {"fq_mul_n4096": fq.random_batch(4096, SEED, dev),
          "fq_mul_n1048576": fq.uniform_batch(1 << 20, SEED, dev)}

    def k0_case(x, y):
        """K0 through the wrapper of the variant's time: PR 7's for fq_pr7."""
        return (lambda: (fq_mul_pr7 if name == "fq_pr7" else fq.fq_mul)(x, y),
                lambda: fq.fq_mul_plain(x, y))

    cases = {
        **{name: k0_case(*xy) for name, xy in k0.items()},
        "miller_product": (lambda: miller.miller_product(a, b), lambda: f_one),
        "final_exp_b1": (lambda: fexp.final_exp(f_one[None]),
                         lambda: fexp.final_exp_plain(f_one[None])),
        "miller_step_d0": (lambda: miller.miller_step(0, b, qn0, a, f0, t0),
                           lambda: miller.miller_step_plain(0, b, qn0, a, f0, t0)),
        "miller_step_d1": (lambda: miller.miller_step(1, b, qn0, a, f0, t0),
                           lambda: miller.miller_step_plain(1, b, qn0, a, f0, t0)),
        "fq12_exp_n14": (lambda: exp.fq12_exp(x8, off8, bits8),
                         lambda: exp.fq12_exp_plain(x8, off8, bits8)),
        **{f"{name}_n{n}": (lambda fn=getattr(msm, name), x=x[:n]: fn(x),
                            lambda curve=G2 if name.endswith("2") else G1, x=x[:n]:
                            msm.msm_finish_plain(curve, x))
           for name, x in x2.items() for n in (4096, N)},
        **{f"g2_torsion_n{n}": (lambda x=x2["msm_sum_g2"][:n]: x1.g2_torsion(x),
                                lambda x=x2["msm_sum_g2"][:n]: x1.g2_torsion_plain(x))
           for n in (4096, N)},
    }
    want = {case: plain() for case, (_, plain) in cases.items()}

    def flat(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    ok = True
    try:
        for turn, name in enumerate(turns):
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
    if "fq_pr7" in libs and "words" in libs:
        emit({"wrapper_split_us": wrapper_split(*k0["fq_mul_n4096"], libs["fq_pr7"],
                                                libs["words"]),
              "calls": SPLIT_CALLS, "batch": 4096})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    print(smi, flush=True)
    if not ok:
        raise SystemExit("a variant disagrees with its plain version")


if __name__ == "__main__":
    main()
