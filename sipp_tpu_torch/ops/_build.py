"""Build the port's native code at first use, cached by content hash.

Two libraries, both plain C interfaces loaded with ctypes:

* the CUDA kernels (K0 batched Fq multiply, K1 Miller product, K2 final
  exponentiation, K3 fold ladders, K4/K5 transcript tail, K6 per-lane exp
  ladders, K7 Miller step, K8 per-lane Fq12 exp, X1 G2 r-torsion verdicts,
  X2 the sum of the MSM finals' lanes):
  sipp_tpu_torch/csrc/*.cu with their headers, compiled by nvcc for sm_90a,
  one nvcc process per source, all started together, then linked; with
  three generated headers of constants derived from params/hostref,
  fields/poseidon and ops/schedule (so no constant or schedule table is
  typed by hand in the CUDA sources, and a SIPP_POSEIDON_RC_FILE table
  builds its own library);
* the host library of the repo's csrc/ (Poseidon transcript chain, Fq12
  pow/mul), compiled by g++ (see native.py).

Outputs go to sipp_tpu_torch/build/ (listed in .gitignore) under a name that
hashes the compiler command and every input's content; a finished library is
moved into place atomically, so concurrent builders never load a partial
file.  A failed build raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "build"
CUDA_SRC = PKG / "csrc"
CUDA_SOURCES = ("miller.cu", "fexp.cu", "fold.cu", "transcript.cu", "exp.cu", "fq.cu",
                "validate.cu", "msm.cu")
CUDA_HEADERS = ("bn254.cuh", "fq12_table.cuh", "ladder.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# filled by cuda_library(): wall seconds of the call (near 0 when the
# library was already built) and the compiler's report (ptxas registers,
# stack and spills per kernel; empty when cached)
BUILD_INFO = {}


def _digest(parts) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else str(part).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def compile_shared(tag: str, cmd: list, sources: list):
    """Compile `sources` with `cmd` (+ -o OUT) into BUILD_DIR, unless a
    library of identical inputs is already there.  Returns (path, log)."""
    key = _digest([*cmd, *(pathlib.Path(s).read_bytes() for s in sources)])
    out = BUILD_DIR / f"lib{tag}_{key}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {tag} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


# ------------------------------------------------------ generated constants

def _words(x: int, n: int = 8):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _arr(name: str, ctype: str, dims: str, flat, align: int = 0) -> str:
    fmt = {"uint32_t": "0x{:08x}u", "uint64_t": "0x{:016x}ull"}.get(ctype, "{}")
    body = ", ".join(fmt.format(v) for v in flat)
    prefix = f"__align__({align}) " if align else ""
    return f"{prefix}static __constant__ {ctype} {name}{dims} = {{{body}}};\n"


def params_header() -> str:
    """BN254 constants for the kernels, in 8 x 32-bit little-endian words,
    Montgomery form (R = 2^256) where they are field elements."""
    from .. import hostref, params
    from ..fields import tower
    from ..pairing.ate import TAPE
    from .miller import BLOCK, PARTIAL_LIMBS

    P, R = params.P, 1 << 256

    def mont(v):
        return _words(v * R % P)

    lines = ["// Generated by sipp_tpu_torch/ops/_build.py from params/hostref.",
             "#pragma once", "#include <cstdint>"]
    for i, w in enumerate(_words(P)):
        lines.append(f"#define BN_P{i} 0x{w:08x}u")
    lines.append(f"#define BN_N0 0x{(-pow(P, -1, 1 << 32)) % (1 << 32):08x}u")
    for i, w in enumerate(mont(1)):
        lines.append(f"#define BN_ONE{i} 0x{w:08x}u")
    lines.append(f"#define BN_X 0x{params.X:016x}ull")
    lines.append(f"#define BN_X_NBITS {params.X.bit_length()}")
    naf = list(reversed(params.ATE_NAF[:-1]))
    lines.append(f"#define BN_NAF_LEN {len(naf)}")
    lines.append(f"#define BN_TAPE_LEN {len(TAPE)}")
    lines.append(f"#define MILLER_BLOCK_LANES {BLOCK}")
    lines.append(f"#define MILLER_PARTIAL_LIMBS {PARTIAL_LIMBS}")
    text = "\n".join(lines) + "\n"
    text += _arr("BN_PM2", "uint32_t", "[8]", _words(P - 2))
    text += _arr("BN_NAF", "signed char", f"[{len(naf)}]", naf)
    text += _arr("BN_TWF", "uint32_t", "[2][2][8]",
                 [w for c in (hostref.TWIST_FROB_X, hostref.TWIST_FROB_Y)
                  for v in c for w in mont(v)])
    # FROB[k-1][i*3+j] multiplies sigma^k of coefficient (w^i v^j)
    text += _arr("BN_FROB", "uint32_t", "[3][6][2][8]",
                 [w for k in (1, 2, 3) for c in tower.frob_consts_ints(k)
                  for v in c for w in mont(v)])
    text += _arr("BN_TAPE", "signed char", f"[{len(TAPE)}][4]",
                 [v for row in TAPE for v in row])
    return text


def transcript_header() -> str:
    """Constants of the transcript kernels: Goldilocks (canonical u64, with
    2^80 mod p and its inverse for the (4, 5) Montgomery state format), the
    Poseidon tables of fields/poseidon.py, and r in 8 x 32-bit words with
    N' = -r^-1 mod 2^32 and R^2 mod r (R = 2^256)."""
    from .. import params
    from ..fields import poseidon

    G, R = params.GOLDILOCKS_P, params.R
    lines = ["// Generated by sipp_tpu_torch/ops/_build.py from params and "
             "fields/poseidon.", "#pragma once", "#include <cstdint>",
             f"#define GL_P 0x{G:016x}ull",
             f"#define GL_EPS 0x{(1 << 64) - G:016x}ull",
             f"#define GL_R80 0x{(1 << 80) % G:016x}ull",
             f"#define GL_RINV 0x{pow(1 << 80, -1, G):016x}ull",
             f"#define PSD_W {poseidon.WIDTH}", f"#define PSD_RATE {poseidon.RATE}",
             f"#define PSD_N_FULL {poseidon.N_FULL}",
             f"#define PSD_N_PARTIAL {poseidon.N_PARTIAL}",
             f"#define PSD_ROUNDS {poseidon.N_ROUNDS}",
             f"#define FR_N0 0x{(-pow(R, -1, 1 << 32)) % (1 << 32):08x}u"]
    lines += [f"#define FR_P{i} 0x{w:08x}u" for i, w in enumerate(_words(R))]
    text = "\n".join(lines) + "\n"
    text += _arr("FR_R2", "uint32_t", "[8]", _words((1 << 512) % R))
    text += _arr("PSD_RC", "uint64_t", f"[{poseidon.N_ROUNDS * poseidon.WIDTH}]",
                 [c for row in poseidon.ROUND_CONSTANTS for c in row])
    text += _arr("PSD_MDS", "uint32_t", f"[{poseidon.WIDTH ** 2}]",
                 [v for row in poseidon.MDS for v in row])
    return text


def schedule_header() -> str:
    """The schedules of ops/schedule.py: K2's (per operation, the Fq2
    products' input masks and each output's linear form: source,
    coefficient, power of xi, padded with coefficient 0; the x-power's
    product tree over the stored squarings) and K1's (the slots, the
    Miller operations' tables and the program) with K7's per-digit
    programs."""
    from . import schedule as S

    ops = S.OPS
    pad = (0, 0, 0)
    lines = ["// Generated by sipp_tpu_torch/ops/_build.py from ops/schedule.py.",
             "#pragma once", f"#define SCHED_N_PROD {S.N_PROD}",
             f"#define SCHED_INPUT {S.INPUT}", f"#define SCHED_MAX_TERMS {S.MAX_TERMS}",
             f"#define SCHED_N_OPS {len(ops)}",
             f"#define POWX_LEVELS {len(S.POWX_TREE)}", f"#define POWX_OUT {S.POWX_OUT}"]
    lines += [f"#define OP_{op.name.upper()} {i}" for i, op in enumerate(ops)]
    text = "\n".join(lines) + "\n"
    text += _arr("OP_NPROD", "unsigned char", f"[{len(ops)}]", [len(op.xmask) for op in ops])
    text += _arr("OP_NOUT", "unsigned char", f"[{len(ops)}]", [len(op.terms) for op in ops])
    for name in ("xmask", "ymask"):
        text += _arr(f"OP_{name.upper()}", "unsigned char", f"[{len(ops)}][{S.N_PROD}]",
                     [m for op in ops for m in list(getattr(op, name))
                      + [0] * (S.N_PROD - len(op.xmask))])
    # (16-byte aligned: whole 32-bit words, which copy_table moves a word at a time)
    text += _arr("OP_TERMS", "signed char", f"[{len(ops)}][6][{S.MAX_TERMS}][3]",
                 [v for op in ops for q in range(6)
                  for t in (list(op.terms[q]) if q < len(op.terms) else [])
                  + [pad] * (S.MAX_TERMS - (len(op.terms[q]) if q < len(op.terms) else 0))
                  for v in t], 16)
    # K1's Miller program: operand terms as slot | 0x40 (times xi) | 0x80
    # (negated), 0xFF-padded; forms as (source, coefficient, xi power),
    # padded with coefficient 0; the operations' tables 16-byte aligned
    # (whole 32-bit words, which copy_table moves a word at a time)
    mops = S.M_OPS
    text += "".join(f"#define MS_{name} {i}\n" for i, name in enumerate(S.SLOTS))
    text += "".join(f"#define MOP_{op.name.upper()} {i}\n" for i, op in enumerate(mops))
    text += (f"#define MILLER_NSLOT {len(S.SLOTS)}\n#define MOP_N_OPS {len(mops)}\n"
             f"#define MOP_MAX_PROD {S.M_PROD}\n#define MOP_OPND {S.M_OPND}\n"
             f"#define MOP_SPLIT2 {S.M_SPLIT2}\n#define MOP_MAX_OUT {S.M_MAX_OUT}\n"
             f"#define MOP_MAX_TERMS {S.M_MAX_TERMS}\n#define MILLER_PROG_LEN {len(S.PROGRAM)}\n")
    text += _arr("MOP_NPROD", "unsigned char", f"[{len(mops)}]", [len(op.x) for op in mops], 16)
    text += _arr("MOP_NOUT", "unsigned char", f"[{len(mops)}]", [len(op.dst) for op in mops], 16)
    for name in ("x", "y"):
        text += _arr(f"MOP_{name.upper()}", "unsigned char",
                     f"[{len(mops)}][{S.M_PROD}][{S.M_OPND}]",
                     [b for op in mops for k in range(S.M_PROD)
                      for b in _operand_bytes(getattr(op, name), k, S.M_OPND)], 16)
    text += _arr("MOP_DST", "unsigned char", f"[{len(mops)}][{S.M_MAX_OUT}]",
                 [d for op in mops for d in list(op.dst) + [0] * (S.M_MAX_OUT - len(op.dst))], 16)
    text += _arr("MOP_TERMS", "signed char",
                 f"[{len(mops)}][{S.M_MAX_OUT}][{S.M_MAX_TERMS}][3]",
                 [v for op in mops for j in range(S.M_MAX_OUT)
                  for t in (list(op.terms[j]) if j < len(op.terms) else [])
                  + [pad] * (S.M_MAX_TERMS - (len(op.terms[j]) if j < len(op.terms) else 0))
                  for v in t], 16)
    text += _arr("MILLER_PROG", "unsigned char", f"[{len(S.PROGRAM)}][3]",
                 [v for name, addend in S.PROGRAM
                  for v in (S.M_OP_ID[name], *((S.SLOT[a] for a in addend) if addend
                                               else (0xFF, 0xFF)))])
    # K7's per-digit programs: operation ids, 0xFF-padded
    steps = max(len(prog) for prog in S.STEP_PROGRAM)
    text += _arr("STEP_LEN", "unsigned char", f"[{len(S.STEP_PROGRAM)}]",
                 [len(prog) for prog in S.STEP_PROGRAM])
    text += _arr("STEP_PROG", "unsigned char", f"[{len(S.STEP_PROGRAM)}][{steps}]",
                 [v for prog in S.STEP_PROGRAM
                  for v in [S.M_OP_ID[name] for name in prog] + [0xFF] * (steps - len(prog))])
    width = max(len(level) for level in S.POWX_TREE)
    text += _arr("POWX_N", "unsigned char", f"[{len(S.POWX_TREE)}]",
                 [len(level) for level in S.POWX_TREE])
    text += _arr("POWX_PAIRS", "unsigned char", f"[{len(S.POWX_TREE)}][{width}][2]",
                 [v for level in S.POWX_TREE
                  for pair in list(level) + [(0, 0)] * (width - len(level)) for v in pair])
    return text


def _operand_bytes(operands, k, width):
    """Operand k of a Miller operation as the kernel reads it."""
    terms = operands[k] if k < len(operands) else ()
    return [s | 0x40 * xi | 0x80 * neg for s, xi, neg in terms] + [0xFF] * (width - len(terms))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_cuda(cmd: list, inc: pathlib.Path, key: str, src: pathlib.Path) -> tuple:
    """One nvcc -c per source of `src`, all running at once, then one nvcc
    link."""
    out = BUILD_DIR / f"libsipp_cuda_{key}.so"
    if out.exists():
        return out, ""
    objdir = BUILD_DIR / f"obj_{key}.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [*cmd, f"-I{inc}", f"-I{src}", "-c", "-o", str(objdir / f"{name}.o"),
         str(src / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in CUDA_SOURCES]
    logs, failed = [], []
    for name, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"building {', '.join(failed)} failed:\n" + "\n".join(logs))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run([cmd[0], "-shared", "-o", str(tmp),
                           *(str(objdir / f"{name}.o") for name in CUDA_SOURCES)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the CUDA library failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out, "".join(logs)


@functools.lru_cache(maxsize=None)
def cuda_library(src: pathlib.Path = CUDA_SRC):
    """Build (or find) and load the kernels' shared library from the
    sources in `src` (csrc/, or a variant of it that a tool times)."""
    headers = {"bn254_params.cuh": params_header(),
               "transcript_params.cuh": transcript_header(),
               "schedule_params.cuh": schedule_header()}
    inc = BUILD_DIR / f"include_{_digest(headers.values())}"
    for name, text in headers.items():
        if not (inc / name).exists():
            inc.mkdir(parents=True, exist_ok=True)
            tmp = inc / f"{name}.{os.getpid()}.tmp"
            tmp.write_text(text)
            os.replace(tmp, inc / name)
    t0 = time.time()
    cmd = [_nvcc(), *NVCC_FLAGS]
    key = _digest([*cmd, *headers.values(),
                   *((src / f).read_bytes() for f in CUDA_SOURCES + CUDA_HEADERS)])
    path, log = _build_cuda(cmd, inc, key, src)
    BUILD_INFO.update(seconds=time.time() - t0, log=log, path=str(path))
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, args in {
        "sipp_miller_product": [vp, vp, vp, vp, ci, ci, vp],
        "sipp_miller_step": [ci, vp, vp, vp, vp, vp, vp, vp, ci, vp],
        "sipp_final_exp": [vp, vp, ci, vp],
        "sipp_fold_g1": [vp, vp, vp, vp, ci, vp],
        "sipp_fold_g2": [vp, vp, vp, vp, ci, vp],
        "sipp_transcript_append_fq12": [vp, vp, vp, vp],
        "sipp_transcript_round_tail": [vp, vp, vp, vp, vp, vp, vp],
        "sipp_digest_to_challenge": [vp, vp, ci, vp],
        "sipp_fr_inverse": [vp, vp, ci, vp],
        "sipp_transcript_probe": [vp, ci, vp, ci, vp],
        "sipp_exp_g1": [vp, vp, vp, vp, ci, vp],
        "sipp_exp_g2": [vp, vp, vp, vp, ci, vp],
        "sipp_fq12_exp": [vp, vp, vp, vp, ci, vp],
        "sipp_fq_mul": [vp, vp, vp, ci, vp],
        "sipp_fq_mul_probe": [vp, vp, ci, vp],
        "sipp_g2_torsion": [vp, vp, ci, vp],
        "sipp_msm_blocks": [ci],
        "sipp_msm_sum_g1": [vp, vp, vp, ci, vp],
        "sipp_msm_sum_g2": [vp, vp, vp, ci, vp],
        "sipp_empty_launch": [vp],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ci
    lib.sipp_cuda_error_string.argtypes = [ci]
    lib.sipp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib, err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.sipp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def check_cuda_input(x, name: str, shape_tail: tuple, device=None):
    """Kernel inputs: contiguous int64 tensors with the given trailing shape,
    on `device` when one is given."""
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: expected torch.int64 limbs, got {x.dtype}")
    if tuple(x.shape[-len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name}: expected trailing shape {shape_tail}, got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    return x.contiguous()
