"""ctypes loader for the repo's host C++ library (csrc/sipp_host.cpp +
csrc/bn254.cpp): the Poseidon-Goldilocks transcript chain and single-element
Fq12 pow/mul (the verifier's Z' chain).

The sources are the JAX package's own, unchanged; the port builds them with
g++ into sipp_tpu_torch/build/ (ops/_build.py) and injects the Poseidon
constants from fields/poseidon.py and the BN254 constants from
params/hostref, exactly as sipp_tpu/native.py does.  The library is
required: get_lib() raises if it cannot be built.  The pure-Python Poseidon
is its test oracle, and the transcript's engine when SIPP_TPU_NO_NATIVE is
set (enabled()).  The numpy codecs at the end need no library.
"""

import ctypes
import functools
import os
import pathlib
import shutil

import numpy as np

from . import hostref, params
from .fields import poseidon
from .ops import _build

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _ptr(arr):
    return arr.ctypes.data_as(_U64P)


def _limbs64(x, n=4):
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def enabled() -> bool:
    """False when SIPP_TPU_NO_NATIVE is set to a non-empty value, as the JAX
    package reads it; read on every call.  Then the transcript runs the
    pure-Python Poseidon and the verifier computes its Z' chain on the
    device (K8).  An explicit opt-in, not a fallback: with it unset the
    library is used, and get_lib() raises when it cannot be built."""
    return not os.environ.get("SIPP_TPU_NO_NATIVE")


@functools.lru_cache(maxsize=None)
def get_lib():
    sources = [CSRC / "sipp_host.cpp", CSRC / "bn254.cpp"]
    if not all(s.exists() for s in sources):
        raise RuntimeError(f"the host library's sources are missing from {CSRC}: "
                           "the port runs from a checkout of the repo, whose csrc/ "
                           "it builds")
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build csrc/ (g++)")
    path, _ = _build.compile_shared(
        "sipp_host",
        [cxx, "-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"], sources)
    lib = ctypes.CDLL(str(path))
    sz = ctypes.c_size_t
    for name, args in {
        "sipp_set_constants": [_U64P, _U64P],
        "sipp_hash_no_pad": [_U64P, sz, _U64P],
        "sipp_transcript_absorb": [_U64P, _U64P, ctypes.POINTER(sz), sz],
        "sipp_bn254_init": [_U64P, ctypes.c_uint64, _U64P, _U64P, _U64P,
                            ctypes.c_uint64],
        "sipp_fq12_mul": [_U64P] * 3,
        "sipp_fq12_pow": [_U64P] * 3,
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None

    rc = np.asarray(poseidon.ROUND_CONSTANTS, dtype=np.uint64).ravel()
    mds = np.asarray(poseidon.MDS, dtype=np.uint64).ravel()
    lib.sipp_set_constants(_ptr(rc), _ptr(mds))

    R = 1 << 256
    p_arr = np.asarray(_limbs64(params.P), dtype=np.uint64)
    n0 = (-pow(params.P, -1, 1 << 64)) % (1 << 64)
    r2 = np.asarray(_limbs64(R * R % params.P), dtype=np.uint64)
    one = np.asarray(_limbs64(R % params.P), dtype=np.uint64)
    # frob[k-1][m][c]: xi^((p^k - 1) m / 6) at position m = 2j+i
    frob = np.zeros((3, 6, 2, 4), dtype=np.uint64)
    for k in (1, 2, 3):
        for m in range(6):
            c = hostref.fq2_pow(params.XI, (params.P**k - 1) * m // 6)
            for u in range(2):
                frob[k - 1, m, u] = _limbs64(c[u] * R % params.P)
    lib.sipp_bn254_init(_ptr(p_arr), n0, _ptr(r2), _ptr(one),
                        _ptr(frob.ravel()), params.X)
    return lib


# ------------------------------------------------------------ transcript

def hash_no_pad(inputs) -> list:
    arr = np.ascontiguousarray(inputs, dtype=np.uint64)
    out = np.zeros(4, dtype=np.uint64)
    get_lib().sipp_hash_no_pad(_ptr(arr), arr.size, _ptr(out))
    return [int(x) for x in out]


def transcript_absorb_flat(state4, flat, lens) -> list:
    """Hash chain over pre-flattened message elements: flat (sum(lens),)
    uint64, lens (num_msgs,)."""
    st = np.array(state4, dtype=np.uint64)
    flat = np.ascontiguousarray(flat, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uintp)
    get_lib().sipp_transcript_absorb(
        _ptr(st), _ptr(flat),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)), len(lens))
    return [int(x) for x in st]


def transcript_absorb(state4, msgs) -> list:
    flat = np.asarray([x for m in msgs for x in m], dtype=np.uint64)
    lens = np.asarray([len(m) for m in msgs], dtype=np.uintp)
    return transcript_absorb_flat(state4, flat, lens)


# --------------------------------------------------------------- Fq12 ops
# Native Fq12 values are (12, 4) uint64 Montgomery limbs (R = 2^256, the
# same radix as the 16-bit limb format, so converting is bit repacking).

def fq12_mul(a, b):
    out = np.zeros((12, 4), dtype=np.uint64)
    get_lib().sipp_fq12_mul(_ptr(np.ascontiguousarray(a, np.uint64)),
                            _ptr(np.ascontiguousarray(b, np.uint64)), _ptr(out))
    return out


def fq12_pow(a, e: int):
    out = np.zeros((12, 4), dtype=np.uint64)
    ev = np.asarray(_limbs64(e), dtype=np.uint64)
    get_lib().sipp_fq12_pow(_ptr(np.ascontiguousarray(a, np.uint64)), _ptr(ev),
                            _ptr(out))
    return out


def fq12_limbs16_to_u64(arr) -> np.ndarray:
    """(..., 2, 3, 2, 16) 16-bit limbs (numpy) -> (..., 12, 4) uint64."""
    a = np.asarray(arr, dtype=np.uint64)
    a = a.reshape(*a.shape[:-4], 12, 4, 4)
    return (a << (np.arange(4, dtype=np.uint64) * np.uint64(16))).sum(
        axis=-1, dtype=np.uint64)


def u64_to_fq12_limbs16(arr) -> np.ndarray:
    """(..., 12, 4) uint64 -> (..., 2, 3, 2, 16) 16-bit limbs (uint32)."""
    a = np.asarray(arr, dtype=np.uint64)[..., None]
    limbs = (a >> (np.arange(4, dtype=np.uint64) * np.uint64(16))) & np.uint64(0xFFFF)
    return limbs.astype(np.uint32).reshape(*a.shape[:-3], 2, 3, 2, 16)


def fq12_u64_to_tower_ints(arr):
    """(12, 4) uint64 Montgomery -> host tower tuple of canonical ints."""
    rinv = pow(1 << 256, -1, params.P)
    flat = [(int(l[0]) | int(l[1]) << 64 | int(l[2]) << 128 | int(l[3]) << 192)
            * rinv % params.P for l in arr]
    return tuple(tuple((flat[6 * i + 2 * j], flat[6 * i + 2 * j + 1])
                       for j in range(3)) for i in range(2))
