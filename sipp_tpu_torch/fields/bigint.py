"""Host-side codecs between Python ints and little-endian 16-bit limb arrays.

Carried over unchanged from sipp_tpu/fields/bigint.py.  The reference device
format of a field element is a little-endian vector of L 16-bit limbs stored
in uint32 (the port holds the same limbs in int64 tensors).  These helpers
convert between that representation and Python ints / u32-digit lists on the
host, and are also used by the statement codec (the Rust statements.rs:90-131
uses 8 u32 limbs per Fq; here an Fq is 16 x 16-bit limbs in a tensor and
8 x u32 limbs on the wire).
"""

import numpy as np

MASK16 = 0xFFFF


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Python int -> little-endian 16-bit limbs as uint32 array of shape (num_limbs,)."""
    assert x >= 0
    out = np.empty(num_limbs, dtype=np.uint32)
    for i in range(num_limbs):
        out[i] = x & MASK16
        x >>= 16
    assert x == 0, "value does not fit in num_limbs 16-bit limbs"
    return out


def limbs_to_int(limbs) -> int:
    """Little-endian 16-bit limb array -> Python int."""
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << 16) | int(arr[..., i])
    return x


def ints_to_limbs(xs, num_limbs: int) -> np.ndarray:
    """List of ints -> (len(xs), num_limbs) uint32 array."""
    return np.stack([int_to_limbs(x, num_limbs) for x in xs])


def limbs_to_ints(arr) -> list:
    """(..., num_limbs) array -> nested list of Python ints over leading dims."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        return limbs_to_int(arr)
    return [limbs_to_ints(a) for a in arr]


def limbs16_to_ints_fast(arr) -> list:
    """(..., L) uint32 array of 16-bit limbs -> FLAT list of Python ints.

    Vectorized via one tobytes() + int.from_bytes per element (no per-limb
    Python shifts): the config-5 prologue decodes ~4*10^5 Fq elements, where
    the per-limb loop of limbs_to_ints costs minutes and this costs ~100 ms.
    """
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32).astype("<u2"))
    flat = a.reshape(-1, a.shape[-1])
    w = flat.shape[-1] * 2
    buf = flat.tobytes()
    return [int.from_bytes(buf[i * w:(i + 1) * w], "little")
            for i in range(flat.shape[0])]


def ints_to_u32x8_array(vals) -> np.ndarray:
    """ints < 2^256 -> (len(vals), 8) uint64 array of little-endian u32
    digits — the transcript element encoding (transcript_native.rs:68-77),
    built in bulk for the 2n-append prologue."""
    b = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(b, dtype="<u4").reshape(len(vals), 8).astype(np.uint64)


def int_to_u32_digits(x: int, num_digits: int) -> list:
    """Python int -> fixed-length little-endian u32 digit list (wire format,
    reference transcript_native.rs:68-77: 8 u32 digits per Fq)."""
    out = []
    for _ in range(num_digits):
        out.append(x & 0xFFFFFFFF)
        x >>= 32
    assert x == 0
    return out


def u32_digits_to_int(digits) -> int:
    x = 0
    for d in reversed(list(digits)):
        x = (x << 32) | int(d)
    return x
