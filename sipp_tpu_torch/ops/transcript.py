"""K4 and K5: the on-chip prover's transcript tail (csrc/transcript.cu),
replacing sipp_tpu/ops/pallas_transcript.py:transcript_round_tail and
transcript_append_fq12.

The wrappers launch the kernels for CUDA tensors and run the plain versions
(the chains of protocol/transcript_device.py) for CPU tensors; there is no
other route.  Formats are the JAX package's: the state is (4, 5) Montgomery
Goldilocks limbs, Fq12 values (2, 3, 2, 16) Montgomery limbs, x and x^-1
(16,) canonical Fr limbs.  Bound on the H100 and design: see the note at the
top of csrc/transcript.cu.
"""

import torch

from ..protocol import transcript_device as td
from . import _build

FQ12 = (2, 3, 2, 16)


def transcript_append_fq12_plain(state, f):
    return td.append_fq12(state, f)


def transcript_round_tail_plain(state, zl, zr):
    state = td.append_fq12(td.append_fq12(state, zl), zr)
    _, x = td.get_challenge(state)
    return state, x, td.fr_inverse(x)


def _inputs(state, *fs):
    """Device check; returns the CUDA inputs, or None for CPU tensors."""
    if tuple(state.shape) != (4, 5) or any(tuple(f.shape) != FQ12 for f in fs):
        raise ValueError(f"transcript: expected a (4, 5) state and {FQ12} Fq12 values, "
                         f"got {tuple(state.shape)}, {[tuple(f.shape) for f in fs]}")
    if state.device.type == "cpu":
        return None
    if state.device.type != "cuda":
        raise ValueError(f"transcript: unsupported device {state.device}")
    return (_build.check_cuda_input(state, "state", (4, 5)),
            *(_build.check_cuda_input(f, "f", FQ12, state.device) for f in fs))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def transcript_append_fq12(state, f):
    """state' = hash_no_pad(state || the 96-element encoding of f)."""
    args = _inputs(state, f)
    if args is None:
        return transcript_append_fq12_plain(state, f)
    lib = _build.cuda_library()
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        err = lib.sipp_transcript_append_fq12(args[0].data_ptr(), args[1].data_ptr(),
                                              out.data_ptr(), _stream(state))
    _build.check_launch(lib, err, "transcript_append_fq12")
    transcript_append_fq12.launches += 1
    return out


def transcript_round_tail(state, zl, zr):
    """A fold round's transcript tail: append zl and zr, derive the
    challenge x, invert it.  Returns (state', x, x^-1)."""
    args = _inputs(state, zl, zr)
    if args is None:
        return transcript_round_tail_plain(state, zl, zr)
    lib = _build.cuda_library()
    out = torch.empty_like(state)
    x = state.new_empty(16)
    xinv = state.new_empty(16)
    with torch.cuda.device(state.device):
        err = lib.sipp_transcript_round_tail(args[0].data_ptr(), args[1].data_ptr(),
                                             args[2].data_ptr(), out.data_ptr(), x.data_ptr(),
                                             xinv.data_ptr(), _stream(state))
    _build.check_launch(lib, err, "transcript_round_tail")
    transcript_round_tail.launches += 1
    return out, x, xinv


def digest_to_challenge_limbs(canon):
    """(n, 4, 5) canonical digests -> (n, 16) challenge limbs before the
    reduction mod r: the kernels' quirk step (a __device__ function of
    csrc/transcript.cu) on its own, for tests of its rare zero-digit cases.
    Not on the prover's path; not counted."""
    if canon.dim() != 3 or tuple(canon.shape[1:]) != (4, 5):
        raise ValueError(f"expected (n, 4, 5) digests, got {tuple(canon.shape)}")
    if canon.device.type == "cpu":
        return torch.stack([td._digest_to_challenge_limbs(c) for c in canon])
    canon = _build.check_cuda_input(canon, "canon", (4, 5))
    lib = _build.cuda_library()
    out = canon.new_empty((canon.shape[0], 16))
    with torch.cuda.device(canon.device):
        err = lib.sipp_digest_to_challenge(canon.data_ptr(), out.data_ptr(), canon.shape[0],
                                           _stream(canon))
    _build.check_launch(lib, err, "digest_to_challenge")
    return out


def fr_inverse_limbs(x):
    """(n, 16) canonical Fr limbs -> (n, 16) limbs of their inverses (0 maps
    to 0): K4's inverse (a __device__ function of csrc/transcript.cu) on
    its own, for tests of its edge values.  Not on the prover's path; not
    counted."""
    if x.dim() != 2 or x.shape[1] != 16:
        raise ValueError(f"expected (n, 16) Fr limbs, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return td.fr_inverse(x)
    x = _build.check_cuda_input(x, "x", (16,))
    lib = _build.cuda_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.sipp_fr_inverse(x.data_ptr(), out.data_ptr(), x.shape[0], _stream(x))
    _build.check_launch(lib, err, "fr_inverse")
    return out


transcript_append_fq12.launches = 0
transcript_round_tail.launches = 0
