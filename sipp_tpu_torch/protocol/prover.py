"""SIPP provers (port of sipp_tpu/protocol/prover.py: sipp_prove, the host
spine, and sipp_prove_onchip).

log2(n) Fiat-Shamir fold rounds.  Z = FE(prod_i Miller(A_i, B_i)) is one K1
launch and one K2 launch; each round's (Z_L, Z_R) is one pair-mode K1 launch
and one K2 launch at B = 2; the folds A' = A_lo + x A_hi and
B' = B_lo + x^-1 B_hi are one K3 launch each.  sipp_prove runs the hash chain
and the challenges on the host (the native transcript), which reads every
round's Z_L and Z_R back from the card.  sipp_prove_onchip keeps the whole
recursion on the card after the host hashes the points: K5 appends Z, and
one K4 launch a round appends (Z_L, Z_R), derives x and inverts it, so the
rounds make no host sync.  Both give the same proof bytes.

With (lo, hi) = split_at(m): Z_L = <A_hi, B_lo>, Z_R = <A_lo, B_hi>, and the
proof [Z, Z_L1, Z_R1, ...] is REVERSED so the verifier pops from the back.
The JAX package keeps a fixed lane width with masked dead lanes to bound
XLA recompiles; eager PyTorch has no such cost, so rounds halve by slicing
(dead lanes contribute 1 and fold to O, so the proof bytes are the same).
"""

import time

import torch

from .. import curves, params
from ..curves import scalar_to_bits
from ..fields import FGL, tower
from ..ops import fold, transcript
from ..pairing import ate
from .transcript import Transcript
from .transcript_device import bits_msb as _bits_msb


def check_shapes(a_g1, b_g2):
    n = a_g1.shape[0]
    if (a_g1.shape[1:] != (2, 16) or b_g2.shape[1:] != (2, 2, 16)
            or b_g2.shape[0] != n or n < 1 or n & (n - 1)):
        raise ValueError(f"SIPP instance must be (n, 2, 16) x (n, 2, 2, 16) with n a "
                         f"power of two, got {tuple(a_g1.shape)} x {tuple(b_g2.shape)}")
    return n


def prologue(a_g1, b_g2):
    """The host transcript after the interleaved (A_i, B_i) prologue."""
    tr = Transcript()
    tr.append_points(curves.g1_decode(a_g1), curves.g2_decode(b_g2))
    return tr


def sipp_prove(a_g1, b_g2, return_transcript=False):
    """a_g1: (n, 2, 16) G1 affine; b_g2: (n, 2, 2, 16) G2 twist affine (int64
    limbs, one device).  Returns the proof (2 log2(n) + 1, 2, 3, 2, 16) in
    verifier pop order, on the inputs' device, and with return_transcript
    also the final host Transcript."""
    check_shapes(a_g1, b_g2)
    tr = prologue(a_g1, b_g2)

    z = ate.inner_product(a_g1, b_g2)
    proof = [z]
    tr.append_fq12(tower.fq12_decode(z))
    host_rounds(a_g1, b_g2, tr, proof)

    proof.reverse()
    return (torch.stack(proof), tr) if return_transcript else torch.stack(proof)


def append_cross(tr, proof, zs):
    """A round's (Z_L, Z_R), (2, 2,3,2, L): onto the proof and the host
    transcript.  Returns the challenge's MSB-first bits for the folds,
    (x, x^-1)."""
    z_l, z_r = tower.fq12_decode(zs)
    proof += [zs[0], zs[1]]
    tr.append_fq12(z_l)
    tr.append_fq12(z_r)
    x = tr.get_challenge()
    return scalar_to_bits(x), scalar_to_bits(pow(x, -1, params.R))


def host_rounds(a, b, tr, proof):
    """The host-spine fold rounds from (a, b) down to one pair, appending
    each round's (Z_L, Z_R) to `proof` and to the host transcript `tr`
    (sipp_prove's rounds, and the sharded prover's gathered tail)."""
    n = a.shape[0]
    while n > 1:
        m = n // 2
        bits_x, bits_xinv = append_cross(tr, proof,
                                         ate.cross_products(a[:m], a[m:], b[:m], b[m:]))
        a = fold.fold_g1(a[:m], a[m:], bits_x)
        b = fold.fold_g2(b[:m], b[m:], bits_xinv)
        n = m


def onchip_rounds(a_g1, b_g2, state, round_times=None):
    """The device part of sipp_prove_onchip: Z and its append (K1, K2, K5),
    then every fold round (K1 pair mode, K2 at B = 2, K4, the challenge bits,
    K3 with device bits), halving by slicing.  state: the (4, 5) Montgomery
    Goldilocks transcript state after the prologue, on the points' device.
    Makes no host sync unless round_times is a list, which then gets each
    round's wall seconds (the round blocked on the card).  Returns
    (proof, state), both on the device."""
    n = check_shapes(a_g1, b_g2)
    z = ate.inner_product(a_g1, b_g2)
    state = transcript.transcript_append_fq12(state, z)
    proof = [z]
    a, b = a_g1, b_g2
    while n > 1:
        t0 = time.perf_counter()
        m = n // 2
        zs = ate.cross_products(a[:m], a[m:], b[:m], b[m:])
        state, x, x_inv = transcript.transcript_round_tail(state, zs[0], zs[1])
        a = fold.fold_g1(a[:m], a[m:], _bits_msb(x))
        b = fold.fold_g2(b[:m], b[m:], _bits_msb(x_inv))
        proof += [zs[0], zs[1]]
        if round_times is not None:
            if a.device.type == "cuda":
                torch.cuda.synchronize(a.device)
            round_times.append(time.perf_counter() - t0)
        n = m
    proof.reverse()
    return torch.stack(proof), state


def sipp_prove_onchip(a_g1, b_g2, return_transcript=False, round_times=None):
    """The prover with the fold recursion on the device: the host hashes the
    points (the prologue), then onchip_rounds runs every round on the card
    with no host round trip; the proof stays on the device.  Same bytes as
    sipp_prove.  With return_transcript, also the Transcript whose state is
    the decoded device state; round_times: see onchip_rounds."""
    check_shapes(a_g1, b_g2)
    tr = prologue(a_g1, b_g2)
    state = FGL.encode(tr.state, a_g1.device)
    proof, state = onchip_rounds(a_g1, b_g2, state, round_times)
    if return_transcript:
        tr.state = FGL.decode(state)
        return proof, tr
    return proof
