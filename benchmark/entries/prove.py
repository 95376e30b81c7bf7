"""Entry `prove`: one operation is sipp_tpu_torch.protocol.sipp_prove_onchip
(a, b) on the next instance, the proof ((2 log2 n + 1, 2, 3, 2, 16) limbs)
copied into host memory before the next call: the host prologue (the
points' decode and the Poseidon hash), K1 and K5 for Z, and a round K1 in
pair mode, K2 at B = 2, K4 and K3 for G1 and G2."""

from benchmark.reference import sipp

CONTROL_CHALLENGE_BITS = 128


def load():
    from sipp_tpu_torch.protocol import sipp_prove_onchip

    return sipp_prove_onchip


def expect(ref, pool, inst):
    """The reference's proof of the instance, and its challenges."""
    proof, xs = ref.proof(*pool.points(inst), *pool.logs(inst))
    return proof, {"challenges": xs}


def control():
    """The reference with challenges cut to 128 bits, which would halve the
    fold ladders."""
    return sipp.Reference(challenge_bits=CONTROL_CHALLENGE_BITS)
