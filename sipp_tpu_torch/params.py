"""BN254 (alt_bn128) curve parameters.

Carried over unchanged from sipp_tpu/params.py (which the port may not
import: importing sipp_tpu loads JAX).  All constants are standard public
parameters of the BN254 curve, as used by ark-bn254 (SURVEY.md D1-D5).
Derived quantities (NAF of the ate loop count, Frobenius coefficients, cofactors)
are computed here at import time with Python ints rather than hard-coded, so they
are self-checking against the BN polynomial parametrization.
"""

# BN parameter x: p(x), r(x) are the standard BN polynomials.
X = 4965661367192848881

# Base field modulus p and scalar field modulus r.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Self-check the BN parametrization (catches typos in the constants above).
assert P == 36 * X**4 + 36 * X**3 + 24 * X**2 + 6 * X + 1
assert R == 36 * X**4 + 36 * X**3 + 18 * X**2 + 6 * X + 1

# Curve: E/Fq : y^2 = x^3 + 3.  G1 generator (1, 2).
B_G1 = 3
G1_GEN = (1, 2)

# Fq2 = Fq[u]/(u^2 + 1); the sextic twist E'/Fq2 : y^2 = x^3 + b/xi with
# xi = 9 + u (D-type twist).  G2 generator (standard alt_bn128 generator).
XI = (9, 1)  # xi = 9 + u as (c0, c1)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# G2 cofactor: h2 = 2p - r for BN curves (#E'(Fq2) = h2 * r).
G2_COFACTOR = 2 * P - R
assert G2_COFACTOR == 21888242871839275222246405745257275088844257914179612981679871602714643921549
# h2's prime factors, each once (tests/test_torch_torsion.py checks that
# they are prime): E'(Fq2) is cyclic of squarefree order r h2.
G2_COFACTOR_PRIMES = (10069, 5864401, 1875725156269,
                      G2_COFACTOR // (10069 * 5864401 * 1875725156269))
assert G2_COFACTOR_PRIMES[-1] * 10069 * 5864401 * 1875725156269 == G2_COFACTOR

# Optimal ate pairing loop count: 6x + 2.
ATE_LOOP_COUNT = 6 * X + 2
assert ATE_LOOP_COUNT == 29793968203157093288


def naf(n: int) -> list:
    """Non-adjacent form of n, least-significant digit first, digits in {-1,0,1}."""
    out = []
    while n > 0:
        if n & 1:
            d = 2 - (n % 4)  # 1 if n%4==1 else -1
            n -= d
        else:
            d = 0
        out.append(d)
        n >>= 1
    return out


# NAF digits of 6x+2, least-significant first.  Any signed-binary representation
# of 6x+2 yields the same ate pairing value; NAF minimizes addition steps.
ATE_NAF = naf(ATE_LOOP_COUNT)

# Goldilocks field (transcript hashing; plonky2's F — SURVEY.md D12).
GOLDILOCKS_P = 2**64 - 2**32 + 1
