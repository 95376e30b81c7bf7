"""The work that K1 and K3 do, counted from the algorithm and frozen here, so
that no kernel can change its own yardstick.

Fq products as benchmark/reference/bn254.py's Tower makes them (a Karatsuba
Fq2 product 3, an Fq2 squaring 2, an Fq12 product 54, an Fq12 squaring 36, a
product by a line 39), each at FQ_PRODUCT_IMULS 32-bit multiplies (an
8-word Montgomery product); sums, small constants and the Fq inversion
(extended Euclid) count nothing.  benchmark/tests/test_sippbench_counts.py
holds these functions to the reference's own count at n = 2 and n = 4.
"""

FQ_PRODUCT_IMULS = 256
LIMB_BYTES = 8                  # the program holds a 16-bit limb in an int64
FQ_BYTES = 16 * LIMB_BYTES

# the Miller loop over the NAF of 6x + 2: 65 steps, 21 of them with an addition
MILLER_STEPS, MILLER_ADDS = 65, 21
F12_SQR, F12_MUL, LINE_MUL = 36, 54, 39
DBL_LINE, ADD_LINE = 31, 40     # a Jacobian step on the twist with its line
TWIST_FROBS = 12                # pi(Q) and pi^2(Q): four Fq2 products

# the fold ladders: a Jacobian doubling, a mixed addition, the affine result
DBL = {"g1": 7, "g2": 16}
MADD = {"g1": 11, "g2": 30}
AFFINE = {"g1": 4, "g2": 15}
COORDS = {"g1": 2, "g2": 4}     # Fq values of an affine point

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def miller_lane_products():
    """One lane of the Miller loop, its two Frobenius lines included."""
    return (MILLER_STEPS * (F12_SQR + DBL_LINE + LINE_MUL) + MILLER_ADDS * (ADD_LINE + LINE_MUL)
            + TWIST_FROBS + 2 * (ADD_LINE + LINE_MUL))


def k1_products(lanes):
    """K1 on `lanes` pairs: a Miller loop a lane and the product tree."""
    return lanes * miller_lane_products() + (lanes - 1) * F12_MUL


def k1_bytes(lanes):
    """The pairs read once and the Fq12 product written once."""
    return lanes * (COORDS["g1"] + COORDS["g2"]) * FQ_BYTES + 12 * FQ_BYTES


def fold_lane_products(group, k):
    """lo + [k] hi on one lane: a doubling a bit after the leading one, an
    addition a set bit after it, the addition of lo, the affine result."""
    return ((k.bit_length() - 1) * DBL[group] + (bin(k).count("1") - 1) * MADD[group]
            + MADD[group] + AFFINE[group])


def k3_products(n, challenges):
    """K3 over one proof of n pairs: round r folds n / 2^(r+1) lanes of G1
    by its challenge x and of G2 by x^-1 mod r."""
    total, m = 0, n
    for x in challenges:
        m //= 2
        total += m * (fold_lane_products("g1", x) + fold_lane_products("g2", pow(x, -1, R)))
    return total


def k3_bytes(n):
    """Each round's lo and hi read once and its folded points written once."""
    total, m = 0, n
    while m > 1:
        m //= 2
        total += 3 * m * (COORDS["g1"] + COORDS["g2"]) * FQ_BYTES
    return total
