"""Entry `aggregate`: one operation is sipp_tpu_torch.pairing.inner_product
(a, b) on the next instance, Z = prod_i e(A_i, B_i) as (2, 3, 2, 16) limbs,
copied into host memory before the next call: K1 (the Miller product and
its tree) and K2 (the final exponentiation), nothing else."""

from benchmark.reference import sipp


def load():
    from sipp_tpu_torch.pairing import inner_product

    return inner_product


def expect(ref, pool, inst):
    """The reference's Z of the instance, and nothing more to record."""
    return sipp.limbs(ref.z(*pool.logs(inst))), {}


def control():
    """The reference with the power of the pairing that a cheaper hard part
    of the final exponentiation gives."""
    return sipp.Reference(power=sipp.HARD_PART_MULTIPLE)
