"""k1_roofline.<mix>: K1's bound over K1's device time (both of its launches,
the Miller product and its tree), in percent.  The bound is the larger of
the Miller product's 32-bit multiplies (counts.k1_products at n lanes) at
the card's peak and its bytes at the card's memory rate."""

from benchmark.metrics import counts

KERNELS = ("miller_product_kernel", "miller_tree_kernel")


def read(run):
    t, peak = run.trace, run.peak
    if t is None or peak is None or not t.ops:
        return None
    seconds = t.device_seconds(KERNELS)
    if not seconds:
        return None
    n, ops = run.config["n"], len(t.ops)
    bound = max(ops * counts.k1_products(n) * counts.FQ_PRODUCT_IMULS / peak["imul_per_s"],
                ops * counts.k1_bytes(n) / peak["hbm_bytes_per_s"])
    return 100 * bound / seconds
