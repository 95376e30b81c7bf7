"""k3_roofline.<mix>: K3's bound over K3's device time (the G1 and G2 fold
ladders of every round), in percent.  The bound is the larger of the
ladders' 32-bit multiplies on each traced proof's own challenges
(counts.k3_products; the reference works them out when it checks the
proof) at the card's peak and their bytes at the card's memory rate."""

from benchmark.metrics import counts

KERNELS = ("fold_kernel",)


def read(run):
    t, peak = run.trace, run.peak
    if t is None or peak is None or not t.ops:
        return None
    seconds = t.device_seconds(KERNELS)
    infos = [run.checked.get(op.index) for op in t.ops]
    if not seconds or any(info is None for info in infos):
        return None
    n = run.config["n"]
    imuls = sum(counts.k3_products(n, info["challenges"]) for info in infos)
    bound = max(imuls * counts.FQ_PRODUCT_IMULS / peak["imul_per_s"],
                len(infos) * counts.k3_bytes(n) / peak["hbm_bytes_per_s"])
    return 100 * bound / seconds
