"""BLS signature aggregation over BN254 via SIPP, on the port.

The port of sipp_tpu/apps/bls_aggregation.py (the reference binary
bls_aggregation.rs; SURVEY.md C10): verifying n-1 BLS signatures reduces to
ONE SIPP instance of size n:

    a = [pk_0, ..., pk_{n-2}, -G1],  b = [H(m_0), ..., H(m_{n-2}), sigma]
    <a, b> = prod e(pk_i, H(m_i)) * e(-G1, sigma) == 1   iff all sigs valid

The hash to G2 (SURVEY.md D9: a deterministic try-and-increment map
Fq2 -> E'(Fq2), then cofactor multiplication by h2 = 2p - r), keygen, sign
and aggregate work on hostref ints and are carried over unchanged, the
increment schedule included (the reference's map lives in a non-vendored
dependency, so the schedule is this framework's own, pinned by the tests).
The aggregate check runs K1 + K2 (inner_product); the proof runs on the
card through sipp_prove_onchip, and sipp_verify checks it.

Run: python -m sipp_tpu_torch.apps.bls_aggregation [n]   (on the card)
"""

import sys

import numpy as np
import torch

from .. import curves, hostref as H, params
from ..convert import resolve_device
from ..fields import tower
from ..pairing import inner_product
from ..protocol import sipp_prove, sipp_prove_onchip, sipp_verify

P = params.P


def _fq_sqrt(a):
    r = pow(a, (P + 1) // 4, P)  # p ≡ 3 (mod 4)
    return r if r * r % P == a % P else None


def fq2_sqrt(t):
    """Square root in Fq2 = Fq[u]/(u^2+1) (complex method), or None."""
    a, b = t[0] % P, t[1] % P
    if b == 0:
        r = _fq_sqrt(a)
        if r is not None:
            return (r, 0)
        s = _fq_sqrt((-a) % P)
        return (0, s) if s is not None else None
    m = _fq_sqrt((a * a + b * b) % P)
    if m is None:
        return None
    inv2 = pow(2, -1, P)
    x = _fq_sqrt((a + m) * inv2 % P)
    if x is None:
        x = _fq_sqrt((a - m) * inv2 % P)
        if x is None:
            return None
    y = b * pow(2 * x, -1, P) % P
    return (x, y)


def map_to_g2_without_cofactor_mul(u):
    """Deterministic Fq2 -> E'(Fq2) (no cofactor clearing): try-and-increment
    on the c0 coordinate (D9 interface: bls_aggregation.rs:21,103)."""
    x = (u[0] % P, u[1] % P)
    while True:
        rhs = H.fq2_add(H.fq2_mul(H.fq2_sqr(x), x), H.B2)
        y = fq2_sqrt(rhs)
        if y is not None:
            # canonical sign: pick the root with even c0
            pick = y if y[0] % 2 == 0 else H.fq2_neg(y)
            assert H.g2_is_on_curve((x, pick))
            return (x, pick)
        x = ((x[0] + 1) % P, x[1])


def hash_to_g2(u):
    """Full hash: map + cofactor clearing (lands in the r-torsion G2)."""
    return H.g2_mul_raw(map_to_g2_without_cofactor_mul(u), params.G2_COFACTOR)


def keygen(rng):
    sk = int.from_bytes(rng.bytes(40), "little") % params.R
    pk = H.g1_mul(params.G1_GEN, sk)
    return sk, pk


def sign(sk, msg_fq2):
    return H.g2_mul(hash_to_g2(msg_fq2), sk)


def aggregate(sigs):
    agg = None
    for s in sigs:
        agg = H.g2_add(agg, s)
    return agg


def verify_bls_aggregation(pks, msgs, sigma, prove=True, device=torch.device("cuda")):
    """Build the SIPP instance (bls_aggregation.rs:114-121) on `device` (the
    card unless asked otherwise) and verify it.

    Returns (ok, proof_or_None).  ok is True iff the aggregate verifies
    (inner product == 1: one K1 launch and one K2 launch on the card) and,
    when prove=True, the SIPP proof roundtrips: the on-chip prover on the
    card, the host-spine prover on the CPU (as the JAX package takes its
    device-resident prover on the TPU), byte-identical proofs; then
    sipp_verify, which raises on an invalid proof."""
    device = resolve_device(device)
    hs = [hash_to_g2(m) for m in msgs]
    a_pts = list(pks) + [H.g1_neg(params.G1_GEN)]
    b_pts = hs + [sigma]
    n = len(a_pts)
    assert n & (n - 1) == 0, "n must be a power of two"

    a = curves.g1_encode(a_pts, device)
    b = curves.g2_encode(b_pts, device)
    if tower.fq12_decode(inner_product(a, b)[None])[0] != H.FQ12_ONE:
        return False, None
    if not prove:
        return True, None
    prove_fn = sipp_prove_onchip if device.type == "cuda" else sipp_prove
    proof = prove_fn(a, b)
    stmt = sipp_verify(a, b, proof)   # raises on invalid proof
    assert stmt.Z == H.FQ12_ONE
    return True, proof


def demo_instance(n: int):
    """The demo's n - 1 keys, messages and signatures from default_rng(0),
    drawn as the JAX package's demo draws them: (pks, msgs, sigma)."""
    rng = np.random.default_rng(0)
    keys = [keygen(rng) for _ in range(n - 1)]
    msgs = [
        (int.from_bytes(rng.bytes(31), "little"),
         int.from_bytes(rng.bytes(31), "little"))
        for _ in range(n - 1)
    ]
    sigs = [sign(sk, m) for (sk, _), m in zip(keys, msgs)]
    return [pk for _, pk in keys], msgs, aggregate(sigs)


def main(n: int = 128, device=torch.device("cuda")):
    """Default demo at the reference's scale (bls_aggregation.rs:93, n=128),
    on `device` (the card unless asked otherwise)."""
    import json
    import time

    device = resolve_device(device)
    print(f"BLS aggregation, n={n} ({n-1} signatures)")
    t0 = time.time()
    pks, msgs, sigma = demo_instance(n)
    setup_s = time.time() - t0
    print(f"keygen+sign+aggregate: {setup_s:.2f}s")
    t0 = time.time()
    ok, proof = verify_bls_aggregation(pks, msgs, sigma, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    verify_s = time.time() - t0
    print(f"verify_bls_aggregation: ok={ok} in {verify_s:.2f}s "
          f"(proof: {None if proof is None else tuple(proof.shape)})")
    print(json.dumps({"app": "bls_aggregation", "n": n, "ok": ok,
                      "setup_s": round(setup_s, 3),
                      "verify_s": round(verify_s, 3)}))
    assert ok
    return ok


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)
