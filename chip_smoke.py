"""Smoke test of the PyTorch + CUDA port (sipp_tpu_torch) on one NVIDIA GPU.

Drives the port's main path, the README quick-start sipp_prove -> sipp_verify,
at n = 128 on the seed-1177 instance, through the hand-written CUDA kernels
K1 (Miller product, both modes), K2 (final exponentiation) and K3 (fold
ladders, G1 and G2).  Phases, one JSON line each; any failure raises and
exits non-zero:

  1. device: card, torch/CUDA versions, build times of the kernels and of
     the host library (so that no later phase times a build);
  2. each kernel against its plain PyTorch version on the same card inputs,
     at the main path's shapes (bit equality: tolerance 0, every value is a
     canonical field element), with both times; K1 also with infinity
     lanes, at padded widths (6 lanes) and over two blocks (130 lanes);
  3. the n = 128 aggregation Z = FE(prod Miller(A_i, B_i)) must hash to the
     JAX reference's digest, then its steady-state time on distinct inputs;
  4. prove and verify at n = 128 with the launch counters reset just before
     (every kernel must have run), a tampered proof must be rejected, and
     the n = 4 golden proof and statement of tests/golden/torch_port.npz must
     come out byte for byte;
  5. the kernel table, the card's name and power limit (nvidia-smi), and the
     last line {"ok": true, "device": {...}}.

Usage, from the root of a checkout (the first run builds the kernels with
nvcc into sipp_tpu_torch/build/):

    python3 chip_smoke.py
"""

import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

N = 128
SEED = 1177
# seed-1177 n=128 aggregation digest of the JAX reference (BENCH_r05.json;
# sha256 of the (2, 3, 2, 16) C-order uint32 Z, as bench.py hashes it)
REF_DIGEST = "2d267b78388f92ba"
REPS = 10
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden" / "torch_port.npz"


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    from sipp_tpu_torch import convert, native, params
    from sipp_tpu_torch.curves import scalar_to_bits
    from sipp_tpu_torch.fields import tower
    from sipp_tpu_torch.ops import _build, fexp, fold, miller
    from sipp_tpu_torch.pairing import ate
    from sipp_tpu_torch.protocol import VerificationError, sipp_prove, sipp_verify
    from sipp_tpu_torch.utils.testing import random_instance

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]

    # ---------------------------------------------------------- 1. device
    t0 = time.time()
    _build.cuda_library()
    build_s = time.time() - t0
    t0 = time.time()
    native.get_lib()            # the host transcript library, built with g++
    host_build_s = time.time() - t0
    regs = [line.split(":", 1)[1].strip() for line in _build.BUILD_INFO["log"].splitlines()
            if "Used" in line and "registers" in line]
    emit({"phase": "device", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "host_build_s": host_build_s,
          "ptxas": regs})

    t0 = time.time()
    a, b = random_instance(N, seed=SEED, device=dev)
    emit({"phase": "instance", "n": N, "seed": SEED, "host_s": time.time() - t0})

    # ------------------------------------- 2. kernels against plain versions
    def kernel_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def plain_ms(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t) * 1e3

    half = N // 2
    pair_p = torch.stack([a[half:], a[:half]], dim=1).reshape(N, 2, 16)
    pair_q = torch.stack([b[:half], b[half:]], dim=1).reshape(N, 2, 2, 16)
    f_one = miller.miller_product(a, b)
    f_two = miller.miller_product(pair_p, pair_q, pair=True)

    p_inf, q_inf = [3, 77, 120], [40, 77, 101]   # A_i = O, B_j = O, both; even and odd

    def with_infinity(p, q):
        p, q = p.clone(), q.clone()
        p[p_inf] = 0
        q[q_inf] = 0
        return p, q

    a_inf, b_inf = with_infinity(a, b)
    pp_inf, pq_inf = with_infinity(pair_p, pair_q)
    # 130 lanes: padded to two 128-lane blocks whose partials are multiplied
    pp_130, pq_130 = torch.cat([pp_inf, pair_p[:2]]), torch.cat([pq_inf, pair_q[:2]])

    def k1(p, q, pair=False):
        return (lambda: miller.miller_product(p, q, pair=pair),
                lambda: miller.miller_product_plain(p, q, pair=pair))

    k1_src = ("miller.cu", "sipp_tpu/ops/pallas_miller.py:289")
    dead = slice(N - 8, N)
    lo1, hi1 = a.clone(), torch.roll(a, 1, 0)
    lo2, hi2 = b.clone(), torch.roll(b, 1, 0)
    for t in (lo1, hi1, lo2, hi2):
        t[dead] = 0
    fold_x = params.R - 12345      # a fixed challenge with its top bit set
    xbits = scalar_to_bits(fold_x)
    xinvbits = scalar_to_bits(pow(fold_x, -1, params.R))
    cases = [
        ("miller_product", "miller_product", *k1_src, *k1(a, b)),
        ("miller_product_inf", "miller_product", *k1_src, *k1(a_inf, b_inf)),
        ("miller_product_n6", "miller_product", *k1_src, *k1(a_inf[:6], b_inf[:6])),
        ("miller_product_pair", "miller_product_pair", *k1_src, *k1(pair_p, pair_q, True)),
        ("miller_product_pair_inf", "miller_product_pair", *k1_src, *k1(pp_inf, pq_inf, True)),
        ("miller_product_pair_n2", "miller_product_pair", *k1_src,
         *k1(pair_p[:2], pair_q[:2], True)),
        ("miller_product_pair_n6", "miller_product_pair", *k1_src,
         *k1(pp_inf[:6], pq_inf[:6], True)),
        ("miller_product_pair_n130", "miller_product_pair", *k1_src, *k1(pp_130, pq_130, True)),
        ("final_exp_b1", "final_exp", "fexp.cu", "sipp_tpu/ops/pallas_fexp.py:327",
         lambda: fexp.final_exp(f_one[None]), lambda: fexp.final_exp_plain(f_one[None])),
        ("final_exp_b2", "final_exp", "fexp.cu", "sipp_tpu/ops/pallas_fexp.py:327",
         lambda: fexp.final_exp(f_two), lambda: fexp.final_exp_plain(f_two)),
        ("fold_g1", "fold_g1", "fold.cu", "sipp_tpu/ops/pallas_fold.py:210",
         lambda: fold.fold_g1(lo1, hi1, xbits), lambda: fold.fold_g1_plain(lo1, hi1, xbits)),
        ("fold_g2", "fold_g2", "fold.cu", "sipp_tpu/ops/pallas_fold.py:221",
         lambda: fold.fold_g2(lo2, hi2, xinvbits), lambda: fold.fold_g2_plain(lo2, hi2, xinvbits)),
    ]
    table = {}
    for name, counter, src, replaces, kern, plain in cases:
        got = kern()
        want, p_ms = plain_ms(plain)
        err = int((got - want).abs().max())
        ok = got.shape == want.shape and err == 0
        k_ms = kernel_ms(kern)
        table[name] = {"name": name, "route": "cuda", "source": f"sipp_tpu_torch/csrc/{src}",
                       "replaces": replaces, "counter": counter, "max_abs_err": err,
                       "ms": k_ms, "plain_ms": p_ms}
        emit({"phase": "kernel", "name": name, "shape": list(got.shape), "bit_equal": ok,
              "max_abs_err": err, "tolerance": 0, "ms": k_ms, "plain_ms": p_ms})
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
    dead_out = (fold.fold_g1(lo1, hi1, xbits)[dead] == 0).all() and \
        (fold.fold_g2(lo2, hi2, xinvbits)[dead] == 0).all()
    if not bool(dead_out):
        raise SystemExit("dead fold lanes did not encode all-zero")
    live = [i for i in range(N) if i not in p_inf + q_inf]
    if not torch.equal(miller.miller_product(a_inf, b_inf),
                       miller.miller_product(a_inf[live], b_inf[live])):
        raise SystemExit("infinity lanes did not contribute 1 to the Miller product")

    # ------------------------------------------------------ 3. aggregation
    z = ate.inner_product(a, b)
    digest = hashlib.sha256(convert.to_reference(z).tobytes()).hexdigest()[:16]
    assert REPS + 1 < N, "rolled inputs would repeat"
    insts = [(torch.roll(a, i + 1, 0), torch.roll(b, i + 1, 0)) for i in range(REPS)]
    torch.cuda.synchronize()
    t = time.time()
    for x, y in insts:
        zz = ate.inner_product(x, y)
    torch.cuda.synchronize()
    agg_ms = (time.time() - t) / REPS * 1e3
    emit({"phase": "aggregation", "n": N, "digest": digest, "reference_digest": REF_DIGEST,
          "ms_per_aggregation": agg_ms, "pairings_per_s": N / agg_ms * 1e3, "card": smi})
    if digest != REF_DIGEST or not torch.equal(zz, z):
        raise SystemExit(f"aggregation digest {digest} != {REF_DIGEST} or rolled input "
                         "changed the product")

    # ------------------------------------------------- 4. prove and verify
    counters = [(miller.miller_product, "launches", "miller_product"),
                (miller.miller_product, "pair_launches", "miller_product_pair"),
                (fexp.final_exp, "launches", "final_exp"),
                (fold.fold_g1, "launches", "fold_g1"),
                (fold.fold_g2, "launches", "fold_g2")]
    for fn, attr, _ in counters:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t = time.time()
    proof = sipp_prove(a, b)
    torch.cuda.synchronize()
    prove_s = time.time() - t
    t = time.time()
    stmt = sipp_verify(a, b, proof)
    verify_s = time.time() - t
    launches = {name: getattr(fn, attr) for fn, attr, name in counters}
    if tuple(proof.shape) != (2 * 7 + 1, 2, 3, 2, 16) or not torch.equal(proof[-1], z):
        raise SystemExit("proof has the wrong shape or does not end with Z")
    if tower.fq12_decode(z) != stmt.Z:
        raise SystemExit("statement Z differs from the aggregation")
    bad = proof.clone()
    bad[1, 0, 0, 0, 0] = (bad[1, 0, 0, 0, 0] + 1) % 0xFFFF
    try:
        sipp_verify(a, b, bad)
    except VerificationError:
        rejected = True
    else:
        rejected = False
    emit({"phase": "protocol", "n": N, "prove_s": prove_s, "verify_s": verify_s,
          "accepted": True, "tampered_rejected": rejected, "launches": launches, "card": smi})
    if not rejected or min(launches.values()) < 1:
        raise SystemExit("tampered proof accepted or a kernel of the path never ran")

    with np.load(GOLDEN) as g:
        a4 = convert.from_reference(g["a4"], dev)
        b4 = convert.from_reference(g["b4"], dev)
        proof4 = sipp_prove(a4, b4)
        stmt4 = sipp_verify(a4, b4, proof4)
        same_proof = np.array_equal(convert.to_reference(proof4), g["proof4"])
        same_stmt = np.array_equal(np.asarray(stmt4.to_vec(), np.uint32), g["stmt4"])
    emit({"phase": "golden_n4", "proof_bytes_equal": same_proof, "statement_equal": same_stmt})
    if not (same_proof and same_stmt):
        raise SystemExit("the n = 4 golden proof or statement was not reproduced")

    # --------------------------------------------------------- 5. summary
    for row in table.values():
        row["launches"] = launches[row.pop("counter")]
    emit({"kernels": list(table.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
