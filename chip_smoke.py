"""Smoke test of the PyTorch + CUDA port (sipp_tpu_torch) on one NVIDIA GPU.

Drives the port's paths at n = 128 on the seed-1177 instance, and its main
path again at n = 4096 (the JAX package's headline size), through the
hand-written CUDA kernels K0 (batched Fq multiply), K1 (Miller product, both
modes), K2 (final exponentiation), K3 (fold ladders), K4/K5 (transcript tail
and Z append), K6 (per-lane exp ladders, G1 and G2), K7 (one Miller step),
K8 (per-lane Fq12 exp), and the two kernels that replace XLA programs of
the JAX verifier: X1 (the G2 r-torsion verdicts of every verify's entry
validation) and X2 (the sum of the MSM finals' lanes, G1 and G2):

  A. the host-spine sipp_prove -> sipp_verify with fold ladders
     (SIPP_VERIFY_MSM=0);
  B. the on-chip prover sipp_prove_onchip;
  C. sipp_verify with MSM-form finals: its default on the card, the verify
     of the README quick-start (every verify also queues X1 from
     check_instance_async; the MSM finals run K6, then X2);
  D. the per-step Miller engine (SIPP_WHOLE_LOOP=0): the aggregation,
     sipp_prove and the fold-form sipp_verify with 65 K7 launches per
     Miller loop, then the plain tail and product tree, then K2;
  E. the verifier without the C++ library (SIPP_TPU_NO_NATIVE=1): the
     pure-Python Poseidon transcript and the device Z' chain (one K8 launch
     over the proof rows, then the product tree);
  BLS. the BLS aggregation app at n = 128 (127 signatures of the demo's
     default_rng(0) stream): the aggregate check (K1 + K2), the on-chip
     prove and the default verify (MSM finals);
  sharded. the sharded prover (parallel/sharded.py) on four shards: K1 in
     both modes and K3 a shard, K2 on the lead card;
  K0. the field micro-benchmark entry point ops/fq.bench_compare;
  n = 4096. the aggregation, both provers, the sharded prover and both
     verify forms on the seed-1177 instance of n = 4096, drawn on the card
     by K6 (utils/testing.random_instance).

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device: card, SM clock, torch/CUDA versions, build times of the kernels
     and of the host library (so that no later phase times a build), and
     ptxas registers / shared memory / stack / spills per kernel entry; then
     the Fq product latency probe: clock64 cycles per product over 4,096
     dependent products on one thread of bn254.cuh's fq_mul (the one Fq
     product of every kernel), the result checked on the host (a
     measurement, not a kernel of the table); then the transcript probe:
     clock64 cycles per permutation over 64 chained permutations on one
     warp and of one Fr inverse, K4/K5's design unit (transcript.cu), from
     which K4's and K5's latency floors follow (their chains at the maximum
     SM clock, no launch, load or store);
  2. each kernel against its plain PyTorch version on the same card inputs,
     at the paths' shapes (bit equality: tolerance 0, every value is a
     canonical field element), with both times and the kernel's bound (the
     kernel's time twice: ms, CUDA events around each wrapper call, host
     work included, as every earlier run measured it; and device_ms, 20
     launches queued behind a sleep, the device's own time); K1
     also with infinity lanes, at padded widths (6 lanes), over 33 blocks
     (130 lanes), and in pair mode at the fold rounds' 128, 64 and 2 lanes;
     K5 on Z of the n = 128 run and on each of its 7 rounds' (state, Z_L),
     K4 on each round's (state, Z_L, Z_R), from an on-chip proof, both also
     on a state whose words are 0 and p - 1; K6 with
     MSM-finals bits at 128 lanes, and at 100 lanes with infinity x lanes,
     infinity offsets and offsets equal to [k]x; the digest -> challenge
     step of K4 alone on synthetic digests with zero digits, and K4's Fr
     inverse alone on 0, 1, 2, r - 1, r - 2, values whose steps shift by
     32 bits and more, and seeded values; K7 for digits
     0, 1 and 2 on a carry three digits into the loop, and with infinity
     lanes; K8 at the verifier's 14 rows of a proof with their challenge
     bits, on 14 seeded lanes off the cyclotomic subgroup (a forged proof's
     rows) with the same bits, and at 100 lanes with all-zero bits, offsets
     of one and x = 1; X1 on the instance's B at 128 lanes and at 100 lanes
     with raw map points (off the r-torsion), points of the cofactor's
     order, one point of each prime order of the cofactor and infinity
     lanes (0 exactly on the forged lanes), each case also equal to the
     [r]Q ladder of the JAX package's form (plain PyTorch on the card,
     ops/validate.py g2_torsion_r_ladder), with its latency floor; X2 on K6's
     output at the MSM finals' 128 lanes, G1 and G2, at 100 lanes with
     a repeated lane that the chain doubles, a lane that cancels the sum,
     infinity lanes and a cancelling pair (also against the sum of the
     lanes on the host), and on K6's first lane alone and its first
     MSM_CHUNK + 1 (csrc/msm.cu), each with its latency floor;
     K0 at 4096, 1000 and 2^20 elements (the last drawn on the card by
     fq.uniform_batch, rows 0, 1 and p - 1 first), with an empty kernel's
     launch beside it, the floor of any launch; K3 at 128 lanes (dead lanes, a dead lo
     under a live hi, a dead hi under a live lo) and at the fold rounds'
     64 and 1 lanes.  K1's to K8's lines carry the
     time of the same case before their redesign, quoted from PERF.md's
     kernel table and not measured here, as earlier_ms_quoted_from_perf_md
     beside ms (the kernels summary line carries measured numbers only);
     K4's and K5's also their latency_floor_ms (K4's with the shifts and
     probed cycles of its own challenge's inverse); then K0 on an operand
     8 bytes off a 16-byte boundary (the wrapper copies it) and an empty
     kernel's launch, the floor of any launch;
     the n = 128 instance is the host draw (hostref's multiplies);
  3. the n = 128 aggregation Z = FE(prod Miller(A_i, B_i)) must hash to the
     JAX reference's digest, then its steady-state time on distinct inputs;
  4. paths A, B and C, each with the launch counters set to 0 just before it
     and read just after (every kernel of a path must have run; X1 once a
     verify, in paths A, C, D, E and BLS, and X2 once a group a verify with
     MSM finals, in C, E and BLS): the on-chip
     proof must equal the host-spine proof byte for byte with equal final
     transcript states, the MSM and fold verifiers must return equal
     statements, a tampered proof must be rejected by both; then, counted
     nowhere: the on-chip rounds again under
     torch.cuda.set_sync_debug_mode("error") (no host sync), a round_times
     run (fold_round_latency_ms_n128, the median round), steady prove_s and
     verify_s, the MSM finals split (K6 against tree sum + to_affine), the
     device idle share over one prove of each prover (torch.profiler), and
     the n = 4 golden proof and statement of tests/golden/torch_port.npz
     from both provers and both verifiers, byte for byte; then entry
     validation: the curve and r-torsion verdicts queued under
     set_sync_debug_mode("error") (validate.queue_verdicts, what
     check_instance_async runs after its limb checks), check_instance_async's
     enqueue and finish() times, sipp_verify on the card rejecting an
     off-curve A, an off-twist B and a B off the r-torsion with the words
     that check_instance_async gives on the CPU, the default verify's
     split (sipp_verify(split=...): validation enqueue, host replay and Z'
     chain, finals, final aggregation, the wait in finish(); three runs)
     and the card's idle share over one default verify (torch.profiler);
  5. path D, counted the same way: the digest again, its steady time, the
     proof of path A byte for byte and path A's statement; one Miller loop's
     65 K7 launches and tail under set_sync_debug_mode("error"); the split
     of an aggregation into K7 steps (one loop's 65 launches, by CUDA events
     and by host clock, and queued behind a sleep for the device's own
     time: the host may set the pace of 65 small launches),
     plain tail, plain tree and K2;
  6. path E, counted: path C's statement, the tampered proof rejected, the
     n = 4 golden proof and statement; the transcript's and the Z' chain's
     times against the C++ library's;
  7. the BLS app, counted (path BLS): ok, the aggregate check's ms, the
     on-chip and host-spine provers' proofs byte for byte, Z = 1 in the
     statement, a tampered sigma (sigma + H(m_0)) rejected, the SHA-256
     of the instance and of the proof equal to the JAX package's (golden
     stage bls128), setup_s (pure-Python keys, hashes and signatures, kept
     out of the card's numbers), prove_s and verify_s; then io: the proof
     saved, loaded onto the card and verified, its statement saved and
     loaded, all equal;
  8. the sharded prover sipp_prove_sharded, counted (path sharded), on
     Mesh((cuda:0,) * 4): four shards that the script puts on one card by
     naming it four times (make_mesh never repeats a card): 5 sharded
     rounds and a gathered tail of 2; its proof must equal paths A's and
     B's byte for byte and verify, and its K1/K2/K3 launches must be the
     shard count's (Z: 4 K1 and 1 K2; a round: 4 pair-mode K1, 4 K3-G1, 4
     K3-G2, 1 K2; a tail round: one of each); its wall seconds beside
     sipp_prove's and sipp_prove_onchip's (steady: the median of three
     runs), and the card's idle share over one sharded prove
     (torch.profiler).  With two or more cards visible
     it runs again on make_mesh over 2 or 4 distinct cards, counted as path
     sharded_cards, its first run (which creates the other cards'
     contexts) apart from the median of three more; on one card the line
     says that part was skipped;
  9. the bucket MSMs (ops/msm.py msm_bucket, msm_bucket_sharded on the
     four-shard mesh), G1 and G2, with the MSM finals' 254-bit scalars of
     the n = 128 proof and 8-bit windows: plain PyTorch, no kernel (their
     counters must stay 0), equal to K6 + msm_finish on the same inputs,
     their wall seconds beside K6's and msm_finish's, and each group's
     split into buckets, window combine and to_affine;
 10. K0's entry point, counted: its timing line and equality;
 11. the n = 4096 phases, each line with "n": 4096 and its own seconds, then
     their total: instance_4096 (K6's draw at n = 128 equal to the host draw
     bit for bit; the n = 4096 draw's seconds and its instance_digest equal
     to INSTANCE_DIGEST_LARGE, frozen from the JAX package);
     aggregation_4096 (the digest of Z equal to the JAX package's
     REF_DIGEST_LARGE, then ms on REPS_LARGE distinct rolled inputs, as
     bench.py times it); protocol_4096 (the on-chip and host-spine proofs
     byte-equal and ending with Z, the default verify (MSM finals) and the
     fold verify accepting with equal statements, a tampered proof rejected
     by both, exact launch counts of each prove and verify, the 12 rounds'
     times, steady times, the default verify's split (three runs), the host
     seconds of msm_bits, of the points' decode and of the prologue (decode
     and hash), the idle share of one on-chip prove and one
     default verify); kernels_4096 (K1 over the instance, K1's pair mode
     over round 1's cross pairs, K3 on round 1's 2,048 lanes, K6 on the
     verify's 4,096 lanes, X2 over K6's output, over it with chunk and
     block edges (chunks and blocks of the chunk launch that repeat,
     cancel or lie at infinity), over its halves cancelling (the sum at
     infinity: all-zero limbs) and over its first 3,971 lanes (a ragged
     last block), and X1 on B (also equal to the [r]Q ladder), each
     against its plain version, tolerance 0, with ms, device_ms and the
     bound counted as the n = 128 rows count it, X1's and X2's with their
     latency floors); sharded_4096
     (sipp_prove_sharded on four shards of one card: 10 sharded rounds and
     a tail of 2, its proof byte-equal to the on-chip one, the shard
     count's K1/K2/K3 launches);
 12. the kernel table (one row per kernel entry point, K0-K8, X1, X2; K0's row also
     with its 2^20 case's times and bound and the empty launch's; the
     rows with an n = 4096 case also carry its numbers under "n4096"), the
     card's name and power limit (nvidia-smi), and the last line
     {"ok": true, "device": {...}}.

A kernel's bound is the larger of its bytes (inputs read once, outputs
written once, over 3.35 TB/s) and its operations as 32-bit multiply
instructions (a 32 x 32 -> 64-bit word product is two: its low and high
halves) over the card's rate of 132 SMs x 64 a clock x the maximum SM clock.
For K0-K3, K6 and K7 the operations are the Fq products that the plain
version computes on the same inputs (counted while it runs; for K6 less the
additions that this run's bits and infinity lanes skip; each Fq12 squaring,
which the plain version computes as a multiply of 54 products, counted at
the kernels' 36), 256 multiplies for an 8-word Montgomery product.  For K8
they are the Fq products of the chain the kernel runs on each lane's own
bits (its fixed window of exp.cu's FQ12_EXP_WINDOW bits: the window's
powers of x, the squarings once the power is no longer 1, a multiply for
each non-zero window and one for the offset; a squaring at 36, a multiply
at 54), against the ~127 multiplies of the plain square-and-multiply.  For
K4 and K5 they are the multiplies that the function needs (transcript_imuls: the permutations on
u64 Goldilocks, the message encode, and for K4's challenge two Fr products
and the word rows of the inverse's Montgomery division by 2^k, k counted
on this run's challenge by the host's model of the kernel's binary
extended Euclid, whose subtract-and-shift steps multiply nothing); the
plain version works on 16-bit Goldilocks limbs in Montgomery form.  For X1
they are the products of the chain validate.cu runs on each lane that is
not all-zero (x1_products: the doublings, complete mixed and Jacobian
additions and psi maps of the endomorphism test, 3 Fq products an Fq2
product); for X2 the least the sum
needs, an incomplete mixed add for each live lane but the first and
to_affine's products (the plain tree also doubles beside every addition).  X2's lines
also carry its latency floor (x2_floor_ms: ceil(log2 n) dependent
complete additions of 5 product levels each, then, unless the sum is at
infinity, the Fermat inversion's chain and to_affine's products, at the
Fq probe's cycles a product), and X1's lines its own (x1_floor_ms: the
dependent product levels of its chain, at the same cycles).  No
PyTorch call computes any of these functions, so library_ms is null.

Usage, from the root of a checkout (the first run builds the kernels with
nvcc into sipp_tpu_torch/build/):

    python3 chip_smoke.py
"""

import collections
import contextlib
import hashlib
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N = 128
LOGN = 7
SEED = 1177
# seed-1177 n=128 aggregation digest of the JAX reference (BENCH_r05.json;
# sha256 of the (2, 3, 2, 16) C-order uint32 Z, as bench.py hashes it)
REF_DIGEST = "2d267b78388f92ba"
REPS = 10
N_LARGE = 4096          # the JAX package's headline size (bench.py BENCH_N)
REPS_LARGE = 4          # bench.py BENCH_REPS at n = 4096
# seed-1177 n=4096 aggregation digest of the JAX reference (BENCH_r04.json,
# BENCH_r05.json: bench.py's whole4096 stage), hashed as REF_DIGEST
REF_DIGEST_LARGE = "aa3a48a7e00f696c"
# utils/testing.instance_digest of the JAX package's
# sipp_tpu.utils.testing.random_points(4096, 1177) (its host multiplies), made by
#   JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py --only instance4096
# (golden stage instance4096; the same value is tests/golden/torch_port.npz's
# instance4096_digest)
INSTANCE_DIGEST_LARGE = "925b7379311dfad26b1ce6abac6b7757ff07f0c61833644c9a2a4dbe8200af3b"
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden" / "torch_port.npz"
HBM_BYTES_PER_S = 3.35e12
FQ_PRODUCT_IMULS = 256                # an 8-word Montgomery product (Fq, Fr)
ADD_MIXED_PRODUCTS = 11               # field products of one incomplete mixed add
DBL_PRODUCTS = 7        # of a doubling (ladder.cuh dbl_staged; curves' dbl makes 8)
ADD_JACOBIAN_PRODUCTS = 16   # of a complete Jacobian add, its doubling case aside
PSI_PRODUCTS = 2        # of the twist's Frobenius on a Jacobian point (X and Y)
GL_PRODUCT_IMULS = 8    # Goldilocks 64 x 64 -> 128 bits: 4 word products; the
#                         reduction by 2^64 = 2^32 - 1 takes shifts and adds
MDS_TERM_IMULS = 4      # an MDS entry (< 2^32) times a u64: 2 word products
FR_DIV_ROW_IMULS = 17   # a word row of a Montgomery division: m, then m r
X2_ADD_DEPTH = 5        # dependent product levels of a complete Jacobian add
#                         (Z^2, U, H^2, H^3, R (V - X3): curves' add's formulas)
DBL_DEPTH = 3           # of a doubling (X^2, B^2, M (S - X3): ladder.cuh's stages)
FQ12_MUL_PRODUCTS = 54  # Fq products of one Fq12 multiply
FQ12_SQR_PRODUCTS = 36  # of one complex squaring (K1's and K7's table);
#                         the plain tower.fq12_sqr multiplies, 54
# The redesigned kernels' times before their last redesign (K1, K2, K3, K6,
# K7, K8: one thread per element or lane; K4, K5: shared-memory rounds and a
# Fermat inverse; X2: one lane group's chain; X1: the [r]Q ladder), quoted
# from the "before"
# column of PERF.md's kernel tables (NVIDIA H100 80GB HBM3, 700.00 W), not
# measured by this script: shown in the kernel phase lines only, under a
# key that says so, never in the kernels summary line
QUOTED_EARLIER_MS = {"final_exp_b1": 14.14, "final_exp_b2": 14.15, "fold_g1": 3.25,
                     "fold_g2": 13.09, "miller_product": 12.08, "miller_product_pair": 11.99,
                     "exp_g1": 4.35, "exp_g2": 16.86, "transcript_append_fq12": 0.238,
                     "transcript_round_tail": 0.773, "miller_step_d0": 0.1021,
                     "miller_step_d1": 0.1580, "miller_step_d2": 0.1580,
                     "miller_step_inf_d1": 0.1580, "miller_step_inf_d2": 0.1580,
                     "fq12_exp_n14": 17.09, "fq12_exp_edge_n100": 17.18,
                     "fq_mul_n4096": 0.0461, "fq_mul_n1000": 0.0359,
                     "msm_sum_g1": 0.6719, "msm_sum_g2": 1.3156,
                     "msm_sum_g1_edge_n100": 0.5636, "msm_sum_g2_edge_n100": 1.0735,
                     "msm_sum_g1_n4096": 16.268, "msm_sum_g2_n4096": 36.480,
                     "g2_torsion": 2.2305, "g2_torsion_forged_n100": 2.2313,
                     "g2_torsion_n4096": 2.457}
PROBE_ITERS = 4096
SLEEP_MS = 50           # device_ms's head start over the host's enqueue
PROBE_PERMS = 64
K0_LARGE = 1 << 20      # K0's bytes-bound batch
BLS_N = 128             # the BLS demo's n (bls_aggregation.rs:93)
SHARDS = 4              # the sharded phase's mesh: four shards on one card
BUCKET_C = 8            # the bucket MSMs' window bits
# each entry point's source under sipp_tpu_torch/csrc/ and the TPU kernel
# (or XLA program) it replaces
KERNEL_SOURCES = {"miller_product": ("miller.cu", "sipp_tpu/ops/pallas_miller.py:289"),
                  "miller_product_pair": ("miller.cu", "sipp_tpu/ops/pallas_miller.py:289"),
                  "fold_g1": ("fold.cu", "sipp_tpu/ops/pallas_fold.py:210"),
                  "fold_g2": ("fold.cu", "sipp_tpu/ops/pallas_fold.py:221"),
                  "exp_g1": ("exp.cu", "sipp_tpu/ops/pallas_exp.py:117"),
                  "exp_g2": ("exp.cu", "sipp_tpu/ops/pallas_exp.py:128"),
                  "g2_torsion": ("validate.cu", "sipp_tpu/protocol/validate.py:90"),
                  "msm_sum_g1": ("msm.cu", "sipp_tpu/protocol/verifier.py:35"),
                  "msm_sum_g2": ("msm.cu", "sipp_tpu/protocol/verifier.py:35")}
# the TPU kernel each entry point replaces (PERF.md's kernel table)
KERNEL_IDS = {"fq_mul": "K0", "miller_product": "K1", "miller_product_pair": "K1",
              "final_exp": "K2", "fold_g1": "K3", "fold_g2": "K3",
              "transcript_round_tail": "K4", "transcript_append_fq12": "K5",
              "exp_g1": "K6", "exp_g2": "K6", "miller_step": "K7", "fq12_exp": "K8",
              "g2_torsion": "X1", "msm_sum_g1": "X2", "msm_sum_g2": "X2"}
FORGED_LANE = 5         # the lane of the forged instances that sipp_verify rejects


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def setenv(name, value):
    """Set an environment variable for the block, then restore it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def ptxas_entries(log):
    """{kernel entry: "<registers line>; <stack line>"} from nvcc's
    -Xptxas -v report."""
    out, entry, lines = {}, None, log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            out[entry] = ""
        elif entry and "Function properties for " + entry in line and i + 1 < len(lines):
            out[entry] += lines[i + 1].strip() + "; "
        elif entry and "Used" in line and "registers" in line:
            out[entry] += line.split(":", 1)[1].strip()
            entry = None
    return out


@contextlib.contextmanager
def count_products():
    """Count the field products of the plain versions, keyed by limb count
    (Field.mul makes three prod_cols calls of the same batch, so a product
    counts 3), and the Fq12 squarings of tower.fq12_sqr, one per lane, under
    "fq12_sqr"."""
    from sipp_tpu_torch.fields import fq, tower

    counts = collections.Counter()
    orig, orig_sqr = fq.prod_cols, tower.fq12_sqr

    def counting(a, b):
        out = orig(a, b)
        counts[out.shape[-1] // 2] += out[..., 0].numel()
        return out

    def counting_sqr(a):
        counts["fq12_sqr"] += a[..., 0, 0, 0, 0].numel()
        return orig_sqr(a)

    fq.prod_cols, tower.fq12_sqr = counting, counting_sqr
    try:
        yield counts
    finally:
        fq.prod_cols, tower.fq12_sqr = orig, orig_sqr


def transcript_perms(appends, challenge):
    """Poseidon permutations of one launch of transcript.cu: each append is
    ceil((4 + 96) / rate), the challenge's digest one more."""
    from sipp_tpu_torch.fields import poseidon as ps

    return appends * -(-(4 + 96) // ps.RATE) + (1 if challenge else 0)


def fr_inverse_shifts(a):
    """k of transcript.cu's fr_inverse on a (canonical, mod r): the shifts
    of Kaliski's almost-inverse, whose result the Montgomery division
    takes by 2^k (0 for a = 0, which the kernel returns at once)."""
    from sipp_tpu_torch import params

    if a == 0:
        return 0
    k = (a & -a).bit_length() - 1     # v's own trailing zeros first
    u, v = params.R, a >> k
    while True:
        if u == v:
            return k + 1
        d = abs(u - v)
        n = (d & -d).bit_length() - 1
        if u > v:
            u = d >> n
        else:
            v = d >> n
        k += n


def transcript_imuls(appends, shifts=None):
    """32-bit multiplies of one launch of transcript.cu: the permutations
    (x^7 as 4 Goldilocks products), 12 Fq products an append (the message
    encode out of Montgomery form), 8 Goldilocks products (the state into
    and out of Montgomery form) and, for K4's challenge (shifts: the k of
    fr_inverse_shifts on this launch's x; None for K5), the two Fr products
    that reduce the digest mod r and take it out of Montgomery form and the
    ceil(k / 32) word rows of the division by 2^k (m and m r each).  The
    inverse's subtract-and-shift steps make no multiply."""
    from sipp_tpu_torch.fields import poseidon as ps

    sboxes = 2 * ps.N_FULL * ps.WIDTH + ps.N_PARTIAL       # x^7: 4 products each
    perm = sboxes * 4 * GL_PRODUCT_IMULS + ps.N_ROUNDS * ps.WIDTH ** 2 * MDS_TERM_IMULS
    perms = transcript_perms(appends, shifts is not None)
    fr = 0 if shifts is None else 2 * FQ_PRODUCT_IMULS + -(-shifts // 32) * FR_DIV_ROW_IMULS
    return perms * perm + 8 * GL_PRODUCT_IMULS + appends * 12 * FQ_PRODUCT_IMULS + fr


def probe_products(lib, dev):
    """Cycles per product of the latency probe (fold.cu
    fq_mul_probe_kernel: bn254.cuh's fq_mul), the result checked against
    the host's power."""
    import torch
    from sipp_tpu_torch import params
    from sipp_tpu_torch.fields import FQ

    x, y = 12345678901234567, 98765432109876543
    xy = FQ.encode([x, y], dev)
    want = x * pow(y, PROBE_ITERS, params.P) % params.P
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = torch.zeros(17, dtype=torch.int64, device=dev)
    for _ in range(2):                               # the first call warms up
        err = lib.sipp_fq_mul_probe(xy.data_ptr(), res.data_ptr(), PROBE_ITERS, stream)
    torch.cuda.synchronize()
    ok = err == 0 and FQ.decode(res[:16]) == want
    return {"fq_mul": {"cycles_per_product": int(res[16]) / PROBE_ITERS, "value_ok": ok}}


def probe_transcript(lib, dev, xs, perms=PROBE_PERMS):
    """K4/K5's dependent chain alone (transcript.cu transcript_probe_kernel,
    clock64 on the card): cycles per permutation over `perms` chained
    permutations of (0, 1, ..., 11) on one warp, and the cycles of the Fr
    inverse of each value of xs (ints mod r) on lane 0, each result checked
    on the host."""
    import torch
    from sipp_tpu_torch import params
    from sipp_tpu_torch.fields import poseidon

    limbs = torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in xs],
                         dtype=torch.int64, device=dev).reshape(-1, 16)
    out = torch.zeros(2 + 17 * len(xs), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(2):                               # the first call warms up
        err = lib.sipp_transcript_probe(limbs.data_ptr(), len(xs), out.data_ptr(), perms,
                                        stream)
    torch.cuda.synchronize()
    out = out.tolist()
    s = list(range(poseidon.WIDTH))
    for _ in range(perms):
        s = poseidon.permute(s)
    invs = [sum(v << (16 * i) for i, v in enumerate(out[3 + 17 * j:19 + 17 * j]))
            for j in range(len(xs))]
    ok = (err == 0 and out[1] % 2**64 == s[0]
          and invs == [pow(x, params.R - 2, params.R) for x in xs])
    return {"cycles_per_permutation": out[0] / perms if perms else None,
            "inverse_cycles": out[2::17], "value_ok": ok}


def idle_share(fn):
    """Device busy time and idle share over one call of fn (torch.profiler);
    None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "window"]
    # device activity: kernels and copies (not the window's own annotation)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "window"]
    if not window or not device:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    busy, end, by_name = 0.0, w0, collections.Counter()
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in device):
        s, e = max(s, end), min(e, w1)
        if e > s:
            busy += e - s
            end = e
    for e in device:
        name = e.name.split("<")[0].split("(")[0]
        by_name[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (w1 - w0),
            "top_ms": dict(by_name.most_common(6))}


def kernel_ms(fn, reps=9):
    """The median over reps launches, each between two CUDA events, after
    a warm-up: a latency-bound kernel's time moves by some percent from
    launch to launch, and one slow launch should not move the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def device_ms(fn, sleep_cycles, reps=20):
    """The device's own time per launch: reps launches queued behind a
    sleep on the stream, between two CUDA events, so that each launch's
    host work (the Python wrapper, which kernel_ms's events bracket)
    overlaps the launches before it.  A short kernel's kernel_ms is
    mostly that host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensors(obj):
    """The tensors of a nest of tuples and lists, in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors(o)]
    return []


def plain_ms(fn):
    """(fn(), its host-clocked ms, the field products it made: count_products'
    keys, a product once)."""
    import torch

    torch.cuda.synchronize()
    with count_products() as counts:
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
    return out, ms, {k: c // 3 if isinstance(k, int) else c for k, c in counts.items()}


def compare(got, want):
    """(max |got - want| over the outputs' limbs, whether the shapes match
    and that is 0)."""
    err = max(int((g - w).abs().max()) for g, w in zip(tensors(got), tensors(want)))
    same = all(g.shape == w.shape for g, w in zip(tensors(got), tensors(want)))
    return err, same and err == 0


def bound(imuls, nbytes, imul_per_s):
    """(bound_ms, bound_by): the larger of the 32-bit multiplies at the
    card's rate and the bytes at HBM_BYTES_PER_S."""
    ops_ms, bytes_ms = imuls / imul_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def launch_counters():
    """(wrapper, attribute, counter name) of every kernel's launch count."""
    from sipp_tpu_torch.ops import exp, fexp, fold, fq, miller, msm, transcript
    from sipp_tpu_torch.ops import validate as x1

    return [(miller.miller_product, "launches", "miller_product"),
            (miller.miller_product, "pair_launches", "miller_product_pair"),
            (fexp.final_exp, "launches", "final_exp"),
            (fold.fold_g1, "launches", "fold_g1"),
            (fold.fold_g2, "launches", "fold_g2"),
            (transcript.transcript_append_fq12, "launches", "transcript_append_fq12"),
            (transcript.transcript_round_tail, "launches", "transcript_round_tail"),
            (exp.exp_g1, "launches", "exp_g1"),
            (exp.exp_g2, "launches", "exp_g2"),
            (miller.miller_step, "launches", "miller_step"),
            (exp.fq12_exp, "launches", "fq12_exp"),
            (fq.fq_mul, "launches", "fq_mul"),
            (x1.g2_torsion, "launches", "g2_torsion"),
            (msm.msm_sum_g1, "launches", "msm_sum_g1"),
            (msm.msm_sum_g2, "launches", "msm_sum_g2")]


def driven(fn):
    """Run fn with every launch counter set to 0 just before; returns
    (result, seconds, counts read just after)."""
    import torch

    counters = launch_counters()
    for f, attr, _ in counters:
        setattr(f, attr, 0)
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t, {name: getattr(f, attr) for f, attr, name in counters}


def k6_skipped(x, bits):
    """Field products of the incomplete adds that K6 skips: lanes whose bit
    is 0, and every add of an x at infinity."""
    from sipp_tpu_torch import curves

    live = ~curves.G1.is_affine_infinity(x) if x.dim() == 3 else \
        ~curves.G2.is_affine_infinity(x)
    adds = int((bits.sum(0) * live).sum())
    return ADD_MIXED_PRODUCTS * (254 * x.shape[0] - adds)


def x2_products(curve, lanes):
    """Fq products of an X2 sum's least work: an incomplete mixed add for
    each live lane but the first (3 Fq products an Fq2 product in G2), and
    to_affine, counted on the plain version."""
    from sipp_tpu_torch.curves import G2

    live = int((~curve.is_affine_infinity(lanes)).sum())
    with count_products() as counts:
        curve.to_affine(curve.lift(lanes[:1]))
    per_fq2 = 3 if curve is G2 else 1
    return ADD_MIXED_PRODUCTS * per_fq2 * max(live - 1, 0) + counts[16] // 3


def msm_define(name):
    """A constant of csrc/msm.cu: MSM_CHUNK, the lanes one group of X2's
    chunk launch chains, or MSM_GROUPS, the groups of a block."""
    from sipp_tpu_torch.ops import _build

    return int(re.search(rf"#define {name} (\d+)", (_build.CUDA_SRC / "msm.cu").read_text())[1])


def x2_floor_ms(curve, lanes, total, cycles_per_product, sm_mhz):
    """X2's latency floor over these lanes: ceil(log2 n) dependent complete
    additions of X2_ADD_DEPTH product levels each (every bracketing of the
    sum is a tree at least that deep), then, unless the sum `total` is at
    infinity (all-zero), to_affine's chain: fq_inv's Fermat
    square-and-multiply (256 squarings and a multiply a set bit of p - 2;
    in G2 the norm's squares before it and a product after it), then
    zinv^2, zinv^3 and y; an Fq2 product counted as one Fq product (its
    parts on separate threads), at the probe's cycles a dependent Fq
    product and the maximum SM clock, with no launch, load or store."""
    from sipp_tpu_torch import params
    from sipp_tpu_torch.curves import G2

    inv = 256 + bin(params.P - 2).count("1") + (2 if curve is G2 else 0) + 3
    levels = (lanes.shape[0] - 1).bit_length()
    products = X2_ADD_DEPTH * levels + (0 if bool((total == 0).all()) else inv)
    return products * cycles_per_product / (sm_mhz * 1e3)


def x1_products(pts):
    """Fq products of X1's chain (validate.cu) on the lanes of pts that are
    not all-zero (an all-zero lane's verdict needs none): [x0]Q from
    infinity (a doubling a bit past the first, a complete mixed addition a
    set bit), psi three times, the doubling of W, the complete mixed
    addition of Q and three complete Jacobian additions, each Fq2 product 3
    Fq products.  The doubling that a complete addition adds on a lane
    where P == Q is left out: only points of small order meet it, a few
    times a run, so the count stays at or below the work."""
    from sipp_tpu_torch import params
    from sipp_tpu_torch.curves import G2

    x = params.X
    fq2 = (DBL_PRODUCTS * x.bit_length() + ADD_MIXED_PRODUCTS * (bin(x).count("1") + 1)
           + 3 * PSI_PRODUCTS + 3 * ADD_JACOBIAN_PRODUCTS)
    return 3 * fq2 * int((~G2.is_affine_infinity(pts)).sum())


def x1_floor_ms(cycles_per_product, sm_mhz):
    """X1's latency floor a lane: the dependent product levels of
    validate.cu's chain, [x0]Q (a doubling a bit past the first, a complete
    mixed addition a set bit), then psi three times (one level each), a
    doubling and four additions, an Fq2 product counted as one Fq product
    (its parts on separate threads), at the probe's cycles a dependent Fq
    product and the maximum SM clock, with no launch, load or store."""
    from sipp_tpu_torch import params

    x = params.X
    levels = (DBL_DEPTH * (x.bit_length() - 1) + X2_ADD_DEPTH * bin(x).count("1")
              + 3 + DBL_DEPTH + 4 * X2_ADD_DEPTH)
    return levels * cycles_per_product / (sm_mhz * 1e3)


def x2_edge(curve, pts):
    """100 lanes for X2 from K6-like lanes: a repeated lane that the chain
    doubles (P, P), then -[2]P (the sum back at infinity), infinity lanes,
    a cancelling pair (Q, -Q) and a lane repeated far from its twin."""
    lanes = pts[:100].clone()
    lanes[1] = lanes[0]
    lanes[2] = curve.neg(curve.to_affine(curve.dbl(curve.jac_from_affine(lanes[0:1]))))[0]
    lanes[[3, 40, 77]] = 0
    lanes[5] = curve.neg(lanes[4:5])[0]
    lanes[90] = lanes[6]
    return lanes


def x2_chunk_edges(curve, lanes, chunk, block):
    """X2's chunk and block edges on K6's lanes: the second chunk repeats
    the first (the block's tree doubles), the fourth negates the third (a
    sum at infinity), the sixth is at infinity; the third block repeats the
    second (the tree launch doubles), the fifth negates the fourth, the
    seventh is at infinity.  chunk: lanes a group; block: lanes a block of
    the chunk launch."""
    lanes = lanes.clone()
    lanes[chunk:2 * chunk] = lanes[:chunk]
    lanes[3 * chunk:4 * chunk] = curve.neg(lanes[2 * chunk:3 * chunk])
    lanes[5 * chunk:6 * chunk] = 0
    lanes[2 * block:3 * block] = lanes[block:2 * block]
    lanes[4 * block:5 * block] = curve.neg(lanes[3 * block:4 * block])
    lanes[6 * block:7 * block] = 0
    return lanes


def challenges(a, b, proof):
    """(x_k, x_k^-1) of each round of a proof of (a, b), replayed on the
    host transcript."""
    from sipp_tpu_torch import params
    from sipp_tpu_torch.fields import tower
    from sipp_tpu_torch.protocol import prover

    tr = prover.prologue(a, b)
    tr.append_fq12(tower.fq12_decode(proof[-1]))
    xs = []
    for k in range((proof.shape[0] - 1) // 2):
        tr.append_fq12(tower.fq12_decode(proof[-2 - 2 * k]))
        tr.append_fq12(tower.fq12_decode(proof[-3 - 2 * k]))
        x = tr.get_challenge()
        xs.append((x, pow(x, -1, params.R)))
    return xs


def sharded_launches(logn, shards=SHARDS):
    """K1/K2/K3 launches of one sharded prove: Z, a K1 launch a shard and
    one K2; each round while n > d, a pair-mode K1, a K3-G1 and a K3-G2
    launch a shard and one K2; the tail's log2(d) rounds on the lead card,
    one of each."""
    tail = shards.bit_length() - 1
    rounds = logn - tail
    return rounds, tail, {"miller_product": shards,
                          "miller_product_pair": shards * rounds + tail,
                          "final_exp": 1 + rounds + tail, "fold_g1": shards * rounds + tail,
                          "fold_g2": shards * rounds + tail}


def run_large(dev, smi, imul_per_s, sleep_cycles, cycles, sm_mhz, a128, b128):
    """The n = 4096 phases on the seed-1177 instance, drawn on the card by
    K6: instance_4096, aggregation_4096, protocol_4096, kernels_4096 and
    sharded_4096, then their total seconds.  a128, b128: the host draw of
    the n = 128 instance, which K6's draw must equal bit for bit; cycles:
    the Fq probe's cycles a dependent product (X2's latency floor).  Raises
    SystemExit where a check fails.  Returns ({case: kernel case as the
    n = 128 table holds it}, {path: launch counts})."""
    import torch
    from sipp_tpu_torch import convert, curves
    from sipp_tpu_torch.curves import G1, G2, scalar_to_bits
    from sipp_tpu_torch.fields import tower
    from sipp_tpu_torch.ops import exp, fold, miller, msm
    from sipp_tpu_torch.ops import validate as x1
    from sipp_tpu_torch.pairing import ate
    from sipp_tpu_torch.parallel import Mesh, sipp_prove_sharded
    from sipp_tpu_torch.protocol import (VerificationError, prover, sipp_prove,
                                         sipp_prove_onchip, sipp_verify, verifier)
    from sipp_tpu_torch.utils.testing import instance_digest, ladder_instance, random_instance

    t_large = time.time()
    n, logn = N_LARGE, N_LARGE.bit_length() - 1

    # ------------------------------------------------------ instance_4096
    t_phase = time.time()
    k6_128 = ladder_instance(N, SEED, dev)
    k6_equals_host = torch.equal(k6_128[0], a128) and torch.equal(k6_128[1], b128)
    torch.cuda.synchronize()
    t = time.time()
    a, b = random_instance(n, SEED, dev)
    torch.cuda.synchronize()
    draw_s = time.time() - t
    t = time.time()
    inst_digest = instance_digest(a, b)
    digest_s = time.time() - t
    emit({"phase": "instance_4096", "n": n, "seed": SEED, "draw_s": draw_s,
          "instance_digest": inst_digest, "frozen_digest": INSTANCE_DIGEST_LARGE,
          "digest_host_s": digest_s, "k6_draw_equals_host_draw_n128": k6_equals_host,
          "seconds": time.time() - t_phase, "card": smi})
    if inst_digest != INSTANCE_DIGEST_LARGE or not k6_equals_host:
        raise SystemExit("K6's draw differs from the host draw at n = 128, or its n = 4096 "
                         "instance digest from the JAX package's")

    # --------------------------------------------------- aggregation_4096
    t_phase = time.time()
    z = ate.inner_product(a, b)
    digest = hashlib.sha256(convert.to_reference(z).tobytes()).hexdigest()[:16]
    assert REPS_LARGE + 1 < n, "rolled inputs would repeat"
    insts = [(torch.roll(a, i + 1, 0), torch.roll(b, i + 1, 0)) for i in range(REPS_LARGE)]
    torch.cuda.synchronize()
    t = time.time()
    for x, y in insts:
        zz = ate.inner_product(x, y)
    torch.cuda.synchronize()
    agg_ms = (time.time() - t) / REPS_LARGE * 1e3
    emit({"phase": "aggregation_4096", "n": n, "digest": digest,
          "reference_digest": REF_DIGEST_LARGE, "reps": REPS_LARGE,
          "ms_per_aggregation": agg_ms, "pairings_per_s": n / agg_ms * 1e3,
          "seconds": time.time() - t_phase, "card": smi})
    if digest != REF_DIGEST_LARGE or not torch.equal(zz, z):
        raise SystemExit(f"n = 4096 aggregation digest {digest} != {REF_DIGEST_LARGE} or "
                         "rolled input changed the product")

    # ------------------------------------------------------ protocol_4096
    t_phase = time.time()
    (proof_o, tr_o), prove_onchip_s, launches_b = driven(
        lambda: sipp_prove_onchip(a, b, return_transcript=True))
    (proof_h, tr_h), prove_host_s, launches_h = driven(
        lambda: sipp_prove(a, b, return_transcript=True))
    with setenv("SIPP_VERIFY_MSM", "auto"):
        stmt_msm, verify_msm_s, launches_c = driven(lambda: sipp_verify(a, b, proof_o))
    with setenv("SIPP_VERIFY_MSM", "0"):
        stmt_fold, verify_fold_s, launches_f = driven(lambda: sipp_verify(a, b, proof_h))
    bad = proof_o.clone()
    bad[1, 0, 0, 0, 0] = (bad[1, 0, 0, 0, 0] + 1) % 0xFFFF
    rejected = {}
    for mode in ("auto", "0"):
        with setenv("SIPP_VERIFY_MSM", mode):
            try:
                sipp_verify(a, b, bad)
                rejected[mode] = False
            except VerificationError:
                rejected[mode] = True
    round_times = []
    sipp_prove_onchip(a, b, round_times=round_times)
    steady = {"prove_onchip_s": driven(lambda: sipp_prove_onchip(a, b))[1],
              "prove_host_s": driven(lambda: sipp_prove(a, b))[1]}
    with setenv("SIPP_VERIFY_MSM", "auto"):
        steady["verify_msm_s"] = driven(lambda: sipp_verify(a, b, proof_o))[1]
    splits = []
    for _ in range(3):
        sp = {}
        torch.cuda.synchronize()
        t = time.time()
        stmt_sp = sipp_verify(a, b, proof_o, split=sp)
        sp["total_s"] = time.time() - t
        splits.append(sp)
    xs = challenges(a, b, proof_o)
    # host work that grows with n: msm_bits (the MSM finals' scalars), and
    # the points' decode and prologue hash of every prove and verify
    host = {}
    t = time.time()
    bits_a, bits_b = verifier.msm_bits(xs, n)
    host["msm_bits_s"] = time.time() - t
    t = time.time()
    curves.g1_decode(a), curves.g2_decode(b)
    host["decode_s"] = time.time() - t
    t = time.time()
    prover.prologue(a, b)
    host["prologue_s"] = time.time() - t
    idle = {"onchip_prove": idle_share(lambda: sipp_prove_onchip(a, b)),
            "default_verify": idle_share(lambda: sipp_verify(a, b, proof_o))}
    # exact launches: an on-chip prove, a host-spine prove, a default verify
    # (MSM finals) and a fold verify; every other counter 0
    want = {"B": {"miller_product": 1, "miller_product_pair": logn, "final_exp": 1 + logn,
                  "fold_g1": logn, "fold_g2": logn, "transcript_round_tail": logn,
                  "transcript_append_fq12": 1},
            "host_spine": {"miller_product": 1, "miller_product_pair": logn,
                           "final_exp": 1 + logn, "fold_g1": logn, "fold_g2": logn},
            "C": {"miller_product": 1, "final_exp": 1, "exp_g1": 1, "exp_g2": 1,
                  "g2_torsion": 1, "msm_sum_g1": 1, "msm_sum_g2": 1},
            "fold_verify": {"miller_product": 1, "final_exp": 1, "fold_g1": logn,
                            "fold_g2": logn, "g2_torsion": 1}}
    got = {"B": launches_b, "host_spine": launches_h, "C": launches_c, "fold_verify": launches_f}
    main_path = {k: launches_b[k] + launches_c[k] for k in launches_b}
    checks = {
        "onchip_equals_host_spine": np.array_equal(convert.to_reference(proof_o),
                                                   convert.to_reference(proof_h)),
        "transcript_states_equal": tr_o.state == tr_h.state,
        "proof_shape": tuple(proof_o.shape) == (2 * logn + 1, 2, 3, 2, 16),
        "proof_z_equals_aggregation": torch.equal(proof_o[-1], z),
        "statement_z_equals_aggregation": stmt_msm.Z == tower.fq12_decode(z),
        "statements_equal": stmt_msm == stmt_fold and stmt_sp == stmt_msm,
        "tampered_rejected_msm": rejected["auto"], "tampered_rejected_fold": rejected["0"],
        **{f"launches_exact_{p}": all(got[p][k] == w.get(k, 0) for k in got[p])
           for p, w in want.items()}}
    emit({"phase": "protocol_4096", "n": n, "prove_onchip_s": prove_onchip_s,
          "prove_host_s": prove_host_s, "verify_msm_s": verify_msm_s,
          "verify_fold_s": verify_fold_s, "steady": steady,
          "fold_round_latency_ms_n4096": statistics.median(round_times) * 1e3,
          "round_ms": [t * 1e3 for t in round_times], "verify_split": splits,
          "verify_split_median": {k: statistics.median(sp[k] for sp in splits)
                                  for k in splits[0]},
          "host": host, "idle": idle, "launches": got,
          "launches_main_path": main_path, "checks": checks,
          "seconds": time.time() - t_phase, "card": smi})
    if not all(checks.values()):
        raise SystemExit(f"an n = 4096 protocol check failed: {checks}")

    # ------------------------------------------------------- kernels_4096
    # each kernel at the n = 4096 path's own shapes against its plain
    # version: K1 over the instance (Z), K1 pair over round 1's cross
    # pairs, K3 on round 1's folds (2,048 lanes), and the verify's MSM
    # finals: K6 over 4,096 lanes, then X2 over its output, and X2 over
    # that output with chunk and block edges (x2_chunk_edges), over its two
    # halves' negation (a sum at infinity) and over its first 3,971 lanes
    # (63 blocks, the last of 3 lanes); X1 on B (K2, K4 and K5 take the
    # same shapes at every n)
    m = n // 2
    pair_p = torch.stack([a[m:], a[:m]], dim=1).reshape(n, 2, 16)
    pair_q = torch.stack([b[:m], b[m:]], dim=1).reshape(n, 2, 2, 16)
    xbits, xinvbits = scalar_to_bits(xs[0][0]), scalar_to_bits(xs[0][1])
    msm_a, msm_b = (torch.as_tensor(v, device=dev) for v in (bits_a, bits_b))
    zeros_a, zeros_b = torch.zeros_like(a), torch.zeros_like(b)
    lanes_a, lanes_b = exp.exp_g1(a, zeros_a, msm_a), exp.exp_g2(b, zeros_b, msm_b)
    chunk = msm_define("MSM_CHUNK")
    x2_large = {}
    for g, curve, lanes in (("g1", G1, lanes_a), ("g2", G2, lanes_b)):
        x2_large[f"msm_sum_{g}_n4096"] = lanes
        x2_large[f"msm_sum_{g}_chunk_edges_n4096"] = x2_chunk_edges(
            curve, lanes, chunk, chunk * msm_define("MSM_GROUPS"))
        x2_large[f"msm_sum_{g}_inf_n4096"] = torch.cat([lanes[:m], curve.neg(lanes[:m])])
        x2_large[f"msm_sum_{g}_n3971"] = lanes[:3971]

    def x2(name):
        lanes, curve = x2_large[name], G2 if "_g2" in name else G1
        kern = msm.msm_sum_g2 if curve is G2 else msm.msm_sum_g1
        return (name, name[:len("msm_sum_g1")], lambda: kern(lanes),
                lambda: msm.msm_finish_plain(curve, lanes), (lanes,))

    cases = [
        ("miller_product_n4096", "miller_product", lambda: miller.miller_product(a, b),
         lambda: miller.miller_product_plain(a, b), (a, b)),
        ("miller_product_pair_n4096", "miller_product_pair",
         lambda: miller.miller_product(pair_p, pair_q, pair=True),
         lambda: miller.miller_product_plain(pair_p, pair_q, pair=True), (pair_p, pair_q)),
        ("fold_g1_n2048", "fold_g1", lambda: fold.fold_g1(a[:m], a[m:], xbits),
         lambda: fold.fold_g1_plain(a[:m], a[m:], xbits), (a[:m], a[m:])),
        ("fold_g2_n2048", "fold_g2", lambda: fold.fold_g2(b[:m], b[m:], xinvbits),
         lambda: fold.fold_g2_plain(b[:m], b[m:], xinvbits), (b[:m], b[m:])),
        ("exp_g1_n4096", "exp_g1", lambda: exp.exp_g1(a, zeros_a, msm_a),
         lambda: exp.exp_g1_plain(a, zeros_a, msm_a), (a, zeros_a, msm_a)),
        ("exp_g2_n4096", "exp_g2", lambda: exp.exp_g2(b, zeros_b, msm_b),
         lambda: exp.exp_g2_plain(b, zeros_b, msm_b), (b, zeros_b, msm_b)),
        *(x2(name) for name in x2_large),
        ("g2_torsion_n4096", "g2_torsion", lambda: x1.g2_torsion(b),
         lambda: x1.g2_torsion_plain(b), (b,)),
    ]
    products_needed = {"exp_g1_n4096": lambda p: p.get(16, 0) - k6_skipped(a, msm_a),
                       "exp_g2_n4096": lambda p: p.get(16, 0) - 3 * k6_skipped(b, msm_b),
                       **{name: (lambda p, lanes=lanes, curve=G2 if "_g2" in name else G1:
                                 x2_products(curve, lanes)) for name, lanes in x2_large.items()},
                       "g2_torsion_n4096": lambda p: x1_products(b)}
    table = {}
    for name, counter, kern, plain, inputs in cases:
        t_case = time.time()
        got_k = kern()
        want_k, p_ms, products = plain_ms(plain)
        err, ok = compare(got_k, want_k)
        k_ms, d_ms = kernel_ms(kern), device_ms(kern, sleep_cycles)
        # as the n = 128 rows: an Fq12 squaring at the complex squaring's
        # products; K6 less what its bits skip; X1 its chain; X2 its least work
        needed = products_needed.get(name, lambda p: p.get(16, 0) - (
            FQ12_MUL_PRODUCTS - FQ12_SQR_PRODUCTS) * p.get("fq12_sqr", 0))(products)
        bound_ms, bound_by = bound(FQ_PRODUCT_IMULS * needed, 8 * sum(
            t.numel() for t in tensors(inputs) + tensors(got_k)), imul_per_s)
        src, replaces = KERNEL_SOURCES[counter]
        table[name] = {"name": name, "route": "cuda", "source": f"sipp_tpu_torch/csrc/{src}",
                       "replaces": replaces, "counter": counter, "max_abs_err": err,
                       "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None}
        extra = ({"earlier_ms_quoted_from_perf_md": QUOTED_EARLIER_MS[name]}
                 if name in QUOTED_EARLIER_MS else {})
        if name in x2_large:
            table[name]["latency_floor_ms"] = extra["latency_floor_ms"] = x2_floor_ms(
                G2 if "_g2" in name else G1, x2_large[name], want_k, cycles, sm_mhz)
        elif counter == "g2_torsion":
            table[name]["latency_floor_ms"] = extra["latency_floor_ms"] = x1_floor_ms(
                cycles, sm_mhz)
            extra["equals_r_ladder"] = torch.equal(got_k, x1.g2_torsion_r_ladder(b))
            ok = ok and extra["equals_r_ladder"]
        emit({"phase": "kernels_4096", "n": n, "name": name,
              "shape": [list(t.shape) for t in tensors(got_k)], "bit_equal": ok,
              "max_abs_err": err, "tolerance": 0, "ms": k_ms, "device_ms": d_ms, **extra,
              "plain_ms": p_ms, "plain_products": products, "products_needed": needed,
              "bound_ms": bound_ms, "bound_by": bound_by, "seconds": time.time() - t_case,
              "card": smi})
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version at n = 4096")
    if not all(bool((out == 0).all()) for out in (
            msm.msm_sum_g1(x2_large["msm_sum_g1_inf_n4096"]),
            msm.msm_sum_g2(x2_large["msm_sum_g2_inf_n4096"]))):
        raise SystemExit("X2's sum at infinity is not all-zero limbs at n = 4096")

    # ------------------------------------------------------- sharded_4096
    t_phase = time.time()
    one_card = Mesh((dev,) * SHARDS)
    proof_sh, sharded_s, launches_sh = driven(lambda: sipp_prove_sharded(a, b, one_card))
    rounds_sh, tail_sh, want_sh = sharded_launches(logn)
    checks_sh = {"equals_onchip": torch.equal(proof_sh, proof_o),
                 "launches_match_shards": all(launches_sh[k] == v for k, v in want_sh.items())}
    emit({"phase": "sharded_4096", "n": n, "shards": SHARDS, "rounds_sharded": rounds_sh,
          "rounds_tail": tail_sh, "prove_s": sharded_s, "launches": launches_sh,
          "launches_expected": want_sh, "checks": checks_sh,
          "seconds": time.time() - t_phase, "card": smi})
    if not all(checks_sh.values()):
        raise SystemExit(f"an n = 4096 sharded prover check failed: {checks_sh}")
    emit({"phase": "n4096_total", "n": n, "seconds": time.time() - t_large, "card": smi})
    paths = {"B_4096": launches_b, "C_4096": launches_c,
             "A_4096": {k: launches_h[k] + launches_f[k] for k in launches_h},
             "sharded_4096": launches_sh}
    return table, paths


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    from sipp_tpu_torch import convert, curves, hostref, native, params
    from sipp_tpu_torch.curves import G1, G2, scalar_to_bits
    from sipp_tpu_torch.fields import FGL, FQ, tower
    from sipp_tpu_torch.apps.bls_aggregation import map_to_g2_without_cofactor_mul
    from sipp_tpu_torch.ops import _build, exp, fexp, fold, fq, miller, msm, transcript
    from sipp_tpu_torch.ops import validate as x1
    from sipp_tpu_torch.pairing import ate
    from sipp_tpu_torch.protocol import (VerificationError, prover, sipp_prove,
                                         sipp_prove_onchip, sipp_verify, validate, verifier)
    from sipp_tpu_torch.protocol import transcript as host_transcript
    from sipp_tpu_torch.utils.testing import random_points

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    imul_per_s = 132 * 64 * sm_mhz * 1e6
    sleep_cycles = int(SLEEP_MS * sm_mhz * 1e3)   # at most SLEEP_MS of spin

    # ---------------------------------------------------------- 1. device
    t0 = time.time()
    _build.cuda_library()
    build_s = time.time() - t0
    t0 = time.time()
    native.get_lib()            # the host transcript library, built with g++
    host_build_s = time.time() - t0
    emit({"phase": "device", "card": smi, "sm_max_mhz": sm_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "host_build_s": host_build_s,
          "ptxas": ptxas_entries(_build.BUILD_INFO["log"])})
    probe = probe_products(_build.cuda_library(), dev)
    emit({"phase": "fq_product_probe", "iters": PROBE_ITERS, "modes": probe,
          "sm_clock_mhz": subprocess.run(
              ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
              capture_output=True, text=True, check=True).stdout.split()[0], "card": smi})
    if not all(m["value_ok"] for m in probe.values()):
        raise SystemExit("the Fq product probe computed a wrong value")
    # K4/K5's latency floor: their chain of permutations (and K4's inverse,
    # probed on each K4 case's own challenge below) at the probe's cycles
    # and the maximum SM clock, with no launch, load, encode or store; the
    # inverse also on a full-width value, a SHA-256 digest mod r
    probe_x = int.from_bytes(hashlib.sha256(b"fr_inverse").digest(), "little") % params.R
    tr_probe = probe_transcript(_build.cuda_library(), dev, [probe_x])
    perm_ms = tr_probe["cycles_per_permutation"] / (sm_mhz * 1e3)
    emit({"phase": "transcript_probe", "perms": PROBE_PERMS, **tr_probe,
          "inverse_of": "sha256(b'fr_inverse') mod r",
          "inverse_shifts": fr_inverse_shifts(probe_x),
          "latency_floor_ms_k5": transcript_perms(1, False) * perm_ms,
          "sm_max_mhz": sm_mhz, "card": smi})
    if not tr_probe["value_ok"]:
        raise SystemExit("the transcript probe computed a wrong value")

    t0 = time.time()
    a_pts, b_pts = random_points(N, seed=SEED)       # the host draw (hostref)
    a, b = curves.g1_encode(a_pts, dev), curves.g2_encode(b_pts, dev)
    emit({"phase": "instance", "n": N, "seed": SEED, "host_s": time.time() - t0})

    # ------------------------------------- 2. kernels against plain versions
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
    # 130 lanes: 33 blocks of 4 lanes, the last with 2 lanes past n, whose
    # partials the kernel's second launch multiplies
    pp_130, pq_130 = torch.cat([pp_inf, pair_p[:2]]), torch.cat([pq_inf, pair_q[:2]])

    def k1(p, q, pair=False):
        return (lambda: miller.miller_product(p, q, pair=pair),
                lambda: miller.miller_product_plain(p, q, pair=pair), (p, q))

    k1_src = KERNEL_SOURCES["miller_product"]
    dead = slice(N - 8, N)
    lo1, hi1 = a.clone(), torch.roll(a, 1, 0)
    lo2, hi2 = b.clone(), torch.roll(b, 1, 0)
    for t in (lo1, hi1, lo2, hi2):
        t[dead] = 0
    for t in (lo1, lo2):
        t[[5, 70]] = 0             # a dead lo under a live hi: [x] hi
    for t in (hi1, hi2):
        t[[6, 71]] = 0             # a dead hi under a live lo: lo
    fold_x = params.R - 12345      # a fixed challenge with its top bit set
    xbits = scalar_to_bits(fold_x)
    xinvbits = scalar_to_bits(pow(fold_x, -1, params.R))

    # K4/K5 inputs from the n = 128 run: the state after the point prologue,
    # Z and the state after Z (each round's state and (Z_L, Z_R) follow the
    # on-chip proof below); and a state whose words are 0 and p - 1
    z128 = fexp.final_exp(f_one[None])[0]
    state0 = FGL.encode(prover.prologue(a, b).state, dev)
    state1 = transcript.transcript_append_fq12(state0, z128)
    state_edge = FGL.encode([0, params.GOLDILOCKS_P - 1, params.GOLDILOCKS_P - 1, 0], dev)

    # K6 inputs: MSM-finals bits of seeded challenges at 128 lanes with zero
    # offsets (the verifier's call); and 100 lanes with infinity x lanes,
    # random offsets, infinity offsets and offsets equal to [k]x
    rng = np.random.default_rng(SEED)
    xs = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(7)]
    bits_a, bits_b = verifier.msm_bits([(x, pow(x, -1, params.R)) for x in xs], N)
    msm_a = torch.as_tensor(bits_a, device=dev)
    msm_b = torch.as_tensor(bits_b, device=dev)
    E = 100
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(E)]
    edge_bits = torch.as_tensor(np.stack([scalar_to_bits(k) for k in ks], 1).astype(np.int64),
                                device=dev)
    x_inf, off_inf, off_eq = [1, 50, 99], [2, 51, 98], [3, 52, 97]

    def edge(x, off, decode, encode, mul):
        x, off = x[:E].clone(), off[:E].clone()
        x[x_inf] = 0
        off[off_inf] = 0
        pts = decode(x[off_eq])
        off[off_eq] = encode([mul(pt, ks[i]) for pt, i in zip(pts, off_eq)], dev)
        return x, off

    ex1, eo1 = edge(a, torch.roll(a, 7, 0), curves.g1_decode, curves.g1_encode, hostref.g1_mul)
    ex2, eo2 = edge(b, torch.roll(b, 7, 0), curves.g2_decode, curves.g2_encode, hostref.g2_mul)

    def k6(fn, plain, x, off, bits):
        return (lambda: fn(x, off, bits), lambda: plain(x, off, bits), (x, off, bits))

    # K7 inputs: the carry after the first three digits (plain steps), on
    # the instance and on the instance with infinity lanes
    def step_inputs(p, q, steps=3):
        f, t, qn = ate.miller_start(p, q)
        for d in ate.DIGITS[:steps]:
            f, t = miller.miller_step_plain(d, q, qn, p, f, t)
        return q, qn, p, f.contiguous(), t

    step_args, step_inf_args = step_inputs(a, b), step_inputs(a_inf, b_inf)

    def k7(digit, args):
        q, qn, p, f, t = args
        read = (q, p, f, t) if digit == 1 else (qn, p, f, t) if digit == 2 else (p, f, t)
        return (lambda: miller.miller_step(digit, *args),
                lambda: miller.miller_step_plain(digit, *args), read)

    # K8 inputs: the verifier's Z' chain rows of a proof of this instance,
    # with their challenge bits and offsets of one; and 100 lanes of seeded
    # Fq12 values with all-zero bits, offsets of one and x = 1
    def z_rows(xs):
        """The verifier's (proof row, exponent) pairs, in its order."""
        return [r for k, (x, x_inv) in enumerate(xs)
                for r in ((2 * LOGN - 1 - 2 * k, x), (2 * LOGN - 2 - 2 * k, x_inv))]

    def bits_of(exps):
        return torch.as_tensor(np.stack([scalar_to_bits(e) for e in exps], 1).astype(np.int64),
                               device=dev)

    proof_k8 = sipp_prove_onchip(a, b)
    rows_k8 = z_rows(challenges(a, b, proof_k8))
    # K4 inputs: every round's (state, Z_L, Z_R) of that on-chip run, the
    # states chained as the prover chains them
    tail_inputs, st = [], state1
    for k in range(LOGN):
        zl, zr = proof_k8[2 * LOGN - 1 - 2 * k], proof_k8[2 * LOGN - 2 - 2 * k]
        tail_inputs.append((st, zl, zr))
        st = transcript.transcript_round_tail(st, zl, zr)[0]
    tail_inputs.append((state_edge, *tail_inputs[0][1:]))
    k8_x = torch.stack([proof_k8[i] for i, _ in rows_k8])
    k8_one = tower.fq12_one((len(rows_k8),), dev).contiguous()
    k8_bits = bits_of([e for _, e in rows_k8])

    def fq12_values(k):
        v = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12 * k)]
        return tower.fq12_encode([tuple(tuple((v[12 * e + 6 * i + 2 * j], v[12 * e + 6 * i + 2 * j + 1])
                                              for j in range(3)) for i in range(2))
                                  for e in range(k)]).to(dev)

    e8_x, e8_off, e8_bits = fq12_values(E), fq12_values(E), edge_bits.clone()
    bits0, off_one, x_one, off_zero = [4, 53, 96], [5, 54, 95], [6, 55, 94], [7, 56, 93]
    e8_bits[:, bits0] = 0
    e8_off[off_one] = tower.fq12_one((), dev)
    e8_x[x_one] = tower.fq12_one((), dev)
    e8_off[off_zero] = 0
    k8_forged = fq12_values(len(rows_k8))       # rows off the cyclotomic subgroup
    if any(torch.equal(c, q) for c, q in zip(tower.fq12_cyclo_sqr(k8_forged),
                                              tower.fq12_sqr(k8_forged))):
        raise SystemExit("a forged K8 row lies in the cyclotomic subgroup")

    def k8(x, off, bits):
        return (lambda: exp.fq12_exp(x, off, bits), lambda: exp.fq12_exp_plain(x, off, bits),
                (x, off, bits))

    k8_window = int(re.search(r"#define FQ12_EXP_WINDOW (\d+)", (
        pathlib.Path(exp.__file__).resolve().parent.parent / "csrc" / "exp.cu").read_text())[1])

    def k8_products(bits, w=k8_window):
        """Fq products of the chain that exp.cu's fq12_exp_kernel runs, on
        each lane's own bits: x^2 .. x^(2^w - 1) (2^w - 2 multiplies); then,
        window by window (the first one (254 - 1) % w + 1 bits wide, the
        others w), w squarings once an earlier window was not 0 and a
        multiply where this one is not 0; then the offset's multiply."""
        b = bits.cpu().numpy() != 0
        edges = [0, *range((len(b) - 1) % w + 1, len(b) + 1, w)]
        nonzero = np.stack([b[lo:hi].any(0) for lo, hi in zip(edges, edges[1:])])
        started = np.cumsum(nonzero, 0) - nonzero > 0
        squarings = int((np.diff(edges)[:, None] * started).sum())
        multiplies = (2 ** w - 1) * b.shape[1] + int(nonzero.sum())
        return FQ12_SQR_PRODUCTS * squarings + FQ12_MUL_PRODUCTS * multiplies

    # K0 inputs: the entry point's batch, an odd one, and the bytes-bound
    # batch drawn on the card (rows 0, 1 and p - 1 first)
    fq_a, fq_b = fq.random_batch(4096, SEED, dev)
    fq_a2, fq_b2 = fq.random_batch(1000, SEED + 1, dev)
    fq_a3, fq_b3 = fq.uniform_batch(K0_LARGE, SEED, dev)

    def k0(x, y):
        return lambda: fq.fq_mul(x, y), lambda: fq.fq_mul_plain(x, y), (x, y)

    zeros_a, zeros_b = torch.zeros_like(a), torch.zeros_like(b)
    k6_g1, k6_g2 = KERNEL_SOURCES["exp_g1"], KERNEL_SOURCES["exp_g2"]
    k4_src = ("transcript.cu", "sipp_tpu/ops/pallas_transcript.py:302")
    k5_src = ("transcript.cu", "sipp_tpu/ops/pallas_transcript.py:269")

    def k4(st, zl, zr):
        return (lambda: transcript.transcript_round_tail(st, zl, zr),
                lambda: transcript.transcript_round_tail_plain(st, zl, zr), (st, zl, zr))

    def k5(st, z):
        return (lambda: transcript.transcript_append_fq12(st, z),
                lambda: transcript.transcript_append_fq12_plain(st, z), (st, z))
    k7_src = ("miller.cu", "sipp_tpu/ops/pallas_miller.py:364")
    k8_src = ("exp.cu", "sipp_tpu/ops/pallas_exp.py:173")
    k0_src = ("fq.cu", "sipp_tpu/ops/pallas_fq.py:33")

    def k3(group, n, bits):
        lo, hi = (lo1, hi1) if group == "g1" else (lo2, hi2)
        kern, plain = getattr(fold, f"fold_{group}"), getattr(fold, f"fold_{group}_plain")
        return (lambda: kern(lo[:n], hi[:n], bits), lambda: plain(lo[:n], hi[:n], bits),
                (lo[:n], hi[:n]))

    k3_g1, k3_g2 = KERNEL_SOURCES["fold_g1"], KERNEL_SOURCES["fold_g2"]

    # X1 inputs: the instance's B at 128 lanes; and 100 lanes with raw map
    # points (on the twist, of order r h2, off the r-torsion), points of the
    # cofactor's order ([r] of a raw point), a point of each prime order l
    # of the cofactor ([r h2 / l] of a raw point) and infinity lanes
    raw = [map_to_g2_without_cofactor_mul((1234 + i, 5678)) for i in range(3)]
    forged_b = b[:E].clone()
    raw_lanes, cofactor_lanes, inf_lanes = [8, 60, 99], [9, 61], [10, 62]
    prime_lanes = [20, 40, 70, 90]
    forged_b[raw_lanes] = curves.g2_encode(raw, dev)
    forged_b[cofactor_lanes] = curves.g2_encode(
        [hostref.g2_mul_raw(pt, params.R) for pt in raw[:2]], dev)
    forged_b[prime_lanes] = curves.g2_encode(
        [hostref.g2_mul_raw(raw[0], params.R * params.G2_COFACTOR // q)
         for q in params.G2_COFACTOR_PRIMES], dev)
    forged_b[inf_lanes] = 0
    x1_src = KERNEL_SOURCES["g2_torsion"]

    def x1_case(pts):
        return (lambda: x1.g2_torsion(pts), lambda: x1.g2_torsion_plain(pts), (pts,))

    # X2 inputs: K6's output at the MSM finals' 128 lanes (the verifier's
    # call); 100 lanes with a repeated lane that the chain doubles, a lane
    # that cancels the sum, infinity lanes and a cancelling pair (x2_edge);
    # the first lane alone and the first MSM_CHUNK + 1 (a chunk and one
    # lane) of K6's output
    k6_out = {"g1": exp.exp_g1(a, zeros_a, msm_a), "g2": exp.exp_g2(b, zeros_b, msm_b)}
    chunk = msm_define("MSM_CHUNK")
    x2_lanes = {"msm_sum_g1": k6_out["g1"], "msm_sum_g2": k6_out["g2"],
                "msm_sum_g1_edge_n100": x2_edge(G1, a), "msm_sum_g2_edge_n100": x2_edge(G2, b),
                "msm_sum_g1_n1": k6_out["g1"][:1], "msm_sum_g2_n1": k6_out["g2"][:1],
                f"msm_sum_g1_n{chunk + 1}": k6_out["g1"][:chunk + 1],
                f"msm_sum_g2_n{chunk + 1}": k6_out["g2"][:chunk + 1]}
    x2_src = KERNEL_SOURCES["msm_sum_g2"]
    cycles = probe["fq_mul"]["cycles_per_product"]

    def x2_case(name):
        lanes, curve = x2_lanes[name], G2 if "g2" in name else G1
        kern = msm.msm_sum_g2 if curve is G2 else msm.msm_sum_g1
        return (lambda: kern(lanes), lambda: msm.msm_finish_plain(curve, lanes), (lanes,))

    cases = [
        ("fq_mul_n4096", "fq_mul", *k0_src, *k0(fq_a, fq_b)),
        ("fq_mul_n1000", "fq_mul", *k0_src, *k0(fq_a2, fq_b2)),
        (f"fq_mul_n{K0_LARGE}", "fq_mul", *k0_src, *k0(fq_a3, fq_b3)),
        ("miller_product", "miller_product", *k1_src, *k1(a, b)),
        ("miller_product_inf", "miller_product", *k1_src, *k1(a_inf, b_inf)),
        ("miller_product_n6", "miller_product", *k1_src, *k1(a_inf[:6], b_inf[:6])),
        ("miller_product_pair", "miller_product_pair", *k1_src, *k1(pair_p, pair_q, True)),
        ("miller_product_pair_inf", "miller_product_pair", *k1_src, *k1(pp_inf, pq_inf, True)),
        ("miller_product_pair_n64", "miller_product_pair", *k1_src,
         *k1(pair_p[:64], pair_q[:64], True)),
        ("miller_product_pair_n2", "miller_product_pair", *k1_src,
         *k1(pair_p[:2], pair_q[:2], True)),
        ("miller_product_pair_n6", "miller_product_pair", *k1_src,
         *k1(pp_inf[:6], pq_inf[:6], True)),
        ("miller_product_pair_n130", "miller_product_pair", *k1_src, *k1(pp_130, pq_130, True)),
        ("final_exp_b1", "final_exp", "fexp.cu", "sipp_tpu/ops/pallas_fexp.py:327",
         lambda: fexp.final_exp(f_one[None]), lambda: fexp.final_exp_plain(f_one[None]),
         (f_one,)),
        ("final_exp_b2", "final_exp", "fexp.cu", "sipp_tpu/ops/pallas_fexp.py:327",
         lambda: fexp.final_exp(f_two), lambda: fexp.final_exp_plain(f_two), (f_two,)),
        ("fold_g1", "fold_g1", *k3_g1, *k3("g1", N, xbits)),
        ("fold_g2", "fold_g2", *k3_g2, *k3("g2", N, xinvbits)),
        ("fold_g1_n64", "fold_g1", *k3_g1, *k3("g1", 64, xbits)),
        ("fold_g2_n64", "fold_g2", *k3_g2, *k3("g2", 64, xinvbits)),
        ("fold_g1_n1", "fold_g1", *k3_g1, *k3("g1", 1, xbits)),
        ("fold_g2_n1", "fold_g2", *k3_g2, *k3("g2", 1, xinvbits)),
        ("transcript_append_fq12", "transcript_append_fq12", *k5_src, *k5(state0, z128)),
        ("transcript_append_fq12_edge", "transcript_append_fq12", *k5_src,
         *k5(state_edge, z128)),
        *((f"transcript_append_fq12_r{k}", "transcript_append_fq12", *k5_src, *k5(st, zl))
          for k, (st, zl, _) in enumerate(tail_inputs[:LOGN])),
        *((f"transcript_round_tail{'' if k == 0 else '_edge' if k == LOGN else f'_r{k}'}",
           "transcript_round_tail", *k4_src, *k4(*args)) for k, args in enumerate(tail_inputs)),
        ("exp_g1", "exp_g1", *k6_g1, *k6(exp.exp_g1, exp.exp_g1_plain, a, zeros_a, msm_a)),
        ("exp_g2", "exp_g2", *k6_g2, *k6(exp.exp_g2, exp.exp_g2_plain, b, zeros_b, msm_b)),
        ("exp_g1_edge_n100", "exp_g1", *k6_g1,
         *k6(exp.exp_g1, exp.exp_g1_plain, ex1, eo1, edge_bits)),
        ("exp_g2_edge_n100", "exp_g2", *k6_g2,
         *k6(exp.exp_g2, exp.exp_g2_plain, ex2, eo2, edge_bits)),
        ("miller_step_d0", "miller_step", *k7_src, *k7(0, step_args)),
        ("miller_step_d1", "miller_step", *k7_src, *k7(1, step_args)),
        ("miller_step_d2", "miller_step", *k7_src, *k7(2, step_args)),
        ("miller_step_inf_d1", "miller_step", *k7_src, *k7(1, step_inf_args)),
        ("miller_step_inf_d2", "miller_step", *k7_src, *k7(2, step_inf_args)),
        ("fq12_exp_n14", "fq12_exp", *k8_src, *k8(k8_x, k8_one, k8_bits)),
        ("fq12_exp_forged_n14", "fq12_exp", *k8_src, *k8(k8_forged, k8_one, k8_bits)),
        ("fq12_exp_edge_n100", "fq12_exp", *k8_src, *k8(e8_x, e8_off, e8_bits)),
        ("g2_torsion", "g2_torsion", *x1_src, *x1_case(b)),
        ("g2_torsion_forged_n100", "g2_torsion", *x1_src, *x1_case(forged_b)),
        *((name, name[:len("msm_sum_g1")], *x2_src, *x2_case(name)) for name in x2_lanes),
    ]
    skipped = {"exp_g1": k6_skipped(a, msm_a), "exp_g2": 3 * k6_skipped(b, msm_b),
               "exp_g1_edge_n100": k6_skipped(ex1, edge_bits),
               "exp_g2_edge_n100": 3 * k6_skipped(ex2, edge_bits)}
    chain = {"fq12_exp_n14": k8_products(k8_bits), "fq12_exp_forged_n14": k8_products(k8_bits),
             "fq12_exp_edge_n100": k8_products(e8_bits),
             **{name: x2_products(G2 if "g2" in name else G1, lanes)
                for name, lanes in x2_lanes.items()},
             "g2_torsion": x1_products(b), "g2_torsion_forged_n100": x1_products(forged_b)}
    table = {}
    for name, counter, src, replaces, kern, plain, inputs in cases:
        got = kern()
        want, p_ms, products = plain_ms(plain)
        err, ok = compare(got, want)
        k_ms = kernel_ms(kern)
        d_ms = device_ms(kern, sleep_cycles)
        extra = ({"earlier_ms_quoted_from_perf_md": QUOTED_EARLIER_MS[name]}
                 if name in QUOTED_EARLIER_MS else {})
        if counter == "transcript_append_fq12":
            imuls = transcript_imuls(1)
            extra["latency_floor_ms"] = transcript_perms(1, False) * perm_ms
        elif counter == "transcript_round_tail":
            # this case's challenge: its inverse's shifts and probed cycles
            xc = sum(int(v) << (16 * i) for i, v in enumerate(want[1].tolist()))
            shifts = fr_inverse_shifts(xc)
            imuls = transcript_imuls(2, shifts)
            inv = probe_transcript(_build.cuda_library(), dev, [xc], perms=0)
            ok = ok and inv["value_ok"]
            extra.update(inverse_shifts=shifts, inverse_cycles=inv["inverse_cycles"][0],
                         latency_floor_ms=transcript_perms(2, True) * perm_ms
                         + inv["inverse_cycles"][0] / (sm_mhz * 1e3))
        elif name in chain:
            imuls = FQ_PRODUCT_IMULS * chain[name]
            if name in x2_lanes:
                extra["latency_floor_ms"] = x2_floor_ms(
                    G2 if "g2" in name else G1, x2_lanes[name], want, cycles, sm_mhz)
        else:
            # an Fq12 squaring needs the complex squaring's products
            sqr_saved = (FQ12_MUL_PRODUCTS - FQ12_SQR_PRODUCTS) * products.get("fq12_sqr", 0)
            imuls = FQ_PRODUCT_IMULS * (products.get(16, 0) - sqr_saved - skipped.get(name, 0))
        if counter == "g2_torsion":
            # X1's verdicts also against the [r]Q ladder, the JAX package's form
            extra["latency_floor_ms"] = x1_floor_ms(cycles, sm_mhz)
            extra["equals_r_ladder"] = torch.equal(got, x1.g2_torsion_r_ladder(inputs[0]))
            ok = ok and extra["equals_r_ladder"]
        bound_ms, bound_by = bound(imuls, 8 * sum(t.numel() for t in tensors(inputs)
                                                  + tensors(got)), imul_per_s)
        table[name] = {"name": name, "route": "cuda", "source": f"sipp_tpu_torch/csrc/{src}",
                       "replaces": replaces, "counter": counter, "max_abs_err": err,
                       "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if counter.startswith(("msm_sum", "g2_torsion")):
            table[name]["latency_floor_ms"] = extra["latency_floor_ms"]
        emit({"phase": "kernel", "name": name, "shape": [list(t.shape) for t in tensors(got)],
              "bit_equal": ok, "max_abs_err": err, "tolerance": 0, "ms": k_ms,
              "device_ms": d_ms, **extra,
              "plain_ms": p_ms, "plain_products": products, "imul": imuls,
              "bound_ms": table[name]["bound_ms"]})
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
    # K6 edge lanes against hostref: offset + [k] x on the host
    for out, x, off, dec, add, mul in (
            (exp.exp_g1(ex1, eo1, edge_bits), ex1, eo1, curves.g1_decode, hostref.g1_add,
             hostref.g1_mul),
            (exp.exp_g2(ex2, eo2, edge_bits), ex2, eo2, curves.g2_decode, hostref.g2_add,
             hostref.g2_mul)):
        lanes = x_inf + off_inf + off_eq
        xh, oh = dec(x[lanes]), dec(off[lanes])
        want = [add(o, mul(p, ks[i]) if p is not None else None)
                for p, o, i in zip(xh, oh, lanes)]
        if dec(out[lanes]) != want:
            raise SystemExit("K6 edge lanes differ from offset + [k]x on the host")

    # K8 edge lanes: all-zero bits and x = 1 give the offset back, off = 0
    # gives 0; two lanes against hostref's off * x^k
    e8_out = exp.fq12_exp(e8_x, e8_off, e8_bits)
    host_lanes = [0, off_one[0]]
    e8_host = [hostref.fq12_mul(o, hostref.fq12_pow(x, ks[i])) for x, o, i in zip(
        tower.fq12_decode(e8_x[host_lanes]), tower.fq12_decode(e8_off[host_lanes]), host_lanes)]
    if not (torch.equal(e8_out[bits0], e8_off[bits0]) and torch.equal(e8_out[x_one], e8_off[x_one])
            and bool((e8_out[off_zero] == 0).all())
            and tower.fq12_decode(e8_out[host_lanes]) == e8_host):
        raise SystemExit("K8 edge lanes differ from the offset, from 0 or from off * x^k "
                         "on the host")
    # K7 infinity lanes: the tail masks them, so a whole per-step loop over
    # the instance with infinity lanes equals K1's product
    if not torch.equal(ate.product_tree(ate.miller_loop_fused(a_inf, b_inf)),
                       miller.miller_product(a_inf, b_inf)):
        raise SystemExit("the per-step Miller loop with infinity lanes differs from K1")
    # X1's forged lanes: 0 exactly on the lanes off the r-torsion
    bad_lanes = torch.nonzero(x1.g2_torsion(forged_b) == 0).flatten().tolist()
    if bad_lanes != sorted(raw_lanes + cofactor_lanes + prime_lanes) or \
            not bool(x1.g2_torsion(b).all()):
        raise SystemExit(f"X1 flagged lanes {bad_lanes}, not exactly the forged ones")
    # X2's edge lanes against hostref: the sum of the lanes on the host
    for name, add, dec in (("msm_sum_g1_edge_n100", hostref.g1_add, curves.g1_decode),
                           ("msm_sum_g2_edge_n100", hostref.g2_add, curves.g2_decode)):
        want_sum = None
        for pt in dec(x2_lanes[name]):
            want_sum = add(want_sum, pt)
        got_sum = dec(msm.msm_finish(G2 if "g2" in name else G1, x2_lanes[name]))[0]
        if got_sum != want_sum:
            raise SystemExit(f"{name} differs from the sum of its lanes on the host")


    # the digest -> challenge step of K4 on digests with zero digits
    digests = [[1, 2, 3, 4], [0x123456789ABCDEF0, 2**64 - 2**32, 1, 2**63],
               [0xDEADBEEF, 5, 0, 0xFFFFFFFF], [0, 0, 0, 0], [0, 2**32, 0x7FFFFFFF, 0],
               [2**32, 0, 0, 7]]
    canon = torch.tensor([[[(d >> (16 * t)) & 0xFFFF for t in range(4)] + [0] for d in ds]
                          for ds in digests], dtype=torch.int64)
    q_got = transcript.digest_to_challenge_limbs(canon.to(dev)).cpu()
    q_want = transcript.digest_to_challenge_limbs(canon)
    q_host = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in q_want]
    q_ok = torch.equal(q_got, q_want) and all(
        v % params.R == host_transcript.challenge_from_digest(ds)
        for v, ds in zip(q_host, digests))
    emit({"phase": "kernel_quirk", "name": "digest_to_challenge", "digests": len(digests),
          "bit_equal": q_ok, "tolerance": 0})
    if not q_ok:
        raise SystemExit("the digest -> challenge step disagrees with the plain version")

    # K4's Fr inverse alone on edge values (0, 1, 2, r - 1, r - 2, steps that
    # shift by 32 bits and more) and seeded ones
    R = params.R
    u1 = R * pow(3, -1, 2**32) % 2**32
    inv_x = [0, 1, 2, R - 1, R - 2, 1 << 253, R - (1 << 40), R - 2 * u1] + \
        [int.from_bytes(rng.bytes(32), "little") % R for _ in range(24)]
    inv_in = torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in inv_x])
    inv_got = transcript.fr_inverse_limbs(inv_in.to(dev)).cpu()
    inv_ok = torch.equal(inv_got, transcript.fr_inverse_limbs(inv_in)) and \
        [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in inv_got] == \
        [pow(x, R - 2, R) for x in inv_x]
    one_x = inv_in[-1:].to(dev)
    emit({"phase": "kernel_quirk", "name": "fr_inverse", "values": len(inv_x),
          "bit_equal": inv_ok, "tolerance": 0,
          "ms_one_value": kernel_ms(lambda: transcript.fr_inverse_limbs(one_x))})
    if not inv_ok:
        raise SystemExit("the Fr inverse disagrees with Fermat")

    # K0 on an operand 8 bytes off a 16-byte boundary (its kernel reads
    # 16-byte vectors; the wrapper must copy it), and K0's floor: an empty
    # kernel's launch on the same queue (fq.cu sipp_empty_launch)
    off = torch.empty(fq_a.numel() + 1, dtype=torch.int64, device=dev)[1:].view_as(fq_a)
    off.copy_(fq_a)
    off_ok = off.data_ptr() % 16 == 8 and torch.equal(fq.fq_mul(off, fq_b),
                                                       fq.fq_mul_plain(fq_a, fq_b))
    lib = _build.cuda_library()

    def empty():
        _build.check_launch(lib, lib.sipp_empty_launch(torch.cuda.current_stream().cuda_stream),
                            "empty_launch")
    empty_launch = {"ms": kernel_ms(empty), "device_ms": device_ms(empty, sleep_cycles)}
    emit({"phase": "fq_launch_floor", "empty_launch": empty_launch,
          "fq_mul_n4096_device_ms": table["fq_mul_n4096"]["device_ms"],
          "above_floor_us": (table["fq_mul_n4096"]["device_ms"]
                             - empty_launch["device_ms"]) * 1e3,
          "misaligned_operand_bit_equal": off_ok, "tolerance": 0, "batch": 4096,
          "card": smi})
    if not off_ok:
        raise SystemExit("K0 on an operand off a 16-byte boundary disagrees with its plain version")

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
    def rejects(proof):
        try:
            sipp_verify(a, b, proof)
        except VerificationError:
            return True
        return False

    (proof_h, tr_h), prove_host_s, launches_a1 = driven(
        lambda: sipp_prove(a, b, return_transcript=True))
    with setenv("SIPP_VERIFY_MSM", "0"):
        stmt_fold, verify_fold_s, launches_a2 = driven(lambda: sipp_verify(a, b, proof_h))
    (proof_o, tr_o), prove_onchip_s, launches_b = driven(
        lambda: sipp_prove_onchip(a, b, return_transcript=True))
    with setenv("SIPP_VERIFY_MSM", "auto"):
        stmt_msm, verify_msm_s, launches_c = driven(lambda: sipp_verify(a, b, proof_o))
    launches_a = {k: launches_a1[k] + launches_a2[k] for k in launches_a1}
    paths = {"A": launches_a, "B": launches_b, "C": launches_c}
    needed = {"A": ["miller_product", "miller_product_pair", "final_exp", "fold_g1", "fold_g2",
                    "g2_torsion"],
              "B": ["miller_product", "miller_product_pair", "final_exp", "fold_g1", "fold_g2",
                    "transcript_append_fq12", "transcript_round_tail"],
              "C": ["miller_product", "final_exp", "exp_g1", "exp_g2", "g2_torsion",
                    "msm_sum_g1", "msm_sum_g2"]}
    # one X1 launch a verify; two X2 launches a verify with MSM finals
    per_verify = {"A": (1, 0), "C": (1, 1), "E": (1, 1), "BLS": (1, 1), "D": (1, 0)}
    same_proof = np.array_equal(convert.to_reference(proof_o), convert.to_reference(proof_h))
    same_state = tr_o.state == tr_h.state
    bad = proof_o.clone()
    bad[1, 0, 0, 0, 0] = (bad[1, 0, 0, 0, 0] + 1) % 0xFFFF
    with setenv("SIPP_VERIFY_MSM", "auto"):
        rejected_msm = rejects(bad)
    with setenv("SIPP_VERIFY_MSM", "0"):
        rejected_fold = rejects(bad)
    if tuple(proof_h.shape) != (2 * LOGN + 1, 2, 3, 2, 16) or not torch.equal(proof_h[-1], z):
        raise SystemExit("proof has the wrong shape or does not end with Z")
    if tower.fq12_decode(z) != stmt_fold.Z:
        raise SystemExit("statement Z differs from the aggregation")

    # the on-chip rounds again, where any host sync raises
    state0 = FGL.encode(prover.prologue(a, b).state, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        proof_s, state_s = prover.onchip_rounds(a, b, state0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    no_sync = torch.equal(proof_s, proof_o) and FGL.decode(state_s) == tr_o.state
    round_times = []
    sipp_prove_onchip(a, b, round_times=round_times)
    fold_round_ms = statistics.median(round_times) * 1e3
    steady = {}
    for name, fn in (("prove_host_s", lambda: sipp_prove(a, b)),
                     ("prove_onchip_s", lambda: sipp_prove_onchip(a, b))):
        steady[name] = driven(fn)[1]
    for mode, name in (("0", "verify_fold_s"), ("auto", "verify_msm_s")):
        with setenv("SIPP_VERIFY_MSM", mode):
            steady[name] = driven(lambda: sipp_verify(a, b, proof_o))[1]
    # the MSM finals split: K6 (both groups) against tree sum + to_affine
    xs_run = challenges(a, b, proof_o)
    ba, bb = (torch.as_tensor(v, device=dev) for v in verifier.msm_bits(xs_run, N))
    k6_ms = kernel_ms(lambda: (exp.exp_g1(a, zeros_a, ba), exp.exp_g2(b, zeros_b, bb)), reps=3)
    lanes_a, lanes_b = exp.exp_g1(a, zeros_a, ba), exp.exp_g2(b, zeros_b, bb)
    x2_ms = kernel_ms(lambda: (msm.msm_finish(G1, lanes_a), msm.msm_finish(G2, lanes_b)),
                      reps=3)
    fa, fb = msm.msm_finish(G1, lanes_a), msm.msm_finish(G2, lanes_b)
    finals_ok = (curves.g1_decode(fa)[0], curves.g2_decode(fb)[0]) == \
        (stmt_msm.final_A, stmt_msm.final_B)
    idle = {"host_spine": idle_share(lambda: sipp_prove(a, b)),
            "onchip": idle_share(lambda: sipp_prove_onchip(a, b))}
    emit({"phase": "protocol", "n": N, "prove_host_s": prove_host_s,
          "prove_onchip_s": prove_onchip_s, "verify_fold_s": verify_fold_s,
          "verify_msm_s": verify_msm_s, "steady": steady,
          "fold_round_latency_ms_n128": fold_round_ms,
          "round_ms": [t * 1e3 for t in round_times],
          "msm_finals_k6_ms": k6_ms, "msm_finals_x2_ms": x2_ms,
          "onchip_equals_host_spine": same_proof, "transcript_states_equal": same_state,
          "rounds_without_host_sync": no_sync, "statements_equal": stmt_msm == stmt_fold,
          "msm_finals_split_agrees": finals_ok, "tampered_rejected_msm": rejected_msm,
          "tampered_rejected_fold": rejected_fold, "launches": paths, "idle": idle, "card": smi})
    missing = [(p, k) for p, ks in needed.items() for k in ks if paths[p][k] < 1]
    if not (same_proof and same_state and no_sync and stmt_msm == stmt_fold and finals_ok
            and rejected_msm and rejected_fold) or missing:
        raise SystemExit(f"a protocol check failed, or a kernel of a path never ran: {missing}")

    with np.load(GOLDEN) as g:
        a4 = convert.from_reference(g["a4"], dev)
        b4 = convert.from_reference(g["b4"], dev)
        proofs4 = {"host_spine": sipp_prove(a4, b4), "onchip": sipp_prove_onchip(a4, b4)}
        same4 = {k: np.array_equal(convert.to_reference(v), g["proof4"])
                 for k, v in proofs4.items()}
        for mode in ("0", "auto"):
            with setenv("SIPP_VERIFY_MSM", mode):
                stmt4 = sipp_verify(a4, b4, proofs4["onchip"])
            same4[f"statement_msm_{mode}"] = np.array_equal(
                np.asarray(stmt4.to_vec(), np.uint32), g["stmt4"])
    emit({"phase": "golden_n4", "equal": same4})
    if not all(same4.values()):
        raise SystemExit("the n = 4 golden proof or statement was not reproduced")

    # ------------------------- 4b. entry validation and the verify_s split
    # the verdicts are queued with no host sync (queue_verdicts is what
    # check_instance_async runs after its limb checks, which sync)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side, verdicts = validate.queue_verdicts(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side.synchronize()                  # the verdicts are the side stream's
    queued_ok = all(bool(v.all()) for v in verdicts)
    torch.cuda.synchronize()
    t = time.time()
    finish = validate.check_instance_async(a, b)
    enqueue_s = time.time() - t
    t = time.time()
    finish()
    finish_s = time.time() - t

    def raised(fn):
        try:
            fn()
        except VerificationError as e:
            return str(e)
        return ""

    # forged instances: sipp_verify on the card must reject each with the
    # words that check_instance_async gives on the CPU for its first 8 lanes
    one = FQ.encode(1, dev)
    a_off, b_off, b_sub = a.clone(), b.clone(), b.clone()
    a_off[FORGED_LANE, 1] = FQ.add(a[FORGED_LANE, 1], one)            # y + 1
    b_off[FORGED_LANE, 1, 0] = FQ.add(b[FORGED_LANE, 1, 0], one)
    b_sub[FORGED_LANE] = curves.g2_encode(raw[:1], dev)[0]
    forged = {}
    for name, (fa_, fb_) in {"off_curve_a": (a_off, b), "off_twist_b": (a, b_off),
                             "outside_subgroup_b": (a, b_sub)}.items():
        forged[name] = {
            "card": raised(lambda: sipp_verify(fa_, fb_, proof_o)),
            "cpu": raised(lambda: validate.check_instance_async(fa_[:8].cpu(), fb_[:8].cpu())())}
    forged_ok = all(v["card"] == v["cpu"] != "" for v in forged.values())
    # where a default verify's time goes (MSM finals; sipp_verify's split:
    # with it the finals end in a synchronize), and the card's idle share
    splits = []
    for _ in range(3):
        sp = {}
        torch.cuda.synchronize()
        t = time.time()
        stmt_sp = sipp_verify(a, b, proof_o, split=sp)
        sp["total_s"] = time.time() - t
        splits.append(sp)
    split_median = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    idle_verify = idle_share(lambda: sipp_verify(a, b, proof_o))
    emit({"phase": "validation", "n": N, "verdicts_queued_without_host_sync": queued_ok,
          "check_instance_async_enqueue_s": enqueue_s, "finish_s": finish_s,
          "forged_messages": forged, "verify_split": splits,
          "verify_split_median": split_median, "idle_default_verify": idle_verify,
          "card": smi})
    if not (queued_ok and forged_ok and stmt_sp == stmt_msm):
        raise SystemExit("a validation check failed: verdicts synced or were not all 1, a "
                         "forged instance was not rejected with the CPU's words, or the "
                         "split verify's statement differs")

    # ------------------------------ 5. path D: the per-step Miller engine
    with setenv("SIPP_WHOLE_LOOP", "0"):
        z_d, _, launches_d0 = driven(lambda: ate.inner_product(a, b))
        digest_d = hashlib.sha256(convert.to_reference(z_d).tobytes()).hexdigest()[:16]
        torch.cuda.synchronize()
        t = time.time()
        for x, y in insts:
            zz_d = ate.inner_product(x, y)
        torch.cuda.synchronize()
        agg_d_ms = (time.time() - t) / REPS * 1e3
        proof_d, prove_d_s, launches_d1 = driven(lambda: sipp_prove(a, b))
        with setenv("SIPP_VERIFY_MSM", "0"):
            stmt_d, verify_d_s, launches_d2 = driven(lambda: sipp_verify(a, b, proof_d))
        # one Miller loop's 65 K7 launches and its tail, where a host sync raises
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            f_d = ate.miller_loop_fused(a, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        loop_d_ok = torch.equal(ate.product_tree(f_d), f_one)
        # an aggregation split: K7 steps (events), plain tail, plain tree, K2
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        f, t_, qn = ate.miller_start(a, b)
        torch.cuda.synchronize()
        t = time.time()
        start.record()
        for digit in ate.DIGITS:
            f, t_ = miller.miller_step(digit, b, qn, a, f, t_)
        end.record()
        torch.cuda.synchronize()
        split = {"k7_steps_ms": start.elapsed_time(end),
                 "k7_steps_host_ms": (time.time() - t) * 1e3}

        f0, t0, qn0 = ate.miller_start(a, b)
        f0 = f0.contiguous()

        def k7_loop():
            g, u = f0, t0
            for digit in ate.DIGITS:
                g, u = miller.miller_step(digit, b, qn0, a, g, u)
        split["k7_steps_device_ms"] = device_ms(k7_loop, sleep_cycles, reps=3)
        for key, fn in (("tail_ms", lambda v: ate.miller_tail(v, t_, a, b)),
                        ("tree_ms", ate.product_tree),
                        ("k2_ms", lambda v: fexp.final_exp(v[None])[0])):
            t = time.time()
            f = fn(f)
            torch.cuda.synchronize()
            split[key] = (time.time() - t) * 1e3
        split_ok = torch.equal(f, z)
    launches_d = {k: launches_d0[k] + launches_d1[k] + launches_d2[k] for k in launches_d0}
    paths["D"] = launches_d
    needed["D"] = ["miller_step", "miller_product_pair", "final_exp", "fold_g1", "fold_g2",
                   "g2_torsion"]
    checks_d = {"digest": digest_d == REF_DIGEST and torch.equal(zz_d, zz),
                "proof_equals_path_a": torch.equal(proof_d, proof_h),
                "statement_equals_path_a": stmt_d == stmt_fold,
                "loop_without_host_sync": loop_d_ok, "split_equals_z": split_ok,
                "k7_per_loop": launches_d["miller_step"] == 3 * len(ate.DIGITS),
                "no_whole_loop_k1": launches_d["miller_product"] == 0}
    emit({"phase": "path_d", "n": N, "digest": digest_d, "ms_per_aggregation": agg_d_ms,
          "pairings_per_s": N / agg_d_ms * 1e3, "prove_s": prove_d_s, "verify_fold_s": verify_d_s,
          "aggregation_split": split, "launches": launches_d, "checks": checks_d, "card": smi})
    if not all(checks_d.values()):
        raise SystemExit(f"a path D check failed: {checks_d}")

    # ---------------------- 6. path E: the verifier without the C++ library
    with setenv("SIPP_TPU_NO_NATIVE", "1"):
        stmt_e, verify_e_s, launches_e = driven(lambda: sipp_verify(a, b, proof_o))
        rejected_e = rejects(bad)
        t = time.time()
        prover.prologue(a, b)
        prologue_py_s = time.time() - t
        rows_o = z_rows(xs_run)
        torch.cuda.synchronize()
        t = time.time()
        z_chain = verifier.z_chain_device(proof_o, rows_o)
        z_chain_host = tower.fq12_decode(z_chain)
        z_chain_device_ms = (time.time() - t) * 1e3
        with np.load(GOLDEN) as g:
            a4 = convert.from_reference(g["a4"], dev)
            b4 = convert.from_reference(g["b4"], dev)
            proof4_e = sipp_prove(a4, b4)
            stmt4_e = sipp_verify(a4, b4, proof4_e)
            golden_e = {"proof": np.array_equal(convert.to_reference(proof4_e), g["proof4"]),
                        "statement": np.array_equal(np.asarray(stmt4_e.to_vec(), np.uint32),
                                                    g["stmt4"])}
    t = time.time()
    prover.prologue(a, b)
    prologue_native_s = time.time() - t
    proof_u = native.fq12_limbs16_to_u64(proof_o.cpu().numpy())
    t = time.time()
    z_u = proof_u[-1]
    for i, e in rows_o:
        z_u = native.fq12_mul(z_u, native.fq12_pow(proof_u[i], e))
    z_chain_native_ms = (time.time() - t) * 1e3
    paths["E"] = launches_e
    needed["E"] = ["fq12_exp", "miller_product", "final_exp", "exp_g1", "exp_g2", "g2_torsion",
                   "msm_sum_g1", "msm_sum_g2"]
    checks_e = {"statement_equals_path_c": stmt_e == stmt_msm, "tampered_rejected": rejected_e,
                "z_chain_equals_native": z_chain_host == native.fq12_u64_to_tower_ints(z_u)
                and z_chain_host == stmt_e.final_Z, **{f"golden_n4_{k}": v
                                                       for k, v in golden_e.items()}}
    emit({"phase": "path_e", "n": N, "verify_s": verify_e_s,
          "prologue_python_s": prologue_py_s, "prologue_native_s": prologue_native_s,
          "z_chain_k8_tree_ms": z_chain_device_ms, "z_chain_native_ms": z_chain_native_ms,
          "launches": launches_e, "checks": checks_e, "card": smi})
    if not all(checks_e.values()):
        raise SystemExit(f"a path E check failed: {checks_e}")

    # ----------------------------------------------- 7. the BLS app and io
    from sipp_tpu_torch import io as port_io
    from sipp_tpu_torch.apps import bls_aggregation as bls

    t = time.time()
    pks, msgs, sigma = bls.demo_instance(BLS_N)
    bls_setup_s = time.time() - t
    (bls_ok, proof_bls), bls_s, launches_bls = driven(
        lambda: bls.verify_bls_aggregation(pks, msgs, sigma, device=dev))
    paths["BLS"] = launches_bls
    needed["BLS"] = ["miller_product", "miller_product_pair", "final_exp", "fold_g1", "fold_g2",
                     "transcript_append_fq12", "transcript_round_tail", "exp_g1", "exp_g2",
                     "g2_torsion", "msm_sum_g1", "msm_sum_g2"]
    # the app's instance again (host hashes, not timed with the card), for
    # its digest, the split and the tamper case
    t = time.time()
    hs = [bls.hash_to_g2(m) for m in msgs]
    a_bls = curves.g1_encode(pks + [hostref.g1_neg(params.G1_GEN)], dev)
    b_bls = curves.g2_encode(hs + [sigma], dev)
    rehash_s = time.time() - t
    bls_ip_ms = kernel_ms(lambda: ate.inner_product(a_bls, b_bls), reps=5)
    z_bls = tower.fq12_decode(ate.inner_product(a_bls, b_bls))
    proof_o_bls, bls_prove_s, _ = driven(lambda: sipp_prove_onchip(a_bls, b_bls))
    stmt_bls, bls_verify_s, _ = driven(lambda: sipp_verify(a_bls, b_bls, proof_bls))
    proof_h_bls = sipp_prove(a_bls, b_bls)
    bad_ok, _ = bls.verify_bls_aggregation(pks, msgs, hostref.g2_add(sigma, hs[0]), prove=False,
                                           device=dev)
    with np.load(GOLDEN) as g:
        want_inst, want_proof = str(g["bls128_instance_sha256"]), str(g["bls128_proof_sha256"])
    inst_sha = hashlib.sha256(convert.to_reference(a_bls).tobytes()
                              + convert.to_reference(b_bls).tobytes()).hexdigest()
    proof_sha = hashlib.sha256(convert.to_reference(proof_bls).tobytes()).hexdigest()
    with tempfile.TemporaryDirectory() as d:
        port_io.save_proof(f"{d}/proof.npz", a_bls, b_bls, proof_bls)
        a_io, b_io, p_io = port_io.load_proof(f"{d}/proof.npz", dev)
        stmt_io = sipp_verify(a_io, b_io, p_io)
        port_io.save_statement(f"{d}/stmt.u32", stmt_io)
        stmt_file = port_io.load_statement(f"{d}/stmt.u32", BLS_N)
    checks_bls = {
        "ok": bls_ok, "aggregate_is_one": z_bls == hostref.FQ12_ONE,
        "proof_equals_onchip_rerun": torch.equal(proof_o_bls, proof_bls),
        "host_spine_equals_onchip": np.array_equal(convert.to_reference(proof_h_bls),
                                                   convert.to_reference(proof_bls)),
        "statement_z_is_one": stmt_bls.Z == hostref.FQ12_ONE,
        "tampered_sigma_rejected": not bad_ok,
        "instance_sha256_equals_jax": inst_sha == want_inst,
        "proof_sha256_equals_jax": proof_sha == want_proof,
        "io_roundtrip": (all(x.device == a_bls.device for x in (a_io, b_io, p_io))
                         and torch.equal(a_io, a_bls) and torch.equal(b_io, b_bls)
                         and torch.equal(p_io, proof_bls) and stmt_io == stmt_bls
                         and stmt_file == stmt_bls)}
    emit({"phase": "bls", "n": BLS_N, "setup_s": bls_setup_s, "app_s": bls_s,
          "rehash_s": rehash_s, "inner_product_check_ms": bls_ip_ms, "prove_s": bls_prove_s,
          "verify_s": bls_verify_s, "instance_sha256": inst_sha, "proof_sha256": proof_sha,
          "launches": launches_bls, "checks": checks_bls, "card": smi})
    if not all(checks_bls.values()):
        raise SystemExit(f"a BLS app check failed: {checks_bls}")

    # -------------------------- 8. the sharded prover (parallel/sharded.py)
    from sipp_tpu_torch.parallel import Mesh, make_mesh, sipp_prove_sharded

    one_card = Mesh((dev,) * SHARDS)          # four shards on one card, named so
    proof_sh, sharded_s, launches_sh = driven(lambda: sipp_prove_sharded(a, b, one_card))
    paths["sharded"] = launches_sh
    needed["sharded"] = ["miller_product", "miller_product_pair", "final_exp", "fold_g1",
                         "fold_g2"]
    rounds_sh, tail_sh, want_sh = sharded_launches(LOGN)
    steady_sh = statistics.median(driven(lambda: sipp_prove_sharded(a, b, one_card))[1]
                                  for _ in range(3))
    idle_sh = idle_share(lambda: sipp_prove_sharded(a, b, one_card))
    stmt_sh = sipp_verify(a, b, proof_sh)
    checks_sh = {"equals_host_spine": torch.equal(proof_sh, proof_h),
                 "equals_onchip": torch.equal(proof_sh, proof_o),
                 "verified": stmt_sh == stmt_msm,
                 "launches_match_shards": all(launches_sh[k] == v for k, v in want_sh.items())}
    cards = torch.cuda.device_count()
    distinct = 1 << (min(4, cards).bit_length() - 1)
    line_cards = {"distinct_cards_run": "skipped: one card visible" if distinct < 2 else distinct}
    if distinct >= 2:
        mesh_cards = make_mesh(distinct)
        # the first run also creates the other cards' contexts and loads
        # the kernels there; the steady time is the median of three more
        proof_c, cards_first_s, launches_c = driven(lambda: sipp_prove_sharded(a, b, mesh_cards))
        cards_s = statistics.median(driven(lambda: sipp_prove_sharded(a, b, mesh_cards))[1]
                                    for _ in range(3))
        paths["sharded_cards"] = launches_c
        checks_sh["distinct_cards_equal"] = torch.equal(proof_c.to(dev), proof_h)
        line_cards.update(distinct_cards_first_s=cards_first_s, distinct_cards_steady_s=cards_s,
                          distinct_cards_launches=launches_c)
    emit({"phase": "sharded", "n": N, "shards": SHARDS, "distinct_cards": 1,
          "rounds_sharded": rounds_sh, "rounds_tail": tail_sh, "prove_s": sharded_s,
          "steady_prove_s": steady_sh, "sipp_prove_steady_s": steady["prove_host_s"],
          "sipp_prove_onchip_steady_s": steady["prove_onchip_s"], "launches": launches_sh,
          "launches_expected": want_sh, "idle": idle_sh, **line_cards, "checks": checks_sh,
          "card": smi})
    if not all(checks_sh.values()):
        raise SystemExit(f"a sharded prover check failed: {checks_sh}")

    # ------------------------------------ 9. the bucket MSMs (ops/msm.py)
    bucket, bucket_s, bucket_launches = {}, {}, {}
    for name, curve, pts, bits in (("g1", G1, a, ba), ("g2", G2, b, bb)):
        bucket[name], bucket_s[name], bucket_launches[name] = driven(
            lambda: curve.to_affine(msm.msm_bucket(curve, pts, bits, BUCKET_C)[None]))
        bucket[f"{name}_sharded"], bucket_s[f"{name}_sharded"], _ = driven(
            lambda: curve.to_affine(msm.msm_bucket_sharded(curve, pts, bits, one_card,
                                                           BUCKET_C)[None]))
    # where a bucket MSM's time goes: every window's buckets (sort, scan,
    # gather), the suffix sums + tree + Horner combine, the final to_affine
    split_mb = {}
    for name, curve, pts, bits in (("g1", G1, a, ba), ("g2", G2, b, bb)):
        stamps = [time.time()]
        buckets = msm._window_buckets(curve, pts, msm._digits(bits, BUCKET_C), BUCKET_C)
        torch.cuda.synchronize()
        stamps.append(time.time())
        acc = msm._horner_windows(curve, buckets, BUCKET_C)
        torch.cuda.synchronize()
        stamps.append(time.time())
        curve.to_affine(acc[None])
        torch.cuda.synchronize()
        stamps.append(time.time())
        split_mb[name] = dict(zip(("buckets_s", "horner_s", "to_affine_s"),
                                  np.diff(stamps).tolist()))
    checks_mb = {"g1_equals_k6_msm_finish": torch.equal(bucket["g1"], fa),
                 "g2_equals_k6_msm_finish": torch.equal(bucket["g2"], fb),
                 "g1_sharded_equals_k6_msm_finish": torch.equal(bucket["g1_sharded"], fa),
                 "g2_sharded_equals_k6_msm_finish": torch.equal(bucket["g2_sharded"], fb),
                 "no_kernel_launched": not any(v for c in bucket_launches.values()
                                               for v in c.values())}
    emit({"phase": "msm_bucket", "n": N, "c": BUCKET_C, "bits": 254, "shards": SHARDS,
          "wall_s": bucket_s, "split": split_mb, "k6_both_groups_ms": k6_ms, "x2_both_groups_ms": x2_ms,
          "checks": checks_mb, "card": smi})
    if not all(checks_mb.values()):
        raise SystemExit(f"a bucket MSM check failed: {checks_mb}")

    # ----------------------------------- 10. K0: the field micro-benchmark
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench, _, launches_k0 = driven(fq.bench_compare)
    paths["K0"] = launches_k0
    needed["K0"] = ["fq_mul"]
    emit({"phase": "fq_bench", "batch": 4096, "reps": 10, "plain_s": bench["plain"],
          "kernel_s": bench["kernel"], "equal": bench["equal"],
          "printed": out.getvalue().splitlines(), "launches": launches_k0["fq_mul"], "card": smi})
    missing = [(p, k) for p, ks in needed.items() for k in ks if paths[p][k] < 1]
    missing += [(p, k, paths[p][k]) for p, (n1, n2) in per_verify.items()
                for k, want in (("g2_torsion", n1), ("msm_sum_g1", n2), ("msm_sum_g2", n2))
                if paths[p][k] != want]
    if not bench["equal"] or missing:
        raise SystemExit(f"K0's entry point disagrees, or a kernel of a path never ran or "
                         f"ran other than once a verify: {missing}")

    # ------------------------------------------- 11. the n = 4096 phases
    table_large, paths_large = run_large(dev, smi, imul_per_s, sleep_cycles, cycles, sm_mhz,
                                         a, b)
    paths.update(paths_large)

    # -------------------------------------------------------- 12. summary
    # one row per kernel entry point: the numbers of its first case (the
    # paths' shape), the largest error over all its cases, and launches
    # summed over the driven runs of paths A-E, BLS, the sharded prover,
    # K0's entry point and the n = 4096 provers and verifiers; K0's row also
    # carries its bytes-bound case and the empty launch, and a row with an
    # n = 4096 case that case's numbers and its error
    rows = {}
    for case in table.values():
        counter = case.pop("counter")
        row = rows.setdefault(counter, dict(case, name=counter, id=KERNEL_IDS[counter],
                                            case=case["name"], cases=0))
        row["cases"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], case["max_abs_err"])
    for counter, row in rows.items():
        row["launches"] = sum(launches[counter] for launches in paths.values())
    large = table[f"fq_mul_n{K0_LARGE}"]
    rows["fq_mul"].update({f"{k}_n{K0_LARGE}": large[k] for k in ("ms", "device_ms", "plain_ms",
                                                                  "bound_ms", "bound_by")})
    rows["fq_mul"]["empty_launch_device_ms"] = empty_launch["device_ms"]
    for case in table_large.values():
        row = rows[case["counter"]]
        row["cases"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], case["max_abs_err"])
        # the first n = 4096 case of a row: the main path's shape
        row.setdefault(f"n{N_LARGE}", {k: case[k] for k in (
            "name", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "latency_floor_ms")
            if k in case})
    emit({"kernels": sorted(rows.values(), key=lambda r: r["id"])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
