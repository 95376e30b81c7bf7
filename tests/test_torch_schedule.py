"""The schedules of the redesigned kernels K1, K2, K3 and K6 on the CPU,
tolerance 0.

ops/schedule.py holds them as data: K2's tables (the Fq2 products of each
Fq12-level operation and each output's linear form, written into the
kernels' generated schedule_params.cuh by ops/_build.py) and the x-power's
product tree; K3's (and K6's) staged doubling and mixed addition; K1's
Miller operations (the generic Fq12 squaring, the line multiply, the
staged doubling and addition with their lines, the Fq12 multiply of the
lane product) and the program that strings them along the loop.  Here the
tables are evaluated in plain PyTorch against fields/tower.py, pairing/ate,
hostref and the JAX package's own schedule, and the stages against curves'
dbl and add_mixed, on seeded values.

The last tests compile the kernels' device code itself (csrc/bn254.cuh,
fq.cu, miller.cu, fold.cu, exp.cu, fexp.cu, transcript.cu, validate.cu,
msm.cu) with g++ on an emulated carry flag, run each block as host threads
(tests/host_emulation/sim.h, with __shfl_sync and __any_sync as a per-warp
exchange buffer), and hold the results against the plain versions: K0
with a tail block; ladder.cuh's complete addition against curves'
add_mixed(p, q, dbl(q)); X1 against g2_torsion_plain on points off the
r-torsion; X2 against msm_finish_plain on repeated, cancelling and
infinity lanes; K4/K5's permutation against poseidon.permute
(with the pinned table and with a random one loaded through
SIPP_POSEIDON_RC_FILE), their appends and round tail against
transcript_*_plain, their Fr inverse against pow(x, r - 2, r).  They need
g++ with C++20 and skip without it.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sipp_tpu_torch import convert, hostref, params
from sipp_tpu_torch.curves import G1, G2, scalar_to_bits
from sipp_tpu_torch.fields import FGL, FQ, poseidon, tower
from sipp_tpu_torch.ops import _build, exp, fexp, fold, fq, miller, msm, schedule, transcript
from sipp_tpu_torch.protocol import transcript_device as td
from sipp_tpu_torch.pairing import ate
from sipp_tpu_torch.utils.testing import random_instance

HOST = pathlib.Path(__file__).parent / "host_emulation"
GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fq12_values(k, seed):
    rng = np.random.default_rng(seed)
    v = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(12 * k)]
    return tower.fq12_encode([tuple(tuple((v[12 * e + 6 * i + 2 * j], v[12 * e + 6 * i + 2 * j + 1])
                                          for j in range(3)) for i in range(2))
                              for e in range(k)])


@pytest.fixture(scope="module")
def cyclotomic():
    """Seeded elements of the cyclotomic subgroup (after the easy part)."""
    return ate.easy_part(fq12_values(2, 4))


def test_fq12_mul_table_matches_tower():
    a, b = fq12_values(3, 1), fq12_values(3, 2)
    assert torch.equal(schedule.fq12_mul(a, b), tower.fq12_mul(a, b))


def test_cyclo_table_matches_tower(cyclotomic):
    g = cyclotomic
    got = schedule.fq12_cyclo_sqr(g)
    assert torch.equal(got, tower.fq12_cyclo_sqr(g))
    assert torch.equal(got, tower.fq12_mul(g, g))


def test_inverse_tables_match_tower():
    f = fq12_values(2, 3)
    inv = schedule.fq12_inv(f)
    assert torch.equal(inv, tower.fq12_inv(f))
    assert torch.equal(tower.fq12_mul(f, inv), tower.fq12_one((2,)).contiguous())


def test_powx_tree_matches_square_and_multiply_and_hostref(cyclotomic):
    g = cyclotomic[:1]
    got = schedule.powx(g)
    assert torch.equal(got, ate._powx(g))
    assert tower.fq12_decode(got[0]) == hostref.fq12_pow(tower.fq12_decode(g[0]), params.X)


def test_powx_tree_is_the_tpu_kernels_schedule():
    from sipp_tpu.ops import pallas_fexp

    assert list(schedule.X_SET) == list(pallas_fexp._X_SET_POWS)
    assert [len(level) for level in schedule.POWX_TREE] == [14, 7, 3, 2, 1]
    used = [j for level in schedule.POWX_TREE for pair in level for j in pair]
    assert sorted(set(used)) == sorted(schedule.X_SET)


def test_generated_header_holds_the_tables():
    """The kernel reads what the tests evaluate: schedule_params.cuh's
    arrays are the tables of ops/schedule.py."""
    text = _build.schedule_header()

    def array(name):
        body = re.search(rf"{name}\[[^=]*= \{{([^}}]*)\}}", text).group(1)
        return [int(v) for v in body.split(",")]

    ops = schedule.OPS
    assert array("OP_NPROD") == [len(op.xmask) for op in ops]
    assert array("OP_NOUT") == [len(op.terms) for op in ops]
    xmask = np.array(array("OP_XMASK")).reshape(len(ops), schedule.N_PROD)
    terms = np.array(array("OP_TERMS")).reshape(len(ops), 6, schedule.MAX_TERMS, 3)
    for i, op in enumerate(ops):
        assert list(xmask[i, :len(op.xmask)]) == list(op.xmask)
        for q, form in enumerate(op.terms):
            assert [tuple(t) for t in terms[i, q] if t[1]] == list(form)
    pairs = np.array(array("POWX_PAIRS")).reshape(len(schedule.POWX_TREE), -1, 2)
    for level, want in zip(pairs, schedule.POWX_TREE):
        assert [tuple(p) for p in level[:len(want)]] == list(want)


@pytest.fixture(scope="module")
def points():
    """Lanes of G1 and G2 points with a lane at infinity (all-zero)."""
    a, b = random_instance(4, seed=3, device="cpu")
    a[2], b[2] = 0, 0
    return {"g1": (G1, a), "g2": (G2, b)}


def jacobian_lanes(C, pts):
    """Generic Jacobian points (Z != 1), one at infinity (Z = 0)."""
    p = C.dbl(C.add_mixed(C.dbl(C.jac_from_affine(torch.roll(pts, 1, 0))), pts))
    p[3] = 0
    return p


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_staged_dbl_matches_curves(points, group):
    C, pts = points[group]
    p = jacobian_lanes(C, pts)
    assert torch.equal(schedule.dbl_staged(C, p), C.dbl(p))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_staged_add_mixed_matches_curves(points, group):
    """With the accumulator at infinity (lane 3) and q at infinity (lane 2)."""
    C, pts = points[group]
    p = jacobian_lanes(C, pts)
    for q in (pts, torch.roll(pts, 2, 0)):
        assert torch.equal(schedule.add_mixed_staged(C, p, q), C.add_mixed(p, q))


def jacobian_pairs(C, pts):
    """Jacobian p, q for the complete Jacobian addition at 9 lanes: P == Q
    under another Z (lane 0) and under the same one (7), P == -Q (1), q at
    infinity (2), p at infinity (3), both (4), Z = 0 under other X and Y
    in p (5) and in q (6), and a generic lane (8)."""
    p = C.dbl(C.add_mixed(C.dbl(C.jac_from_affine(torch.roll(pts, 1, 0))), pts))
    lam = C.f.mul(C._c(p, 2), C._c(p, 0))                    # any non-zero scale
    lam2 = C.f.mul(lam, lam)
    q = C._pt(C.f.mul(C._c(p, 0), lam2), C.f.mul(C._c(p, 1), C.f.mul(lam2, lam)),
              C.f.mul(C._c(p, 2), lam))                       # the same points
    q[1] = C.neg(q[1:2])[0]
    q[8] = C.dbl(p[8:9])[0]
    q[7] = p[7]
    q[[2, 4]] = 0
    p[[3, 4]] = 0
    p[5].select(0, 2).zero_()
    q[6].select(0, 2).zero_()
    return p, q


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_staged_add_jacobian_matches_curves(group):
    """X2's Jacobian addition (the tree's) on P == Q, P == -Q and infinity
    on either side."""
    a, b = random_instance(9, seed=21, device="cpu")
    C, pts = (G1, a) if group == "g1" else (G2, b)
    p, q = jacobian_pairs(C, pts)
    assert torch.equal(schedule.add_jacobian_staged(C, p, q), C.add(p, q))


def _miller_op(name):
    return schedule.M_OPS[schedule.M_OP_ID[name]]


def _with_f(slots, f):
    slots = slots.clone()
    slots[..., :6, :, :] = f.reshape(*f.shape[:-4], 6, 2, 16)
    return slots


def _f(slots):
    return slots[..., :6, :, :].reshape(*slots.shape[:-3], 2, 3, 2, 16)


@pytest.fixture(scope="module")
def miller_lanes():
    """Two seeded lanes' slots at the start of the loop, and f values."""
    a, b = random_instance(2, seed=21, device="cpu")
    return a, b, schedule.miller_slots(a, b), fq12_values(2, 22)


def test_miller_sqr_table_matches_tower(miller_lanes):
    """The generic (complex) squaring beside the doubling's second stage; f
    is not cyclotomic during the loop."""
    _, _, slots, f = miller_lanes
    got = schedule.run_miller_op(_miller_op("dbl2_sqr"), _with_f(slots, f))
    assert torch.equal(_f(got), tower.fq12_sqr(f))


def test_miller_line_table_matches_tower(miller_lanes):
    """The sparse line multiply f (a + b w + c v w), alone and beside each
    stage it shares an operation with."""
    _, _, slots, f = miller_lanes
    line = fq12_values(2, 23).reshape(2, 6, 2, 16)[:, :3].unbind(1)
    s = _with_f(slots, f)
    for v, name in zip(line, ("LA", "LB", "LC")):
        s[:, schedule.SLOT[name]] = v
    want = tower.fq12_mul_line(f, *line)
    for name in ("ml", "dbl1_ml", "add1_ml", "add4_ml"):
        assert torch.equal(_f(schedule.run_miller_op(_miller_op(name), s)), want)


def test_miller_mul_table_matches_tower(miller_lanes):
    """The lane product's multiply, y operands from the other lane."""
    _, _, slots, f = miller_lanes
    g = fq12_values(2, 24)
    got = schedule.run_miller_op(_miller_op("mul"), _with_f(slots, f), _with_f(slots, g))
    assert torch.equal(_f(got), tower.fq12_mul(f, g))


def test_miller_stages_match_the_reference_steps(miller_lanes):
    """The staged doubling and addition give the reference's T and line
    (pairing/ate.py _dbl_step, _add_step: the same line scaling)."""
    a, b, slots, _ = miller_lanes
    S = schedule.SLOT
    xp, yp = a[..., 0, :], a[..., 1, :]
    t0 = torch.stack([slots[:, S[n]] for n in ("X", "Y", "Z")], 1)
    t_ref, line_ref = ate._dbl_step(t0, xp, yp)
    s = slots
    for name in ("dbl1", "dbl2_sqr", "dbl3"):
        s = schedule.run_miller_op(_miller_op(name), s)
    assert torch.equal(torch.stack([s[:, S[n]] for n in ("X", "Y", "Z")], 1), t_ref)
    assert all(torch.equal(s[:, S[n]], v) for n, v in zip(("LA", "LB", "LC"), line_ref))
    q1 = ate.twist_frob(b)
    t_ref, line_ref = ate._add_step(t_ref, q1, xp, yp)
    s = s.clone()
    s[:, S["AX"]], s[:, S["AY"]] = s[:, S["Q1X"]], s[:, S["Q1Y"]]
    for name in ("add1", "add2", "add3", "add4_ml", "add5"):
        s = schedule.run_miller_op(_miller_op(name), s)
    assert torch.equal(torch.stack([s[:, S[n]] for n in ("X", "Y", "Z")], 1), t_ref)
    assert all(torch.equal(s[:, S[n]], v) for n, v in zip(("LA", "LB", "LC"), line_ref))


def test_miller_program_matches_miller_loop(miller_lanes):
    """The whole program: 3 operations a zero digit, 8 a set one, then the
    Frobenius lines."""
    a, b, _, _ = miller_lanes
    from sipp_tpu_torch.pairing.ate import DIGITS

    set_digits = sum(1 for d in DIGITS if d)
    assert len(schedule.PROGRAM) == 3 * len(DIGITS) + 5 * set_digits + 9
    assert torch.equal(schedule.miller_program(a, b), ate.miller_loop(a, b))


@pytest.fixture(scope="module")
def step_carry():
    """K7's inputs at 5 lanes: the carry two digits into the loop, a P at
    infinity (lane 1) and a Q at infinity (lane 3), and a qn that is not
    -qp (the next lane's point), so that each digit shows which tensor it
    reads."""
    a, b = random_instance(5, seed=43, device="cpu")
    a[1], b[3] = 0, 0
    f, t, qn = ate.miller_start(a, b)
    for d in ate.DIGITS[:2]:
        f, t = ate.miller_step_plain(d, b, qn, a, f, t)
    return b, torch.roll(b, 1, 0), a, f, t


@pytest.mark.parametrize("digit", [0, 1, 2])
def test_step_program_matches_miller_step_plain(step_carry, digit):
    """K7's program for one digit (K1's steps of that digit, the pending
    line multiply flushed) gives the plain step's f and T's coordinates."""
    assert len(schedule.STEP_PROGRAM[digit]) == (4 if digit == 0 else 8)
    got = schedule.miller_step_program(digit, *step_carry)
    want = ate.miller_step_plain(digit, *step_carry)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_generated_header_holds_the_miller_tables():
    """schedule_params.cuh's K1 arrays are the tables of ops/schedule.py."""
    text = _build.schedule_header()

    def array(name):
        body = re.search(rf"{name}\[[^=]*= \{{([^}}]*)\}}", text).group(1)
        return np.array([int(v) for v in body.split(",")])

    ops = schedule.M_OPS
    assert list(array("MOP_NPROD")) == [len(op.x) for op in ops]
    x = array("MOP_X").reshape(len(ops), schedule.M_PROD, schedule.M_OPND)
    terms = array("MOP_TERMS").reshape(len(ops), schedule.M_MAX_OUT, schedule.M_MAX_TERMS, 3)
    dst = array("MOP_DST").reshape(len(ops), schedule.M_MAX_OUT)
    for i, op in enumerate(ops):
        for k, opnd in enumerate(op.x):
            assert [b for b in x[i, k] if b != 0xFF] == [s | 64 * xi | 128 * neg
                                                         for s, xi, neg in opnd]
        assert list(dst[i, :len(op.dst)]) == list(op.dst)
        for j, form in enumerate(op.terms):
            assert [tuple(t) for t in terms[i, j] if t[1]] == list(form)
    prog = array("MILLER_PROG").reshape(-1, 3)
    assert [schedule.M_OPS[o].name for o in prog[:, 0]] == [n for n, _ in schedule.PROGRAM]
    steps = array("STEP_PROG").reshape(3, -1)
    assert list(array("STEP_LEN")) == [len(p) for p in schedule.STEP_PROGRAM]
    for row, want in zip(steps, schedule.STEP_PROGRAM):
        assert [schedule.M_OPS[o].name for o in row[:len(want)]] == list(want)


# ------------------------------------------ the device code, emulated on the CPU

def compile_sim(d, transcript_header):
    """g++ on tests/host_emulation/sim_main.cpp with the generated constant
    headers, into directory d."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the device code for the CPU")
    (d / "bn254_params.cuh").write_text(_build.params_header())
    (d / "schedule_params.cuh").write_text(_build.schedule_header())
    (d / "transcript_params.cuh").write_text(transcript_header)
    exe = d / "sim"
    proc = subprocess.run([gxx, "-O1", "-std=c++20", "-pthread", f"-I{HOST}", f"-I{d}",
                           f"-I{_build.CUDA_SRC}", str(HOST / "sim_main.cpp"), "-o", str(exe)],
                          capture_output=True, text=True, timeout=300)  # 4-20 s measured
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr
    return d, exe


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The emulation binary, with the Poseidon table in force."""
    return compile_sim(tmp_path_factory.mktemp("host_emulation"), _build.transcript_header())


@pytest.fixture(scope="module")
def sim_rc_file(tmp_path_factory):
    """The emulation binary built with a random round-constant table loaded
    through SIPP_POSEIDON_RC_FILE (the header generated in a child process,
    where the hook is read), and that table as the hook reduces it."""
    d = tmp_path_factory.mktemp("host_emulation_rc")
    rng = np.random.default_rng(17)
    table = [int(v) for v in rng.integers(0, 2**64, poseidon.N_ROUNDS * poseidon.WIDTH,
                                          dtype=np.uint64)]
    (d / "rc.txt").write_text(" ".join(hex(v) for v in table))
    child = "from sipp_tpu_torch.ops import _build; print(_build.transcript_header(), end='')"
    header = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                            env=dict(os.environ, SIPP_POSEIDON_RC_FILE=str(d / "rc.txt")),
                            cwd=HOST.parent.parent, check=True, timeout=300).stdout
    return compile_sim(d, header), [v % poseidon.P for v in table]


def run_sim(sim, mode, n, arrays):
    d, exe = sim
    np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in arrays]).tofile(d / "in.bin")
    # 1 s alone, over 10 s for the longest modes under a loaded tier-1 run
    subprocess.run([str(exe), mode, str(n), str(d / "in.bin"), str(d / "out.bin")], check=True,
                   timeout=300)
    return torch.from_numpy(np.fromfile(d / "out.bin", dtype=np.int64))


def test_fq_cc_matches_the_plain_field(sim):
    """bn254.cuh's carry-chain product, add, sub and inverse on the emulated
    carry flag, edge values (0, 1, p - 1, the Montgomery one) included."""
    rng = np.random.default_rng(9)
    edge = [0, 1, 2, params.P - 1, params.P - 2, (1 << 256) % params.P]
    vals = edge + [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(40)]
    pairs = [(x, y) for x in edge for y in edge] + list(zip(vals, vals[::-1]))
    a = FQ.encode([x for x, _ in pairs])
    b = FQ.encode([y for _, y in pairs])
    got = run_sim(sim, "fq", len(pairs), [torch.stack([a, b], 1)]).reshape(-1, 4, 16)
    assert torch.equal(got[:, 0], FQ.mul(a, b))
    assert torch.equal(got[:, 1], FQ.add(a, b))
    assert torch.equal(got[:, 2], FQ.sub(a, b))
    assert torch.equal(got[:, 3], FQ.inv(a))


@pytest.mark.parametrize("batch", [1, 37, 1000, 4096])
def test_fq_mul_kernel_emulated_matches_plain(sim, batch):
    """K0's device code (fq.cu: the shared-memory tile, the tail block)
    against fq_mul_plain; rows 0, 1 and p - 1 (as limbs and in Montgomery
    form) among seeded values."""
    rng = np.random.default_rng(batch)
    edge = [0, 1, params.P - 1]
    xs = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(2 * batch)]
    a, b = FQ.encode(xs[:batch]), FQ.encode(xs[batch:])
    rows = torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in edge])
    for i, row in enumerate(list(rows) + list(FQ.encode(edge))):
        a[(2 * i) % batch], b[(3 * i + 1) % batch] = row, row
    got = run_sim(sim, "fq_mul", batch, [a, b]).reshape(batch, 16)
    assert torch.equal(got, fq.fq_mul_plain(a, b))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fold_kernel_emulated_matches_plain(sim, group):
    """K3's device code at 10 lanes (two blocks): a dead lo, a dead hi and a
    dead lane; then all-zero bits."""
    a, b = random_instance(10, seed=11, device="cpu")
    pts = a if group == "g1" else b
    lo, hi = pts.clone(), torch.roll(pts, 1, 0)
    lo[2], hi[3], lo[4], hi[4] = 0, 0, 0, 0
    plain = getattr(fold, f"fold_{group}_plain")
    for bits in (scalar_to_bits(params.R - 12345), [0] * 254):
        got = run_sim(sim, f"fold_{group}", 10, [lo, hi, bits]).reshape(lo.shape)
        assert torch.equal(got, plain(lo, hi, bits))
    assert bool((got[4] == 0).all())


def test_final_exp_kernel_emulated_matches_plain(sim):
    """K2's device code at B = 2 (two blocks of eight warps)."""
    a, b = random_instance(2, seed=5, device="cpu")
    f = ate.miller_loop(a, b)
    got = run_sim(sim, "fexp", 2, [f]).reshape(f.shape)
    assert torch.equal(got, fexp.final_exp_plain(f))


@pytest.mark.parametrize("lanes,pair", [(2, False), (5, False), (2, True), (6, True)])
def test_miller_kernel_emulated_matches_plain(sim, lanes, pair):
    """K1's device code (two launches: the lanes' warps with the block's
    tree, then the partials' tree), against miller_product_plain: an
    infinity P lane and an infinity Q lane; 5 and 6 lanes pad a second
    block of 4 with lanes past n."""
    a, b = random_instance(lanes, seed=31 + lanes, device="cpu")
    if lanes > 2:
        a[1], b[lanes - 2] = 0, 0
    mode = "miller_pair" if pair else "miller"
    got = run_sim(sim, mode, lanes, [a, b])
    want = miller.miller_product_plain(a, b, pair=pair)
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("digit", [0, 1, 2])
def test_miller_step_kernel_emulated_matches_plain(sim, step_carry, digit):
    """K7's device code at 5 lanes (a whole block of 4 and one lane of a
    second block), infinity lanes included, against miller_step_plain; the
    lanes past n write nothing."""
    qp, qn, p, f, t = step_carry
    got = run_sim(sim, "miller_step", 5, [[digit], qp, qn, p, f, t])
    lanes = 8
    f_got, t_got = got[:lanes * 192].reshape(lanes, 2, 3, 2, 16), got[lanes * 192:].reshape(
        lanes, 3, 2, 16)
    f_want, t_want = ate.miller_step_plain(digit, *step_carry)
    assert torch.equal(f_got[:5], f_want) and torch.equal(t_got[:5], t_want)
    assert bool((f_got[5:] == -1).all() and (t_got[5:] == -1).all())


def test_fq12_exp_kernel_emulated_matches_plain(sim):
    """K8's device code (one warp a lane, K2's multiply table, the fixed
    window) at 5 lanes: seeded x off the cyclotomic subgroup with seeded
    bits, x = 0, all-zero bits, off = 0, and offsets other than 1; against
    fq12_exp_plain."""
    x, off = fq12_values(5, 51), fq12_values(5, 52)
    x[1] = 0
    off[4] = 0
    rng = np.random.default_rng(53)
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(5)]
    ks[2] = 0
    bits = torch.as_tensor(np.stack([scalar_to_bits(k) for k in ks], 1).astype(np.int64))
    assert not torch.equal(tower.fq12_cyclo_sqr(x[:1]), tower.fq12_sqr(x[:1]))
    got = run_sim(sim, "fq12_exp", 5, [x, off, bits]).reshape(x.shape)
    want = exp.fq12_exp_plain(x, off, bits)
    assert torch.equal(got, want)
    assert torch.equal(got[2], off[2]) and bool((got[1] == 0).all())
    assert bool((got[4] == 0).all())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_exp_kernel_emulated_matches_plain(sim, group):
    """K6's device code at 9 lanes (two blocks) with per-lane bits: an x at
    infinity, an offset at infinity, an offset equal to [k]x (the complete
    add's doubling) and one equal to -[k]x."""
    from sipp_tpu_torch import curves, hostref

    a, b = random_instance(9, seed=13, device="cpu")
    x = (a if group == "g1" else b).clone()
    off = torch.roll(x, 3, 0).clone()
    rng = np.random.default_rng(14)
    ks = [int.from_bytes(rng.bytes(40), "little") % params.R for _ in range(9)]
    dec, enc, mul = ((curves.g1_decode, curves.g1_encode, hostref.g1_mul) if group == "g1"
                     else (curves.g2_decode, curves.g2_encode, hostref.g2_mul))
    x[1], off[2] = 0, 0
    off[4] = enc([mul(dec(x[4:5])[0], ks[4])])[0]
    off[6] = enc([mul(dec(x[6:7])[0], params.R - ks[6])])[0]
    bits = torch.as_tensor(np.stack([scalar_to_bits(k) for k in ks], 1).astype(np.int64))
    got = run_sim(sim, f"exp_{group}", 9, [x, off, bits]).reshape(x.shape)
    assert torch.equal(got, getattr(exp, f"exp_{group}_plain")(x, off, bits))
    assert bool((got[6] == 0).all())          # -[k]x + [k]x = O


def forged_g2(k):
    """k points of the twist outside the r-torsion (the BLS map before
    cofactor clearing), as host points."""
    from sipp_tpu_torch.apps.bls_aggregation import map_to_g2_without_cofactor_mul

    return [map_to_g2_without_cofactor_mul((1234 + i, 5678)) for i in range(k)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_complete_kernel_emulated_matches_plain(sim, group):
    """ladder.cuh's add_complete_staged at 9 lanes (two blocks) against
    curves' add_mixed(p, q, dbl(q)): P == Q (the doubling), P == -Q, q at
    infinity, p at infinity (all-zero, and Z = 0 under other X, Y), both at
    infinity, and generic lanes."""
    a, b = random_instance(9, seed=21, device="cpu")
    C, pts = (G1, a) if group == "g1" else (G2, b)
    p = C.dbl(C.jac_from_affine(pts))                  # Z != 1
    q = torch.roll(pts, 1, 0).clone()
    q[0] = C.to_affine(p[0:1])[0]                      # P == Q
    q[1] = C.neg(C.to_affine(p[1:2]))[0]               # P == -Q
    q[2], q[5] = 0, 0
    p[3], p[5] = 0, 0
    p[4].select(0, 2).zero_()                          # Z = 0, X and Y not
    got = run_sim(sim, f"add_complete_{group}", 9, [p, q]).reshape(p.shape)
    want = C.add_mixed(p, q, C.dbl(C.jac_from_affine(q)))
    assert torch.equal(got, want)
    assert torch.equal(C.to_affine(got[0:1]), C.to_affine(C.dbl(p[0:1])))
    assert bool(C.is_infinity(got[1:2]).all()) and bool(C.is_infinity(got[5:6]).all())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_jacobian_kernel_emulated_matches_plain(sim, group):
    """ladder.cuh's add_jacobian_staged (X2's tree) at 9 lanes (two blocks)
    against curves' add: P == Q under two Z and one, P == -Q, infinity on
    either side and both, Z = 0 under other X and Y, a generic lane."""
    a, b = random_instance(9, seed=21, device="cpu")
    C, pts = (G1, a) if group == "g1" else (G2, b)
    p, q = jacobian_pairs(C, pts)
    got = run_sim(sim, f"add_jacobian_{group}", 9, [p, q]).reshape(p.shape)
    assert torch.equal(got, C.add(p, q))
    assert torch.equal(C.to_affine(got[[0, 7]]), C.to_affine(C.dbl(p[[0, 7]])))
    assert bool(C.is_infinity(got[[1, 4]]).all())


def test_torsion_kernel_emulated_matches_plain(sim):
    """X1's device code (validate.cu) at 16 lanes (two blocks): honest
    points, three off the r-torsion (the raw map, of order r h2), one of the
    cofactor's order ([r] of a raw point), an infinity lane, and from the
    raw point T = [r h2 / m]T for m = r and each prime l of h2 (order m)
    and for m = r l (order r l), against g2_torsion_plain."""
    from sipp_tpu_torch import curves
    from sipp_tpu_torch.ops import validate as x1

    _, b = random_instance(8, seed=23, device="cpu")
    raw = forged_g2(3)
    b[[1, 4, 6]] = curves.g2_encode(raw)
    b[5] = curves.g2_encode([hostref.g2_mul_raw(raw[0], params.R)])[0]
    b[3] = 0
    order = params.R * params.G2_COFACTOR
    ms = [params.R, *params.G2_COFACTOR_PRIMES, *(params.R * l for l in params.G2_COFACTOR_PRIMES)]
    pts = curves.g2_encode([hostref.g2_mul_raw(raw[0], order // m) for m in ms])
    b = torch.cat([b[:2], pts[:1], b[3:], pts[1:]])
    got = run_sim(sim, "torsion", 16, [b])
    want = x1.g2_torsion_plain(b)
    assert torch.equal(got, want)
    assert want.tolist() == [1, 0, 1, 1, 0, 0, 0, 1] + [0] * 8


MSM_SRC = (_build.CUDA_SRC / "msm.cu").read_text()
MSM_CONST = {k: int(re.search(rf"#define {k} (\d+)", MSM_SRC)[1])
             for k in ("MSM_CHUNK", "MSM_GROUPS")}
# X2's cases past the first ones: n as a function of the chunk (lanes a
# group) and the block (lanes a block of the chunk launch)
MSM_CASES = {"edge": lambda c, blk: 10, "all_inf": lambda c, blk: 3,
             "n1": lambda c, blk: 1, "chunk_plus_one": lambda c, blk: c + 1,
             "ragged": lambda c, blk: 2 * blk + 3 * c + 1,
             "tree_chains": lambda c, blk: MSM_CONST["MSM_GROUPS"] * blk + c + 1,
             "equal_chunks": lambda c, blk: 2 * blk,
             "cancel_chunks": lambda c, blk: 2 * blk + c,
             "inf_chunk": lambda c, blk: 2 * blk + 2}


@pytest.fixture(scope="module")
def msm_pool():
    """Distinct affine points of G1 and G2, the pairwise sums of 33 seeded
    ones (1,089 a group, enough for every case)."""
    a, b = random_instance(33, seed=25, device="cpu")
    i, j = torch.triu_indices(33, 33).unbind(0)
    i, j = torch.cat([i, j[j != i]]), torch.cat([j, i[j != i]])
    return {C: C.to_affine(C.add(C.lift(pts[i]), C.lift(pts[j]))) for C, pts in ((G1, a), (G2, b))}


def msm_lanes(C, pool, case):
    """Affine lanes for X2 (K6's output form): "edge": a repeated lane that
    the chain doubles (P, P), then -[2]P (the sum back at infinity), an
    infinity lane, a cancelling pair (Q, -Q) and a lane repeated far from
    its twin; "all_inf": every lane at infinity; "n1", "chunk_plus_one",
    "ragged" (several blocks and a tail: a partial count that is not a
    power of two), "tree_chains" (more partials than the tree block has
    groups: its groups chain them) on distinct points; "equal_chunks": the
    second chunk repeats the first (the block's tree doubles) and the
    second block the first (the tree launch doubles); "cancel_chunks": the
    second chunk and the second block negate the first (sums at infinity
    before a tail chunk); "inf_chunk": a chunk and a block at infinity."""
    c = MSM_CONST["MSM_CHUNK"]
    blk = c * MSM_CONST["MSM_GROUPS"]
    n = MSM_CASES[case](c, blk)
    lanes = pool[:n].clone()
    if case == "all_inf":
        return torch.zeros_like(lanes)
    if case == "edge":
        lanes[1] = lanes[0]
        lanes[2] = C.neg(C.to_affine(C.dbl(C.jac_from_affine(lanes[0:1]))))[0]
        lanes[3] = 0
        lanes[5] = C.neg(lanes[4:5])[0]
        lanes[9] = lanes[6]
    elif case == "equal_chunks":
        lanes[c:2 * c] = lanes[:c]
        lanes[blk:] = lanes[:blk]
    elif case == "cancel_chunks":
        lanes[c:2 * c] = C.neg(lanes[:c])
        lanes[blk:2 * blk] = C.neg(lanes[:blk])
    elif case == "inf_chunk":
        lanes[c:2 * c] = 0
        lanes[blk:2 * blk] = 0
    return lanes


@pytest.mark.parametrize("case", list(MSM_CASES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_sum_kernel_emulated_matches_plain(sim, msm_pool, group, case):
    """X2's device code (msm.cu: the chunk launch block by block, then the
    tree launch) against msm_finish_plain, on the cases of msm_lanes."""
    C = G1 if group == "g1" else G2
    lanes = msm_lanes(C, msm_pool[C], case)
    want = msm.msm_finish_plain(C, lanes)
    got = run_sim(sim, f"msm_sum_{group}", lanes.shape[0], [lanes]).reshape(want.shape)
    assert torch.equal(got, want)
    assert bool((got == 0).all()) == (case == "all_inf")


def gl_edge_states():
    """States of 0 and p - 1, and one whose first S-box input is 2^48 under
    the table in force: its square 2^96 takes the product's borrow (2^96 =
    -1)."""
    P, rc = poseidon.P, poseidon.ROUND_CONSTANTS
    return [[0] * 12, [P - 1] * 12, [0, P - 1] * 6, [P - 1, 0] * 6,
            [(2**48 - rc[0][0]) % P] + [0] * 11]


def test_round_emulated_matches_poseidon_round(sim):
    """One round of K4/K5's permutation (tr_round: the S-box, the MDS row
    through shared memory, the next constant in the reduction) on words that
    the kernel may hold, any u64 standing for its value mod p: the largest
    ones, an S-box input of 2^48, and a partial round whose row 0 sums carry
    out of 64 bits (m_01 x_1 with x_1's high half making the high sum -1 mod
    2^32), against the round of poseidon.permute."""
    P, M = poseidon.P, poseidon.MDS
    rng = np.random.default_rng(29)
    a = (-1 * pow(M[0][1], -1, 2**32)) % 2**32
    rand = [int(v) for v in rng.integers(0, 2**64, 12, dtype=np.uint64)]
    cases = [(True, [2**64 - 1] * 12, [P - 1] * 12), (False, [2**64 - 1] * 12, [P - 1] * 12),
             (True, [2**48] + rand[1:], [0] * 12),
             (False, [0, a << 32 | 0xFFFFFFFF] + [0] * 10, [0] * 12),
             (True, rand, [v % P for v in rand[::-1]]), (False, rand, [0] * 12)]
    words = np.array([[int(full)] + x + c for full, x, c in cases], dtype=np.uint64)
    got = run_sim(sim, "round", len(cases), [words.view(np.int64)]).numpy().view(np.uint64)
    for (full, x, c), row in zip(cases, got.reshape(-1, 12)):
        y = [poseidon._sbox(v % P) if full or j == 0 else v % P for j, v in enumerate(x)]
        want = [(sum(M[t][j] * y[j] for j in range(12)) + c[t]) % P for t in range(12)]
        assert [int(v) for v in row] == want


@pytest.mark.parametrize("table", ["pinned", "rc_file"])
def test_permute_emulated_matches_poseidon(request, monkeypatch, table):
    """K4/K5's permutation (one warp: shuffled state words, lazy MDS sums,
    constants added in the reduction) against poseidon.permute, with the
    pinned table and with a random one read through SIPP_POSEIDON_RC_FILE,
    on edge states and seeded ones."""
    if table == "pinned":
        exe = request.getfixturevalue("sim")
    else:
        exe, flat = request.getfixturevalue("sim_rc_file")
        w = poseidon.WIDTH
        monkeypatch.setattr(poseidon, "ROUND_CONSTANTS",
                            [flat[w * r:w * (r + 1)] for r in range(poseidon.N_ROUNDS)])
    rng = np.random.default_rng(19)
    states = gl_edge_states() + [[int(v) % poseidon.P for v in rng.integers(0, 2**64, 12,
                                                                         dtype=np.uint64)]
                               for _ in range(4)]
    words = np.array(states, dtype=np.uint64).view(np.int64)
    got = run_sim(exe, "permute", len(states), [words]).numpy().view(np.uint64).reshape(-1, 12)
    assert [[int(v) for v in row] for row in got] == [poseidon.permute(s) for s in states]


@pytest.fixture(scope="module")
def transcript_inputs():
    """The golden state and Fq12 values of tests/test_torch_transcript.py,
    and a state whose words are 0 and p - 1."""
    with np.load(GOLDEN) as g:
        gold = {k: convert.from_reference(g[k], device="cpu") for k in ("td_state", "td_f1",
                                                                        "td_f2")}
    edge = FGL.encode([0, poseidon.P - 1, poseidon.P - 1, 0])
    return [(gold["td_state"], gold["td_f1"], gold["td_f2"]), (edge, gold["td_f2"], gold["td_f1"])]


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("mode", ["append", "round_tail"])
def test_transcript_kernel_emulated_matches_plain(sim, transcript_inputs, mode, case):
    """K5's and K4's device code (the message encode, the appends, the
    digest, the challenge and its inverse) against transcript_*_plain."""
    state, f1, f2 = transcript_inputs[case]
    if mode == "append":
        got = run_sim(sim, mode, 1, [state, f1])
        assert torch.equal(got.reshape(4, 5), transcript.transcript_append_fq12_plain(state, f1))
        return
    got = run_sim(sim, mode, 1, [state, f1, f2])
    st, x, xinv = transcript.transcript_round_tail_plain(state, f1, f2)
    assert torch.equal(got[:20].reshape(4, 5), st)
    assert torch.equal(got[20:36], x)
    assert torch.equal(got[36:], xinv)


def test_fr_inverse_emulated_matches_fermat(sim):
    """K4's binary extended Euclid on 0, 1, 2, r - 1, r - 2, values whose
    steps shift by 32 bits and more, and seeded values, against
    pow(x, r - 2, r) and the plain version's Fermat chain."""
    rng = np.random.default_rng(23)
    R = params.R
    # 2^253 and r - 2^40 shift out 253 and 40 zeros at once; with u1 = r / 3
    # mod 2^32, r - 2 u1 leaves u = u1 after one step and then v - u = r - 3 u1
    # = 0 mod 2^32, so the result's cofactor shifts by 32 bits and more
    u1 = R * pow(3, -1, 2**32) % 2**32
    xs = [0, 1, 2, R - 1, R - 2, 1 << 253, R - (1 << 40), R - 2 * u1] + \
        [int.from_bytes(rng.bytes(32), "little") % R for _ in range(40)]
    limbs = torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)] for x in xs])
    got = run_sim(sim, "fr_inv", len(xs), [limbs]).reshape(-1, 16)
    assert [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in got] == \
        [pow(x, R - 2, R) for x in xs]
    assert torch.equal(got, td.fr_inverse(limbs))
