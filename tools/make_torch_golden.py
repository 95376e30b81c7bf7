"""Freeze golden vectors from the JAX reference for the PyTorch port's tests.

Runs the unmodified `sipp_tpu` package on the CPU (its XLA paths, which the
package's own tests hold bit-identical to the Pallas kernels) and writes
tests/golden/torch_port.npz, a few KB of uint32 arrays in the reference
device format (16 x 16-bit Montgomery limbs):

  a4, b4           random_instance(4, seed=7)
  a2, b2           random_instance(2, seed=8)
  f4, f2           _product_tree(miller_loop(A, B))             (pre-FE)
  pair_p, pair_q   pair-mode Miller inputs (even lanes: A_hi x B_lo, odd
                   lanes: A_lo x B_hi), lane 2 set to the point at infinity
  pair_f           (2, ...) = _inner_f(A_hi, B_lo), _inner_f(A_lo, B_hi)
  pair_z           final_exp(pair_f)                              (B = 2)
  z4, z2           final_exp(f4), final_exp(f2)
  fold_x           the fixed G1 fold challenge (as 16-bit limbs; x^-1 for G2)
  fold_g1_lo/hi/out, fold_g2_lo/hi/out
                   G1/G2.to_affine(fold(lo, hi, bits)), lane 3 dead in both
  proof4           sipp_prove(a4, b4)
  stmt4            sipp_verify(a4, b4, proof4).to_vec() as uint32

Each stage runs in its own process, two at a time.  Usage (about a quarter
of an hour on the CPU; XLA compiles dominate):

    JAX_PLATFORMS=cpu PYTHONPATH= python tools/make_torch_golden.py
"""

import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sipp_tpu import params  # noqa: E402
from sipp_tpu.curves import G1, G2, scalar_to_bits  # noqa: E402
from sipp_tpu.fields import bigint  # noqa: E402
from sipp_tpu.pairing.ate import (_inner_f, _product_tree, final_exp,  # noqa: E402
                                  miller_loop)
from sipp_tpu.protocol import sipp_prove, sipp_verify  # noqa: E402
from sipp_tpu.utils.testing import random_instance  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden" / "torch_port.npz"

# fold challenge with its top (254th) bit set, so the ladder's start at
# [bit0]base takes the base; its inverse exercises an arbitrary top bit
FOLD_X = params.R - 12345


def u32(x):
    return np.asarray(jax.device_get(x), dtype=np.uint32)


def log(msg, t0=[time.time()]):
    print(f"[{time.time() - t0[0]:7.1f}s] {msg}", flush=True)


def stage_inputs(g):
    a4, b4 = random_instance(4, seed=7)
    a2, b2 = random_instance(2, seed=8)
    g.update(a4=u32(a4), b4=u32(b4), a2=u32(a2), b2=u32(b2))


def stage_miller(g):
    stage_inputs(g)
    g["f4"] = u32(_product_tree(miller_loop(g["a4"], g["b4"])))
    g["f2"] = u32(_product_tree(miller_loop(g["a2"], g["b2"])))


def _pair_inputs(A, B):
    # pair mode at W = 4, m = 2: lanes interleave (A_hi, B_lo) on even lanes
    # and (A_lo, B_hi) on odd lanes; lane 2 (A_hi[1] x B_lo[1]) is dead
    a_lo, a_hi, b_lo, b_hi = A[:2].copy(), A[2:].copy(), B[:2], B[2:]
    a_hi[1] = 0
    p = np.stack([a_hi, a_lo], axis=1).reshape(4, 2, 16)
    q = np.stack([b_lo, b_hi], axis=1).reshape(4, 2, 2, 16)
    return a_lo, a_hi, b_lo, b_hi, p, q


def stage_pair(g):
    stage_inputs(g)
    a_lo, a_hi, b_lo, b_hi, p, q = _pair_inputs(g["a4"], g["b4"])
    fl = _inner_f(a_hi, b_lo, None)
    fr = _inner_f(a_lo, b_hi, None)
    g.update(pair_p=p, pair_q=q, pair_f=np.stack([u32(fl), u32(fr)]))


def stage_fexp(g, pair_f, f4, f2):
    g["pair_z"] = u32(final_exp(pair_f))
    g["z4"] = u32(final_exp(f4[None]))[0]
    g["z2"] = u32(final_exp(f2[None]))[0]


def stage_fold(g):
    stage_inputs(g)
    A, B = g["a4"], g["b4"]
    xinv = pow(FOLD_X, -1, params.R)
    g["fold_x"] = bigint.int_to_limbs(FOLD_X, 16)
    lo1, hi1 = A.copy(), np.roll(A, 1, axis=0)
    lo2, hi2 = B.copy(), np.roll(B, 1, axis=0)
    for arr in (lo1, hi1, lo2, hi2):
        arr[3] = 0
    g.update(fold_g1_lo=lo1, fold_g1_hi=hi1, fold_g2_lo=lo2, fold_g2_hi=hi2)
    g["fold_g1_out"] = u32(G1.to_affine(G1.fold(lo1, hi1, scalar_to_bits(FOLD_X))))
    g["fold_g2_out"] = u32(G2.to_affine(G2.fold(lo2, hi2, scalar_to_bits(xinv))))


def stage_prove(g):
    stage_inputs(g)
    g["proof4"] = u32(sipp_prove(g["a4"], g["b4"]))


def stage_verify(g, proof4):
    stage_inputs(g)
    stmt = sipp_verify(g["a4"], g["b4"], proof4)
    g["stmt4"] = np.asarray(stmt.to_vec(), dtype=np.uint32)


# Each stage runs in its own process: XLA:CPU runs out of memory maps when
# one process compiles every program of the list.  (stage, inputs it needs)
STAGES = [("miller", ()), ("pair", ()), ("fold", ()), ("prove", ()),
          ("fexp", ("pair", "miller")), ("verify", ("prove",))]


def run_stage(name, tmp):
    g = {}
    deps = {}
    for dep in dict(STAGES)[name]:
        with np.load(tmp / f"{dep}.npz") as d:
            deps.update({k: d[k] for k in d.files})
    if name == "fexp":
        stage_fexp(g, deps["pair_f"], deps["f4"], deps["f2"])
    elif name == "verify":
        stage_verify(g, deps["proof4"])
    else:
        globals()[f"stage_{name}"](g)
    np.savez(tmp / f"{name}.npz", **g)
    log(f"stage {name} done")


def main():
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = pathlib.Path(tmpdir)
        done, running = set(), {}
        while len(done) < len(STAGES):
            for name, deps in STAGES:
                if (name not in done and name not in running and len(running) < 2
                        and set(deps) <= done):
                    running[name] = subprocess.Popen(
                        [sys.executable, __file__, "--stage", name, str(tmp)])
            for name, proc in list(running.items()):
                if proc.poll() is not None:
                    if proc.returncode != 0:
                        raise SystemExit(f"stage {name} failed ({proc.returncode})")
                    done.add(name)
                    del running[name]
            time.sleep(1)
        g = {}
        for name, _ in STAGES:
            with np.load(tmp / f"{name}.npz") as d:
                g.update({k: d[k] for k in d.files})
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **g)
    log(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--stage":
        run_stage(sys.argv[2], pathlib.Path(sys.argv[3]))
    else:
        main()
