// K6: offset + [k_i] x_i for every lane, each lane with its own scalar,
// result in affine coordinates; G1 (over Fq) and G2 (over Fq2).  K8 (at the
// end): off_i * x_i^(k_i) in Fq12, on K2's Fq12 table operations.
//
// Replaces sipp_tpu/ops/pallas_exp.py:exp_g1_fused and exp_g2_fused (both via
// _exp_call): the MSB-first ladder from infinity, 254 x (double, incomplete
// mixed add of x, per-lane select on the lane's bit), then the complete mixed
// add of the offset (the P == Q doubling case and both infinities), then
// Jacobian -> affine by Fermat inversion with infinity mapped to (0, 0).  An
// x at infinity leaves the accumulator as it is, and so does an offset at
// infinity.  The verifier's MSM-form finals call it with a zero offset.
//
// What bounds it on the H100: latency, as K3 (the MSM finals' 128 lanes
// fill 16 blocks of one warp).  Design: K3's staged ladder (ladder.cuh: 4
// threads a lane, 8 lanes a warp, the doubling in 3 and the addition in 5
// stages of independent products), with one difference: the bits are a
// (254, B) plane, one per lane, so the 8 lanes of a warp disagree on the
// add.  As the TPU kernel does, every step computes the addition and each
// lane commits it or not on its own bit, as data (add_staged's `take`), so
// the warp never diverges around a __syncwarp: 254 x (3 + 5) stages.  The
// complete add of the offset is ladder.cuh's add_complete_staged: the
// staged addition, then, on lanes where it met P == Q, the staged doubling
// of the offset; P == -Q gives Z3 = Z H = 0, infinity, by itself.
#include <cuda_runtime.h>

#include "fq12_table.cuh"
#include "ladder.cuh"

template <class F>
__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
exp_kernel(const long long* __restrict__ xs, const long long* __restrict__ offs,
           const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    __shared__ FoldLane<F> lanes[FOLD_LANES];
    const int sub = threadIdx.x % FOLD_GROUP;
    const int lane = blockIdx.x * FOLD_LANES + threadIdx.x / FOLD_GROUP;
    const bool live = lane < n;
    FoldLane<F>& L = lanes[threadIdx.x / FOLD_GROUP];
    const size_t base = (size_t)lane * 2 * F::LIMBS;
    if (sub == 0) {
        F::zero(L.zero);
        if (live) {
            F::load(L.hx, xs + base); F::load(L.hy, xs + base + F::LIMBS);
            F::load(L.lx, offs + base); F::load(L.ly, offs + base + F::LIMBS);
        } else {
            F::zero(L.lx); F::zero(L.ly); F::zero(L.hx); F::zero(L.hy);
        }
        F::zero(L.X); F::zero(L.Y); F::zero(L.Z);
    }
    __syncwarp();
    for (int i = 0; i < 254; i++) {
        dbl_staged<F>(L, sub, true);
        add_staged<F>(L, L.hx, L.hy, sub, live && bits[(size_t)i * n + lane] != 0);
    }
    add_complete_staged<F>(L, L.lx, L.ly, sub, true);
    if (sub == 0 && live) store_affine<F>(out + base, L);
}

// K8: off_i * x_i^(k_i) per lane in Fq12.
//
// Replaces sipp_tpu/ops/pallas_exp.py:fq12_exp_fused (kernel
// _fq12_exp_kernel): pw = 1, then for each of the 254 MSB-first bits
// pw <- pw^2 and, where the lane's bit is 1, pw <- pw * x; finally
// out = off * pw (bit-identical to tower.fq12_exp_with_offset: x^k is a
// function and every value is canonical, so any correct chain gives the
// same bits).  The verifier's device Z' chain calls it with off = 1 on the
// 2 log2(n) proof rows.
//
// What bounds it on the H100: latency.  A lane is one chain of ~380
// Fq12 operations, and the verifier has 14 lanes.  Design: K2's, one warp
// per lane and each lane's warp a block of its own, so that 14 lanes run
// on 14 SMs.
// * Every Fq12 operation is K2's multiply table (fq12_table.cuh lin_op:
//   18 Fq2 products on 18 threads, then 6 linear forms), the squarings
//   too, with a = b.  No cyclotomic squaring: the rows are untrusted proof
//   input and need not lie in the cyclotomic subgroup.
// * A fixed window of FQ12_EXP_WINDOW = W bits: x^1 .. x^(2^W - 1) first,
//   then W squarings and at most one multiply a window; the squarings of
//   pw = 1 before the first set bit are skipped.  For W = 4: 14 + 252 +
//   <= 64 operations, against 254 + ~127 for the TPU kernel's
//   square-and-multiply (W = 1), which read slower on the card.
// * The lane's bits are read into shared memory first; the window value is
//   uniform over the warp, so a zero window skips its multiply without
//   divergence.  pw, the powers and off live in shared memory beside the
//   tables.
#define FQ12_EXP_WINDOW 4
#define FQ12_EXP_BITS 254
#define FQ12_EXP_POWERS ((1 << FQ12_EXP_WINDOW) - 1)

struct Fq12ExpShared {
    Fq2 pw[6], off[6];
    Fq2 pow[FQ12_EXP_POWERS][6];          // x^1 .. x^(2^W - 1)
    Fq2 prods[SCHED_N_PROD];
    Fq parts[SPLIT_MAX][3];
    Tables tab;
    unsigned char bit[FQ12_EXP_BITS];
};

__global__ void __launch_bounds__(32)
fq12_exp_kernel(const long long* __restrict__ xs, const long long* __restrict__ offs,
                const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    __shared__ Fq12ExpShared sh;
    const int lane = blockIdx.x, l = threadIdx.x;
    const size_t base = (size_t)lane * 192;
    load_tables(sh.tab);
    for (int i = l; i < FQ12_EXP_BITS; i += 32) sh.bit[i] = bits[(size_t)i * n + lane] != 0;
    if (l < 6) {
        fq2_load(sh.pow[0][l], xs + base + 32 * l);
        fq2_load(sh.off[l], offs + base + 32 * l);
        if (l == 0) fq2_one(sh.pw[0]);
        else fq2_zero(sh.pw[l]);
    }
    __syncwarp();
#define MUL(o, a, b) lin_op(o, a, b, OP_MUL, sh.prods, sh.parts, sh.tab, l)
    for (int k = 1; k < FQ12_EXP_POWERS; k++) MUL(sh.pow[k], sh.pow[k - 1], sh.pow[0]);
    bool one = true;                       // pw is still 1
    for (int i = 0, w = (FQ12_EXP_BITS - 1) % FQ12_EXP_WINDOW + 1; i < FQ12_EXP_BITS;
         i += w, w = FQ12_EXP_WINDOW) {
        int v = 0;
        for (int j = 0; j < w; j++) v = 2 * v + sh.bit[i + j];
        if (!one)
            for (int j = 0; j < w; j++) MUL(sh.pw, sh.pw, sh.pw);
        if (v) {
            MUL(sh.pw, sh.pw, sh.pow[v - 1]);
            one = false;
        }
    }
    MUL(sh.pw, sh.off, sh.pw);
#undef MUL
    if (l < 6) fq2_store(out + base + 32 * l, sh.pw[l]);
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
template <class F>
static int launch_exp(const void* x, const void* off, const void* bits, void* out, int n,
                      void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    exp_kernel<F><<<(n + FOLD_LANES - 1) / FOLD_LANES, FOLD_LANES * FOLD_GROUP, 0,
                    (cudaStream_t)stream>>>(
        (const long long*)x, (const long long*)off, (const long long*)bits, (long long*)out, n);
    return (int)cudaGetLastError();
}

// x, off, out: (n, 2, 16) G1 or (n, 2, 2, 16) G2 affine int64 limbs;
// bits: (254, n) int64, MSB first, one column per lane.
extern "C" int sipp_exp_g1(const void* x, const void* off, const void* bits, void* out, int n,
                           void* stream) {
    return launch_exp<G1Field>(x, off, bits, out, n, stream);
}

extern "C" int sipp_exp_g2(const void* x, const void* off, const void* bits, void* out, int n,
                           void* stream) {
    return launch_exp<G2Field>(x, off, bits, out, n, stream);
}

// x, off, out: (n, 2, 3, 2, 16) int64 limbs; bits: (254, n) int64, MSB first.
extern "C" int sipp_fq12_exp(const void* x, const void* off, const void* bits, void* out,
                             int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fq12_exp_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
        (const long long*)x, (const long long*)off, (const long long*)bits, (long long*)out, n);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
