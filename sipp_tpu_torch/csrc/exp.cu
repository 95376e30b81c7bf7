// K6: offset + [k_i] x_i for every lane, each lane with its own scalar,
// result in affine coordinates; G1 (over Fq) and G2 (over Fq2).  K8 (at the
// end): off_i * x_i^(k_i) in Fq12, the same ladder in the multiplicative
// group.
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
// complete add of the offset is the staged addition, then, on lanes where
// it met P == Q (accumulator not at infinity, offset not at infinity,
// H = R = 0), the staged doubling of the offset, which the other lanes do
// not commit; P == -Q gives Z3 = Z H = 0, infinity, by itself.
#include <cuda_runtime.h>

#include "ladder.cuh"

template <class F>
__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
exp_kernel(const long long* __restrict__ xs, const long long* __restrict__ offs,
           const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    __shared__ FoldLane<F> lanes[FOLD_LANES];
    __shared__ bool doubled[FOLD_LANES];
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
    // the complete add of the offset
    const bool acc_finite = !F::is_zero(L.Z);
    add_staged<F>(L, L.lx, L.ly, sub, true);
    if (sub == 0) {
        const bool same = acc_finite && !(F::is_zero(L.lx) && F::is_zero(L.ly))
                          && F::is_zero(L.s[11]) && F::is_zero(L.s[12]);
        if (same) {
            L.X = L.lx; L.Y = L.ly; F::one(L.Z);
        }
        doubled[threadIdx.x / FOLD_GROUP] = same;
    }
    __syncwarp();
    dbl_staged<F>(L, sub, doubled[threadIdx.x / FOLD_GROUP]);
    if (sub == 0 && live) store_affine<F>(out + base, L);
}

// K8: off_i * x_i^(k_i) per lane in Fq12.
//
// Replaces sipp_tpu/ops/pallas_exp.py:fq12_exp_fused (kernel
// _fq12_exp_kernel), in its order: pw = 1, then for each of the 254
// MSB-first bits pw <- pw^2 and, where the lane's bit is 1, pw <- pw * x;
// finally out = off * pw (bit-identical to tower.fq12_exp_with_offset).  The
// verifier's device Z' chain calls it with off = 1 on the 2 log2(n) proof
// rows.
//
// Design: one thread per lane, FQ12_EXP_BLOCK lanes per block; bits are the
// (254, B) plane of K6.  A lane whose bit is 0 skips the multiply (the TPU
// kernel computes it and selects), so a warp diverges per bit; x and the
// offset stay in registers / local memory.  What bounds it on the H100: the
// latency of each lane's chain of 254 squarings (36 Fq products each) and
// ~127 multiplies (54 each), dependent 256-bit multiplies on one thread.
#define FQ12_EXP_BLOCK 32

__global__ void __launch_bounds__(FQ12_EXP_BLOCK)
fq12_exp_kernel(const long long* __restrict__ xs, const long long* __restrict__ offs,
                const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    Fq12 x, pw;
    fq12_load(x, xs + (size_t)lane * 192);
    fq12_one(pw);
    for (int i = 0; i < 254; i++) {
        fq12_sqr(pw, pw);
        if (bits[(size_t)i * n + lane]) fq12_mul(pw, pw, x);
    }
    fq12_load(x, offs + (size_t)lane * 192);
    fq12_mul(pw, x, pw);
    fq12_store(out + (size_t)lane * 192, pw);
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
    fq12_exp_kernel<<<(n + FQ12_EXP_BLOCK - 1) / FQ12_EXP_BLOCK, FQ12_EXP_BLOCK, 0,
                      (cudaStream_t)stream>>>(
        (const long long*)x, (const long long*)off, (const long long*)bits, (long long*)out, n);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
