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
// Design: one thread per lane, the templates of curve.cuh (the fold ladder's
// doubling and mixed add).  The bits are a (254, B) plane, so a warp reads
// one bit of 32 neighbouring lanes at a time; a lane whose bit is 0 skips the
// add, and its warp waits for the lanes that take it (the TPU kernel computes
// the add for every lane and selects).  What bounds it on the H100: the
// latency of each lane's chain of ~254 doublings and ~127 additions of
// dependent 256-bit multiplies (integer multiply latency), plus one Fermat
// inversion; at B = 128 lanes the grid fills two SMs of 132.
#include <cuda_runtime.h>

#include "curve.cuh"

#define EXP_BLOCK 64

template <class F>
__global__ void __launch_bounds__(EXP_BLOCK)
exp_kernel(const long long* __restrict__ xs, const long long* __restrict__ offs,
           const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    typedef typename F::T T;
    const size_t base = (size_t)lane * 2 * F::LIMBS;
    T bx, by, ox, oy;
    F::load(bx, xs + base); F::load(by, xs + base + F::LIMBS);
    F::load(ox, offs + base); F::load(oy, offs + base + F::LIMBS);
    Jac<F> acc;
    F::zero(acc.X); F::zero(acc.Y); F::zero(acc.Z);
    for (int i = 0; i < 254; i++) {
        jac_dbl<F>(acc);
        if (bits[(size_t)i * n + lane]) jac_add_mixed<F>(acc, bx, by);
    }
    jac_add_mixed_complete<F>(acc, ox, oy);
    T x, y;
    jac_to_affine<F>(x, y, acc);
    F::store(out + base, x);
    F::store(out + base + F::LIMBS, y);
}

template <class F>
static int launch_exp(const void* x, const void* off, const void* bits, void* out, int n,
                      void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int block = n < EXP_BLOCK ? n : EXP_BLOCK;
    exp_kernel<F><<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
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

// x, off, out: (n, 2, 3, 2, 16) int64 limbs; bits: (254, n) int64, MSB first.
extern "C" int sipp_fq12_exp(const void* x, const void* off, const void* bits, void* out,
                             int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fq12_exp_kernel<<<(n + FQ12_EXP_BLOCK - 1) / FQ12_EXP_BLOCK, FQ12_EXP_BLOCK, 0,
                      (cudaStream_t)stream>>>(
        (const long long*)x, (const long long*)off, (const long long*)bits, (long long*)out, n);
    return (int)cudaGetLastError();
}
