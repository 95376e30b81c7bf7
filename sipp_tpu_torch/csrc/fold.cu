// K3: the SIPP fold  lo + [x] hi  for every lane, one shared scalar x,
// result in affine coordinates; G1 (over Fq) and G2 (over Fq2).
//
// Replaces sipp_tpu/ops/pallas_fold.py:fold_g1_fused and fold_g2_fused
// (both via _fold_call): the 254-step MSB-first double-and-add ladder that
// starts at [bit0] hi, doubles and adds hi on set bits (the bits are shared,
// so zero bits skip the add uniformly), the mixed add of the offset lo with
// both infinity selects, and Jacobian -> affine by Fermat inversion, with
// infinity mapped to (0, 0).  Dead lanes (both points all-zero) fold as
// O + x*O = O and encode all-zero, as the reference's padding requires.
//
// Design: one thread per lane, templated on the coordinate field.  What
// bounds it on the H100: ~254 doublings and ~127 additions of dependent
// 256-bit multiplies per lane (integer multiply throughput and latency),
// plus one Fermat inversion; at n = 128 lanes the grid fills one or two
// SMs of 132.  More threads per lane is the first work for a later change.
#include <cuda_runtime.h>

#include "curve.cuh"

#define FOLD_BLOCK 64

template <class F>
__global__ void __launch_bounds__(FOLD_BLOCK)
fold_kernel(const long long* __restrict__ lo, const long long* __restrict__ hi,
            const long long* __restrict__ bits, long long* __restrict__ out, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    typedef typename F::T T;
    const size_t base = (size_t)lane * 2 * F::LIMBS;
    T x1, y1, x2, y2;
    F::load(x1, lo + base); F::load(y1, lo + base + F::LIMBS);
    F::load(x2, hi + base); F::load(y2, hi + base + F::LIMBS);
    Jac<F> acc;
    if (bits[0]) {
        acc.X = x2; acc.Y = y2; F::one(acc.Z);
    } else {
        F::zero(acc.X); F::zero(acc.Y); F::zero(acc.Z);
    }
    for (int i = 1; i < 254; i++) {
        jac_dbl<F>(acc);
        if (bits[i]) jac_add_mixed<F>(acc, x2, y2);
    }
    jac_add_mixed<F>(acc, x1, y1);
    T x, y;
    jac_to_affine<F>(x, y, acc);
    F::store(out + base, x);
    F::store(out + base + F::LIMBS, y);
}

template <class F>
static int launch_fold(const void* lo, const void* hi, const void* bits, void* out, int n,
                       void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int block = n < FOLD_BLOCK ? n : FOLD_BLOCK;
    fold_kernel<F><<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        (const long long*)lo, (const long long*)hi, (const long long*)bits, (long long*)out, n);
    return (int)cudaGetLastError();
}

// lo, hi, out: (n, 2, 16) G1 or (n, 2, 2, 16) G2 affine int64 limbs;
// bits: (254,) int64, MSB first.
extern "C" int sipp_fold_g1(const void* lo, const void* hi, const void* bits, void* out,
                            int n, void* stream) {
    return launch_fold<G1Field>(lo, hi, bits, out, n, stream);
}

extern "C" int sipp_fold_g2(const void* lo, const void* hi, const void* bits, void* out,
                            int n, void* stream) {
    return launch_fold<G2Field>(lo, hi, bits, out, n, stream);
}
