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

#include "bn254.cuh"

#define FOLD_BLOCK 64

struct G1Field {
    typedef Fq T;
    static const int LIMBS = 16;
    static __device__ void load(T& a, const long long* s) { fq_load(a, s); }
    static __device__ void store(long long* d, const T& a) { fq_store(d, a); }
    static __device__ void mul(T& r, const T& a, const T& b) { fq_mul(r, a, b); }
    static __device__ void add(T& r, const T& a, const T& b) { fq_add(r, a, b); }
    static __device__ void sub(T& r, const T& a, const T& b) { fq_sub(r, a, b); }
    static __device__ void inv(T& r, const T& a) { fq_inv(r, a); }
    static __device__ bool is_zero(const T& a) { return fq_is_zero(a); }
    static __device__ void one(T& a) { fq_one(a); }
    static __device__ void zero(T& a) { fq_zero(a); }
};

struct G2Field {
    typedef Fq2 T;
    static const int LIMBS = 32;
    static __device__ void load(T& a, const long long* s) { fq2_load(a, s); }
    static __device__ void store(long long* d, const T& a) { fq2_store(d, a); }
    static __device__ void mul(T& r, const T& a, const T& b) { fq2_mul(r, a, b); }
    static __device__ void add(T& r, const T& a, const T& b) { fq2_add(r, a, b); }
    static __device__ void sub(T& r, const T& a, const T& b) { fq2_sub(r, a, b); }
    static __device__ void inv(T& r, const T& a) { fq2_inv(r, a); }
    static __device__ bool is_zero(const T& a) { return fq2_is_zero(a); }
    static __device__ void one(T& a) { fq2_one(a); }
    static __device__ void zero(T& a) { fq2_zero(a); }
};

template <class F>
struct Jac { typename F::T X, Y, Z; };

// Jacobian doubling, a = 0; infinity-safe (Z3 = 2YZ = 0)
template <class F>
static __device__ __noinline__ void jac_dbl(Jac<F>& p) {
    typename F::T A, B, YZ, C, D, S, M, X3, Y3, x;
    F::mul(A, p.X, p.X); F::mul(B, p.Y, p.Y); F::mul(YZ, p.Y, p.Z);
    F::add(x, p.X, B);
    F::mul(C, B, B); F::mul(D, x, x);
    F::sub(S, D, A); F::sub(S, S, C); F::add(S, S, S);     // 4 X Y^2
    F::add(M, A, A); F::add(M, M, A);                      // 3 X^2
    F::mul(X3, M, M); F::add(x, S, S); F::sub(X3, X3, x);
    F::sub(x, S, X3); F::mul(Y3, M, x);
    F::add(x, C, C); F::add(x, x, x); F::add(x, x, x); F::sub(Y3, Y3, x);
    F::add(p.Z, YZ, YZ);
    p.X = X3;
    p.Y = Y3;
}

// p += (x2, y2) affine, incomplete (no P == Q case: the ladder never meets
// it); p at infinity gives q, q all-zero (infinity) leaves p.
template <class F>
static __device__ __noinline__ void jac_add_mixed(Jac<F>& p, const typename F::T& x2,
                                                  const typename F::T& y2) {
    if (F::is_zero(x2) && F::is_zero(y2)) return;
    if (F::is_zero(p.Z)) {
        p.X = x2; p.Y = y2; F::one(p.Z);
        return;
    }
    typename F::T ZZ, U2, S2, H, R, HH, RR, HHH, V, Z3, X3, Y3, x;
    F::mul(ZZ, p.Z, p.Z);
    F::mul(U2, x2, ZZ);
    F::mul(S2, y2, p.Z); F::mul(S2, S2, ZZ);
    F::sub(H, U2, p.X);
    F::sub(R, S2, p.Y);
    F::mul(HH, H, H); F::mul(RR, R, R);
    F::mul(HHH, H, HH); F::mul(V, p.X, HH); F::mul(Z3, p.Z, H);
    F::sub(X3, RR, HHH); F::add(x, V, V); F::sub(X3, X3, x);
    F::sub(x, V, X3); F::mul(Y3, R, x); F::mul(x, p.Y, HHH); F::sub(Y3, Y3, x);
    p.X = X3; p.Y = Y3; p.Z = Z3;
}

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
    // Jacobian -> affine; infinity -> (0, 0)
    T zinv, zinv2, x, y;
    if (F::is_zero(acc.Z)) {
        F::zero(x); F::zero(y);
    } else {
        F::inv(zinv, acc.Z);
        F::mul(zinv2, zinv, zinv);
        F::mul(x, acc.X, zinv2);
        F::mul(zinv2, zinv2, zinv);
        F::mul(y, acc.Y, zinv2);
    }
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
