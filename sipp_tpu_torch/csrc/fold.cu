// K3: the SIPP fold  lo + [x] hi  for every lane, one shared scalar x,
// result in affine coordinates; G1 (over Fq) and G2 (over Fq2).
//
// Replaces sipp_tpu/ops/pallas_fold.py:fold_g1_fused and fold_g2_fused
// (both via _fold_call): the 254-step MSB-first double-and-add ladder that
// starts at [bit0] hi, doubles and adds hi on set bits (the bits are shared,
// so zero bits skip the add uniformly), the mixed add of the offset lo with
// both infinity selects, and Jacobian -> affine by Fermat inversion, with
// infinity mapped to (0, 0).  Dead lanes (both points all-zero) fold as
// O + x*O = O and encode all-zero, as the reference's padding requires;
// lanes past n run as dead lanes and store nothing.
//
// What bounds it on the H100, and the design (4 threads a lane, the
// doubling in 3 and the addition in 5 stages of independent products in
// shared memory): see ladder.cuh, whose stages K6 (exp.cu) shares.
#include <cuda_runtime.h>

#include "ladder.cuh"

template <class F>
__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
fold_kernel(const long long* __restrict__ lo, const long long* __restrict__ hi,
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
            F::load(L.lx, lo + base); F::load(L.ly, lo + base + F::LIMBS);
            F::load(L.hx, hi + base); F::load(L.hy, hi + base + F::LIMBS);
        } else {
            F::zero(L.lx); F::zero(L.ly); F::zero(L.hx); F::zero(L.hy);
        }
        if (bits[0]) {
            L.X = L.hx; L.Y = L.hy; F::one(L.Z);
        } else {
            F::zero(L.X); F::zero(L.Y); F::zero(L.Z);
        }
    }
    __syncwarp();
    for (int i = 1; i < 254; i++) {
        dbl_staged<F>(L, sub, true);
        if (bits[i]) add_staged<F>(L, L.hx, L.hy, sub, true);
    }
    add_staged<F>(L, L.lx, L.ly, sub, true);
    if (sub == 0 && live) store_affine<F>(out + base, L);
}

// ------------------------------------------------ Fq product latency probe
// A measurement, not a kernel of any path: one thread makes `iters`
// dependent products x <- x y with bn254.cuh's fq_mul, and writes x and the
// clock64 cycles of the loop.  in: x, y (2, 16) int64 limbs; out: x (16
// limbs), then the cycles.
__global__ void fq_mul_probe_kernel(const long long* __restrict__ in,
                                    long long* __restrict__ out, int iters) {
    Fq x, y;
    fq_load(x, in);
    fq_load(y, in + 16);
    const long long t0 = clock64();
    for (int i = 0; i < iters; i++) fq_mul(x, x, y);
    const long long t1 = clock64();
    fq_store(out, x);
    out[16] = t1 - t0;
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
template <class F>
static int launch_fold(const void* lo, const void* hi, const void* bits, void* out, int n,
                       void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fold_kernel<F><<<(n + FOLD_LANES - 1) / FOLD_LANES, FOLD_LANES * FOLD_GROUP, 0,
                     (cudaStream_t)stream>>>(
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

extern "C" int sipp_fq_mul_probe(const void* in, void* out, int iters, void* stream) {
    fq_mul_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const long long*)in,
                                                           (long long*)out, iters);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
