// X2: the sum of the MSM finals' lanes, sum_j P_j of K6's (n, ...) affine
// output as one canonical affine point (infinity as all-zero); G1 (over Fq)
// and G2 (over Fq2).
//
// Replaces the XLA _tree_sum + to_affine of the JAX verifier's MSM finals
// (sipp_tpu/protocol/verifier.py:_finals_msm_dev), which run after the
// Pallas exp kernels inside one jit program.  No Pallas kernel existed for
// them: on the TPU they were XLA's.  Plain version: ops/msm.py
// msm_finish_plain (curves' complete-add tree and to_affine).  All-zero
// lanes are infinity (curves' lift), never the point (0, 0).
//
// What bounds it on the H100: latency.  The sum is one chain of n
// additions and one Fermat inversion, whatever the design: a group element
// and a canonical affine output, so any bracketing gives the plain tree's
// bytes.  Design, the simplest that is right: one lane of K3's staged
// ladder (ladder.cuh: 4 threads, the addition in 5 stages) adds the lanes
// one after the other with the complete mixed addition (a repeated lane
// doubles, a cancelling pair gives infinity), then store_affine.  The other
// 7 groups of the warp run the same stages on infinity and store nothing.
#include <cuda_runtime.h>

#include "ladder.cuh"

template <class F>
__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
msm_sum_kernel(const long long* __restrict__ pts, long long* __restrict__ out, int n) {
    __shared__ FoldLane<F> lanes[FOLD_LANES];
    const int sub = threadIdx.x % FOLD_GROUP;
    const bool first = threadIdx.x < FOLD_GROUP;        // the group that sums
    FoldLane<F>& L = lanes[threadIdx.x / FOLD_GROUP];
    if (sub == 0) {
        F::zero(L.zero);
        F::zero(L.X); F::zero(L.Y); F::zero(L.Z);
        F::zero(L.hx); F::zero(L.hy);
    }
    for (int j = 0; j < n; j++) {
        __syncwarp();                   // every thread is done with lane j - 1
        if (sub == 0 && first) {
            F::load(L.hx, pts + (size_t)j * 2 * F::LIMBS);
            F::load(L.hy, pts + (size_t)j * 2 * F::LIMBS + F::LIMBS);
        }
        __syncwarp();
        add_complete_staged<F>(L, L.hx, L.hy, sub, true);
    }
    if (threadIdx.x == 0) store_affine<F>(out, L);
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
template <class F>
static int launch_msm_sum(const void* pts, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    msm_sum_kernel<F><<<1, FOLD_LANES * FOLD_GROUP, 0, (cudaStream_t)stream>>>(
        (const long long*)pts, (long long*)out, n);
    return (int)cudaGetLastError();
}

// pts: (n, 2, 16) G1 or (n, 2, 2, 16) G2 affine int64 limbs; out: (1, 2, 16)
// or (1, 2, 2, 16).
extern "C" int sipp_msm_sum_g1(const void* pts, void* out, int n, void* stream) {
    return launch_msm_sum<G1Field>(pts, out, n, stream);
}

extern "C" int sipp_msm_sum_g2(const void* pts, void* out, int n, void* stream) {
    return launch_msm_sum<G2Field>(pts, out, n, stream);
}
#endif  // __CUDACC__
