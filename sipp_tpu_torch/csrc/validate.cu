// X1: the G2 r-torsion verdict of every lane: 1 where [r]Q == O or Q is
// the all-zero encoding of infinity, else 0.
//
// Replaces the XLA program sipp_tpu/protocol/validate.py:_g2_in_subgroup
// (a lax.scan over the 254 bits of r with the complete mixed add), which
// the JAX package dispatches asynchronously from check_instance_async while
// the host replays the transcript.  No Pallas kernel existed for it: on the
// TPU it was XLA's.  Plain version: ops/validate.py g2_torsion_plain
// (curves' mul_check_ladder).
//
// What bounds it on the H100: latency, as K3-G2.  The verifier checks n
// points (128 in the paths), so the grid fills 16 warps of the card, and
// each lane is one chain of 254 doublings and 101 complete additions (r's
// set bits).  Design: K3's shape (ladder.cuh: 4 threads a lane, 8 lanes a
// warp, the doubling in 3 and the addition in 5 stages of independent
// products), the bits r's own, shared by every lane, MSB first, from
// infinity.  The addition is the complete one (add_complete_staged): the
// points are untrusted, and one off the subgroup can meet P == Q in the
// ladder, where the incomplete add of K3 would give a wrong point; its
// doubling stages run only where a lane of the warp met P == Q.
#include <cuda_runtime.h>

#include "ladder.cuh"

static __device__ __forceinline__ bool r_bit(int i) {      // MSB first
    const int k = BN_R_NBITS - 1 - i;
    return (BN_R[k / 32] >> (k % 32)) & 1;
}

__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
g2_torsion_kernel(const long long* __restrict__ b, long long* __restrict__ out, int n) {
    __shared__ FoldLane<G2Field> lanes[FOLD_LANES];
    const int sub = threadIdx.x % FOLD_GROUP;
    const int lane = blockIdx.x * FOLD_LANES + threadIdx.x / FOLD_GROUP;
    const bool live = lane < n;
    FoldLane<G2Field>& L = lanes[threadIdx.x / FOLD_GROUP];
    if (sub == 0) {
        fq2_zero(L.zero);
        if (live) {
            fq2_load(L.hx, b + (size_t)lane * 64);
            fq2_load(L.hy, b + (size_t)lane * 64 + 32);
        } else {
            fq2_zero(L.hx); fq2_zero(L.hy);
        }
        fq2_zero(L.X); fq2_zero(L.Y); fq2_zero(L.Z);
    }
    __syncwarp();
    for (int i = 0; i < BN_R_NBITS; i++) {
        dbl_staged<G2Field>(L, sub, true);
        if (r_bit(i)) add_complete_staged<G2Field>(L, L.hx, L.hy, sub, true);
    }
    if (sub == 0 && live)
        out[lane] = fq2_is_zero(L.Z) || (fq2_is_zero(L.hx) && fq2_is_zero(L.hy));
}

// The launcher (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
// b: (n, 2, 2, 16) affine int64 limbs; out: (n,) int64 verdicts.
extern "C" int sipp_g2_torsion(const void* b, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    g2_torsion_kernel<<<(n + FOLD_LANES - 1) / FOLD_LANES, FOLD_LANES * FOLD_GROUP, 0,
                        (cudaStream_t)stream>>>((const long long*)b, (long long*)out, n);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
