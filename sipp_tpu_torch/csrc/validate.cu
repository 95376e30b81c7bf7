// X1: the G2 r-torsion verdict of every lane: 1 where [r]Q == O or Q is
// the all-zero encoding of infinity, else 0, for Q on the twist E'(Fq2).
//
// Replaces the XLA program sipp_tpu/protocol/validate.py:_g2_in_subgroup
// (a lax.scan over the 254 bits of r with the complete mixed add), which
// the JAX package dispatches asynchronously from check_instance_async while
// the host replays the transcript.  No Pallas kernel existed for it: on the
// TPU it was XLA's.  Plain version: ops/validate.py g2_torsion_plain.
//
// The test is not [r]Q == O but the BN endomorphism test of eprint
// 2022/348 (Dai, Lin, Zhao, Zhou, sections 3 and 5.1), with psi the
// twist's Frobenius and x0 the BN parameter (params.X, 63 bits):
//   [x0 + 1]Q + psi([x0]Q) + psi^2([x0]Q) == psi^3([2 x0]Q).
// E'(Fq2) is cyclic of squarefree order r h2, so this kernel of an
// endomorphism is the r-torsion on every point of the twist iff it holds
// on the order-r points and fails on one point of each prime order of h2:
// tests/test_torch_torsion.py proves that.  Off the twist the verdict is
// whatever the formulas give and means nothing: check_instance_async
// reports a B off the twist before it reads any torsion verdict.
//
// What bounds it on the H100: latency, as K3-G2.  The verifier checks n
// points (128 in the paths), so the grid fills 16 warps of the card, and
// each lane is one chain.  Design: K3's shape (ladder.cuh: 4 threads a
// lane, 8 lanes a warp, the doubling in 3 and the addition in 5 stages of
// independent products), from infinity:
//   T = [x0]Q over x0's bits, MSB first (62 doublings, 28 complete mixed
//       additions: a point of small order meets P == +-Q and O here);
//   U = psi(T), V = psi(U), W = [2] psi(V), one stage each psi;
//   D = T + Q + U + V + (-W): the complete mixed addition, then three
//       complete Jacobian ones (-W negates Y; P == -Q gives Z = 0);
//   the verdict Z(D) == 0 or Q == (0, 0), no inversion.
// About 352 dependent product levels a lane, against r's 1,267.
#include <cuda_runtime.h>

#include "ladder.cuh"

static __device__ __forceinline__ bool x_bit(int i) {      // MSB first
    return (BN_X >> (BN_X_NBITS - 1 - i)) & 1;
}

// b: (n, 2, 2, 16) affine int64 limbs; out: (n,) int64 verdicts
__global__ void __launch_bounds__(FOLD_LANES * FOLD_GROUP)
g2_torsion_kernel(const long long* __restrict__ b, long long* __restrict__ out, int n) {
    __shared__ FoldLane<G2Field> lanes[FOLD_LANES];
    __shared__ Fq2 saved[FOLD_LANES][4][3];     // T, U, V, -W of each lane
    const int sub = threadIdx.x % FOLD_GROUP;
    const int lane = blockIdx.x * FOLD_LANES + threadIdx.x / FOLD_GROUP;
    const bool live = lane < n;
    FoldLane<G2Field>& L = lanes[threadIdx.x / FOLD_GROUP];
    Fq2 (*S)[3] = saved[threadIdx.x / FOLD_GROUP];
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
    // T = [x0]Q (the first doubling, of infinity, would leave it all-zero)
    for (int i = 0; i < BN_X_NBITS; i++) {
        if (i) dbl_staged<G2Field>(L, sub, true);
        if (x_bit(i)) add_complete_staged<G2Field>(L, L.hx, L.hy, sub, true);
    }
    if (sub == 0) {
        S[0][0] = L.X; S[0][1] = L.Y; S[0][2] = L.Z;
    }
    psi_staged(L, S[1][0], S[1][1], S[1][2], L.X, L.Y, L.Z, sub);
    psi_staged(L, S[2][0], S[2][1], S[2][2], S[1][0], S[1][1], S[1][2], sub);
    psi_staged(L, L.X, L.Y, L.Z, S[2][0], S[2][1], S[2][2], sub);
    dbl_staged<G2Field>(L, sub, true);
    neg_staged<G2Field>(L, sub);
    if (sub == 0) {
        S[3][0] = L.X; S[3][1] = L.Y; S[3][2] = L.Z;
        L.X = S[0][0]; L.Y = S[0][1]; L.Z = S[0][2];
    }
    __syncwarp();
    add_complete_staged<G2Field>(L, L.hx, L.hy, sub, true);
    for (int j = 1; j < 4; j++)
        add_jacobian_staged<G2Field>(L, S[j][0], S[j][1], S[j][2], sub, true);
    if (sub == 0 && live)
        out[lane] = fq2_is_zero(L.Z) || (fq2_is_zero(L.hx) && fq2_is_zero(L.hy));
}

// The launcher (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
extern "C" int sipp_g2_torsion(const void* b, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    g2_torsion_kernel<<<(n + FOLD_LANES - 1) / FOLD_LANES, FOLD_LANES * FOLD_GROUP, 0,
                        (cudaStream_t)stream>>>((const long long*)b, (long long*)out, n);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
