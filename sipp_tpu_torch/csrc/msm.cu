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
// What bounds it on the H100: latency.  The work is n - 1 additions and one
// inversion, microseconds of the card's multipliers; what takes the time is
// the longest chain of dependent products.  The sum is associative on the
// curve and the output is canonical affine, so any bracketing gives the
// plain tree's bytes, and a tree needs ceil(log2 n) dependent additions,
// each at least 5 levels of products (the depth of the addition's
// formulas), then the Fermat inversion's ~380 dependent products: that is
// the floor (chip_smoke.py's X2 latency_floor_ms, in the probe's cycles a
// product).  Design: two launches of one kernel, blocks of MSM_GROUPS
// groups of K3's staged ladder (ladder.cuh: 4 threads a lane group).
//
// * The chunk launch: each group chains MSM_CHUNK consecutive lanes, the
//   first lifted, the others by the complete mixed addition
//   (add_complete_staged: a repeated lane doubles, a cancelling pair gives
//   infinity); then the block's groups add pairwise, log2(MSM_GROUPS)
//   levels of the complete Jacobian addition (add_jacobian_staged) with a
//   __syncthreads between levels, and the block's sum goes to the
//   wrapper's scratch as a Jacobian partial, no inversion.
// * The tree launch: one block, each group chains ceil(blocks /
//   MSM_GROUPS) partials by the Jacobian addition, the same pairwise
//   levels, then thread 0 runs store_affine (the one inversion).  Where one
//   block holds every lane (n <= MSM_GROUPS * MSM_CHUNK) the chunk launch
//   writes the affine sum itself and the tree launch is not made.
// * At n = 4096: 64 blocks of 2 warps, 3 mixed additions, 4 levels, 3
//   chained partials and 4 levels, 14 additions deep against the n - 1 of
//   one group's chain.  A smaller chunk makes more partials, which the
//   tree launch's one block then chains; MSM_CHUNK = 4 is the least depth
//   at n = 4096 for this block (tools/chip_variants.py times 2, 8 and 16:
//   each slower there).  A level's inactive warps skip its stages
//   (a warp-uniform vote), inactive groups of an active warp run them on
//   their own slots and commit nothing.
#include <cuda_runtime.h>

#include "ladder.cuh"

#define MSM_CHUNK 4             // lanes a group chains in the chunk launch
#define MSM_GROUPS 16           // groups of a block (2 warps)
#define MSM_THREADS (MSM_GROUPS * FOLD_GROUP)

// blocks of the chunk launch over n lanes, each a Jacobian partial that the
// tree launch sums (one block: no tree launch)
static inline int msm_blocks(int n) {
    return (n + MSM_GROUPS * MSM_CHUNK - 1) / (MSM_GROUPS * MSM_CHUNK);
}

// Block b's group g sums inputs [(b MSM_GROUPS + g) per, + per) of n:
// affine lanes (JAC false, the chunk launch) or Jacobian partials (the tree
// launch), then the block's groups pairwise; the block's sum is stored at
// out + b (3 coordinates, Jacobian), or as affine at out where `affine`
// (a launch of one block, the last).
template <class F, bool JAC>
__global__ void __launch_bounds__(MSM_THREADS)
msm_sum_kernel(const long long* __restrict__ in, long long* __restrict__ out, int n, int per,
               bool affine) {
    typedef typename F::T T;
    __shared__ FoldLane<F> lanes[MSM_GROUPS];
    const int sub = threadIdx.x % FOLD_GROUP, g = threadIdx.x / FOLD_GROUP;
    const int coords = JAC ? 3 : 2;
    FoldLane<F>& L = lanes[g];
    const int block_first = blockIdx.x * MSM_GROUPS * per;
    const int first = block_first + g * per;
    const int left = n - block_first, groups = (left + per - 1) / per;
    // this group's inputs, the block's longest chain, its groups with inputs
    const int count = first >= n ? 0 : n - first < per ? n - first : per;
    const int steps = left < per ? left : per;
    const int live = groups < MSM_GROUPS ? groups : MSM_GROUPS;
    if (sub == 0) {
        F::zero(L.zero);
        F::zero(L.X); F::zero(L.Y); F::zero(L.Z);
    }
    __syncwarp();
    if (count > 0 && sub < coords)
        F::load(sub == 0 ? L.X : sub == 1 ? L.Y : L.Z,
                in + ((size_t)first * coords + sub) * F::LIMBS);
    __syncwarp();
    if (!JAC && sub == 0 && !(F::is_zero(L.X) && F::is_zero(L.Y))) F::one(L.Z);   // lift
    for (int j = 1; j < steps; j++) {
        const bool take = j < count;
        __syncwarp();                   // every thread is done with input j - 1
        if (take && sub < coords)
            F::load(sub == 0 ? L.hx : sub == 1 ? L.hy : L.lx,
                    in + ((size_t)(first + j) * coords + sub) * F::LIMBS);
        __syncwarp();
        if (JAC) add_jacobian_staged<F>(L, L.hx, L.hy, L.lx, sub, take);
        else add_complete_staged<F>(L, L.hx, L.hy, sub, take);
    }
    for (int s = 1; s < live; s *= 2) {
        __syncthreads();                // every group's sum of the level before is in
        const bool on = g % (2 * s) == 0 && g + s < live;
        const FoldLane<F>& P = lanes[on ? g + s : g];
        if (__any_sync(0xffffffffu, on)) add_jacobian_staged<F>(L, P.X, P.Y, P.Z, sub, on);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        if (affine) {
            store_affine<F>(out, L);
        } else {
            long long* dst = out + (size_t)blockIdx.x * 3 * F::LIMBS;
            F::store(dst, L.X);
            F::store(dst + F::LIMBS, L.Y);
            F::store(dst + 2 * F::LIMBS, L.Z);
        }
    }
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
template <class F>
static int launch_msm_sum(const void* pts, void* partials, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = msm_blocks(n);
    if (blocks > 1 && partials == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    msm_sum_kernel<F, false><<<blocks, MSM_THREADS, 0, s>>>(
        (const long long*)pts, (long long*)(blocks == 1 ? out : partials), n, MSM_CHUNK,
        blocks == 1);
    const cudaError_t err = cudaGetLastError();
    if (blocks == 1 || err != cudaSuccess) return (int)err;
    msm_sum_kernel<F, true><<<1, MSM_THREADS, 0, s>>>(
        (const long long*)partials, (long long*)out, blocks,
        (blocks + MSM_GROUPS - 1) / MSM_GROUPS, true);
    return (int)cudaGetLastError();
}

// The wrapper's scratch: Jacobian partials (sipp_msm_blocks(n), 3, ...) of
// the chunk launch; none where it returns 1.
extern "C" int sipp_msm_blocks(int n) { return msm_blocks(n); }

// pts: (n, 2, 16) G1 or (n, 2, 2, 16) G2 affine int64 limbs; partials:
// (sipp_msm_blocks(n), 3, 16) or (.., 3, 2, 16), or null for one block;
// out: (1, 2, 16) or (1, 2, 2, 16).
extern "C" int sipp_msm_sum_g1(const void* pts, void* partials, void* out, int n,
                               void* stream) {
    return launch_msm_sum<G1Field>(pts, partials, out, n, stream);
}

extern "C" int sipp_msm_sum_g2(const void* pts, void* partials, void* out, int n,
                               void* stream) {
    return launch_msm_sum<G2Field>(pts, partials, out, n, stream);
}
#endif  // __CUDACC__
