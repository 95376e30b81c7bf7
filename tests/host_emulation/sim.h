// Host emulation of the CUDA built-ins that the K0-K8, X1 and X2 device code
// uses, so that g++ compiles sipp_tpu_torch/csrc/{fq,miller,fexp,fold,exp,
// transcript,validate,msm}.cu's kernels for the CPU: a block runs as host
// threads, __syncwarp / __syncthreads are barriers of the warp's / block's
// threads, __shfl_sync, __shfl_xor_sync and __any_sync are a per-warp
// exchange buffer between two warp barriers,
// __shared__ variables are statics, and bn254.cuh's carry flag is emulated
// (its #else branch).
#pragma once
#include <algorithm>
#include <barrier>
#include <cstring>
#include <ctime>
#include <functional>
#include <thread>
#include <vector>

struct Dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) longlong2 { long long x, y; };
static thread_local Dim3 threadIdx, blockIdx, blockDim;
static std::barrier<>* g_warp_barrier[32];
static std::barrier<>* g_block_barrier;

inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline long long clock64() { return (long long)clock(); }
inline int __ffs(int x) { return __builtin_ffs(x); }

// Every lane of the warp writes its value, then reads lane src's (within
// its width-lane segment); the second barrier keeps the buffer until all
// have read.
static unsigned long long g_shfl[32][32];
template <class T>
inline T __shfl_sync(unsigned, T var, int src, int width = 32) {
    static_assert(sizeof(T) <= sizeof(unsigned long long));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    unsigned long long bits = 0;
    std::memcpy(&bits, &var, sizeof(T));
    g_shfl[warp][lane] = bits;
    __syncwarp();
    bits = g_shfl[warp][(lane & ~(width - 1)) + (src & (width - 1))];
    __syncwarp();
    std::memcpy(&var, &bits, sizeof(T));
    return var;
}

// Every lane of the warp writes its predicate, then reads all of them.
inline int __any_sync(unsigned, int pred) {
    const int warp = threadIdx.x / 32;
    const int width = std::min(32, (int)blockDim.x - 32 * warp);
    g_shfl[warp][threadIdx.x % 32] = pred != 0;
    __syncwarp();
    int any = 0;
    for (int i = 0; i < width; i++) any |= (int)g_shfl[warp][i];
    __syncwarp();
    return any;
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T var, int lane_mask, int width = 32) {
    return __shfl_sync(mask, var, (threadIdx.x % 32) ^ lane_mask, width);
}

#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __shared__ static
#define __launch_bounds__(x)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))

// Run body as block `block` of `nthreads` threads (one block at a time: the
// __shared__ statics are the block's shared memory).
static void run_block(int block, int nthreads, const std::function<void()>& body) {
    const int warps = (nthreads + 31) / 32;
    for (int w = 0; w < warps; w++)
        g_warp_barrier[w] = new std::barrier<>(std::min(32, nthreads - 32 * w));
    g_block_barrier = new std::barrier<>(nthreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; t++)
        threads.emplace_back([=, &body] {
            threadIdx.x = t;
            blockIdx.x = block;
            blockDim.x = nthreads;
            body();
        });
    for (auto& t : threads) t.join();
    for (int w = 0; w < warps; w++) delete g_warp_barrier[w];
    delete g_block_barrier;
}
