// K0: the batched Montgomery Fq product  out_i = a_i * b_i * 2^-256 mod p.
//
// Replaces sipp_tpu/ops/pallas_fq.py:fq_mul_pallas (the module's one-op
// kernel and micro-benchmark; the JAX package tiles the batch over
// 2048..8-row VMEM blocks).
//
// What bounds it on the H100: the bytes.  An element is 3 x 16 int64 limbs
// in and out, 384 bytes, against one 8-word Montgomery product (256 32-bit
// multiplies): at B = 2^20, 402.7 MB take 0.120 ms at 3.35 TB/s and the
// multiplies 0.016 ms.  At the entry point's B = 4096 the 1.57 MB take
// 0.47 us, less than a launch, so there the floor is the launch and one
// element's latency (its loads, and bn254.cuh's fq_mul, a dependent chain
// of ~885 cycles).
//
// The design, for both ends:
// * Coalesced 16-byte accesses.  A longlong2 holds limbs 2k and 2k + 1 of
//   one element, exactly one packed 32-bit word.  A block's tile of
//   FQ_MUL_TILE elements is 8 FQ_MUL_TILE such vectors an operand;
//   consecutive threads take
//   consecutive vectors (512 bytes a warp instruction), pack each to a word
//   in shared memory, and after the product store the words back the same
//   way as {w & 0xFFFF, w >> 16}.  A thread's 16 loads are independent, so
//   they are all in flight at once.
// * Rows of FQ_ROW = 9 words in shared memory: the product's reads, a
//   thread an element and a word at a time, fall on 32 different banks.
// * One thread an element for the product (bn254.cuh's fq_mul, untouched).
// * A grid sized from B: a warp a block, 32 elements, so that B = 4096
//   spreads over 128 SMs, and at B = 2^20 32 blocks an SM (64 registers a
//   thread fill the register file) hide the DRAM round trips: tiles of 256
//   elements read 1 % slower there (tools/chip_variants.py, tile256).
// The last tile is bounds-checked by vector index.
#include <cuda_runtime.h>

#include "bn254.cuh"

#define FQ_ROW 9                 // words a row of the shared tile (8 + 1 pad)
#define FQ_MUL_TILE 32           // elements (and threads) a block

__global__ void __launch_bounds__(FQ_MUL_TILE)
fq_mul_kernel(const longlong2* __restrict__ a, const longlong2* __restrict__ b,
              longlong2* __restrict__ out, int n) {
    constexpr int E = FQ_MUL_TILE;
    __shared__ u32 sa[E * FQ_ROW], sb[E * FQ_ROW];
    const int t = threadIdx.x;
    const long long first = (long long)blockIdx.x * E;     // the tile's first element
    const long long nvec = 8 * ((long long)n - first);     // vectors left from there
    a += 8 * first;
    b += 8 * first;
    out += 8 * first;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int i = k * E + t;                 // element i / 8, word i % 8 of the tile
        if (i < nvec) {
            const longlong2 x = a[i], y = b[i];
            sa[(i >> 3) * FQ_ROW + (i & 7)] = (u32)x.x | ((u32)x.y << 16);
            sb[(i >> 3) * FQ_ROW + (i & 7)] = (u32)y.x | ((u32)y.y << 16);
        }
    }
    __syncthreads();
    if (t < n - first) {
        Fq x, y;
#pragma unroll
        for (int k = 0; k < 8; k++) {
            x.v[k] = sa[t * FQ_ROW + k];
            y.v[k] = sb[t * FQ_ROW + k];
        }
        fq_mul(x, x, y);
#pragma unroll
        for (int k = 0; k < 8; k++) sa[t * FQ_ROW + k] = x.v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int i = k * E + t;
        if (i < nvec) {
            const u32 w = sa[(i >> 3) * FQ_ROW + (i & 7)];
            longlong2 v;
            v.x = w & 0xFFFFu;
            v.y = w >> 16;
            out[i] = v;
        }
    }
}

// An empty launch: the floor of any kernel's time on the queue.
__global__ void empty_kernel() {}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
// a, b, out: (n, 16) int64 limbs, canonical Montgomery inputs, 16-byte
// aligned (the wrapper checks).
extern "C" int sipp_fq_mul(const void* a, const void* b, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    fq_mul_kernel<<<(n + FQ_MUL_TILE - 1) / FQ_MUL_TILE, FQ_MUL_TILE, 0, s>>>(
        (const longlong2*)a, (const longlong2*)b, (longlong2*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int sipp_empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
