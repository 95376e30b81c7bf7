// K0: the batched Montgomery Fq product  out_i = a_i * b_i * 2^-256 mod p.
//
// Replaces sipp_tpu/ops/pallas_fq.py:fq_mul_pallas (the module's
// one-op kernel and micro-benchmark; the JAX package tiles the batch over
// 2048..8-row VMEM blocks).  Here one thread per element, FQ_MUL_BLOCK
// elements per block, with bn254.cuh's load / CIOS product / store: each
// thread reads 16 + 16 int64 limbs, runs one 8-word Montgomery product (a
// serial carry chain of 128 word products), and writes 16 limbs, canonical.
// What bounds it on the H100: at the entry point's B = 4096 the 1.57 MB it
// moves takes ~0.5 us at 3.35 TB/s and the 1.05 M 32-bit multiplies
// ~0.06 us, so a launch (a few us) is the floor; a batch of millions would
// be bound by the int64 limb traffic (8 bytes per 16 bits).
#include <cuda_runtime.h>

#include "bn254.cuh"

#define FQ_MUL_BLOCK 128

__global__ void __launch_bounds__(FQ_MUL_BLOCK)
fq_mul_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
              long long* __restrict__ out, int n) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Fq x, y;
    fq_load(x, a + (size_t)e * 16);
    fq_load(y, b + (size_t)e * 16);
    fq_mul(x, x, y);
    fq_store(out + (size_t)e * 16, x);
}

// a, b, out: (n, 16) int64 limbs, canonical Montgomery inputs.
extern "C" int sipp_fq_mul(const void* a, const void* b, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fq_mul_kernel<<<(n + FQ_MUL_BLOCK - 1) / FQ_MUL_BLOCK, FQ_MUL_BLOCK, 0,
                    (cudaStream_t)stream>>>(
        (const long long*)a, (const long long*)b, (long long*)out, n);
    return (int)cudaGetLastError();
}
