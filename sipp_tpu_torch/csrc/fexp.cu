// K2: the final exponentiation f^((p^12 - 1) / r) of a small stack of Fq12.
//
// Replaces sipp_tpu/ops/pallas_fexp.py:final_exp_fused: the easy part
// conj(f) * f^-1 (tower inversion down to one Fermat Fq inversion), times
// its p^2-Frobenius, then the hard part as three x-power chains
// (cyclotomic square-and-multiply) and the reference's lambda tape over a
// 12-slot register file (pairing/ate.py TAPE), finished by frob3.  The
// final exponentiation is a function, so any correct chain gives the same
// bits; mirroring the tape is the shortest route.
//
// Design: one thread per element (B is 1 for an aggregation and 2 for a
// fold round's Z_L/Z_R).  What bounds it on the H100: it is one serial chain
// of roughly 800 Fq12 multiplies with no parallelism inside the element, so
// at B = 1 a single thread runs on a single SM: latency of the dependent
// 256-bit multiplies, not throughput.  The register file (12 x 384 B) sits
// in local memory.  Splitting each Fq12 multiply over a warp is the first
// work for a later change.
#include <cuda_runtime.h>

#include "bn254.cuh"

static __device__ __noinline__ void powx(Fq12& r, const Fq12& v) {
    Fq12 acc;
    fq12_one(acc);
    for (int bit = BN_X_NBITS - 1; bit >= 0; bit--) {
        fq12_cyclo_sqr(acc, acc);
        if ((BN_X >> bit) & 1) fq12_mul(acc, acc, v);
    }
    r = acc;
}

__global__ void final_exp_kernel(const long long* __restrict__ in,
                                 long long* __restrict__ out, int n) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Fq12 f, g, t;
    fq12_load(f, in + (size_t)e * 192);
    // easy part: g = conj(f) / f, then g^(p^2) * g
    fq12_inv(t, f);
    fq12_conj(g, f);
    fq12_mul(g, g, t);
    fq12_frob(t, g, 2);
    fq12_mul(g, t, g);
    // hard part: registers 0..3 = g, g^x, g^(x^2), g^(x^3); 4..11 scratch
    Fq12 regs[12];
    regs[0] = g;
    for (int k = 0; k < 3; k++) powx(regs[k + 1], regs[k]);
    for (int i = 0; i < BN_TAPE_LEN; i++) {
        const int dst = BN_TAPE[i][0], s1 = BN_TAPE[i][1], s2 = BN_TAPE[i][2];
        const int post = BN_TAPE[i][3];
        fq12_mul(t, regs[s1], regs[s2]);
        if (post == 1) fq12_conj(t, t);
        else if (post == 2) fq12_frob(t, t, 1);
        else if (post == 3) fq12_frob(t, t, 2);
        regs[dst] = t;
    }
    fq12_frob(t, g, 3);
    fq12_mul(t, regs[5], t);
    fq12_store(out + (size_t)e * 192, t);
}

// in, out: (n, 2, 3, 2, 16) int64 limbs.
extern "C" int sipp_final_exp(const void* in, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const int block = n < 32 ? n : 32;
    final_exp_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        (const long long*)in, (long long*)out, n);
    return (int)cudaGetLastError();
}
