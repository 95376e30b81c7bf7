// K2: the final exponentiation f^((p^12 - 1) / r) of a small stack of Fq12.
//
// Replaces sipp_tpu/ops/pallas_fexp.py:final_exp_fused: the easy part
// conj(f) * f^-1 (tower inversion down to one Fermat Fq inversion), times
// its p^2-Frobenius, then the hard part as three x-power chains and the
// reference's lambda tape over a 12-slot register file (pairing/ate.py
// TAPE), finished by frob3.  The final exponentiation is a function, so
// any correct chain gives the same bits.
//
// What bounds it on the H100: latency.  B is 1 for an aggregation and 2
// for a fold round's (Z_L, Z_R), and each element is one serial chain of
// ~245 Fq12-level operations (3 x 62 cyclotomic squarings, the x-powers'
// products, the 30 tape rows, the easy part) and one Fq inversion.  The
// design shortens each link of the chain and runs independent links at
// once:
//
// * one block of FEXP_WARPS warps per element.  An Fq12-level operation
//   runs on one warp: thread k computes the k-th independent Fq2 product
//   (18 for a multiply, 9 for a cyclotomic squaring, 6 for a Frobenius
//   map), then thread q < 6 forms output coefficient q from the products;
//   the products' inputs and the outputs' linear forms are the tables of
//   ops/schedule.py (schedule_params.cuh), which the CPU tests evaluate
//   against fields/tower.py; fq12_table.cuh's lin_op runs them (K8 runs
//   the same operations).  An operation costs one Fq2 product (one Fq
//   product where it is split, below) and one combine pass, where one
//   thread made 54 (36) Fq products in a row.
// * each x-power as the TPU kernel's _powx_ref computes it: the 62
//   squarings stored, then the 28 set-bit powers multiplied as a 5-level
//   tree (14, 7, 3, 2, 1 products), the products of a level on different
//   warps: 62 + 6 links instead of 62 + 27.
// * the easy part's inversion as five table operations (two Fq6
//   squarings, the Fq6 inversion's cofactors and norm, the two Fq6
//   products) around one Fq2 inversion on one thread, whose Fermat chain
//   (~380 dependent Fq products) is the kernel's serial floor.
// * a thread's products share its one carry flag, so two independent
//   products on one thread run one after the other, and an Fq2 product on
//   one thread costs three: an operation of up to 10 products (the squarings,
//   the inversion's steps) runs each as its three Karatsuba Fq products on
//   three lanes.
// * the state (12 registers, the 63 stored powers, each warp's 18
//   products and their parts, the tables) lives in static shared memory,
//   ~47 KB: lanes that read different rows of a table in constant memory
//   would wait for one another.  The Fq product is bn254.cuh's carry-chain
//   product, inline into the Fq2 product and into the split products.
// The lambda tape stays serial on warp 0, as it is written.
#include <cuda_runtime.h>

#include "fq12_table.cuh"

#define FEXP_WARPS 8

struct FexpShared {
    Fq12 regs[12];                        // 0 g, 1..3 g^(x^k), 4..11 tape scratch
    Fq12 chain[BN_X_NBITS];               // v^(2^j); the easy part's scratch
    Fq2 prods[FEXP_WARPS][SCHED_N_PROD];  // each warp's Fq2 products
    Fq parts[FEXP_WARPS][SPLIT_MAX][3];   // their Karatsuba parts, when split
    Tables tab;
};

static __device__ __forceinline__ Fq2* coeffs(Fq12& a) { return reinterpret_cast<Fq2*>(&a); }

// out = a^(p^k), k in {1, 2, 3}: coefficient q times FROB[k-1][q]
static __device__ __noinline__ void frob_op(Fq2* out, const Fq2* a, int k, int l) {
    if (l < 6) {
        Fq2 t = a[l], c;
        if (k & 1) fq2_conj(t, t);
#pragma unroll
        for (int w = 0; w < 8; w++) {
            c.c0.v[w] = BN_FROB[k - 1][l][0][w];
            c.c1.v[w] = BN_FROB[k - 1][l][1][w];
        }
        fq2_mul(out[l], t, c);
    }
    __syncwarp();
}

// out = conj(a) (the w half negated); out may alias a
static __device__ __forceinline__ void conj_op(Fq2* out, const Fq2* a, int l) {
    if (l < 6) {
        if (l < 3) out[l] = a[l];
        else fq2_neg(out[l], a[l]);
    }
    __syncwarp();
}

static __device__ __forceinline__ void copy_op(Fq2* out, const Fq2* a, int l) {
    if (l < 6) out[l] = a[l];
    __syncwarp();
}

// r = v^x (every thread of the block calls it)
static __device__ void powx(Fq2* r, const Fq2* v, FexpShared& sh, int warp, int l) {
    Fq2* prods = sh.prods[warp];
    Fq(*parts)[3] = sh.parts[warp];
    if (warp == 0) {
        copy_op(coeffs(sh.chain[0]), v, l);
        for (int j = 1; j < BN_X_NBITS; j++)
            lin_op(coeffs(sh.chain[j]), coeffs(sh.chain[j - 1]), coeffs(sh.chain[j - 1]),
                   OP_CYCLO, prods, parts, sh.tab, l);
    }
    __syncthreads();
    for (int level = 0; level < POWX_LEVELS; level++) {
        for (int m = warp; m < POWX_N[level]; m += FEXP_WARPS) {
            Fq2* d = coeffs(sh.chain[POWX_PAIRS[level][m][0]]);
            lin_op(d, d, coeffs(sh.chain[POWX_PAIRS[level][m][1]]), OP_MUL, prods, parts,
                   sh.tab, l);
        }
        __syncthreads();
    }
    if (warp == 0) copy_op(r, coeffs(sh.chain[POWX_OUT]), l);
    __syncthreads();
}

__global__ void __launch_bounds__(32 * FEXP_WARPS)
final_exp_kernel(const long long* __restrict__ in, long long* __restrict__ out) {
    __shared__ FexpShared sh;
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const size_t base = (size_t)blockIdx.x * 192;
    Fq2* prods = sh.prods[warp];
    Fq(*parts)[3] = sh.parts[warp];
    load_tables(sh.tab);
    __syncthreads();
#define R(k) coeffs(sh.regs[k])
#define OP(...) lin_op(__VA_ARGS__, prods, parts, sh.tab, l)
    if (warp == 0) {
        // easy part: g = conj(f) / f, then g^(p^2) * g; scratch in the chain
        Fq2* f = coeffs(sh.chain[0]);
        Fq2* t0 = coeffs(sh.chain[1]);          // f0^2 - v f1^2, then its cofactors
        Fq2* abc = t0 + 3;
        Fq2* nrm = t0 + 6;                      // the Fq2 norm and its inverse
        Fq2* t0inv = t0 + 8;
        Fq2* finv = coeffs(sh.chain[3]);
        Fq2* t = coeffs(sh.chain[4]);
        if (l < 6) fq2_load(f[l], in + base + 32 * l);
        __syncwarp();
        OP(t0, f, f, OP_INV_SQ);
        OP(abc, t0, t0, OP_INV6_ABC);
        OP(nrm, t0, abc, OP_INV6_NORM);
        if (l == 0) fq2_inv(nrm[1], nrm[0]);
        __syncwarp();
        OP(t0inv, abc, nrm + 1, OP_INV6_OUT);
        OP(finv, f, t0inv, OP_INV_OUT);
        conj_op(t, f, l);
        OP(R(0), t, finv, OP_MUL);
        frob_op(t, R(0), 2, l);
        OP(R(0), t, R(0), OP_MUL);
    }
    __syncthreads();
    // hard part: registers 0..3 = g, g^x, g^(x^2), g^(x^3); 4..11 scratch
    for (int k = 0; k < 3; k++) powx(R(k + 1), R(k), sh, warp, l);
    if (warp == 0) {
        for (int i = 0; i < BN_TAPE_LEN; i++) {
            const int dst = BN_TAPE[i][0], post = BN_TAPE[i][3];
            OP(R(dst), R(BN_TAPE[i][1]), R(BN_TAPE[i][2]), OP_MUL);
            if (post == 1) conj_op(R(dst), R(dst), l);
            else if (post >= 2) frob_op(R(dst), R(dst), post - 1, l);
        }
        Fq2* t = coeffs(sh.chain[0]);
        frob_op(t, R(0), 3, l);
        OP(t, R(5), t, OP_MUL);
        if (l < 6) fq2_store(out + base + 32 * l, t[l]);
    }
#undef OP
#undef R
}

// The launcher (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
// in, out: (n, 2, 3, 2, 16) int64 limbs.
extern "C" int sipp_final_exp(const void* in, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    final_exp_kernel<<<n, 32 * FEXP_WARPS, 0, (cudaStream_t)stream>>>(
        (const long long*)in, (long long*)out);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
