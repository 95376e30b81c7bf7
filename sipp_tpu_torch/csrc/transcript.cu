// K4 and K5: the on-chip prover's Fiat-Shamir transcript tail.
//
// Replaces sipp_tpu/ops/pallas_transcript.py:transcript_round_tail (K4: both
// appends of a fold round, the challenge from the digest with the
// to_u32_digits quirk, reduced mod r, and x^-1 by Fermat in Fr) and
// transcript_append_fq12 (K5: one hash-chain append of an Fq12, the initial
// Z).  The kernels also do the Fq12 -> 96-element message encode that the
// JAX package leaves in XLA (direct basis, from Montgomery, u32 digits), so a
// launch takes the Fq12 values as the card holds them.
//
// The formats at the boundary are the JAX package's: the state is (4, 5)
// int64 16-bit Montgomery limbs with R = 2^80; x and x^-1 are (16,) canonical
// Fr limbs.  Inside, a Goldilocks element is a canonical u64 and products
// reduce with 2^64 = 2^32 - 1 (mod p); every operation returns a canonical
// value, so the results equal the plain versions' limbs whatever the
// grouping.
//
// What bounds it on the H100: latency.  An append is 13 Poseidon
// permutations in a chain (30 rounds each; a round's S-box and 12 x 12 MDS
// products depend on the round before), the challenge one more, and the Fr
// inversion about 253 squarings and 130 products of 8-word Montgomery
// multiplies in a chain, while the work itself (some 150k 32-bit multiplies a
// round tail) would take the card microseconds if it were parallel.
// Design: one block of one warp.  Thread i holds state word i and computes
// its S-box and its MDS row out of shared memory (the round constants and the
// MDS matrix are copied there first: constant memory serialises a warp that
// reads 12 different addresses); thread k < 12 encodes direct coefficient k
// of an Fq12; thread 0 runs the digest -> Fr step and the Fermat chain.  The
// constants (Goldilocks, Poseidon tables, r and its N') come from the
// generated transcript_params.cuh (ops/_build.py).
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "transcript_params.cuh"

#define TR_THREADS 32
#define MSG_LEN 96                 // elements of one Fq12 message
#define APPEND_LEN (4 + MSG_LEN)   // the chain state, then the message

// ------------------------------------------------------------ Goldilocks

DEV u64 gl_canon(u64 x) { return x >= GL_P ? x - GL_P : x; }

DEV u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += GL_EPS;        // 2^64 = EPS (mod p); cannot carry again
    return gl_canon(s);
}

// lo + 2^64 hi mod p, with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)
DEV u64 gl_reduce128(u64 lo, u64 hi) {
    const u64 hh = hi >> 32, hl = hi & GL_EPS;
    u64 t0 = lo - hh;
    if (lo < hh) t0 -= GL_EPS;     // borrow: add p = 2^64 - EPS
    const u64 t1 = hl * GL_EPS;
    u64 t2 = t0 + t1;
    if (t2 < t0) t2 += GL_EPS;
    return gl_canon(t2);
}

DEV u64 gl_mul(u64 a, u64 b) { return gl_reduce128(a * b, __umul64hi(a, b)); }

DEV u64 gl_sbox(u64 x) {
    const u64 x2 = gl_mul(x, x), x4 = gl_mul(x2, x2);
    return gl_mul(gl_mul(x4, x2), x);
}

// ------------------------------------------------------ Poseidon chain

struct TrShared {
    u64 rc[PSD_ROUNDS][PSD_W];
    u32 mds[PSD_W][PSD_W];
    u64 st[PSD_W];                 // the sponge
    u64 chain[4];                  // the transcript state
    u64 msg[2][MSG_LEN];
};

DEV void permute(TrShared& s, int t) {
    for (int r = 0; r < PSD_ROUNDS; r++) {
        u64 x = 0;
        if (t < PSD_W) {
            x = gl_add(s.st[t], s.rc[r][t]);
            if (t == 0 || r < PSD_N_FULL || r >= PSD_N_FULL + PSD_N_PARTIAL) x = gl_sbox(x);
        }
        __syncthreads();
        if (t < PSD_W) s.st[t] = x;
        __syncthreads();
        if (t < PSD_W) {           // row t of the MDS product, 128-bit sum
            u64 lo = 0, hi = 0;
            for (int j = 0; j < PSD_W; j++) {
                const u64 m = s.mds[t][j], v = s.st[j], p = m * v;
                hi += __umul64hi(m, v);
                lo += p;
                hi += lo < p;
            }
            x = gl_reduce128(lo, hi);
        }
        __syncthreads();
        if (t < PSD_W) s.st[t] = x;
        __syncthreads();
    }
}

// chain = hash_no_pad(chain || msg): overwrite-absorb in rate-sized chunks
DEV void append(TrShared& s, const u64* msg, int t) {
    if (t < PSD_W) s.st[t] = 0;
    __syncthreads();
    for (int i = 0; i < APPEND_LEN; i += PSD_RATE) {
        const int k = i + t;
        if (t < PSD_RATE && k < APPEND_LEN) s.st[t] = k < 4 ? s.chain[k] : msg[k - 4];
        __syncthreads();
        permute(s, t);
    }
    if (t < 4) s.chain[t] = s.st[t];
    __syncthreads();
}

// f: (2, 3, 2, 16) Montgomery limbs -> msg: direct coefficient k, canonical,
// as 8 u32 digits.  k = 2j + i < 6 is c0 - 9 c1 of tower coefficient w^i v^j,
// k = 6 + 2j + i its c1 (the MyFq12 order of the host transcript).
DEV void fq12_message(const long long* f, u64* msg, int t) {
    if (t >= 12) return;
    const int m = t % 6;
    const long long* c = f + 32 * (3 * (m % 2) + m / 2);
    Fq c0, c1, d, one;
    fq_load(c0, c);
    fq_load(c1, c + 16);
    if (t < 6) {
        fq_add(d, c1, c1); fq_add(d, d, d); fq_add(d, d, d); fq_add(d, d, c1);  // 9 c1
        fq_sub(d, c0, d);
    } else {
        d = c1;
    }
    fq_zero(one);
    one.v[0] = 1;
    fq_mul(d, d, one);             // from Montgomery
    for (int w = 0; w < 8; w++) msg[8 * t + w] = d.v[w];
}

// ------------------------------------------------------------ challenge

struct Fr { u32 v[8]; };

__device__ __constant__ static const u32 kR[8] = {FR_P0, FR_P1, FR_P2, FR_P3,
                                                 FR_P4, FR_P5, FR_P6, FR_P7};

// The canonical digest -> the 8 u32 words of the quirk-exact integer: Rust's
// BigUint::to_u32_digits drops each element's leading zero digits, so an
// element contributes 2, 1 (high word zero) or 0 (zero) digits, and the
// later elements' digits move down.
static __device__ void digest_to_challenge(const u64 d[4], u32 out[8]) {
    for (int k = 0; k < 8; k++) out[k] = 0;
    int off = 0;
    for (int k = 0; k < 4; k++) {
        const u32 lo = (u32)d[k], hi = (u32)(d[k] >> 32);
        const int len = hi ? 2 : (lo ? 1 : 0);
        if (len >= 1) out[off] = lo;
        if (len == 2) out[off + 1] = hi;
        off += len;
    }
}

// Montgomery product a b 2^-256 mod r (CIOS, as fq_mul).  a may be any value
// below 2^256 (the digest integer) when b < r: the result is then < 2r
// before the one conditional subtraction, so it is canonical.
static __device__ __noinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
    u32 t[10];
    #pragma unroll
    for (int k = 0; k < 10; k++) t[k] = 0;
    #pragma unroll
    for (int i = 0; i < 8; i++) {
        u64 c = 0;
        #pragma unroll
        for (int j = 0; j < 8; j++) {
            u64 s = (u64)a.v[j] * b.v[i] + t[j] + c;
            t[j] = (u32)s;
            c = s >> 32;
        }
        u64 s = (u64)t[8] + c;
        t[8] = (u32)s;
        t[9] = (u32)(s >> 32);
        const u32 m = t[0] * FR_N0;
        s = (u64)m * kR[0] + t[0];
        c = s >> 32;
        #pragma unroll
        for (int j = 1; j < 8; j++) {
            s = (u64)m * kR[j] + t[j] + c;
            t[j - 1] = (u32)s;
            c = s >> 32;
        }
        s = (u64)t[8] + c;
        t[7] = (u32)s;
        t[8] = t[9] + (u32)(s >> 32);
    }
    u32 d[8];
    u64 borrow = 0;
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        const u64 s = (u64)t[k] - kR[k] - borrow;
        d[k] = (u32)s;
        borrow = (s >> 32) & 1;
    }
    #pragma unroll
    for (int k = 0; k < 8; k++) r.v[k] = borrow ? t[k] : d[k];
}

DEV void fr_store(long long* dst, const Fr& a) {
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        dst[2 * k] = a.v[k] & 0xFFFFu;
        dst[2 * k + 1] = a.v[k] >> 16;
    }
}

// digest (canonical) -> x and x^-1 as canonical Fr limbs
DEV void challenge(const u64 d[4], long long* x_out, long long* xinv_out) {
    u32 w[8];
    digest_to_challenge(d, w);
    Fr v, r2, raw1, xm, x, acc;
    for (int k = 0; k < 8; k++) {
        v.v[k] = w[k];
        r2.v[k] = FR_R2[k];
        raw1.v[k] = k == 0;
        acc.v[k] = FR_ONE[k];
    }
    fr_mul(xm, v, r2);             // to Montgomery: reduces the integer mod r
    fr_mul(x, xm, raw1);
    // Fermat: x^-1 = xm^(r - 2) in Montgomery form, MSB first from acc = one
    for (int k = 7; k >= 0; k--)
        for (int bit = 31; bit >= 0; bit--) {
            fr_mul(acc, acc, acc);
            if ((FR_RM2[k] >> bit) & 1) fr_mul(acc, acc, xm);
        }
    fr_mul(acc, acc, raw1);
    fr_store(x_out, x);
    fr_store(xinv_out, acc);
}

// ---------------------------------------------------------------- kernels

// f2 == nullptr: K5, one append.  Otherwise K4: append f1 and f2, then the
// challenge and its inverse.
__global__ void __launch_bounds__(TR_THREADS)
transcript_kernel(const long long* __restrict__ state, const long long* __restrict__ f1,
                  const long long* __restrict__ f2, long long* __restrict__ state_out,
                  long long* __restrict__ x_out, long long* __restrict__ xinv_out) {
    __shared__ TrShared s;
    const int t = threadIdx.x;
    for (int k = t; k < PSD_ROUNDS * PSD_W; k += TR_THREADS) s.rc[k / PSD_W][k % PSD_W] = PSD_RC[k];
    for (int k = t; k < PSD_W * PSD_W; k += TR_THREADS) s.mds[k / PSD_W][k % PSD_W] = PSD_MDS[k];
    if (t < 4) {
        const long long* l = state + 5 * t;
        const u64 mont = (u64)l[0] | ((u64)l[1] << 16) | ((u64)l[2] << 32) | ((u64)l[3] << 48);
        s.chain[t] = gl_mul(mont, GL_RINV);    // from Montgomery (R = 2^80)
    }
    fq12_message(f1, s.msg[0], t);
    if (f2) fq12_message(f2, s.msg[1], t);
    __syncthreads();
    append(s, s.msg[0], t);
    if (f2) {
        append(s, s.msg[1], t);
        // digest = hash_no_pad(chain): one permutation of (chain, 0, ..., 0)
        if (t < PSD_W) s.st[t] = t < 4 ? s.chain[t] : 0;
        __syncthreads();
        permute(s, t);
        if (t == 0) {
            const u64 d[4] = {s.st[0], s.st[1], s.st[2], s.st[3]};
            challenge(d, x_out, xinv_out);
        }
    }
    if (t < 4) {
        const u64 m = gl_mul(s.chain[t], GL_R80);  // to Montgomery
        for (int k = 0; k < 4; k++) state_out[5 * t + k] = (m >> (16 * k)) & 0xFFFF;
        state_out[5 * t + 4] = 0;
    }
}

// one thread per digest: (n, 4, 5) canonical limbs -> (n, 16) limbs
__global__ void digest_kernel(const long long* __restrict__ canon, long long* __restrict__ out,
                              int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 d[4];
    for (int k = 0; k < 4; k++) {
        const long long* l = canon + 20 * i + 5 * k;
        d[k] = (u64)l[0] | ((u64)l[1] << 16) | ((u64)l[2] << 32) | ((u64)l[3] << 48);
    }
    u32 w[8];
    digest_to_challenge(d, w);
    for (int k = 0; k < 8; k++) {
        out[16 * i + 2 * k] = w[k] & 0xFFFFu;
        out[16 * i + 2 * k + 1] = w[k] >> 16;
    }
}

// state, state_out: (4, 5); f: (2, 3, 2, 16) int64 limbs.
extern "C" int sipp_transcript_append_fq12(const void* state, const void* f, void* state_out,
                                           void* stream) {
    transcript_kernel<<<1, TR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)state, (const long long*)f, nullptr, (long long*)state_out,
        nullptr, nullptr);
    return (int)cudaGetLastError();
}

// ... and zl, zr: (2, 3, 2, 16); x, xinv: (16,).
extern "C" int sipp_transcript_round_tail(const void* state, const void* zl, const void* zr,
                                          void* state_out, void* x, void* xinv, void* stream) {
    transcript_kernel<<<1, TR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)state, (const long long*)zl, (const long long*)zr,
        (long long*)state_out, (long long*)x, (long long*)xinv);
    return (int)cudaGetLastError();
}

// The digest -> challenge step alone, for the tests of its rare cases.
extern "C" int sipp_digest_to_challenge(const void* canon, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    digest_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const long long*)canon, (long long*)out, n);
    return (int)cudaGetLastError();
}
