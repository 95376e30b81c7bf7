// BN254 field and tower arithmetic for the port's CUDA kernels (the
// counterpart of the in-kernel field libraries ops/tmul.py and
// ops/tmul_lat.py of the JAX package: same values, not the same domains).
// Every kernel (K0-K8) uses it; each Fq operation has one definition here.
//
// Fq is 8 little-endian 32-bit words in Montgomery form with R = 2^256 (the
// same R as the 16 x 16-bit reference format, so Montgomery values are equal
// and only the packing differs).  Every result is fully reduced (< p).
// Fq2/Fq6/Fq12 (the layouts) follow the reference tower: u^2 = -1, v^3 = xi = 9 + u,
// w^2 = v.
//
// The Fq product is CIOS on PTX carry chains (mad.lo.cc / madc.hi.cc /
// addc.cc).  Each row a * b_i and m * p is split into its even words (a0,
// a2, a4, a6: lo at 2k, hi at 2k + 1) and its odd words (a1, a3, a5, a7),
// which never overlap inside a row, so a row is two independent chains of 8
// instructions.  The two accumulators swap roles every word: the shift by
// one word of the Montgomery step is a change of which array holds the even
// positions; the merge of the shifted-out word rides on the next row's
// chain.  A thread has one carry flag, so the two chains run one after the
// other; the gain over emulated 64-bit carries is in the instruction count
// (chip_smoke.py's probe measures the cycles of a dependent fq_mul).  Add and
// subtract run on the same chains.
//
// The carry flag lives between separate asm statements: each one is
// volatile, so the compiler keeps their order, and nothing between them
// writes the flag.  Compiled for the host (no __CUDA_ARCH__), the same
// functions run on an emulated flag, which lets a host program check this
// header against integer arithmetic without a card
// (tests/host_emulation/).
//
// The constants (p, n0' = -p^-1 mod 2^32, Montgomery one, p - 2, the NAF of
// 6x+2, the Frobenius tables, the lambda tape) come from the generated
// bn254_params.cuh, which ops/_build.py derives from params/hostref.
//
// Build time: fully inlined BN254 towers make nvcc run for many minutes.
// fq_mul and the Fq add/sub/select helpers are inline, so their operands
// stay in registers inside the Fq2 product (three independent products)
// and in the kernels' split products; the Fq2 product and the inversions
// are __noinline__.  Fq6/Fq12 arithmetic is not here: the kernels spread
// each Fq12 operation over a warp as tables (fq12_table.cuh, miller.cu).
#pragma once
#include <cstdint>

#include "bn254_params.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

// 16-byte aligned, so that a copy of an element in shared memory moves 128
// bits an instruction (the table-driven kernels copy slots all the time)
struct __align__(16) Fq { u32 v[8]; };
struct Fq2 { Fq c0, c1; };
struct Fq6 { Fq2 c[3]; };
struct Fq12 { Fq6 c[2]; };

#define DEV static __device__ __forceinline__
#define DEV_NOINLINE static __device__ __noinline__


// ------------------------------------------------------------- load/store
// Tensors hold 16-bit limbs in int64 (the reference format); words pack two.

DEV void fq_load(Fq& a, const long long* src) {
#pragma unroll
    for (int k = 0; k < 8; k++)
        a.v[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
}

DEV void fq_store(long long* dst, const Fq& a) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
        dst[2 * k] = a.v[k] & 0xFFFFu;
        dst[2 * k + 1] = a.v[k] >> 16;
    }
}

DEV void fq2_load(Fq2& a, const long long* src) { fq_load(a.c0, src); fq_load(a.c1, src + 16); }
DEV void fq2_store(long long* dst, const Fq2& a) { fq_store(dst, a.c0); fq_store(dst + 16, a.c1); }

// A table of constant memory copied to shared memory by the whole block
// (the table-driven kernels K1, K2, K7 and K8: the lanes of an operation
// read different rows, which constant memory serves one address at a
// time).  A table of whole 32-bit words whose two copies start on a word
// goes a word a thread (the generated tables that are whole words are
// 16-byte aligned, and so are the members they fill), any other a byte a
// thread.  K7 copies K1's 8,868 bytes of tables every launch, where a byte
// a thread was a large share of a step.
template <class T>
static __device__ __forceinline__ void copy_table(T& dst, const T& src) {
    if (sizeof(T) % 4 == 0 && (((uintptr_t)&dst | (uintptr_t)&src) & 3) == 0) {
#pragma unroll 4
        for (int i = threadIdx.x; i < (int)sizeof(T) / 4; i += blockDim.x)
            reinterpret_cast<u32*>(&dst)[i] = reinterpret_cast<const u32*>(&src)[i];
    } else {
        for (int i = threadIdx.x; i < (int)sizeof(T); i += blockDim.x)
            reinterpret_cast<char*>(&dst)[i] = reinterpret_cast<const char*>(&src)[i];
    }
}

// -------------------------------------------------------------------- Fq

DEV void fq_zero(Fq& a) {
#pragma unroll
    for (int k = 0; k < 8; k++) a.v[k] = 0;
}

DEV void fq_one(Fq& a) {
    const u32 one[8] = {BN_ONE0, BN_ONE1, BN_ONE2, BN_ONE3,
                        BN_ONE4, BN_ONE5, BN_ONE6, BN_ONE7};
#pragma unroll
    for (int k = 0; k < 8; k++) a.v[k] = one[k];
}

DEV bool fq_is_zero(const Fq& a) {
    u32 acc = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) acc |= a.v[k];
    return acc == 0;
}

// ------------------------------------------------------ carry primitives

#ifdef __CUDA_ARCH__
#define CC3(name, ins)                                                            \
    DEV u32 name(u32 a, u32 b, u32 c) {                                           \
        u32 r;                                                                    \
        asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));  \
        return r;                                                                 \
    }
#define CC2(name, ins)                                                            \
    DEV u32 name(u32 a, u32 b) {                                                  \
        u32 r;                                                                    \
        asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));              \
        return r;                                                                 \
    }
CC3(mad_lo_cc, "mad.lo.cc.u32")
CC3(madc_lo_cc, "madc.lo.cc.u32")
CC3(madc_hi_cc, "madc.hi.cc.u32")
CC3(madc_hi, "madc.hi.u32")
CC2(add_cc, "add.cc.u32")
CC2(addc_cc, "addc.cc.u32")
CC2(addc, "addc.u32")
CC2(sub_cc, "sub.cc.u32")
CC2(subc_cc, "subc.cc.u32")
CC2(subc, "subc.u32")
DEV u32 mul_hi(u32 a, u32 b) { return __umulhi(a, b); }
#undef CC3
#undef CC2
#else
static thread_local u32 cc_flag;  // the host emulation's carry (or borrow) flag
static inline u32 cc_set(u64 s) { cc_flag = (u32)(s >> 32) & 1; return (u32)s; }
static inline u32 mad_lo_cc(u32 a, u32 b, u32 c) { return cc_set((u64)(a * b) + c); }
static inline u32 madc_lo_cc(u32 a, u32 b, u32 c) { return cc_set((u64)(a * b) + c + cc_flag); }
static inline u32 madc_hi_cc(u32 a, u32 b, u32 c) {
    return cc_set((((u64)a * b) >> 32) + c + cc_flag);
}
static inline u32 madc_hi(u32 a, u32 b, u32 c) { return (u32)(((u64)a * b) >> 32) + c + cc_flag; }
static inline u32 add_cc(u32 a, u32 b) { return cc_set((u64)a + b); }
static inline u32 addc_cc(u32 a, u32 b) { return cc_set((u64)a + b + cc_flag); }
static inline u32 addc(u32 a, u32 b) { return a + b + cc_flag; }
static inline u32 sub_cc(u32 a, u32 b) { return cc_set((u64)a - b); }
static inline u32 subc_cc(u32 a, u32 b) { return cc_set((u64)a - b - cc_flag); }
static inline u32 subc(u32 a, u32 b) { return a - b - cc_flag; }
static inline u32 mul_hi(u32 a, u32 b) { return (u32)(((u64)a * b) >> 32); }
#endif

// ---------------------------------------------------------------- rows
// A row reads the words a[0], a[2], a[4], a[6] (pass a + 1 for the odd
// words) and adds lo(a[j] b) at j, hi(a[j] b) at j + 1.

// acc = a * b (no carry in or out: the words do not overlap)
DEV void row_mul(u32 acc[8], const u32* a, u32 b) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        acc[j] = a[j] * b;
        acc[j + 1] = mul_hi(a[j], b);
    }
}

// acc += a * b, one chain; the carry out is left in the flag
DEV void row_mad(u32 acc[8], const u32* a, u32 b) {
    acc[0] = mad_lo_cc(a[0], b, acc[0]);
    acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
        acc[j] = madc_lo_cc(a[j], b, acc[j]);
        acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
    }
}

// acc = (acc >> 2 words) + a * b + flag, one chain, no carry out
DEV void row_mad_shift(u32 acc[8], const u32* a, u32 b) {
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
        acc[j] = madc_lo_cc(a[j], b, acc[j + 2]);
        acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 3]);
    }
    acc[6] = madc_lo_cc(a[6], b, 0);
    acc[7] = madc_hi(a[6], b, 0);
}

// One word of the Montgomery product.  On entry `even` holds the value's
// words at positions 0..7 and `odd` those at 1..8 (odd[k] at k + 1); on
// exit, after the division by 2^32, the roles have swapped: the caller
// passes them the other way round for the next word.
DEV void mont_word(u32 even[8], u32 odd[8], const u32 a[8], u32 bi, bool first) {
    const u32 p[8] = {BN_P0, BN_P1, BN_P2, BN_P3, BN_P4, BN_P5, BN_P6, BN_P7};
    if (first) {
        row_mul(odd, a + 1, bi);
        row_mul(even, a, bi);
    } else {
        even[0] = add_cc(even[0], odd[1]);   // the word shifted out last time
        row_mad_shift(odd, a + 1, bi);
        row_mad(even, a, bi);
        odd[7] = addc(odd[7], 0);
    }
    const u32 m = even[0] * BN_N0;
    row_mad(odd, p + 1, m);
    row_mad(even, p, m);                     // even[0] becomes 0
    odd[7] = addc(odd[7], 0);
}

// r = t - p if t >= p else t, for t < 2p
DEV void fq_reduce_once(u32 r[8], const u32 t[8]) {
    const u32 p[8] = {BN_P0, BN_P1, BN_P2, BN_P3, BN_P4, BN_P5, BN_P6, BN_P7};
    u32 d[8];
    d[0] = sub_cc(t[0], p[0]);
#pragma unroll
    for (int k = 1; k < 8; k++) d[k] = subc_cc(t[k], p[k]);
    const u32 borrow = subc(0, 0);           // all-ones iff t < p
#pragma unroll
    for (int k = 0; k < 8; k++) r[k] = (t[k] & borrow) | (d[k] & ~borrow);
}

// Montgomery product a * b * 2^-256 mod p; a, b < p.  r may alias a or b.
DEV void fq_mul(Fq& r, const Fq& a, const Fq& b) {
    u32 even[8], odd[8];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
        mont_word(even, odd, a.v, b.v[i], i == 0);
        mont_word(odd, even, a.v, b.v[i + 1], false);
    }
    // the value is even + (odd >> 1 word); it is < 2p
    even[0] = add_cc(even[0], odd[1]);
#pragma unroll
    for (int k = 1; k < 7; k++) even[k] = addc_cc(even[k], odd[k + 1]);
    even[7] = addc(even[7], 0);
    fq_reduce_once(r.v, even);
}

DEV void fq_add(Fq& r, const Fq& a, const Fq& b) {
    u32 t[8];
    t[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int k = 1; k < 8; k++) t[k] = addc_cc(a.v[k], b.v[k]);
    fq_reduce_once(r.v, t);                    // a + b < 2p < 2^255
}

DEV void fq_sub(Fq& r, const Fq& a, const Fq& b) {
    const u32 p[8] = {BN_P0, BN_P1, BN_P2, BN_P3, BN_P4, BN_P5, BN_P6, BN_P7};
    u32 t[8];
    t[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int k = 1; k < 8; k++) t[k] = subc_cc(a.v[k], b.v[k]);
    const u32 borrow = subc(0, 0);           // add p back on a borrow
    r.v[0] = add_cc(t[0], p[0] & borrow);
#pragma unroll
    for (int k = 1; k < 8; k++) r.v[k] = addc_cc(t[k], p[k] & borrow);
}

DEV void fq_neg(Fq& r, const Fq& a) {
    Fq z;
    fq_zero(z);
    fq_sub(r, z, a);
}

DEV void fq_dbl(Fq& r, const Fq& a) { fq_add(r, a, a); }
DEV void fq_sqr(Fq& r, const Fq& a) { fq_mul(r, a, a); }

// a^(p-2) (0 maps to 0): MSB-first square-and-multiply, both products inline
DEV_NOINLINE void fq_inv(Fq& r, const Fq& a) {
    Fq acc;
    fq_one(acc);
    for (int w = 7; w >= 0; w--) {
        const u32 e = BN_PM2[w];
        for (int bit = 31; bit >= 0; bit--) {
            fq_mul(acc, acc, acc);
            if ((e >> bit) & 1) fq_mul(acc, acc, a);
        }
    }
    r = acc;
}

// ------------------------------------------------------------------- Fq2

DEV void fq2_zero(Fq2& a) { fq_zero(a.c0); fq_zero(a.c1); }
DEV void fq2_one(Fq2& a) { fq_one(a.c0); fq_zero(a.c1); }
DEV bool fq2_is_zero(const Fq2& a) { return fq_is_zero(a.c0) && fq_is_zero(a.c1); }
DEV void fq2_add(Fq2& r, const Fq2& a, const Fq2& b) { fq_add(r.c0, a.c0, b.c0); fq_add(r.c1, a.c1, b.c1); }
DEV void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b) { fq_sub(r.c0, a.c0, b.c0); fq_sub(r.c1, a.c1, b.c1); }
DEV void fq2_neg(Fq2& r, const Fq2& a) { fq_neg(r.c0, a.c0); fq_neg(r.c1, a.c1); }
DEV void fq2_dbl(Fq2& r, const Fq2& a) { fq2_add(r, a, a); }
DEV void fq2_conj(Fq2& r, const Fq2& a) { r.c0 = a.c0; fq_neg(r.c1, a.c1); }

// Karatsuba: three independent Fq products, inline, so the scheduler can
// interleave their chains.  r may alias a or b.
DEV_NOINLINE void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
    Fq v0, v1, s, t;
    fq_add(s, a.c0, a.c1);
    fq_add(t, b.c0, b.c1);
    fq_mul(v0, a.c0, b.c0);
    fq_mul(v1, a.c1, b.c1);
    fq_mul(t, s, t);
    fq_sub(r.c0, v0, v1);
    fq_add(s, v0, v1);
    fq_sub(r.c1, t, s);
}

DEV void fq2_sqr(Fq2& r, const Fq2& a) { fq2_mul(r, a, a); }

DEV void fq2_scale(Fq2& r, const Fq2& a, const Fq& s) {
    fq_mul(r.c0, a.c0, s);
    fq_mul(r.c1, a.c1, s);
}

// (9 + u) a = (9 a0 - a1) + (9 a1 + a0) u
DEV void fq2_mul_xi(Fq2& r, const Fq2& a) {
    Fq n0, n1;
    fq_dbl(n0, a.c0); fq_dbl(n0, n0); fq_dbl(n0, n0); fq_add(n0, n0, a.c0);
    fq_dbl(n1, a.c1); fq_dbl(n1, n1); fq_dbl(n1, n1); fq_add(n1, n1, a.c1);
    Fq r0;
    fq_sub(r0, n0, a.c1);
    fq_add(r.c1, n1, a.c0);
    r.c0 = r0;
}

// through the norm: (a0 - a1 u) / (a0^2 + a1^2), one Fermat inversion
DEV_NOINLINE void fq2_inv(Fq2& r, const Fq2& a) {
    Fq n, t;
    fq_sqr(n, a.c0);
    fq_sqr(t, a.c1);
    fq_add(n, n, t);
    fq_inv(n, n);
    fq_mul(r.c0, a.c0, n);
    fq_mul(t, a.c1, n);
    fq_neg(r.c1, t);
}
