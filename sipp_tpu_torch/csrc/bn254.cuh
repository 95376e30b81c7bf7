// BN254 field and tower arithmetic for the port's CUDA kernels (the
// counterpart of the in-kernel field libraries ops/tmul.py and
// ops/tmul_lat.py of the JAX package: same values, not the same domains).
//
// Fq is 8 little-endian 32-bit words in Montgomery form with R = 2^256 (the
// same R as the 16 x 16-bit reference format, so Montgomery values are equal
// and only the packing differs).  Multiplication is CIOS with 64-bit partial
// products; every result is fully reduced (< p).  Fq2/Fq6/Fq12 follow the
// reference tower: u^2 = -1, v^3 = xi = 9 + u, w^2 = v.
//
// Two Fq products give the same values: this file's fq_mul (emulated 64-bit
// carries, __noinline__), used by K0 (fq.cu), K1 and K7 (miller.cu), K4/K5
// (transcript.cu) and K6/K8 (exp.cu); and fq_cc.cuh's fq_mul_cc (PTX carry
// chains, inline into its callers), used by K2 (fexp.cu) and K3 (fold.cu).
//
// The constants (p, n0' = -p^-1 mod 2^32, Montgomery one, p - 2, the NAF of
// 6x+2, the Frobenius tables, the lambda tape) come from the generated
// bn254_params.cuh, which ops/_build.py derives from params/hostref.
//
// Build time: fully inlined BN254 towers make nvcc run for many minutes, so
// the Fq2 multiply and everything at the Fq6/Fq12 level are __noinline__;
// only the short Fq add/sub/select helpers inline.
#pragma once
#include <cstdint>

#include "bn254_params.cuh"

typedef uint32_t u32;
typedef uint64_t u64;

struct Fq { u32 v[8]; };
struct Fq2 { Fq c0, c1; };
struct Fq6 { Fq2 c[3]; };
struct Fq12 { Fq6 c[2]; };

#define DEV static __device__ __forceinline__
#define DEV_NOINLINE static __device__ __noinline__

__device__ __constant__ static const u32 kP[8] = {BN_P0, BN_P1, BN_P2, BN_P3,
                                                 BN_P4, BN_P5, BN_P6, BN_P7};

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

DEV void fq12_load(Fq12& a, const long long* src) {
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++) fq2_load(a.c[i].c[j], src + 32 * (3 * i + j));
}
DEV void fq12_store(long long* dst, const Fq12& a) {
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++) fq2_store(dst + 32 * (3 * i + j), a.c[i].c[j]);
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

// r = t - p if t >= p else t  (t < 2p)
DEV void fq_reduce_once(Fq& r, const u32 t[8]) {
    u32 d[8];
    u64 borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        u64 s = (u64)t[k] - kP[k] - borrow;
        d[k] = (u32)s;
        borrow = (s >> 32) & 1;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) r.v[k] = borrow ? t[k] : d[k];
}

DEV void fq_add(Fq& r, const Fq& a, const Fq& b) {
    u32 t[8];
    u64 c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        u64 s = (u64)a.v[k] + b.v[k] + c;
        t[k] = (u32)s;
        c = s >> 32;
    }
    fq_reduce_once(r, t);  // a + b < 2p < 2^255: no carry out of word 7
}

DEV void fq_sub(Fq& r, const Fq& a, const Fq& b) {
    u32 t[8];
    u64 borrow = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        u64 s = (u64)a.v[k] - b.v[k] - borrow;
        t[k] = (u32)s;
        borrow = (s >> 32) & 1;
    }
    u64 c = 0;
    u32 mask = borrow ? 0xFFFFFFFFu : 0u;  // add p back on borrow
#pragma unroll
    for (int k = 0; k < 8; k++) {
        u64 s = (u64)t[k] + (kP[k] & mask) + c;
        r.v[k] = (u32)s;
        c = s >> 32;
    }
}

DEV void fq_neg(Fq& r, const Fq& a) {
    Fq z;
    fq_zero(z);
    fq_sub(r, z, a);
}

DEV void fq_dbl(Fq& r, const Fq& a) { fq_add(r, a, a); }

// Montgomery product a * b * 2^-256 mod p (CIOS, 32-bit words).  r may
// alias a or b: it is written only at the end.
DEV_NOINLINE void fq_mul(Fq& r, const Fq& a, const Fq& b) {
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
        u32 m = t[0] * BN_N0;
        s = (u64)m * kP[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < 8; j++) {
            s = (u64)m * kP[j] + t[j] + c;
            t[j - 1] = (u32)s;
            c = s >> 32;
        }
        s = (u64)t[8] + c;
        t[7] = (u32)s;
        t[8] = t[9] + (u32)(s >> 32);
    }
    fq_reduce_once(r, t);  // p < 2^254: the CIOS result is < 2p
}

DEV void fq_sqr(Fq& r, const Fq& a) { fq_mul(r, a, a); }

// a^(p-2) by MSB-first square-and-multiply (0 maps to 0).
DEV_NOINLINE void fq_inv(Fq& r, const Fq& a) {
    Fq acc;
    fq_one(acc);
    for (int w = 7; w >= 0; w--) {
        u32 e = BN_PM2[w];
        for (int bit = 31; bit >= 0; bit--) {
            fq_sqr(acc, acc);
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

DEV_NOINLINE void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
    Fq v0, v1, s, t;
    fq_mul(v0, a.c0, b.c0);
    fq_mul(v1, a.c1, b.c1);
    fq_add(s, a.c0, a.c1);
    fq_add(t, b.c0, b.c1);
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
DEV_NOINLINE void fq2_mul_xi(Fq2& r, const Fq2& a) {
    Fq n0, n1;
    fq_dbl(n0, a.c0); fq_dbl(n0, n0); fq_dbl(n0, n0); fq_add(n0, n0, a.c0);
    fq_dbl(n1, a.c1); fq_dbl(n1, n1); fq_dbl(n1, n1); fq_add(n1, n1, a.c1);
    Fq r0;
    fq_sub(r0, n0, a.c1);
    fq_add(r.c1, n1, a.c0);
    r.c0 = r0;
}

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

// ------------------------------------------------------------------- Fq6

DEV_NOINLINE void fq6_add(Fq6& r, const Fq6& a, const Fq6& b) {
    for (int i = 0; i < 3; i++) fq2_add(r.c[i], a.c[i], b.c[i]);
}
DEV_NOINLINE void fq6_sub(Fq6& r, const Fq6& a, const Fq6& b) {
    for (int i = 0; i < 3; i++) fq2_sub(r.c[i], a.c[i], b.c[i]);
}

// Karatsuba/Toom over Fq2 (the reference's six products).
DEV_NOINLINE void fq6_mul(Fq6& r, const Fq6& a, const Fq6& b) {
    Fq2 v0, v1, v2, x, y, t12, t01, t02;
    fq2_mul(v0, a.c[0], b.c[0]);
    fq2_mul(v1, a.c[1], b.c[1]);
    fq2_mul(v2, a.c[2], b.c[2]);
    fq2_add(x, a.c[1], a.c[2]); fq2_add(y, b.c[1], b.c[2]); fq2_mul(t12, x, y);
    fq2_add(x, a.c[0], a.c[1]); fq2_add(y, b.c[0], b.c[1]); fq2_mul(t01, x, y);
    fq2_add(x, a.c[0], a.c[2]); fq2_add(y, b.c[0], b.c[2]); fq2_mul(t02, x, y);
    // c0 = v0 + xi (t12 - v1 - v2)
    fq2_add(x, v1, v2); fq2_sub(x, t12, x); fq2_mul_xi(x, x); fq2_add(r.c[0], v0, x);
    // c1 = t01 - v0 - v1 + xi v2
    fq2_add(x, v0, v1); fq2_sub(x, t01, x); fq2_mul_xi(y, v2); fq2_add(r.c[1], x, y);
    // c2 = t02 - v0 - v2 + v1
    fq2_add(x, v0, v2); fq2_sub(x, t02, x); fq2_add(r.c[2], x, v1);
}

// v (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
DEV_NOINLINE void fq6_mul_by_v(Fq6& r, const Fq6& a) {
    Fq2 t;
    fq2_mul_xi(t, a.c[2]);
    r.c[2] = a.c[1];
    r.c[1] = a.c[0];
    r.c[0] = t;
}

// ------------------------------------------------------------------ Fq12

DEV void fq12_one(Fq12& a) {
    fq2_one(a.c[0].c[0]);
    fq2_zero(a.c[0].c[1]); fq2_zero(a.c[0].c[2]);
    for (int j = 0; j < 3; j++) fq2_zero(a.c[1].c[j]);
}

DEV_NOINLINE void fq12_mul(Fq12& r, const Fq12& a, const Fq12& b) {
    Fq6 v0, v1, x, y;
    fq6_mul(v0, a.c[0], b.c[0]);
    fq6_mul(v1, a.c[1], b.c[1]);
    fq6_add(x, a.c[0], a.c[1]);
    fq6_add(y, b.c[0], b.c[1]);
    fq6_mul(x, x, y);
    fq6_add(y, v0, v1);
    fq6_sub(r.c[1], x, y);
    fq6_mul_by_v(v1, v1);
    fq6_add(r.c[0], v0, v1);
}

// complex squaring: t = c0 c1, u = (c0 + c1)(c0 + v c1);
// c0' = u - t - v t, c1' = 2t
DEV_NOINLINE void fq12_sqr(Fq12& r, const Fq12& a) {
    Fq6 t, u, x, y;
    fq6_mul(t, a.c[0], a.c[1]);
    fq6_add(x, a.c[0], a.c[1]);
    fq6_mul_by_v(y, a.c[1]);
    fq6_add(y, a.c[0], y);
    fq6_mul(u, x, y);
    fq6_mul_by_v(x, t);
    fq6_add(x, t, x);
    fq6_sub(r.c[0], u, x);
    fq6_add(r.c[1], t, t);
}

