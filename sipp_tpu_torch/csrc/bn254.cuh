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
DEV_NOINLINE void fq6_neg(Fq6& r, const Fq6& a) {
    for (int i = 0; i < 3; i++) fq2_neg(r.c[i], a.c[i]);
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

DEV_NOINLINE void fq6_inv(Fq6& r, const Fq6& a) {
    Fq2 A, B, C, t, u;
    fq2_sqr(A, a.c[0]); fq2_mul(t, a.c[1], a.c[2]); fq2_mul_xi(t, t); fq2_sub(A, A, t);
    fq2_sqr(B, a.c[2]); fq2_mul_xi(B, B); fq2_mul(t, a.c[0], a.c[1]); fq2_sub(B, B, t);
    fq2_sqr(C, a.c[1]); fq2_mul(t, a.c[0], a.c[2]); fq2_sub(C, C, t);
    // t = a0 A + xi (a2 B + a1 C)
    fq2_mul(t, a.c[2], B); fq2_mul(u, a.c[1], C); fq2_add(t, t, u); fq2_mul_xi(t, t);
    fq2_mul(u, a.c[0], A); fq2_add(t, t, u);
    fq2_inv(t, t);
    fq2_mul(r.c[0], A, t);
    fq2_mul(r.c[1], B, t);
    fq2_mul(r.c[2], C, t);
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

DEV_NOINLINE void fq12_conj(Fq12& r, const Fq12& a) {
    r.c[0] = a.c[0];
    fq6_neg(r.c[1], a.c[1]);
}

DEV_NOINLINE void fq12_inv(Fq12& r, const Fq12& a) {
    Fq6 t0, t1;
    fq6_mul(t0, a.c[0], a.c[0]);
    fq6_mul(t1, a.c[1], a.c[1]);
    fq6_mul_by_v(t1, t1);
    fq6_sub(t0, t0, t1);
    fq6_inv(t0, t0);
    fq6_mul(r.c[0], a.c[0], t0);
    fq6_mul(t1, a.c[1], t0);
    fq6_neg(r.c[1], t1);
}

// a^(p^k), k in {1, 2, 3}: coefficient (w^i v^j) -> sigma^k(a_ij) FROB[k-1][3i+j]
DEV_NOINLINE void fq12_frob(Fq12& r, const Fq12& a, int k) {
    for (int i = 0; i < 2; i++)
        for (int j = 0; j < 3; j++) {
            Fq2 t = a.c[i].c[j], c;
            if (k & 1) fq2_conj(t, t);
            for (int w = 0; w < 8; w++) {
                c.c0.v[w] = BN_FROB[k - 1][3 * i + j][0][w];
                c.c1.v[w] = BN_FROB[k - 1][3 * i + j][1][w];
            }
            fq2_mul(r.c[i].c[j], t, c);
        }
}

// Granger-Scott squaring; valid on the cyclotomic subgroup (every value of
// the hard part of the final exponentiation).
DEV_NOINLINE void fq12_cyclo_sqr(Fq12& r, const Fq12& g) {
    const Fq2 &z0 = g.c[0].c[0], &z4 = g.c[0].c[1], &z3 = g.c[0].c[2];
    const Fq2 &z2 = g.c[1].c[0], &z1 = g.c[1].c[1], &z5 = g.c[1].c[2];
    Fq2 a2, b2, ab, t0, t1, u0, u1, s0, s1, x;
    // (z0, z1), (z2, z3), (z4, z5): t = a^2 + xi b^2, u = 2ab
    fq2_sqr(a2, z0); fq2_sqr(b2, z1); fq2_mul(ab, z0, z1);
    fq2_mul_xi(x, b2); fq2_add(t0, a2, x); fq2_dbl(t1, ab);
    fq2_sqr(a2, z2); fq2_sqr(b2, z3); fq2_mul(ab, z2, z3);
    fq2_mul_xi(x, b2); fq2_add(u0, a2, x); fq2_dbl(u1, ab);
    fq2_sqr(a2, z4); fq2_sqr(b2, z5); fq2_mul(ab, z4, z5);
    fq2_mul_xi(x, b2); fq2_add(s0, a2, x); fq2_dbl(s1, ab);
    fq2_mul_xi(s1, s1);
    Fq12 o;
    // 3t - 2z (minus) or 3t + 2z (plus)
#define TRI(dst, t, z, plus) { Fq2 r3, d2; fq2_dbl(r3, t); fq2_add(r3, r3, t); \
        fq2_dbl(d2, z); if (plus) fq2_add(dst, r3, d2); else fq2_sub(dst, r3, d2); }
    TRI(o.c[0].c[0], t0, z0, false);
    TRI(o.c[0].c[1], u0, z4, false);
    TRI(o.c[0].c[2], s0, z3, false);
    TRI(o.c[1].c[0], s1, z2, true);
    TRI(o.c[1].c[1], t1, z1, true);
    TRI(o.c[1].c[2], u1, z5, true);
#undef TRI
    r = o;
}
