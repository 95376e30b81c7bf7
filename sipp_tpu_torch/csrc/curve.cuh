// Jacobian curve arithmetic for the curve kernel K6 (exp.cu),
// templated on the coordinate field: G1 over Fq, G2 over Fq2.  Short
// Weierstrass with a = 0; a Jacobian point (X, Y, Z) is at infinity iff
// Z = 0, an affine point iff it is all-zero (the reference's encoding).
#pragma once
#include "bn254.cuh"

struct G1Field {
    typedef Fq T;
    static const int LIMBS = 16;
    static __device__ void load(T& a, const long long* s) { fq_load(a, s); }
    static __device__ void store(long long* d, const T& a) { fq_store(d, a); }
    static __device__ void mul(T& r, const T& a, const T& b) { fq_mul(r, a, b); }
    static __device__ void add(T& r, const T& a, const T& b) { fq_add(r, a, b); }
    static __device__ void sub(T& r, const T& a, const T& b) { fq_sub(r, a, b); }
    static __device__ void inv(T& r, const T& a) { fq_inv(r, a); }
    static __device__ bool is_zero(const T& a) { return fq_is_zero(a); }
    static __device__ void one(T& a) { fq_one(a); }
    static __device__ void zero(T& a) { fq_zero(a); }
};

struct G2Field {
    typedef Fq2 T;
    static const int LIMBS = 32;
    static __device__ void load(T& a, const long long* s) { fq2_load(a, s); }
    static __device__ void store(long long* d, const T& a) { fq2_store(d, a); }
    static __device__ void mul(T& r, const T& a, const T& b) { fq2_mul(r, a, b); }
    static __device__ void add(T& r, const T& a, const T& b) { fq2_add(r, a, b); }
    static __device__ void sub(T& r, const T& a, const T& b) { fq2_sub(r, a, b); }
    static __device__ void inv(T& r, const T& a) { fq2_inv(r, a); }
    static __device__ bool is_zero(const T& a) { return fq2_is_zero(a); }
    static __device__ void one(T& a) { fq2_one(a); }
    static __device__ void zero(T& a) { fq2_zero(a); }
};

template <class F>
struct Jac { typename F::T X, Y, Z; };

// Jacobian doubling, a = 0; infinity-safe (Z3 = 2YZ = 0)
template <class F>
static __device__ __noinline__ void jac_dbl(Jac<F>& p) {
    typename F::T A, B, YZ, C, D, S, M, X3, Y3, x;
    F::mul(A, p.X, p.X); F::mul(B, p.Y, p.Y); F::mul(YZ, p.Y, p.Z);
    F::add(x, p.X, B);
    F::mul(C, B, B); F::mul(D, x, x);
    F::sub(S, D, A); F::sub(S, S, C); F::add(S, S, S);     // 4 X Y^2
    F::add(M, A, A); F::add(M, M, A);                      // 3 X^2
    F::mul(X3, M, M); F::add(x, S, S); F::sub(X3, X3, x);
    F::sub(x, S, X3); F::mul(Y3, M, x);
    F::add(x, C, C); F::add(x, x, x); F::add(x, x, x); F::sub(Y3, Y3, x);
    F::add(p.Z, YZ, YZ);
    p.X = X3;
    p.Y = Y3;
}

// p += (x2, y2) affine, incomplete (no P == Q case: the ladder never meets
// it); p at infinity gives q, q all-zero (infinity) leaves p.
template <class F>
static __device__ __noinline__ void jac_add_mixed(Jac<F>& p, const typename F::T& x2,
                                                  const typename F::T& y2) {
    if (F::is_zero(x2) && F::is_zero(y2)) return;
    if (F::is_zero(p.Z)) {
        p.X = x2; p.Y = y2; F::one(p.Z);
        return;
    }
    typename F::T ZZ, U2, S2, H, R, HH, RR, HHH, V, Z3, X3, Y3, x;
    F::mul(ZZ, p.Z, p.Z);
    F::mul(U2, x2, ZZ);
    F::mul(S2, y2, p.Z); F::mul(S2, S2, ZZ);
    F::sub(H, U2, p.X);
    F::sub(R, S2, p.Y);
    F::mul(HH, H, H); F::mul(RR, R, R);
    F::mul(HHH, H, HH); F::mul(V, p.X, HH); F::mul(Z3, p.Z, H);
    F::sub(X3, RR, HHH); F::add(x, V, V); F::sub(X3, X3, x);
    F::sub(x, V, X3); F::mul(Y3, R, x); F::mul(x, p.Y, HHH); F::sub(Y3, Y3, x);
    p.X = X3; p.Y = Y3; p.Z = Z3;
}

// p += (x2, y2) affine, complete: also the P == Q case (then 2Q) and both
// infinities.  The offset add of K6 can meet P == Q (offset == [k]x is legal
// input); the ladders never do, so they keep the cheaper jac_add_mixed.
template <class F>
static __device__ __noinline__ void jac_add_mixed_complete(Jac<F>& p, const typename F::T& x2,
                                                           const typename F::T& y2) {
    if (F::is_zero(x2) && F::is_zero(y2)) return;
    if (!F::is_zero(p.Z)) {
        typename F::T ZZ, U2, S2;
        F::mul(ZZ, p.Z, p.Z);
        F::mul(U2, x2, ZZ);
        F::mul(S2, y2, p.Z); F::mul(S2, S2, ZZ);
        F::sub(U2, U2, p.X);
        F::sub(S2, S2, p.Y);
        if (F::is_zero(U2) && F::is_zero(S2)) {   // H = R = 0: P == Q
            p.X = x2; p.Y = y2; F::one(p.Z);
            jac_dbl<F>(p);
            return;
        }
    }
    jac_add_mixed<F>(p, x2, y2);
}

// Jacobian -> affine (x, y); infinity -> (0, 0)
template <class F>
static __device__ __forceinline__ void jac_to_affine(typename F::T& x, typename F::T& y,
                                                     const Jac<F>& p) {
    typename F::T zinv, zinv2;
    if (F::is_zero(p.Z)) {
        F::zero(x); F::zero(y);
    } else {
        F::inv(zinv, p.Z);
        F::mul(zinv2, zinv, zinv);
        F::mul(x, p.X, zinv2);
        F::mul(zinv2, zinv2, zinv);
        F::mul(y, p.Y, zinv2);
    }
}
