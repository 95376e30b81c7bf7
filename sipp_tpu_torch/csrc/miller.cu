// K1: the Miller product  prod_i miller(P_i, Q_i)  over a block of lanes;
// K7 (below it): one step of the Miller loop, sharing K1's device functions.
//
// Replaces sipp_tpu/ops/pallas_miller.py:miller_product_fused (kernel body
// _full_kernel): the whole optimal-ate Miller loop over the NAF of 6x+2, the
// two Frobenius correction lines, infinity masking, and the Fq12 product
// over the lanes.  pair = 1 stops the product at stride 2, so lane 0 of a
// block holds the product of its even lanes and lane 1 that of its odd lanes
// (a fold round's Z_L and Z_R, interleaved by the caller).
//
// Design: one thread per pairing lane, B lanes per block (B a power of two,
// at most 128; the wrapper pads with infinity lanes and launches
// ceil(n / 128) blocks, each writing its partial product).  The NAF digit
// is shared by every lane, so the branch on it is uniform.  The lines are
// the reference's denominator-cleared ones (pairing/ate.py:_dbl_step and
// _add_step): another line scaling would give another pre-final-exp value.
// The lane product is a tree in shared memory: at each level the upper half
// of the live threads park their Fq12 (384 B each) and the lower half
// multiplies it in; field products are exact, so the order is free.
//
// What bounds it on the H100: this is a long serial chain of 256-bit
// multiplies per lane, bound by integer multiply throughput and by register
// pressure (f, T, Q, P and the tower temporaries exceed 255 registers and
// spill to local memory).  At n = 128 one block runs on one of 132 SMs.
// Spreading a lane over several threads, or lanes over more blocks, is the
// first work for a later change.
#include <cuda_runtime.h>

#include "bn254.cuh"   // with bn254_params.cuh: MILLER_MAX_BLOCK = ops/miller.py:BLOCK

struct Jac2 { Fq2 X, Y, Z; };
struct Line { Fq2 a, b, c; };   // a + b w + c v w

// f * (a + b w + c v w): 15 Fq2 products (the reference's fq12_mul_line)
static __device__ __noinline__ void fq12_mul_line(Fq12& f, const Line& l) {
    const Fq2 &f00 = f.c[0].c[0], &f01 = f.c[0].c[1], &f02 = f.c[0].c[2];
    const Fq2 &f10 = f.c[1].c[0], &f11 = f.c[1].c[1], &f12 = f.c[1].c[2];
    Fq2 s0, s1, s2, ab, v[15];
    fq2_add(s0, f00, f10); fq2_add(s1, f01, f11); fq2_add(s2, f02, f12);
    fq2_add(ab, l.a, l.b);
    fq2_mul(v[0], f00, l.a); fq2_mul(v[1], f01, l.a); fq2_mul(v[2], f02, l.a);
    fq2_mul(v[3], f10, l.b); fq2_mul(v[4], f11, l.b); fq2_mul(v[5], f12, l.b);
    fq2_mul(v[6], f10, l.c); fq2_mul(v[7], f11, l.c); fq2_mul(v[8], f12, l.c);
    fq2_mul(v[9], s0, ab); fq2_mul(v[10], s1, ab); fq2_mul(v[11], s2, ab);
    fq2_mul(v[12], s0, l.c); fq2_mul(v[13], s1, l.c); fq2_mul(v[14], s2, l.c);
    Fq2 r0, r1, r2, t0, t1, t2, x;
    fq2_mul_xi(x, v[8]); fq2_add(r0, v[3], x);          // f1 * (b + c v)
    fq2_add(r1, v[4], v[6]);
    fq2_add(r2, v[5], v[7]);
    fq2_mul_xi(x, v[14]); fq2_add(t0, v[9], x);         // (f0+f1)(a+b + c v)
    fq2_add(t1, v[10], v[12]);
    fq2_add(t2, v[11], v[13]);
    fq2_mul_xi(x, r2); fq2_add(f.c[0].c[0], v[0], x);   // c0 = f0 a + v r
    fq2_add(f.c[0].c[1], v[1], r0);
    fq2_add(f.c[0].c[2], v[2], r1);
    fq2_add(x, v[0], r0); fq2_sub(f.c[1].c[0], t0, x);  // c1 = t - f0 a - r
    fq2_add(x, v[1], r1); fq2_sub(f.c[1].c[1], t1, x);
    fq2_add(x, v[2], r2); fq2_sub(f.c[1].c[2], t2, x);
}

// T <- 2T, with the line  2YZ^3 yp - 3X^2Z^2 xp w + (3X^3 - 2Y^2) v w
static __device__ __noinline__ void dbl_step(Jac2& t, Line& l, const Fq& xp, const Fq& yp) {
    Fq2 A, B, ZZ, YZ, C, D, T1, T2, T3, x, S, M;
    fq2_sqr(A, t.X); fq2_sqr(B, t.Y); fq2_sqr(ZZ, t.Z); fq2_mul(YZ, t.Y, t.Z);
    fq2_add(x, t.X, B);
    fq2_sqr(C, B); fq2_sqr(D, x); fq2_mul(T1, YZ, ZZ); fq2_mul(T2, A, ZZ); fq2_mul(T3, t.X, A);
    fq2_sub(S, D, A); fq2_sub(S, S, C); fq2_dbl(S, S);          // 4 X Y^2
    fq2_dbl(M, A); fq2_add(M, M, A);                            // 3 X^2
    Fq2 X3, Y3;
    fq2_sqr(X3, M); fq2_dbl(x, S); fq2_sub(X3, X3, x);
    fq2_sub(x, S, X3); fq2_mul(Y3, M, x);
    fq2_dbl(x, C); fq2_dbl(x, x); fq2_dbl(x, x); fq2_sub(Y3, Y3, x);
    fq2_dbl(t.Z, YZ);
    t.X = X3;
    t.Y = Y3;
    fq2_dbl(x, T1); fq2_scale(l.a, x, yp);
    fq2_dbl(x, T2); fq2_add(x, x, T2); fq2_scale(x, x, xp); fq2_neg(l.b, x);
    fq2_dbl(x, T3); fq2_add(x, x, T3); fq2_dbl(l.c, B); fq2_sub(l.c, x, l.c);
}

// T <- T + Q (Q affine), with the line  Z3 yp - theta xp w + (theta x2 - Z3 y2) v w
static __device__ __noinline__ void add_step(Jac2& t, Line& l, const Fq2& x2, const Fq2& y2,
                                             const Fq& xp, const Fq& yp) {
    Fq2 ZZ, ZZZ, U2, S2, H, R, HH, RR, HHH, V, Z3, X3, Y3, x;
    fq2_sqr(ZZ, t.Z);
    fq2_mul(ZZZ, ZZ, t.Z); fq2_mul(U2, x2, ZZ);
    fq2_mul(S2, y2, ZZZ);
    fq2_sub(H, U2, t.X);
    fq2_sub(R, S2, t.Y);
    fq2_sqr(HH, H); fq2_sqr(RR, R);
    fq2_mul(HHH, H, HH); fq2_mul(V, t.X, HH); fq2_mul(Z3, t.Z, H);
    fq2_sub(X3, RR, HHH); fq2_dbl(x, V); fq2_sub(X3, X3, x);
    fq2_sub(x, V, X3); fq2_mul(Y3, R, x); fq2_mul(x, t.Y, HHH); fq2_sub(Y3, Y3, x);
    fq2_mul(l.c, R, x2); fq2_mul(x, Z3, y2); fq2_sub(l.c, l.c, x);
    fq2_scale(l.a, Z3, yp);
    fq2_scale(x, R, xp); fq2_neg(l.b, x);
    t.X = X3; t.Y = Y3; t.Z = Z3;
}

// G2 Frobenius on twist affine coordinates: (conj(x) cx, conj(y) cy)
static __device__ void twist_frob(Fq2& xo, Fq2& yo, const Fq2& x, const Fq2& y) {
    Fq2 cx, cy, t;
    for (int w = 0; w < 8; w++) {
        cx.c0.v[w] = BN_TWF[0][0][w]; cx.c1.v[w] = BN_TWF[0][1][w];
        cy.c0.v[w] = BN_TWF[1][0][w]; cy.c1.v[w] = BN_TWF[1][1][w];
    }
    fq2_conj(t, x); fq2_mul(xo, t, cx);
    fq2_conj(t, y); fq2_mul(yo, t, cy);
}

static __device__ __noinline__ void miller_lane(Fq12& f, const Fq& xp, const Fq& yp,
                                                const Fq2& qx, const Fq2& qy) {
    Fq2 nqy;
    fq2_neg(nqy, qy);
    Jac2 t;
    t.X = qx; t.Y = qy; fq2_one(t.Z);
    fq12_one(f);
    Line l;
    for (int i = 0; i < BN_NAF_LEN; i++) {
        fq12_sqr(f, f);
        dbl_step(t, l, xp, yp);
        fq12_mul_line(f, l);
        int d = BN_NAF[i];
        if (d != 0) {
            add_step(t, l, qx, d == 1 ? qy : nqy, xp, yp);
            fq12_mul_line(f, l);
        }
    }
    Fq2 q1x, q1y, q2x, q2y;
    twist_frob(q1x, q1y, qx, qy);
    twist_frob(q2x, q2y, q1x, q1y);
    fq2_neg(q2y, q2y);
    add_step(t, l, q1x, q1y, xp, yp);
    fq12_mul_line(f, l);
    add_step(t, l, q2x, q2y, xp, yp);
    fq12_mul_line(f, l);
}

__global__ void __launch_bounds__(MILLER_MAX_BLOCK)
miller_product_kernel(const long long* __restrict__ p, const long long* __restrict__ q,
                      long long* __restrict__ out, int pair) {
    __shared__ Fq12 park[MILLER_MAX_BLOCK / 2];
    const int tid = threadIdx.x;
    const int lane = blockIdx.x * blockDim.x + tid;
    Fq xp, yp;
    Fq2 qx, qy;
    fq_load(xp, p + 32 * lane);
    fq_load(yp, p + 32 * lane + 16);
    fq2_load(qx, q + 64 * lane);
    fq2_load(qy, q + 64 * lane + 32);
    Fq12 f;
    miller_lane(f, xp, yp, qx, qy);
    // e(O, Q) = e(P, O) = 1
    bool inf_p = fq_is_zero(xp) && fq_is_zero(yp);
    bool inf_q = fq2_is_zero(qx) && fq2_is_zero(qy);
    if (inf_p || inf_q) fq12_one(f);

    const int stop = pair ? 2 : 1;
    for (int s = blockDim.x / 2; s >= stop; s /= 2) {
        if (tid >= s && tid < 2 * s) park[tid - s] = f;
        __syncthreads();
        if (tid < s) fq12_mul(f, f, park[tid]);
        __syncthreads();
    }
    const int k = pair ? 2 : 1;
    if (tid < k && tid < blockDim.x)
        fq12_store(out + (size_t)(blockIdx.x * k + tid) * 192, f);
}

// K7: ONE Miller step for n lanes (replaces sipp_tpu/ops/pallas_miller.py:
// miller_step, kernel _step_kernel): f <- f^2 * line_dbl(T, P), T <- 2T,
// then, when the shared NAF digit is not 0, f <- f * line_add(T, +-Q, P),
// T <- T +- Q (digit 1 adds qp, digit 2 adds qn = -Q).  The steps of K1's
// loop, one launch per digit: the JAX package's SIPP_WHOLE_LOOP=0 engine.
//
// Design: one thread per lane, STEP_BLOCK lanes per block, so 128 lanes
// fill four SMs; the digit comes by value (a launch needs no host read) and
// is uniform over the grid.  The carry stays in the port's (n, ...) layout
// in device memory between launches, canonical.  What bounds it on the
// H100: the same per-lane latency chain as K1 (38 dependent Fq2 products a
// step, 66 with the add), plus the carry's 2,304 bytes of int64 limbs read
// and written per lane, and a launch per digit.
#define STEP_BLOCK 32

__global__ void __launch_bounds__(STEP_BLOCK)
miller_step_kernel(int digit, const long long* __restrict__ qp,
                   const long long* __restrict__ qn, const long long* __restrict__ p,
                   const long long* __restrict__ f_in, const long long* __restrict__ t_in,
                   long long* __restrict__ f_out, long long* __restrict__ t_out, int n) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    Fq xp, yp;
    fq_load(xp, p + 32 * lane);
    fq_load(yp, p + 32 * lane + 16);
    Fq12 f;
    fq12_load(f, f_in + (size_t)lane * 192);
    Jac2 t;
    fq2_load(t.X, t_in + (size_t)lane * 96);
    fq2_load(t.Y, t_in + (size_t)lane * 96 + 32);
    fq2_load(t.Z, t_in + (size_t)lane * 96 + 64);
    Line l;
    fq12_sqr(f, f);
    dbl_step(t, l, xp, yp);
    fq12_mul_line(f, l);
    if (digit != 0) {
        const long long* q = (digit == 1 ? qp : qn) + 64 * lane;
        Fq2 qx, qy;
        fq2_load(qx, q);
        fq2_load(qy, q + 32);
        add_step(t, l, qx, qy, xp, yp);
        fq12_mul_line(f, l);
    }
    fq12_store(f_out + (size_t)lane * 192, f);
    fq2_store(t_out + (size_t)lane * 96, t.X);
    fq2_store(t_out + (size_t)lane * 96 + 32, t.Y);
    fq2_store(t_out + (size_t)lane * 96 + 64, t.Z);
}

// digit in {0, 1, 2}; qp, qn: (n, 2, 2, 16) Q and -Q; p: (n, 2, 16);
// f_in, f_out: (n, 2, 3, 2, 16); t_in, t_out: (n, 3, 2, 16) Jacobian; all
// int64 limbs, outputs distinct from inputs.
extern "C" int sipp_miller_step(int digit, const void* qp, const void* qn, const void* p,
                                const void* f_in, const void* t_in, void* f_out, void* t_out,
                                int n, void* stream) {
    if (n <= 0 || digit < 0 || digit > 2) return (int)cudaErrorInvalidValue;
    miller_step_kernel<<<(n + STEP_BLOCK - 1) / STEP_BLOCK, STEP_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        digit, (const long long*)qp, (const long long*)qn, (const long long*)p,
        (const long long*)f_in, (const long long*)t_in, (long long*)f_out,
        (long long*)t_out, n);
    return (int)cudaGetLastError();
}

// p: (n, 2, 16), q: (n, 2, 2, 16) int64 limbs; block: lanes per block, a
// power of two up to MILLER_MAX_BLOCK that divides n (the wrapper chooses
// it); out: (n / block, pair ? 2 : 1, 2, 3, 2, 16).
extern "C" int sipp_miller_product(const void* p, const void* q, void* out, int n,
                                   int block, int pair, void* stream) {
    if (n <= 0 || block <= 0 || block > MILLER_MAX_BLOCK || n % block != 0
            || (block & (block - 1)) != 0 || (pair && block < 2))
        return (int)cudaErrorInvalidValue;
    miller_product_kernel<<<n / block, block, 0, (cudaStream_t)stream>>>(
        (const long long*)p, (const long long*)q, (long long*)out, pair);
    return (int)cudaGetLastError();
}

extern "C" const char* sipp_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
