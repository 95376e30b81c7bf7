// The staged Jacobian doubling, mixed addition, complete mixed addition
// and complete Jacobian addition of the curve ladders K3 (fold.cu: lo + [x]
// hi, one shared scalar), K6 (exp.cu: off_i + [k_i] x_i, a scalar per
// lane), X1 (validate.cu: [x0]Q per lane and the endomorphism test after
// it, with the twist's Frobenius psi and the negation below) and of X2's
// chunks and tree (msm.cu: the sum of the lanes), over G1 (Fq) and G2
// (Fq2), one definition for every kernel.
//
// What bounds a ladder on the H100: latency.  A fold round has 64 to 1 live
// lanes and the MSM finals 128, so the grid fills a few SMs at most, and
// each lane is one chain of 254 doublings and up to 254 additions.  The
// stages cut the chain:
//
// * a group of FOLD_GROUP = 4 threads of one warp per lane, for G1 and G2,
//   FOLD_LANES = 8 lanes a warp (one block).  A doubling runs as 3 stages of
//   independent products, {X^2, Y^2, Y Z}, {B^2, (X + B)^2, M^2} with
//   M = 3 X^2, {M (S - X3)}; a mixed addition as 5, {Z^2, y2 Z},
//   {x2 ZZ, y2 Z ZZ}, {H^2, R^2, Z H}, {H HH, X HH}, {R (V - X3), Y HHH}.
//   Each product of a stage runs on its own thread of the group, so a
//   ladder step is 3 + 5 product latencies instead of 11 + 11 (G2: 21 + 33
//   Fq products).  G1 takes 4 threads too: with the card nearly empty, the
//   stage count is the kernel's time.
// * a thread's products share its one carry flag, so two independent
//   products on one thread run one after the other, and an Fq2 product on
//   one thread costs three Fq products.  For G2, where a stage has one
//   product (the doubling's last), threads 0..2 run its three Karatsuba
//   products, and where it has two (four of the addition's five), two
//   threads share each.  A warp runs divergent paths one after another, so
//   the adds before a stage's products are one instruction stream with
//   per-thread operands where they can be.
// * the accumulator and every product live in the lane's slots in shared
//   memory; a stage's threads read their operands there, the adds between
//   stages run on the thread that needs them (the commit of a step on thread
//   0), and __syncwarp orders the stages.  Every thread of the warp runs
//   every stage, and the selects (accumulator at infinity, the addend at
//   infinity, and `take`: K6's per-lane bit) are data, not branches, so the
//   warp never diverges around a barrier.
// * the affine conversion runs on thread 0 of the group: its Fermat
//   inversion, ~380 dependent Fq products, is a ladder's serial floor.
// * the complete addition (add_complete_staged: K6's offset, X1's ladder,
//   X2's chunks) is the staged addition, then the staged doubling of the
//   addend where the addition met P == Q; the doubling's stages run only
//   where a lane of the warp needs them (a vote), so a chain that never
//   meets P == Q (every honest one) pays the 5 stages of the addition.
//   X2's tree adds two Jacobian points (add_jacobian_staged), also in 5
//   stages, with the same vote for its doubling.
// ops/schedule.py (dbl_staged, add_mixed_staged, add_jacobian_staged) is
// the plain version of these stages, checked against curves' own by
// tests/test_torch_schedule.py; the complete additions are held against
// curves' add_mixed(p, q, dbl(q)) and add there, emulated.
#pragma once
#include "bn254.cuh"

#define FOLD_GROUP 4
#define FOLD_LANES 8            // lanes of one warp (one block)

struct G1Field {
    typedef Fq T;
    static const int LIMBS = 16;
    static __device__ void load(T& a, const long long* s) { fq_load(a, s); }
    static __device__ void store(long long* d, const T& a) { fq_store(d, a); }
    static __device__ __forceinline__ void mul(T& r, const T& a, const T& b) { fq_mul(r, a, b); }
    static __device__ void add(T& r, const T& a, const T& b) { fq_add(r, a, b); }
    static __device__ void sub(T& r, const T& a, const T& b) { fq_sub(r, a, b); }
    static __device__ void inv(T& r, const T& a) { fq_inv(r, a); }
    static __device__ bool is_zero(const T& a) { return fq_is_zero(a); }
    static __device__ void one(T& a) { fq_one(a); }
    static __device__ void zero(T& a) { fq_zero(a); }
    // one product on thread 0 (an Fq product is not split)
    static __device__ void mul_part(Fq* v, const T& a, const T& b, int part) {
        if (part == 0) fq_mul(v[0], a, b);
    }
    static __device__ void combine(T& r, const Fq* v) { r = v[0]; }
    // a stage's two products: product k on thread k
    static __device__ int pair_index(int sub) { return sub; }
    static __device__ void mul_pair(T* dst, const T& a, const T& b, Fq (*)[3], int sub) {
        if (sub < 2) fq_mul(dst[sub], a, b);
    }
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
    // Karatsuba product `part` (a0 b0, a1 b1, (a0 + a1)(b0 + b1)) of threads
    // 0..2, then one thread combines them
    static __device__ void mul_part(Fq* v, const T& a, const T& b, int part) {
        if (part > 2) return;
        Fq x = part == 1 ? a.c1 : a.c0, y = part == 1 ? b.c1 : b.c0;
        if (part == 2) {
            fq_add(x, x, a.c1);
            fq_add(y, y, b.c1);
        }
        fq_mul(v[part], x, y);
    }
    static __device__ void combine(T& r, const Fq* v) {
        Fq s;
        fq_add(s, v[0], v[1]);
        fq_sub(r.c0, v[0], v[1]);
        fq_sub(r.c1, v[2], s);
    }
    // a stage's two products: product k on threads 2k (parts 0 and 2) and
    // 2k + 1 (part 1), two Fq product times instead of three; thread 2k
    // combines
    static __device__ int pair_index(int sub) { return sub >> 1; }
    static __device__ void mul_pair(T* dst, const T& a, const T& b, Fq (*parts)[3], int sub) {
        const int k = sub >> 1, h = sub & 1;
        mul_part(parts[k], a, b, h);
        if (h == 0) mul_part(parts[k], a, b, 2);
        __syncwarp();
        if (h == 0) combine(dst[k], parts[k]);
    }
};

// one lane's state: the Jacobian accumulator, the ladder's addend (hx, hy:
// K3's hi, K6's x) and its offset (lx, ly: K3's lo, K6's off), both affine,
// the values of a step (s[k] as the comments of the stages name them), a
// zero, and the split products' parts
template <class F>
struct FoldLane {
    typename F::T X, Y, Z, hx, hy, lx, ly, s[13], zero;
    Fq part[2][3];
};

// Jacobian doubling, a = 0; infinity-safe (Z3 = 2YZ = 0).  The adds before
// a stage's products run as one instruction stream on every thread (the
// operands differ, the code does not), since a warp runs divergent paths
// one after another.  Stage 3 has one product: threads 0..2 split it.
// The result is committed only where `take` (read on thread 0) holds.
// s: 0 A = X^2, 1 B = Y^2, 2 YZ, 3 C = B^2, 4 D = (X + B)^2, 5 W = M^2,
// 6 M = 3A
template <class F>
static __device__ __noinline__ void dbl_staged(FoldLane<F>& L, int sub, bool take) {
    typedef typename F::T T;
    if (sub < 3)
        F::mul(L.s[sub], sub == 0 ? L.X : L.Y, sub == 0 ? L.X : sub == 1 ? L.Y : L.Z);
    __syncwarp();
    if (sub < 3) {
        // B + 0 + 0, X + B + 0, A + A + A
        T x;
        F::add(x, sub == 1 ? L.X : sub == 2 ? L.s[0] : L.zero, sub == 2 ? L.s[0] : L.s[1]);
        F::add(x, x, sub == 2 ? L.s[0] : L.zero);
        if (sub == 2) L.s[6] = x;
        F::mul(L.s[3 + sub], x, x);
    }
    __syncwarp();
    if (sub < 3) {
        // S = 2 (D - A - C) = 4 X Y^2, X3 = W - 2 S, then M (S - X3)
        T S, t, X3;
        F::sub(S, L.s[4], L.s[0]);
        F::sub(S, S, L.s[3]);
        F::add(S, S, S);
        F::add(t, S, S);
        F::sub(X3, L.s[5], t);
        F::sub(t, S, X3);
        F::mul_part(L.part[0], L.s[6], t, sub);
        if (sub == 0 && take) L.X = X3;
    }
    __syncwarp();
    if (sub == 0 && take) {
        // Y3 = M (S - X3) - 8 C, Z3 = 2 Y Z
        T t, c8;
        F::combine(t, L.part[0]);
        F::add(c8, L.s[3], L.s[3]);
        F::add(c8, c8, c8);
        F::add(c8, c8, c8);
        F::sub(L.Y, t, c8);
        F::add(L.Z, L.s[2], L.s[2]);
    }
    __syncwarp();
}

// acc += (qx, qy) affine, incomplete (no P == Q case: the fold and exp
// ladders never meet it); acc at infinity gives q, q all-zero (infinity)
// leaves acc, and so does a false `take` (read on thread 0).  H and R stay
// in s[11], s[12] for add_complete_staged.
// s: 0 ZZ, 1 T1 = qy Z, 2 U2 = qx ZZ, 3 S2 = T1 ZZ, 4 HH = H^2, 5 RR = R^2,
// 6 Z3 = Z H, 7 HHH = H HH, 8 V = X HH, 9 R (V - X3), 10 Y HHH,
// 11 H = U2 - X, 12 R = S2 - Y; X3 = RR - HHH - 2V
template <class F>
static __device__ __noinline__ void add_staged(FoldLane<F>& L, const typename F::T& qx,
                                               const typename F::T& qy, int sub, bool take) {
    typedef typename F::T T;
    const int k = F::pair_index(sub);       // the product of a two-product stage
    F::mul_pair(L.s, k ? qy : L.Z, L.Z, L.part, sub);
    __syncwarp();
    F::mul_pair(L.s + 2, k ? L.s[1] : qx, L.s[0], L.part, sub);
    __syncwarp();
    if (sub < 3) {
        // H (threads 0, 2) or R (thread 1)
        T x;
        F::sub(x, sub == 1 ? L.s[3] : L.s[2], sub == 1 ? L.Y : L.X);
        if (sub < 2) L.s[11 + sub] = x;
        F::mul(L.s[4 + sub], sub == 2 ? L.Z : x, x);
    }
    __syncwarp();
    F::mul_pair(L.s + 7, k ? L.X : L.s[11], L.s[4], L.part, sub);
    __syncwarp();
    T X3, t;
    F::sub(X3, L.s[5], L.s[7]);
    F::sub(X3, X3, L.s[8]);
    F::sub(X3, X3, L.s[8]);
    F::sub(t, L.s[8], X3);
    F::mul_pair(L.s + 9, k ? L.Y : L.s[12], k ? L.s[7] : t, L.part, sub);
    __syncwarp();
    if (sub == 0 && take && !(F::is_zero(qx) && F::is_zero(qy))) {
        if (F::is_zero(L.Z)) {
            L.X = qx;
            L.Y = qy;
            F::one(L.Z);
        } else {
            L.X = X3;
            F::sub(L.Y, L.s[9], L.s[10]);
            L.Z = L.s[6];
        }
    }
    __syncwarp();
}

// acc += (qx, qy) affine, complete (curves' add_mixed(acc, q, dbl(q))): the
// staged addition, then, on lanes where the accumulator and q are finite
// and H = R = 0 (P == Q), the staged doubling of q, committed there only;
// P == -Q gives Z3 = Z H = 0, infinity, by itself.  A false `take` commits
// nothing.  Every thread of a lane's group computes `same` from the lane's
// slots, and the doubling's 3 stages run only where a lane of the warp
// needs them (__any_sync, uniform over the warp, so no thread skips a
// __syncwarp that another one reaches).
template <class F>
static __device__ __noinline__ void add_complete_staged(FoldLane<F>& L, const typename F::T& qx,
                                                        const typename F::T& qy, int sub,
                                                        bool take) {
    const bool acc_finite = !F::is_zero(L.Z);
    add_staged<F>(L, qx, qy, sub, take);
    const bool same = take && acc_finite && !(F::is_zero(qx) && F::is_zero(qy))
                      && F::is_zero(L.s[11]) && F::is_zero(L.s[12]);
    if (__any_sync(0xffffffffu, same)) {
        if (sub == 0 && same) {
            L.X = qx;
            L.Y = qy;
            F::one(L.Z);
        }
        __syncwarp();
        dbl_staged<F>(L, sub, same);
    }
}

// acc += (qX, qY, qZ) Jacobian, complete (curves' add): 5 stages of
// independent products, {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1 = X1 Z2^2,
// U2 = X2 Z1^2, S1 = Y1 Z2 Z2^2, S2 = Y2 Z1 Z1^2}, {H^2, R^2, Z1 Z2},
// {H HH, U1 HH, Z1Z2 H}, {R (V - X3), S1 HHH}: the depth of the formulas
// (curves' six groups, with Z2^3 and Z1 Z2 moved up a stage), the same
// canonical values.  Then, on lanes where both are finite and H = R = 0
// (P == Q), the staged doubling of acc, committed there only (a vote, as
// add_complete_staged); P == -Q gives Z3 = Z1 Z2 H = 0 by itself.  q at
// infinity leaves acc, acc at infinity gives q, a false `take` commits
// nothing.  q may lie in another lane's slots (X2's tree: that lane's
// group only reads during the call), never in this lane's s[].
// s: 0 Z1Z1, 1 Z2Z2, 2 Y1 Z2, 3 Y2 Z1, 4 U1, 5 U2, 6 S1, 7 S2, 8 HH, 9 RR,
// 10 Z1Z2, 11 H, 12 R; then 0 HHH, 1 V, 2 Z3, 3 R (V - X3), 4 S1 HHH
template <class F>
static __device__ __noinline__ void add_jacobian_staged(FoldLane<F>& L, const typename F::T& qX,
                                                        const typename F::T& qY,
                                                        const typename F::T& qZ, int sub,
                                                        bool take) {
    typedef typename F::T T;
    const bool inf1 = F::is_zero(L.Z), inf2 = F::is_zero(qZ);
    F::mul(L.s[sub], sub == 0 ? L.Z : sub == 1 ? qZ : sub == 2 ? L.Y : qY,
           sub == 0 ? L.Z : sub == 1 ? qZ : sub == 2 ? qZ : L.Z);
    __syncwarp();
    F::mul(L.s[4 + sub], sub == 0 ? L.X : sub == 1 ? qX : L.s[sub], L.s[sub & 1 ? 0 : 1]);
    __syncwarp();
    if (sub < 3) {
        // H (threads 0, 2) or R (thread 1); HH, RR, Z1 Z2
        T x;
        F::sub(x, sub == 1 ? L.s[7] : L.s[5], sub == 1 ? L.s[6] : L.s[4]);
        if (sub < 2) L.s[11 + sub] = x;
        F::mul(L.s[8 + sub], sub == 2 ? L.Z : x, sub == 2 ? qZ : x);
    }
    __syncwarp();
    if (sub < 3)
        F::mul(L.s[sub], sub == 0 ? L.s[11] : sub == 1 ? L.s[4] : L.s[10],
               sub == 2 ? L.s[11] : L.s[8]);
    __syncwarp();
    T X3, t;
    F::sub(X3, L.s[9], L.s[0]);
    F::sub(X3, X3, L.s[1]);
    F::sub(X3, X3, L.s[1]);
    F::sub(t, L.s[1], X3);
    const int k = F::pair_index(sub);
    F::mul_pair(L.s + 3, k ? L.s[6] : L.s[12], k ? L.s[0] : t, L.part, sub);
    __syncwarp();
    const bool same = take && !inf1 && !inf2 && F::is_zero(L.s[11]) && F::is_zero(L.s[12]);
    if (sub == 0 && take && !inf2 && !same) {
        if (inf1) {
            L.X = qX;
            L.Y = qY;
            L.Z = qZ;
        } else {
            L.X = X3;
            F::sub(L.Y, L.s[3], L.s[4]);
            L.Z = L.s[2];
        }
    }
    __syncwarp();
    if (__any_sync(0xffffffffu, same)) dbl_staged<F>(L, sub, same);
}

// The twist's Frobenius endomorphism psi on Jacobian coordinates (G2):
// (X : Y : Z) -> (conj(X) gx, conj(Y) gy, conj(Z)), gx and gy hostref's
// TWIST_FROB_X and TWIST_FROB_Y (BN_TWF), so that x = X / Z^2 maps to
// conj(x) gx as on affine points; Z = 0 (infinity) stays 0.  One stage:
// the two Fq2 products split as mul_pair splits them (parts 0 and 2 on
// threads 0 and 2, part 1 on threads 1 and 3), Z's conjugate on thread 0.
// The output may be the input: every thread reads its operands before the
// barrier, and threads 0 and 2 write after it.
static __device__ __noinline__ void psi_staged(FoldLane<G2Field>& L, Fq2& oX, Fq2& oY, Fq2& oZ,
                                               const Fq2& X, const Fq2& Y, const Fq2& Z,
                                               int sub) {
    const int k = sub >> 1, h = sub & 1;
    Fq2 a, g, z;
    fq2_conj(a, k ? Y : X);
    fq2_conj(z, Z);
    for (int w = 0; w < 8; w++) {
        g.c0.v[w] = BN_TWF[k][0][w];
        g.c1.v[w] = BN_TWF[k][1][w];
    }
    G2Field::mul_part(L.part[k], a, g, h);
    if (h == 0) G2Field::mul_part(L.part[k], a, g, 2);
    __syncwarp();
    if (h == 0) G2Field::combine(k ? oY : oX, L.part[k]);
    if (sub == 0) oZ = z;
    __syncwarp();
}

// acc = -acc: Y negated on thread 0, Z untouched (infinity stays there)
template <class F>
static __device__ void neg_staged(FoldLane<F>& L, int sub) {
    if (sub == 0) F::sub(L.Y, L.zero, L.Y);
    __syncwarp();
}

// Jacobian -> affine (x, y) of the accumulator, infinity -> (0, 0), stored
// at dst; one thread
template <class F>
static __device__ void store_affine(long long* dst, const FoldLane<F>& L) {
    typedef typename F::T T;
    T x, y;
    if (F::is_zero(L.Z)) {
        F::zero(x); F::zero(y);
    } else {
        T zinv, zinv2;
        F::inv(zinv, L.Z);
        F::mul(zinv2, zinv, zinv);
        F::mul(x, L.X, zinv2);
        F::mul(zinv2, zinv2, zinv);
        F::mul(y, L.Y, zinv2);
    }
    F::store(dst, x);
    F::store(dst + F::LIMBS, y);
}
