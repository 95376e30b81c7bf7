// K4 and K5: the on-chip prover's Fiat-Shamir transcript tail.
//
// Replaces sipp_tpu/ops/pallas_transcript.py:transcript_round_tail (K4: both
// appends of a fold round, the challenge from the digest with the
// to_u32_digits quirk, reduced mod r, and x^-1 in Fr) and
// transcript_append_fq12 (K5: one hash-chain append of an Fq12, the initial
// Z).  The kernels also do the Fq12 -> 96-element message encode that the
// JAX package leaves in XLA (direct basis, from Montgomery, u32 digits), so a
// launch takes the Fq12 values as the card holds them.
//
// The formats at the boundary are the JAX package's: the state is (4, 5)
// int64 16-bit Montgomery limbs with R = 2^80; x and x^-1 are (16,) canonical
// Fr limbs.  Inside, a Goldilocks element is a u64, canonical wherever it
// leaves a permutation (the chain, the digest), so the results equal the
// plain versions' limbs whatever the grouping.
//
// What bounds it on the H100: latency.  An append is 13 Poseidon
// permutations in a chain (30 rounds each; a round's S-box and 12 x 12 MDS
// products depend on the round before), the challenge one more, then the Fr
// inverse, while the work itself (some 0.7 M 32-bit multiplies a round
// tail) would take the card microseconds if it were parallel.  So the
// design shortens the chain:
//
// - Goldilocks products are four 32 x 32 -> 64-bit multiplies, reduced with
//   2^64 = 2^32 - 1 and 2^96 = -1 (mod p) on bn254.cuh's carry chains (a
//   borrow or a carry folds back as -/+ (2^32 - 1), with no branch); inside
//   the permutation a value is any u64 congruent to it (made canonical on
//   the way out), so no step spends a compare on it.  The S-box x^7 is
//   three dependent products (x^2, then x^3 and x^4 side by side).
// - The permutation lives in one warp's registers: lanes t and t + 16 hold
//   state word t < 12 and the 12 coefficients of MDS row t (all below 64),
//   loaded once a launch.  A round publishes the words' 32-bit halves in
//   shared memory (__syncwarp, two buffers); lanes 0-15 sum m * lo, lanes
//   16-31 m * hi (each below 2^42), the two swap sums by __shfl_xor_sync,
//   and one reduction ends the row; the next round's constant (shared
//   memory, a zero row after the last) is added inside it.  In the 22
//   partial rounds the S-box of word 0 and the sums over words 1-11 are
//   independent, so they overlap and only column 0 waits for the S-box
//   (broadcast by __shfl_sync).  No block barrier: the block is one warp.
// - x^-1 is a binary extended Euclid (Kaliski's almost-inverse: ~180
//   subtract-and-shift steps on 8-word values, variable time, which a public
//   challenge allows), then a Montgomery division by the 2^k it leaves; the
//   Fermat chain it replaces took ~380 Fr products.  x^-1 mod r is unique,
//   so the bits equal Fermat's; x = 0 gives 0.
//
// Thread k < 12 encodes direct coefficient k of an Fq12 (one Fq product out
// of Montgomery form); thread 0 runs the digest -> Fr step and the inverse.
// The constants (Goldilocks, Poseidon tables, r and its N') come from the
// generated transcript_params.cuh (ops/_build.py).
#include <cuda_runtime.h>

#include "bn254.cuh"
#include "transcript_params.cuh"

#define TR_THREADS 32
#define FULL_MASK 0xffffffffu
#define MSG_LEN 96                 // elements of one Fq12 message
#define APPEND_LEN (4 + MSG_LEN)   // the chain state, then the message

// ------------------------------------------------------------ Goldilocks
// Inside the permutation any u64 stands for its value mod p; gl_canon makes
// the canonical form where a value leaves it.  The products and reductions
// run on bn254.cuh's carry chains.

DEV u64 gl_canon(u64 x) { return x >= GL_P ? x - GL_P : x; }

// a + c mod p for canonical c
DEV u64 gl_add(u64 a, u64 c) {
    const u64 s = a + c;
    return s + (s < a ? GL_EPS : 0);   // a carry: 2^64 = EPS; cannot carry again
}

// (x0 + 2^32 x1) + 2^64 h mod p for h < 2^32: h 2^64 = h EPS
DEV u64 gl_reduce96(u32 x0, u32 x1, u32 h) {
    const u64 t = (u64)h * GL_EPS;
    x0 = add_cc(x0, (u32)t);
    x1 = addc_cc(x1, (u32)(t >> 32));
    const u32 carry = addc(0, 0);      // + 2^64 = + EPS; cannot carry again
    x0 = add_cc(x0, 0u - carry);
    x1 = addc(x1, 0);
    return (u64)x1 << 32 | x0;
}

// a b from four 32 x 32 -> 64-bit products, as words r0..r3, then
// r0 + 2^32 r1 - r3 + r2 EPS (2^96 = -1, 2^64 = EPS, mod p)
DEV u64 gl_mul(u64 a, u64 b) {
    const u32 a0 = (u32)a, a1 = (u32)(a >> 32), b0 = (u32)b, b1 = (u32)(b >> 32);
    u32 r0 = a0 * b0, r1 = mul_hi(a0, b0), r2 = a1 * b1, r3 = mul_hi(a1, b1);
    r1 = mad_lo_cc(a0, b1, r1);
    r2 = madc_hi_cc(a0, b1, r2);
    r3 = addc(r3, 0);
    r1 = mad_lo_cc(a1, b0, r1);
    r2 = madc_hi_cc(a1, b0, r2);
    r3 = addc(r3, 0);
    r0 = sub_cc(r0, r3);
    r1 = subc_cc(r1, 0);
    const u32 borrow = subc(0, 0);     // all ones on a borrow: + p = - EPS
    r0 = sub_cc(r0, borrow);
    r1 = subc(r1, 0);
    return gl_reduce96(r0, r1, r2);
}

DEV u64 gl_sbox(u64 x) {
    const u64 x2 = gl_mul(x, x);
    return gl_mul(gl_mul(x2, x), gl_mul(x2, x2));
}

// ------------------------------------------------------ Poseidon chain

// Lanes t and t + 16 both hold state word t & 15; lanes whose t & 15 is 12
// or more compute a copy of row 0 and are not read.
struct TrShared {
    u64 rc[PSD_ROUNDS + 1][PSD_W];   // the round constants, then a zero row
    u64 msg[2][MSG_LEN];
    // the rounds' exchange of the state words' 32-bit halves, [buffer][half]
    // [lane], two buffers: a lane may write round r + 1's while another
    // still reads round r's
    u32 xch[2][2][TR_THREADS];
};

// The row of the MDS matrix and of the round constants that lane t uses
DEV int tr_row(int t) { return (t & 15) < PSD_W ? t & 15 : 0; }

// The round constants into shared memory and lane t's MDS row into m.
DEV void tr_setup(TrShared& s, u32 m[PSD_W], int t) {
    for (int k = t; k < (PSD_ROUNDS + 1) * PSD_W; k += TR_THREADS)
        s.rc[k / PSD_W][k % PSD_W] = k < PSD_ROUNDS * PSD_W ? PSD_RC[k] : 0;
#pragma unroll
    for (int j = 0; j < PSD_W; j++) m[j] = PSD_MDS[PSD_W * tr_row(t) + j];
}

// One round: the S-box (of word 0 alone in a partial round), then row t & 15
// of the MDS product plus c, the next round's constant.  The words go
// through shared memory as 32-bit halves; lanes 0-15 sum m * lo, lanes
// 16-31 m * hi (below 2^42, two accumulators each), and the two swap their
// sums, so one reduction ends the row.  A partial round publishes its
// words before the S-box, so columns 1-11 are summed while lane 0 computes
// it (every lane does, to keep the warp on one path), and only column 0
// waits for it.
template <bool FULL>
DEV u64 tr_round(u64 x, const u32 m[PSD_W], u64 c, u32 (*xch)[TR_THREADS], int t) {
    const int half = t >> 4;
    u64 y = FULL ? gl_sbox(x) : x;
    xch[0][t] = (u32)y;
    xch[1][t] = (u32)(y >> 32);
    __syncwarp();
    if (!FULL) y = gl_sbox(x);
    const u32* v = xch[half];
    u64 a[2];
#pragma unroll
    for (int j = 1; j < PSD_W; j++) {
        const u64 pr = (u64)m[j] * v[j];
        a[j & 1] = j < 3 ? pr : a[j & 1] + pr;
    }
    const u64 own = a[0] + a[1] + (half ? c >> 32 : (u32)c);
    const u64 other = __shfl_xor_sync(FULL_MASK, own, 16);
    const u64 pre_lo = half ? other : own, pre_hi = half ? own : other;
    const u64 y0 = FULL ? (u64)xch[1][0] << 32 | xch[0][0] : __shfl_sync(FULL_MASK, y, 0);
    const u64 slo = (u64)m[0] * (u32)y0 + pre_lo, shi = (u64)m[0] * (u32)(y0 >> 32) + pre_hi;
    // slo + 2^32 shi as words w0, w1, w2 (w2 < 2^11)
    const u32 w1 = add_cc((u32)(slo >> 32), (u32)shi);
    const u32 w2 = addc((u32)(shi >> 32), 0);
    return gl_reduce96((u32)slo, w1, w2);
}

// One permutation of the state (word w in lanes w and w + 16), canonical on
// exit.  Every lane of the warp calls it; round r's constants are added
// inside round r - 1's reduction.
DEV u64 permute(u64 x, TrShared& s, const u32 m[PSD_W], int t) {
    const int w = tr_row(t);
    x = gl_add(x, s.rc[0][w]);
    int r = 0;
    for (; r < PSD_N_FULL; r++) x = tr_round<true>(x, m, s.rc[r + 1][w], s.xch[r & 1], t);
    for (; r < PSD_N_FULL + PSD_N_PARTIAL; r++)
        x = tr_round<false>(x, m, s.rc[r + 1][w], s.xch[r & 1], t);
    for (; r < PSD_ROUNDS; r++) x = tr_round<true>(x, m, s.rc[r + 1][w], s.xch[r & 1], t);
    return gl_canon(x);
}

// chain' = hash_no_pad(chain || msg): overwrite-absorb in rate-sized chunks
// into a zero sponge.  Words 0-3 hold the chain on entry and on exit.
DEV u64 append(u64 x, TrShared& s, const u64* msg, const u32 m[PSD_W], int t) {
    const int w = t & 15;
    if (w >= 4) x = 0;             // the first chunk's chain words are x itself
    for (int i = 0; i < APPEND_LEN; i += PSD_RATE) {
        const int k = i + w;
        if (w < PSD_RATE && k >= 4 && k < APPEND_LEN) x = msg[k - 4];
        x = permute(x, s, m, t);
    }
    return x;
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

// t = x + m r as 9 words: one word row of a Montgomery reduction (with
// m = -x r^-1 mod 2^b, the low b bits of t are zero)
DEV void fr_add_mr(u32 t[9], const u32 x[8], u32 m) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        const u64 s = (u64)m * kR[j] + x[j] + c;
        t[j] = (u32)s;
        c = s >> 32;
    }
    t[8] = (u32)c;
}

// Montgomery product a b 2^-256 mod r (CIOS, as fq_mul).  a may be any value
// below 2^256 (the digest integer) when b < r: the result is then < 2r
// before the one conditional subtraction, so it is canonical.
static __device__ __noinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
    u32 t[10], w[9];
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
        fr_add_mr(w, t, t[0] * FR_N0);
        #pragma unroll
        for (int j = 0; j < 7; j++) t[j] = w[j + 1];
        s = (u64)t[8] + w[8];
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

// ----------------------------------------------------------- Fr inverse
// 8-word helpers on the carry chains of bn254.cuh; all values stay below
// 2^255 (r < 2^254).

// d = a - b; returns all ones on a borrow (a < b)
DEV u32 w8_sub(u32 d[8], const u32 a[8], const u32 b[8]) {
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < 8; k++) d[k] = subc_cc(a[k], b[k]);
    return subc(0, 0);
}

DEV void w8_add(u32 a[8], const u32 b[8]) {
    a[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < 7; k++) a[k] = addc_cc(a[k], b[k]);
    a[7] = addc(a[7], b[7]);
}

DEV bool w8_is_zero(const u32 a[8]) {
    u32 acc = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) acc |= a[k];
    return acc == 0;
}

// x >>= its trailing zeros (x != 0); returns their count
DEV int w8_shr_ctz(u32 x[8]) {
    int n = 0;
    while (x[0] == 0) {            // 32 zero bits at once (rare)
#pragma unroll
        for (int k = 0; k < 7; k++) x[k] = x[k + 1];
        x[7] = 0;
        n += 32;
    }
    const int b = __ffs(x[0]) - 1;
    if (b) {
#pragma unroll
        for (int k = 0; k < 7; k++) x[k] = (x[k] >> b) | (x[k + 1] << (32 - b));
        x[7] >>= b;
    }
    return n + b;
}

DEV void w8_shl(u32 x[8], int n) {
    for (; n >= 32; n -= 32) {
#pragma unroll
        for (int k = 7; k > 0; k--) x[k] = x[k - 1];
        x[0] = 0;
    }
    if (n) {
#pragma unroll
        for (int k = 7; k > 0; k--) x[k] = (x[k] << n) | (x[k - 1] >> (32 - n));
        x[0] <<= n;
    }
}

// x = (x + m r) / 2^b with m = -x r^-1 mod 2^b (1 <= b <= 32): x 2^-b mod r,
// canonical for x < r
DEV void fr_div_pow2(u32 x[8], int b) {
    u32 t[9];
    fr_add_mr(t, x, (x[0] * FR_N0) & (b == 32 ? ~0u : (1u << b) - 1));
#pragma unroll
    for (int j = 0; j < 8; j++) x[j] = (u32)(((u64)t[j + 1] << 32 | t[j]) >> b);
}

// a^-1 mod r for canonical a; 0 maps to 0.  Kaliski's almost-inverse keeps
// r = u s + v q with u, v odd, and a q = -u 2^k, a s = v 2^k (mod r); each
// step subtracts the smaller of u, v from the larger and shifts out the
// difference's zeros, k counting the shifts.  At u = v = 1 the result is
// -q 2^-k (q < 2r), which the Montgomery division takes to a^-1.
static __device__ __noinline__ void fr_inverse(Fr& out, const Fr& a) {
    u32 u[8], v[8], q[8], s[8], d[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        u[k] = kR[k];
        v[k] = a.v[k];
        q[k] = 0;
        s[k] = k == 0;
        out.v[k] = 0;
    }
    if (w8_is_zero(v)) return;
    int k = w8_shr_ctz(v);         // q = 0: its shift changes nothing
    while (true) {
        if (!w8_sub(d, u, v)) {
            if (d[0] == 0 && w8_is_zero(d)) break;   // u = v (= 1)
#pragma unroll
            for (int j = 0; j < 8; j++) u[j] = d[j];
            const int n = w8_shr_ctz(u);
            w8_add(q, s);
            w8_shl(s, n);
            k += n;
        } else {
            w8_sub(v, v, u);
            const int n = w8_shr_ctz(v);
            w8_add(s, q);
            w8_shl(q, n);
            k += n;
        }
    }
    w8_shl(q, 1);                  // the last step, at u = v: q = 2q
    k += 1;
    if (!w8_sub(d, q, kR)) {       // q mod r
#pragma unroll
        for (int j = 0; j < 8; j++) q[j] = d[j];
    }
    w8_sub(out.v, kR, q);          // -q, canonical (q != 0)
    for (; k > 32; k -= 32) fr_div_pow2(out.v, 32);
    fr_div_pow2(out.v, k);
}

DEV void fr_store(long long* dst, const Fr& a) {
    #pragma unroll
    for (int k = 0; k < 8; k++) {
        dst[2 * k] = a.v[k] & 0xFFFFu;
        dst[2 * k + 1] = a.v[k] >> 16;
    }
}

DEV void fr_load(Fr& a, const long long* src) {
#pragma unroll
    for (int k = 0; k < 8; k++) a.v[k] = (u32)src[2 * k] | ((u32)src[2 * k + 1] << 16);
}

// digest (canonical) -> x and x^-1 as canonical Fr limbs
DEV void challenge(const u64 d[4], long long* x_out, long long* xinv_out) {
    u32 w[8];
    digest_to_challenge(d, w);
    Fr v, r2, raw1, xm, x, xinv;
    for (int k = 0; k < 8; k++) {
        v.v[k] = w[k];
        r2.v[k] = FR_R2[k];
        raw1.v[k] = k == 0;
    }
    fr_mul(xm, v, r2);             // to Montgomery: reduces the integer mod r
    fr_mul(x, xm, raw1);
    fr_inverse(xinv, x);
    fr_store(x_out, x);
    fr_store(xinv_out, xinv);
}

// ---------------------------------------------------------------- kernels

// f2 == nullptr: K5, one append.  Otherwise K4: append f1 and f2, then the
// challenge and its inverse.  One warp.
__global__ void __launch_bounds__(TR_THREADS)
transcript_kernel(const long long* __restrict__ state, const long long* __restrict__ f1,
                  const long long* __restrict__ f2, long long* __restrict__ state_out,
                  long long* __restrict__ x_out, long long* __restrict__ xinv_out) {
    __shared__ TrShared s;
    const int t = threadIdx.x;
    u32 m[PSD_W];
    tr_setup(s, m, t);
    u64 x = 0;
    if ((t & 15) < 4) {
        const long long* l = state + 5 * (t & 15);
        const u64 mont = (u64)l[0] | ((u64)l[1] << 16) | ((u64)l[2] << 32) | ((u64)l[3] << 48);
        x = gl_mul(mont, GL_RINV);     // from Montgomery (R = 2^80)
    }
    fq12_message(f1, s.msg[0], t);
    if (f2) fq12_message(f2, s.msg[1], t);
    __syncwarp();
    x = append(x, s, s.msg[0], m, t);
    if (f2) {
        x = append(x, s, s.msg[1], m, t);
        // digest = hash_no_pad(chain): one permutation of (chain, 0, ..., 0)
        const u64 dig = permute((t & 15) < 4 ? x : 0, s, m, t);
        u64 d[4];
        for (int k = 0; k < 4; k++) d[k] = __shfl_sync(FULL_MASK, dig, k);
        if (t == 0) challenge(d, x_out, xinv_out);
    }
    if (t < 4) {
        const u64 mont = gl_canon(gl_mul(x, GL_R80));  // to Montgomery
        for (int k = 0; k < 4; k++) state_out[5 * t + k] = (mont >> (16 * k)) & 0xFFFF;
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

// one thread per value: (n, 16) canonical Fr limbs -> their inverses
__global__ void fr_inverse_kernel(const long long* __restrict__ x, long long* __restrict__ out,
                                  int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fr a, inv;
    fr_load(a, x + 16 * i);
    fr_inverse(inv, a);
    fr_store(out + 16 * i, inv);
}

// The latency probe: `perms` dependent permutations on one warp, between
// two clock64 reads, then on lane 0 the Fr inverse of each of the n values
// xs ((n, 16) canonical Fr limbs), each between two more.  out: the
// permutations' cycles and result word, then per value its cycles and the
// 16 limbs of its inverse (the results keep the work alive).
__global__ void transcript_probe_kernel(const long long* __restrict__ xs, int n,
                                        long long* __restrict__ out, int perms) {
    __shared__ TrShared s;
    const int t = threadIdx.x;
    u32 m[PSD_W];
    tr_setup(s, m, t);
    __syncwarp();
    u64 x = t & 15;
    const long long t0 = clock64();
    for (int i = 0; i < perms; i++) x = permute(x, s, m, t);
    const long long t1 = clock64();
    if (t != 0) return;
    out[0] = t1 - t0;
    out[1] = (long long)x;
    for (int i = 0; i < n; i++) {
        Fr a, inv;
        fr_load(a, xs + 16 * i);
        const long long t2 = clock64();
        fr_inverse(inv, a);
        const long long t3 = clock64();
        out[2 + 17 * i] = t3 - t2;
        fr_store(out + 3 + 17 * i, inv);
    }
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
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

// K4's Fr inverse alone, for the tests of its edge values.
extern "C" int sipp_fr_inverse(const void* x, void* out, int n, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    fr_inverse_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const long long*)x, (long long*)out, n);
    return (int)cudaGetLastError();
}

// xs: (n, 16) limbs; out: 2 + 17 n.
extern "C" int sipp_transcript_probe(const void* xs, int n, void* out, int perms,
                                     void* stream) {
    if (n < 0 || perms < 0) return (int)cudaErrorInvalidValue;
    transcript_probe_kernel<<<1, TR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)xs, n, (long long*)out, perms);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
