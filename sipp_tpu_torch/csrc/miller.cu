// K1: the Miller product  prod_i miller(P_i, Q_i)  over lanes; K7 (below
// it): one step of the Miller loop, as one digit's slice of K1's program.
//
// Replaces sipp_tpu/ops/pallas_miller.py:miller_product_fused (kernel body
// _full_kernel): the whole optimal-ate Miller loop over the NAF of 6x+2, the
// two Frobenius correction lines, infinity masking, and the Fq12 product
// over the lanes.  pair = 1 forms the product of the even lanes and that of
// the odd lanes apart (a fold round's Z_L and Z_R).  The lines are the
// reference's denominator-cleared ones (pairing/ate.py:_dbl_step and
// _add_step): another line scaling would give another pre-final-exp value.
//
// What bounds it on the H100: latency.  A lane is a chain of ~10,000
// dependent Fq products; 128 lanes are a few warps an SM.  The design cuts
// the chain:
//
// * one warp per lane, MILLER_BLOCK_LANES lanes a block.  The lane runs as
//   a program of table operations (ops/schedule.py: M_OPS, PROGRAM, written
//   into the generated schedule_params.cuh): each operation is up to 32
//   independent Fq2 products, product k on thread k, then output j on
//   thread j as a linear form over the products and the lane's slots (Fq2
//   values in shared memory: f, T, P, Q and its Frobenius images, the line,
//   the stages' values).  An operation costs one Fq2 product (an Fq product
//   where it has few: its Karatsuba parts then run on two or three threads)
//   and one combine pass, where one thread made its products in a row.
// * the G2 doubling runs as 3 stages of independent products and the mixed
//   addition as 5, as in K3 (ladder.cuh), with the line's coefficients as
//   products of those stages.  f's squaring (the complex squaring, 12 Fq2
//   products) runs beside the doubling's second stage on the other
//   threads, and each line multiply (15) beside the next stage that does
//   not write f, so a zero digit is 3 operations and a set digit 8, ~309
//   for the loop and the Frobenius lines, against ~9,950 dependent Fq
//   products on one thread.
// * a warp runs divergent paths one after another, so every thread runs
//   the same code on its own table row (the operands, the forms); the
//   tables sit in shared memory, since lanes that read different rows of
//   constant memory would wait for one another.  The program is read by
//   every thread at once (constant memory).
// * an infinity lane (P = O or Q = O: all-zero) and a lane past n skip the
//   loop and contribute f = 1; no lane is padded on the host.
// * the lane product: a tree over the block's warps in shared memory (in
//   pair mode it stops at stride 2), one partial per block (and parity);
//   then a second launch of MILLER_TREE_WARPS warps per parity multiplies
//   the partials (each warp a strided share of them, then a tree over the
//   warps).  Both use the Fq12 multiply's table; field products are exact,
//   so the order is free.
#include <cuda_runtime.h>

// with bn254_params.cuh: MILLER_BLOCK_LANES and MILLER_PARTIAL_LIMBS (an
// Fq12 partial product as 96 words, in int64 units) from ops/miller.py
#include "bn254.cuh"
#include "schedule_params.cuh"

#define MILLER_TREE_WARPS 8

// the tables of the operations, copied to shared memory at the start, each
// a whole number of 32-bit words (so copy_table moves words)
struct __align__(16) MillerTables {
    unsigned char nprod[MOP_N_OPS], nout[MOP_N_OPS];
    unsigned char x[MOP_N_OPS][MOP_MAX_PROD][MOP_OPND], y[MOP_N_OPS][MOP_MAX_PROD][MOP_OPND];
    unsigned char dst[MOP_N_OPS][MOP_MAX_OUT];
    signed char terms[MOP_N_OPS][MOP_MAX_OUT][MOP_MAX_TERMS][3];
};

// a warp's products and, where they are split, their Karatsuba parts
struct MillerProducts {
    Fq2 prod[MOP_MAX_PROD];
    Fq part[MOP_SPLIT2][3];
};

struct MillerLane {
    Fq2 slot[MILLER_NSLOT];
    MillerProducts w;
};

static __device__ void load_miller_tables(MillerTables& tab) {
    copy_table(tab.nprod, MOP_NPROD);
    copy_table(tab.nout, MOP_NOUT);
    copy_table(tab.x, MOP_X);
    copy_table(tab.y, MOP_Y);
    copy_table(tab.dst, MOP_DST);
    copy_table(tab.terms, MOP_TERMS);
}

// r = the operand t over src: a signed sum of slots, a term optionally
// times xi (bits 6 and 7 of its byte)
static __device__ __forceinline__ void mop_operand(Fq2& r, const Fq2* src,
                                                   const unsigned char* t) {
    for (int i = 0; i < MOP_OPND; i++) {
        const unsigned e = t[i];
        if (e == 0xFF) break;
        Fq2 v = src[e & 0x3F];
        if (e & 0x40) fq2_mul_xi(v, v);
        if (i == 0) {
            if (e & 0x80) fq2_neg(r, v);
            else r = v;
        } else if (e & 0x80) {
            fq2_sub(r, r, v);
        } else {
            fq2_add(r, r, v);
        }
    }
}

// Karatsuba part `part` of x * y: x0 y0, x1 y1, (x0 + x1)(y0 + y1)
static __device__ __forceinline__ void kara_part(Fq& r, const Fq2& x, const Fq2& y, int part) {
    Fq u = part == 1 ? x.c1 : x.c0, w = part == 1 ? y.c1 : y.c0;
    if (part == 2) {
        fq_add(u, u, x.c1);
        fq_add(w, w, y.c1);
    }
    fq_mul(r, u, w);
}

// v <- c v for a small c > 0 (double and add)
static __device__ __forceinline__ void fq2_times(Fq2& v, int c) {
    if (c == 1) return;
    const Fq2 b = v;
    int bit = 1;
    while ((bit << 1) <= c) bit <<= 1;
    for (bit >>= 1; bit; bit >>= 1) {
        fq2_add(v, v, v);
        if (c & bit) fq2_add(v, v, b);
    }
}

// o = the form t over the products and the slots.  The terms come sorted
// by (power of xi, |coefficient|): each run of equal ones is summed, then
// scaled once (and multiplied by xi once).
static __device__ __forceinline__ void mop_form(Fq2& o, const signed char (*t)[3],
                                                const Fq2* prod, const Fq2* slots) {
    Fq2 run;
    int cur = 0, curxi = 0;
    bool have = false;
    for (int i = 0; i <= MOP_MAX_TERMS; i++) {
        const int c = i < MOP_MAX_TERMS ? t[i][1] : 0;
        const int ac = c < 0 ? -c : c, xi = i < MOP_MAX_TERMS ? t[i][2] : 0;
        if (cur && (ac != cur || xi != curxi)) {
            fq2_times(run, cur);
            if (curxi) fq2_mul_xi(run, run);
            if (have) fq2_add(o, o, run);
            else o = run;
            have = true;
            cur = 0;
        }
        if (c == 0) break;
        const int src = t[i][0];
        const Fq2& v = src < MOP_MAX_PROD ? prod[src] : slots[src - MOP_MAX_PROD];
        if (cur == 0) {
            if (c > 0) run = v;
            else fq2_neg(run, v);
            cur = ac;
            curxi = xi;
        } else if (c > 0) {
            fq2_add(run, run, v);
        } else {
            fq2_sub(run, run, v);
        }
    }
}

// One table operation on one warp (every thread calls it; l = its lane):
// x operands over xs, y operands over ys, forms over the products and
// slots, outputs into slots, written after every read.  Up to 10 products
// run as their three Karatsuba Fq products on three threads, up to
// MOP_SPLIT2 as two threads each (parts 0 and 2, part 1), more as one Fq2
// product a thread.
static __device__ __noinline__ void mop_run(int op, const Fq2* xs, const Fq2* ys, Fq2* slots,
                                            MillerProducts& w, const MillerTables& tab, int l) {
    const int nprod = tab.nprod[op];
    const int split = nprod <= 10 ? 3 : nprod <= MOP_SPLIT2 ? 2 : 1;
    const int k = l / split, part = l % split;
    if (k < nprod) {
        Fq2 x, y;
        mop_operand(x, xs, tab.x[op][k]);
        mop_operand(y, ys, tab.y[op][k]);
        if (split == 1) {
            fq2_mul(w.prod[k], x, y);
        } else {
            for (int p = part; p < 3; p += split) kara_part(w.part[k][p], x, y, p);
        }
    }
    __syncwarp();
    if (split > 1 && l < nprod) {
        Fq s;
        fq_add(s, w.part[l][0], w.part[l][1]);
        fq_sub(w.prod[l].c0, w.part[l][0], w.part[l][1]);
        fq_sub(w.prod[l].c1, w.part[l][2], s);
    }
    __syncwarp();
    const int nout = tab.nout[op];
    Fq2 o;
    if (l < nout) mop_form(o, tab.terms[op][l], w.prod, slots);
    __syncwarp();
    if (l < nout) slots[tab.dst[op][l]] = o;
    __syncwarp();
}

// f (slots 0..5) as 96 words at dst, or from src
static __device__ void store_partial(long long* dst, const Fq2* f, int l) {
    if (l < 6) *reinterpret_cast<Fq2*>(reinterpret_cast<u32*>(dst) + 16 * l) = f[l];
}
static __device__ void load_partial(Fq2* f, const long long* src, int l) {
    if (l < 6) f[l] = *reinterpret_cast<const Fq2*>(reinterpret_cast<const u32*>(src) + 16 * l);
}
static __device__ void set_one(Fq2* f, int l) {
    if (l == 0) fq2_one(f[0]);
    else if (l < 6) fq2_zero(f[l]);
}

// G2 Frobenius on twist affine coordinates: (conj(x) cx, conj(y) cy)
static __device__ void twist_frob(Fq2& o, const Fq2& a, int y) {
    Fq2 c, t;
    for (int w = 0; w < 8; w++) {
        c.c0.v[w] = BN_TWF[y][0][w];
        c.c1.v[w] = BN_TWF[y][1][w];
    }
    fq2_conj(t, a);
    fq2_mul(o, t, c);
}

// p: (n, 2, 16), q: (n, 2, 2, 16) int64 limbs; partials: per block, one
// (pair: two, even then odd) Fq12 of MILLER_PARTIAL_LIMBS
__global__ void __launch_bounds__(32 * MILLER_BLOCK_LANES)
miller_product_kernel(const long long* __restrict__ p, const long long* __restrict__ q,
                      long long* __restrict__ partials, int n, int pair) {
    __shared__ MillerTables tab;
    __shared__ MillerLane lanes[MILLER_BLOCK_LANES];
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const int lane = blockIdx.x * MILLER_BLOCK_LANES + warp;
    MillerLane& L = lanes[warp];
    Fq2* s = L.slot;
    load_miller_tables(tab);
    if (lane < n) {
        if (l < 2) {
            fq_load(s[l ? MS_YP : MS_XP].c0, p + 32 * lane + 16 * l);
            fq_zero(s[l ? MS_YP : MS_XP].c1);
        } else if (l < 4) {
            fq2_load(s[l == 2 ? MS_QX : MS_QY], q + 64 * lane + 32 * (l - 2));
        }
    }
    __syncthreads();
    // e(O, Q) = e(P, O) = 1: such lanes, and lanes past n, skip the loop
    const bool live = lane < n && !(fq_is_zero(s[MS_XP].c0) && fq_is_zero(s[MS_YP].c0))
                      && !(fq2_is_zero(s[MS_QX]) && fq2_is_zero(s[MS_QY]));
    if (live) {
        if (l < 2) {                  // pi(Q), then pi^2(Q), -pi^2(Q).y
            Fq2 t;
            twist_frob(t, s[l ? MS_QY : MS_QX], l);
            s[l ? MS_Q1Y : MS_Q1X] = t;
            twist_frob(t, t, l);
            if (l) fq2_neg(s[MS_NQ2Y], t);
            else s[MS_Q2X] = t;
        } else if (l == 2) {
            fq2_neg(s[MS_NQY], s[MS_QY]);
        } else if (l == 3) {
            s[MS_X] = s[MS_QX];
            s[MS_Y] = s[MS_QY];
            fq2_one(s[MS_Z]);
        }
        if (l >= 4) set_one(s, l - 4);  // f = 1 on threads 4..9
        __syncwarp();
        for (int i = 0; i < MILLER_PROG_LEN; i++) {
            if (MILLER_PROG[i][1] != 0xFF) {
                if (l < 2) s[MS_AX + l] = s[MILLER_PROG[i][1 + l]];
                __syncwarp();
            }
            mop_run(MILLER_PROG[i][0], s, s, s, L.w, tab, l);
        }
    } else {
        set_one(s, l);
    }
    __syncthreads();
    for (int st = MILLER_BLOCK_LANES / 2; st >= (pair ? 2 : 1); st /= 2) {
        if (warp < st) mop_run(MOP_MUL, s, lanes[warp + st].slot, s, L.w, tab, l);
        __syncthreads();
    }
    const int k = pair ? 2 : 1;
    if (warp < k)
        store_partial(partials + ((size_t)blockIdx.x * k + warp) * MILLER_PARTIAL_LIMBS, s, l);
}

struct TreeWarp {
    Fq2 acc[6], other[6];
    MillerProducts w;
};

// block `parity` of k = pair ? 2 : 1: out[parity] = the product of the
// nblk partials of that parity, (2, 3, 2, 16) int64 limbs
__global__ void __launch_bounds__(32 * MILLER_TREE_WARPS)
miller_tree_kernel(const long long* __restrict__ partials, long long* __restrict__ out,
                   int nblk, int pair) {
    __shared__ MillerTables tab;
    __shared__ TreeWarp tw[MILLER_TREE_WARPS];
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const int k = pair ? 2 : 1, parity = blockIdx.x;
    TreeWarp& W = tw[warp];
    load_miller_tables(tab);
    __syncthreads();
    if (warp < nblk)
        load_partial(W.acc, partials + ((size_t)warp * k + parity) * MILLER_PARTIAL_LIMBS, l);
    else
        set_one(W.acc, l);
    __syncwarp();
    for (int j = warp + MILLER_TREE_WARPS; j < nblk; j += MILLER_TREE_WARPS) {
        load_partial(W.other, partials + ((size_t)j * k + parity) * MILLER_PARTIAL_LIMBS, l);
        __syncwarp();
        mop_run(MOP_MUL, W.acc, W.other, W.acc, W.w, tab, l);
    }
    __syncthreads();
    for (int st = MILLER_TREE_WARPS / 2; st >= 1; st /= 2) {
        if (warp < st) mop_run(MOP_MUL, W.acc, tw[warp + st].acc, W.acc, W.w, tab, l);
        __syncthreads();
    }
    if (warp == 0 && l < 6) fq2_store(out + (size_t)parity * 192 + 32 * l, W.acc[l]);
}

// ---------------------------------------------------------------- K7
// K7: ONE Miller step for n lanes (replaces sipp_tpu/ops/pallas_miller.py:
// miller_step, kernel _step_kernel): f <- f^2 * line_dbl(T, P), T <- 2T,
// then, when the shared NAF digit is not 0, f <- f * line_add(T, +-Q, P),
// T <- T +- Q (digit 1 adds qp, digit 2 adds qn = -Q).  The steps of K1's
// loop, one launch per digit: the JAX package's SIPP_WHOLE_LOOP=0 engine.
//
// Design: K1's warp per lane, run one digit at a time.  Each lane runs on
// one warp, MILLER_BLOCK_LANES lanes a block, as the digit's slice of K1's
// program (ops/schedule.py STEP_PROGRAM, the generated STEP_PROG): digit 0
// is dbl1, dbl2_sqr, dbl3, ml (4 table operations), digits 1 and 2 add
// add1_ml, add2, add3, add4_ml, add5 (8), the line multiplies on the
// threads that a curve stage leaves idle, the last one flushed at the end
// of the step.  The digit comes by value (a launch needs no host read) and
// is uniform over the grid.  The carry stays in the port's (n, ...) layout
// in device memory between launches, canonical: thread j of a lane's warp
// loads one Fq2 slot (f, T, P as (x, 0), and the addend from the digit's
// own tensor) and stores one.  Unlike K1, a lane whose P or Q is at
// infinity runs the step like any other, as the plain step does (the tail
// masks it); lanes past n do nothing.  What bounds it on the H100: the
// latency of 4 (8) table operations on one warp, plus the carry's 2,304
// bytes of int64 limbs read and written per lane, the tables' copy to
// shared memory, and a launch per digit.

__global__ void __launch_bounds__(32 * MILLER_BLOCK_LANES)
miller_step_kernel(int digit, const long long* __restrict__ qp,
                   const long long* __restrict__ qn, const long long* __restrict__ p,
                   const long long* __restrict__ f_in, const long long* __restrict__ t_in,
                   long long* __restrict__ f_out, long long* __restrict__ t_out, int n) {
    static_assert(MS_Y == MS_X + 1 && MS_Z == MS_X + 2 && MS_YP == MS_XP + 1
                  && MS_AY == MS_AX + 1, "K7 loads T, P and the addend as runs of slots");
    __shared__ MillerTables tab;
    __shared__ MillerLane lanes[MILLER_BLOCK_LANES];
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const int lane = blockIdx.x * MILLER_BLOCK_LANES + warp;
    Fq2* s = lanes[warp].slot;
    if (lane < n) {
        if (l < 6) {
            fq2_load(s[l], f_in + (size_t)lane * 192 + 32 * l);
        } else if (l < 9) {
            fq2_load(s[MS_X + l - 6], t_in + (size_t)lane * 96 + 32 * (l - 6));
        } else if (l < 11) {
            fq_load(s[MS_XP + l - 9].c0, p + (size_t)lane * 32 + 16 * (l - 9));
            fq_zero(s[MS_XP + l - 9].c1);
        } else if (l < 13 && digit != 0) {
            fq2_load(s[MS_AX + l - 11], (digit == 1 ? qp : qn) + (size_t)lane * 64 + 32 * (l - 11));
        }
    }
    load_miller_tables(tab);        // after the carry's loads, which it overlaps
    __syncthreads();
    if (lane >= n) return;
    for (int i = 0; i < STEP_LEN[digit]; i++)
        mop_run(STEP_PROG[digit][i], s, s, s, lanes[warp].w, tab, l);
    if (l < 6) fq2_store(f_out + (size_t)lane * 192 + 32 * l, s[l]);
    else if (l < 9) fq2_store(t_out + (size_t)lane * 96 + 32 * (l - 6), s[MS_X + l - 6]);
}

// The launchers (nvcc only: a CPU test compiles the device code above with
// g++ on an emulated carry flag and host threads).
#ifdef __CUDACC__
// digit in {0, 1, 2}; qp, qn: (n, 2, 2, 16) Q and -Q; p: (n, 2, 16);
// f_in, f_out: (n, 2, 3, 2, 16); t_in, t_out: (n, 3, 2, 16) Jacobian; all
// int64 limbs, outputs distinct from inputs.
extern "C" int sipp_miller_step(int digit, const void* qp, const void* qn, const void* p,
                                const void* f_in, const void* t_in, void* f_out, void* t_out,
                                int n, void* stream) {
    if (n <= 0 || digit < 0 || digit > 2) return (int)cudaErrorInvalidValue;
    miller_step_kernel<<<(n + MILLER_BLOCK_LANES - 1) / MILLER_BLOCK_LANES,
                         32 * MILLER_BLOCK_LANES, 0, (cudaStream_t)stream>>>(
        digit, (const long long*)qp, (const long long*)qn, (const long long*)p,
        (const long long*)f_in, (const long long*)t_in, (long long*)f_out,
        (long long*)t_out, n);
    return (int)cudaGetLastError();
}

// p: (n, 2, 16), q: (n, 2, 2, 16) int64 limbs; partials: scratch of
// ceil(n / MILLER_BLOCK_LANES) x (pair ? 2 : 1) x MILLER_PARTIAL_LIMBS
// int64; out: (pair ? 2 : 1, 2, 3, 2, 16).  Two launches on the stream.
extern "C" int sipp_miller_product(const void* p, const void* q, void* partials, void* out,
                                   int n, int pair, void* stream) {
    if (n <= 0 || (pair && n % 2)) return (int)cudaErrorInvalidValue;
    const int nblk = (n + MILLER_BLOCK_LANES - 1) / MILLER_BLOCK_LANES;
    miller_product_kernel<<<nblk, 32 * MILLER_BLOCK_LANES, 0, (cudaStream_t)stream>>>(
        (const long long*)p, (const long long*)q, (long long*)partials, n, pair);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    miller_tree_kernel<<<pair ? 2 : 1, 32 * MILLER_TREE_WARPS, 0, (cudaStream_t)stream>>>(
        (const long long*)partials, (long long*)out, nblk, pair);
    return (int)cudaGetLastError();
}

extern "C" const char* sipp_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
#endif  // __CUDACC__
