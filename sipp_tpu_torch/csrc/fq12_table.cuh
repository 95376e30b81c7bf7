// The Fq12-level table operations of K2 (fexp.cu) and K8 (exp.cu): one
// Fq12 operation spread over the threads of one warp.
//
// Thread k < nprod computes the Fq2 product x_k * y_k, where x_k (y_k) is
// the sum of the input coefficients of A (B) that the operation's xmask[k]
// (ymask[k]) selects; then thread q < nout forms output coefficient q as
// the linear form terms[q] over the products and the inputs.  The tables
// are ops/schedule.py's OPS (the generated schedule_params.cuh), which the
// CPU tests evaluate against fields/tower.py.  An operation costs one Fq2
// product (one Fq product where it is split over three threads) and one
// combine pass.
#pragma once
#include "bn254.cuh"
#include "schedule_params.cuh"

#define SPLIT_MAX 10                      // products split over 3 lanes of a warp

// schedule_params.cuh's tables, copied to shared memory at the start: the
// lanes of an operation read different rows, which constant memory serves
// one address at a time (terms, whole 32-bit words, aligned for
// copy_table's word copy)
struct Tables {
    unsigned char nprod[SCHED_N_OPS], nout[SCHED_N_OPS];
    unsigned char xmask[SCHED_N_OPS][SCHED_N_PROD], ymask[SCHED_N_OPS][SCHED_N_PROD];
    __align__(16) signed char terms[SCHED_N_OPS][6][SCHED_MAX_TERMS][3];
};

// r = the sum of the coefficients of a that mask selects
static __device__ __forceinline__ void fq2_sum(Fq2& r, const Fq2* a, int mask) {
    bool first = true;
#pragma unroll
    for (int q = 0; q < 6; q++) {
        if (!(mask >> q & 1)) continue;
        if (first) r = a[q];
        else fq2_add(r, r, a[q]);
        first = false;
    }
}

// acc +/-= c v for a small non-zero integer c
static __device__ __forceinline__ void fq2_add_small(Fq2& acc, const Fq2& v, int c) {
    Fq2 t = v;
    for (int k = 1; k < (c < 0 ? -c : c); k++) fq2_add(t, t, v);
    if (c > 0) fq2_add(acc, acc, t);
    else fq2_sub(acc, acc, t);
}

// One table operation on one warp (every lane calls it; l = lane):
// out[q] = form q over the products x_k * y_k and the inputs a.  a, b and
// out are coefficient arrays in shared memory; out may alias a or b.  Up
// to SPLIT_MAX products (a cyclotomic squaring's 9) run as their three
// Karatsuba Fq products on three lanes each, then one lane per product
// combines its parts.
static __device__ __noinline__ void lin_op(Fq2* out, const Fq2* a, const Fq2* b, int op,
                                           Fq2* prods, Fq (*parts)[3], const Tables& tab,
                                           int l) {
    const int nprod = tab.nprod[op];
    if (nprod <= SPLIT_MAX) {
        const int k = l / 3, part = l % 3;
        if (k < nprod) {
            Fq2 x, y;
            fq2_sum(x, a, tab.xmask[op][k]);
            fq2_sum(y, b, tab.ymask[op][k]);
            Fq u = part == 1 ? x.c1 : x.c0, w = part == 1 ? y.c1 : y.c0;
            if (part == 2) {
                fq_add(u, u, x.c1);
                fq_add(w, w, y.c1);
            }
            fq_mul(parts[k][part], u, w);
        }
        __syncwarp();
        if (l < nprod) {
            Fq s;
            fq_add(s, parts[l][0], parts[l][1]);
            fq_sub(prods[l].c0, parts[l][0], parts[l][1]);
            fq_sub(prods[l].c1, parts[l][2], s);
        }
    } else if (l < nprod) {
        Fq2 x, y;
        fq2_sum(x, a, tab.xmask[op][l]);
        fq2_sum(y, b, tab.ymask[op][l]);
        fq2_mul(prods[l], x, y);
    }
    __syncwarp();
    Fq2 o;
    if (l < tab.nout[op]) {
        Fq2 p, s;                          // the xi^0 and xi^1 parts
        fq2_zero(p);
        fq2_zero(s);
        for (int t = 0; t < SCHED_MAX_TERMS; t++) {
            const signed char* term = tab.terms[op][l][t];
            if (term[1] == 0) break;
            const Fq2& v = term[0] < SCHED_INPUT ? prods[term[0]] : a[term[0] - SCHED_INPUT];
            if (term[2]) fq2_add_small(s, v, term[1]);
            else fq2_add_small(p, v, term[1]);
        }
        fq2_mul_xi(s, s);
        fq2_add(o, p, s);
    }
    __syncwarp();
    if (l < tab.nout[op]) out[l] = o;
    __syncwarp();
}

static __device__ __forceinline__ void load_tables(Tables& tab) {
    copy_table(tab.nprod, OP_NPROD);
    copy_table(tab.nout, OP_NOUT);
    copy_table(tab.xmask, OP_XMASK);
    copy_table(tab.ymask, OP_YMASK);
    copy_table(tab.terms, OP_TERMS);
}
