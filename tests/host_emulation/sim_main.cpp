// Runs the kernels' device code (fq.cu, miller.cu, fexp.cu, fold.cu, exp.cu,
// transcript.cu, validate.cu, msm.cu) and bn254.cuh's Fq arithmetic on the
// CPU: see sim.h.
//
//   sim fq N in out           N pairs (a, b) of 16-limb Fq -> a*b, a+b, a-b, 1/a
//   sim fq_mul N in out       a, b (N, 16) -> K0's a*b (N, 16), FQ_MUL_TILE
//                             elements a block
//   sim fold_g1 N in out      lo, hi (N, 2, 16), bits (254,) -> (N, 2, 16)
//   sim fold_g2 N in out      lo, hi (N, 2, 2, 16), bits (254,) -> (N, 2, 2, 16)
//   sim exp_g1 N in out       x, off (N, 2, 16), bits (254, N) -> (N, 2, 16)
//   sim exp_g2 N in out       x, off (N, 2, 2, 16), bits (254, N) -> (N, 2, 2, 16)
//   sim fexp N in out         f (N, 2, 3, 2, 16) -> (N, 2, 3, 2, 16)
//   sim miller N in out       p (N, 2, 16), q (N, 2, 2, 16) -> (2, 3, 2, 16)
//   sim miller_pair N in out  the same -> (2, 2, 3, 2, 16)
//   sim miller_step N in out  digit (1,), qp, qn (N, 2, 2, 16), p (N, 2, 16),
//                             f (N, 2, 3, 2, 16), t (N, 3, 2, 16) -> f, t over
//                             the grid's whole blocks (lanes past N as -1)
//   sim fq12_exp N in out     x, off (N, 2, 3, 2, 16), bits (254, N) -> (N, 2, 3, 2, 16)
//   sim round N in out        N cases of a full flag, 12 u64 words x and 12
//                             canonical constants c -> one round, canonical
//   sim permute N in out      N states of 12 canonical u64 -> permuted
//   sim append N in out       N cases of state (4, 5), f (2, 3, 2, 16) -> (4, 5)
//   sim round_tail N in out   N cases of state, zl, zr -> state (4, 5), x, x^-1 (16,)
//   sim fr_inv N in out       N canonical Fr (16,) -> their inverses
//   sim torsion N in out      b (N, 2, 2, 16) -> X1's verdicts (N,)
//   sim add_complete_g1 N in out
//                             p (N, 3, 16) Jacobian, q (N, 2, 16) affine ->
//                             ladder.cuh's add_complete_staged p + q (N, 3, 16)
//   sim add_complete_g2 N in out
//                             the same over Fq2: (N, 3, 2, 16), (N, 2, 2, 16)
//   sim add_jacobian_g1 N in out
//                             p, q (N, 3, 16) Jacobian -> ladder.cuh's
//                             add_jacobian_staged p + q (N, 3, 16)
//   sim add_jacobian_g2 N in out
//                             the same over Fq2: (N, 3, 2, 16)
//   sim msm_sum_g1 N in out   lanes (N, 2, 16) -> X2's sum (1, 2, 16): the
//                             chunk launch block by block, then the tree
//                             launch
//   sim msm_sum_g2 N in out   lanes (N, 2, 2, 16) -> X2's sum (1, 2, 2, 16)
//
// in and out hold int64 limbs (round, permute: u64 words), C order, in the
// port's format.
#include "sim.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "exp.cu"
#include "fexp.cu"
#include "fold.cu"
#include "fq.cu"
#include "miller.cu"
#include "msm.cu"
#include "transcript.cu"
#include "validate.cu"

// p + q with add_complete_staged, lane by lane: p (n, 3, LIMBS) Jacobian,
// q (n, 2, LIMBS) affine -> out (n, 3, LIMBS); FOLD_LANES lanes a block
template <class F>
static void add_complete_lanes(const long long* p, const long long* q, long long* out, int n) {
    for (int blk = 0; blk < (n + FOLD_LANES - 1) / FOLD_LANES; blk++)
        run_block(blk, FOLD_LANES * FOLD_GROUP, [&] {
            __shared__ FoldLane<F> lanes[FOLD_LANES];
            const int sub = threadIdx.x % FOLD_GROUP;
            const int lane = blockIdx.x * FOLD_LANES + threadIdx.x / FOLD_GROUP;
            const bool live = lane < n;
            FoldLane<F>& L = lanes[threadIdx.x / FOLD_GROUP];
            const size_t pj = (size_t)lane * 3 * F::LIMBS, qj = (size_t)lane * 2 * F::LIMBS;
            if (sub == 0) {
                F::zero(L.zero);
                F::zero(L.X); F::zero(L.Y); F::zero(L.Z); F::zero(L.hx); F::zero(L.hy);
                if (live) {
                    F::load(L.X, p + pj); F::load(L.Y, p + pj + F::LIMBS);
                    F::load(L.Z, p + pj + 2 * F::LIMBS);
                    F::load(L.hx, q + qj); F::load(L.hy, q + qj + F::LIMBS);
                }
            }
            __syncwarp();
            add_complete_staged<F>(L, L.hx, L.hy, sub, true);
            if (sub == 0 && live) {
                F::store(out + pj, L.X); F::store(out + pj + F::LIMBS, L.Y);
                F::store(out + pj + 2 * F::LIMBS, L.Z);
            }
        });
}

// p + q with add_jacobian_staged, lane by lane: p, q (n, 3, LIMBS) Jacobian
// -> out (n, 3, LIMBS); FOLD_LANES lanes a block, q in the lane's hx, hy, lx
template <class F>
static void add_jacobian_lanes(const long long* p, const long long* q, long long* out, int n) {
    for (int blk = 0; blk < (n + FOLD_LANES - 1) / FOLD_LANES; blk++)
        run_block(blk, FOLD_LANES * FOLD_GROUP, [&] {
            __shared__ FoldLane<F> lanes[FOLD_LANES];
            const int sub = threadIdx.x % FOLD_GROUP;
            const int lane = blockIdx.x * FOLD_LANES + threadIdx.x / FOLD_GROUP;
            const bool live = lane < n;
            FoldLane<F>& L = lanes[threadIdx.x / FOLD_GROUP];
            const size_t j = (size_t)lane * 3 * F::LIMBS;
            if (sub == 0) {
                F::zero(L.zero);
                F::zero(L.X); F::zero(L.Y); F::zero(L.Z);
                F::zero(L.hx); F::zero(L.hy); F::zero(L.lx);
                if (live) {
                    F::load(L.X, p + j); F::load(L.Y, p + j + F::LIMBS);
                    F::load(L.Z, p + j + 2 * F::LIMBS);
                    F::load(L.hx, q + j); F::load(L.hy, q + j + F::LIMBS);
                    F::load(L.lx, q + j + 2 * F::LIMBS);
                }
            }
            __syncwarp();
            add_jacobian_staged<F>(L, L.hx, L.hy, L.lx, sub, true);
            if (sub == 0 && live) {
                F::store(out + j, L.X); F::store(out + j + F::LIMBS, L.Y);
                F::store(out + j + 2 * F::LIMBS, L.Z);
            }
        });
}

// X2 as msm.cu's launcher runs it: the chunk launch block by block (the
// affine sum itself where one block holds every lane), then the tree launch
template <class F>
static void msm_sum(const long long* pts, long long* out, int n) {
    const int blocks = msm_blocks(n);
    std::vector<long long> partials((size_t)blocks * 3 * F::LIMBS);
    for (int b = 0; b < blocks; b++)
        run_block(b, MSM_THREADS, [&] {
            msm_sum_kernel<F, false>(pts, blocks == 1 ? out : partials.data(), n, MSM_CHUNK,
                                     blocks == 1);
        });
    if (blocks > 1)
        run_block(0, MSM_THREADS, [&] {
            msm_sum_kernel<F, true>(partials.data(), out, blocks,
                                    (blocks + MSM_GROUPS - 1) / MSM_GROUPS, true);
        });
}

int main(int argc, char** argv) {
    if (argc != 5) return 2;
    const char* mode = argv[1];
    const int n = atoi(argv[2]);
    std::vector<long long> in(1 << 20), out;
    FILE* f = fopen(argv[3], "rb");
    if (!f) return 3;
    in.resize(fread(in.data(), 8, in.size(), f));
    fclose(f);
    if (!strcmp(mode, "fq")) {
        out.resize(64 * (size_t)n);
        for (int i = 0; i < n; i++) {
            Fq a, b, r[4];
            fq_load(a, &in[32 * i]);
            fq_load(b, &in[32 * i + 16]);
            fq_mul(r[0], a, b);
            fq_add(r[1], a, b);
            fq_sub(r[2], a, b);
            fq_inv(r[3], a);
            for (int k = 0; k < 4; k++) fq_store(&out[64 * i + 16 * k], r[k]);
        }
    } else if (!strcmp(mode, "fq_mul")) {
        const longlong2* a = reinterpret_cast<const longlong2*>(in.data());
        const longlong2* b = a + 8 * (size_t)n;
        out.resize(16 * (size_t)n);
        longlong2* o = reinterpret_cast<longlong2*>(out.data());
        for (int blk = 0; blk < (n + FQ_MUL_TILE - 1) / FQ_MUL_TILE; blk++)
            run_block(blk, FQ_MUL_TILE, [&] { fq_mul_kernel(a, b, o, n); });
    } else if (!strcmp(mode, "round")) {
        out.resize(PSD_W * (size_t)n);
        for (int i = 0; i < n; i++) {
            const long long* c = &in[(1 + 2 * PSD_W) * i];
            run_block(0, TR_THREADS, [&] {
                __shared__ TrShared s;
                const int t = threadIdx.x, w = tr_row(t);
                u32 m[PSD_W];
                tr_setup(s, m, t);
                __syncwarp();
                const u64 x = c[1 + w], k = c[1 + PSD_W + w];
                const u64 y = c[0] ? tr_round<true>(x, m, k, s.xch[0], t)
                                   : tr_round<false>(x, m, k, s.xch[0], t);
                if (t < PSD_W) out[PSD_W * i + t] = (long long)gl_canon(y);
            });
        }
    } else if (!strcmp(mode, "permute")) {
        out.resize(PSD_W * (size_t)n);
        for (int i = 0; i < n; i++)
            run_block(0, TR_THREADS, [&] {
                __shared__ TrShared s;
                const int t = threadIdx.x;
                u32 m[PSD_W];
                tr_setup(s, m, t);
                __syncwarp();
                const u64 x = permute(in[PSD_W * i + tr_row(t)], s, m, t);
                if (t < PSD_W) out[PSD_W * i + t] = (long long)x;
            });
    } else if (!strcmp(mode, "append") || !strcmp(mode, "round_tail")) {
        const int tail = !strcmp(mode, "round_tail");
        const size_t in_len = 20 + 192 * (1 + tail), out_len = 20 + 32 * tail;
        out.resize(out_len * n);
        for (int i = 0; i < n; i++) {
            const long long* c = &in[in_len * i];
            long long* o = &out[out_len * i];
            run_block(0, TR_THREADS, [&] {
                transcript_kernel(c, c + 20, tail ? c + 212 : nullptr, o,
                                  tail ? o + 20 : nullptr, tail ? o + 36 : nullptr);
            });
        }
    } else if (!strcmp(mode, "fr_inv")) {
        out.resize(16 * (size_t)n);
        for (int i = 0; i < n; i++) {
            Fr a, inv;
            fr_load(a, &in[16 * i]);
            fr_inverse(inv, a);
            fr_store(&out[16 * i], inv);
        }
    } else if (!strcmp(mode, "fexp")) {
        out.resize(192 * (size_t)n);
        for (int e = 0; e < n; e++)
            run_block(e, 32 * FEXP_WARPS, [&] { final_exp_kernel(in.data(), out.data()); });
    } else if (!strcmp(mode, "miller_step")) {
        const int blocks = (n + MILLER_BLOCK_LANES - 1) / MILLER_BLOCK_LANES;
        const size_t lanes = (size_t)blocks * MILLER_BLOCK_LANES;
        const long long* qp = in.data() + 1;
        const long long* qn = qp + (size_t)n * 64;
        const long long* p = qn + (size_t)n * 64;
        const long long* f_in = p + (size_t)n * 32;
        const long long* t_in = f_in + (size_t)n * 192;
        out.assign(lanes * (192 + 96), -1);
        for (int b = 0; b < blocks; b++)
            run_block(b, 32 * MILLER_BLOCK_LANES, [&] {
                miller_step_kernel((int)in[0], qp, qn, p, f_in, t_in, out.data(),
                                   out.data() + lanes * 192, n);
            });
    } else if (!strcmp(mode, "fq12_exp")) {
        const long long* x = in.data();
        out.resize(192 * (size_t)n);
        for (int b = 0; b < n; b++)
            run_block(b, 32, [&] {
                fq12_exp_kernel(x, x + (size_t)n * 192, x + (size_t)n * 384, out.data(), n);
            });
    } else if (!strcmp(mode, "torsion")) {
        out.resize(n);
        for (int blk = 0; blk < (n + FOLD_LANES - 1) / FOLD_LANES; blk++)
            run_block(blk, FOLD_LANES * FOLD_GROUP,
                      [&] { g2_torsion_kernel(in.data(), out.data(), n); });
    } else if (!strncmp(mode, "add_complete_g", 14)) {
        const int limbs = mode[14] == '2' ? 32 : 16;
        out.resize((size_t)n * 3 * limbs);
        if (limbs == 32)
            add_complete_lanes<G2Field>(in.data(), in.data() + (size_t)n * 96, out.data(), n);
        else
            add_complete_lanes<G1Field>(in.data(), in.data() + (size_t)n * 48, out.data(), n);
    } else if (!strncmp(mode, "add_jacobian_g", 14)) {
        const int limbs = mode[14] == '2' ? 32 : 16;
        out.resize((size_t)n * 3 * limbs);
        if (limbs == 32)
            add_jacobian_lanes<G2Field>(in.data(), in.data() + (size_t)n * 96, out.data(), n);
        else
            add_jacobian_lanes<G1Field>(in.data(), in.data() + (size_t)n * 48, out.data(), n);
    } else if (!strncmp(mode, "msm_sum_g", 9)) {
        const bool g2 = mode[9] == '2';
        out.resize(g2 ? 64 : 32);
        if (g2) msm_sum<G2Field>(in.data(), out.data(), n);
        else msm_sum<G1Field>(in.data(), out.data(), n);
    } else if (!strncmp(mode, "miller", 6)) {
        const int pair = !strcmp(mode, "miller_pair");
        const int k = pair ? 2 : 1;
        const int blocks = (n + MILLER_BLOCK_LANES - 1) / MILLER_BLOCK_LANES;
        const long long* p = in.data();
        const long long* q = p + (size_t)n * 32;
        std::vector<long long> partials((size_t)blocks * k * MILLER_PARTIAL_LIMBS);
        out.resize(192 * (size_t)k);
        for (int b = 0; b < blocks; b++)
            run_block(b, 32 * MILLER_BLOCK_LANES,
                      [&] { miller_product_kernel(p, q, partials.data(), n, pair); });
        for (int b = 0; b < k; b++)
            run_block(b, 32 * MILLER_TREE_WARPS,
                      [&] { miller_tree_kernel(partials.data(), out.data(), blocks, pair); });
    } else {
        const bool g2 = mode[strlen(mode) - 1] == '2';
        const bool ladder = !strncmp(mode, "exp", 3);
        const int limbs = g2 ? 32 : 16;
        const long long* a = in.data();
        const long long* b = a + (size_t)n * 2 * limbs;
        const long long* bits = b + (size_t)n * 2 * limbs;
        out.resize((size_t)n * 2 * limbs);
        for (int blk = 0; blk < (n + FOLD_LANES - 1) / FOLD_LANES; blk++)
            run_block(blk, FOLD_LANES * FOLD_GROUP, [&] {
                if (ladder && g2) exp_kernel<G2Field>(a, b, bits, out.data(), n);
                else if (ladder) exp_kernel<G1Field>(a, b, bits, out.data(), n);
                else if (g2) fold_kernel<G2Field>(a, b, bits, out.data(), n);
                else fold_kernel<G1Field>(a, b, bits, out.data(), n);
            });
    }
    f = fopen(argv[4], "wb");
    fwrite(out.data(), 8, out.size(), f);
    fclose(f);
    return 0;
}
