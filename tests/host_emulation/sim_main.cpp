// Runs K3's and K2's device code (fold.cu, fexp.cu) and fq_cc.cuh's Fq
// arithmetic on the CPU: see sim.h.
//
//   sim fq N in out       N pairs (a, b) of 16-limb Fq -> a*b, a+b, a-b, 1/a
//   sim fold_g1 N in out  lo, hi (N, 2, 16), bits (254,) -> (N, 2, 16)
//   sim fold_g2 N in out  lo, hi (N, 2, 2, 16), bits (254,) -> (N, 2, 2, 16)
//   sim fexp N in out     f (N, 2, 3, 2, 16) -> (N, 2, 3, 2, 16)
//
// in and out hold int64 limbs, C order, in the port's format.
#include "sim.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "fexp.cu"
#include "fold.cu"

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
            fq_mul_cc(r[0], a, b);
            fq_add_cc(r[1], a, b);
            fq_sub_cc(r[2], a, b);
            fq_inv_cc(r[3], a);
            for (int k = 0; k < 4; k++) fq_store(&out[64 * i + 16 * k], r[k]);
        }
    } else if (!strcmp(mode, "fexp")) {
        out.resize(192 * (size_t)n);
        for (int e = 0; e < n; e++)
            run_block(e, 32 * FEXP_WARPS, [&] { final_exp_kernel(in.data(), out.data()); });
    } else {
        const bool g2 = !strcmp(mode, "fold_g2");
        const int limbs = g2 ? 32 : 16;
        const long long* lo = in.data();
        const long long* hi = lo + (size_t)n * 2 * limbs;
        const long long* bits = hi + (size_t)n * 2 * limbs;
        out.resize((size_t)n * 2 * limbs);
        for (int b = 0; b < (n + FOLD_LANES - 1) / FOLD_LANES; b++)
            run_block(b, FOLD_LANES * FOLD_GROUP, [&] {
                if (g2) fold_kernel<G2cc>(lo, hi, bits, out.data(), n);
                else fold_kernel<G1cc>(lo, hi, bits, out.data(), n);
            });
    }
    f = fopen(argv[4], "wb");
    fwrite(out.data(), 8, out.size(), f);
    fclose(f);
    return 0;
}
