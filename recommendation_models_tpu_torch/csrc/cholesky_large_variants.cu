// Batched ridge-Cholesky solves of order 160 < k <= 656 with the factor and
// substitution schedules of the reference's non-default TPU variants, one
// thread-block cluster a system, hand-written for Hopper (sm_90a). Built by
// nvcc into a shared library with a plain C interface and called through
// ctypes (recommendation_models_tpu_torch/ops/cholesky.py).
//
// Replaces, in recommendation_models_tpu/ops/pallas/cholesky.py, at their
// single-block grid (a padded order kp > 160, where the reference's batch
// block is narrower than 128 lanes and must span the whole batch:
// pallas_supported, b <= block_batch(kp), 120 systems at kp = 168 down to 8
// from kp = 512 to 656); csrc/cholesky_rank_panel.cu takes kp <= 160:
//   RANK1 <SROWS>  <- _cholesky_solve_kernel (:198, pair=False; SROWS 1:
//                     _substitutions :812, 2: _substitutions_pair :749)
//   PAIR          <- its pair=True, subs2=False combination (fcols 2, srows 1)
//   PANEL         <- _cholesky_solve_kernel_panel (:107)
//   SCHUR <SROWS> <- _cholesky_solve_kernel_schur (:697; _factor_body_schur
//                     :429), k % 16 == 0
//   DUAL          <- _cholesky_solve_kernel_dual (:675;
//                     _factor_body_pair_multi :554,
//                     _substitutions_pair_multi :605)
//
// The design is csrc/cholesky_cluster.cuh's frame (a cluster of C CTAs a
// system, the factor in the cluster's distributed shared memory, a
// lookahead of one panel; csrc/cholesky_large.cu's B1 runs in it too), each
// schedule with its plain version's order of terms (`grouped` there). The
// dual schedule's two systems a block were the TPU's layout: here it is the
// rank-2 factor with two-row substitutions, one system a cluster. What
// bounds them is in that header.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_KMAX 656   // largest system order: the reference's budget cap
#include "cholesky_common.cuh"
#include "cholesky_cluster.cuh"

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major; kq = k rounded up to a multiple of 32;
// C the CTAs of a system's cluster (1 <= C <= 16 and at most kq / 32;
// ops/cholesky.py::cluster_size), refused where a CTA's share of the factor
// does not fit in shared memory; 1 <= k <= 656 (the caller keeps B to the
// reference's one-block batch). sched is csrc/cholesky_rank_panel.cu's
// code: 1 and 2 the rank-1 schedule's fcols (srows 1 or 2 at fcols 1, 1 at
// fcols 2), 8 the panel (srows 1), 16 Schur (k % 16 == 0, srows 1 or 2), 32
// dual (srows 2).
int cholesky_solve_variant_large(const void* G, const void* rhs,
                                 const void* reg, void* out, int B, int k,
                                 int kq, int C, int sched, int srows,
                                 void* stream) {
    using namespace clu;
    if (!valid(B, k, kq, C)) return (int)cudaErrorInvalidValue;
    if (sched == SCHUR && k % 16) return (int)cudaErrorInvalidValue;
    Args p;
    p.G = static_cast<const float*>(G);
    p.G2 = nullptr;
    p.rhs = static_cast<const float*>(rhs);
    p.reg = static_cast<const float*>(reg);
    p.out = static_cast<float*>(out);
    p.B = B;
    p.k = k;
    p.kq = kq;
    p.C = C;
    p.h = k / 2;
    cudaError_t (*run)(const Args&, cudaStream_t) =
        sched == RANK1 && srows == 1   ? launch<RANK1, 1, false>
        : sched == RANK1 && srows == 2 ? launch<RANK1, 2, false>
        : sched == PAIR && srows == 1  ? launch<PAIR, 1, false>
        : sched == PANEL && srows == 1 ? launch<PANEL, 1, false>
        : sched == SCHUR && srows == 1 ? launch<SCHUR, 1, false>
        : sched == SCHUR && srows == 2 ? launch<SCHUR, 2, false>
        : sched == DUAL && srows == 2  ? launch<DUAL, 2, false>
                                       : nullptr;
    if (!run) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    return (int)run(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
