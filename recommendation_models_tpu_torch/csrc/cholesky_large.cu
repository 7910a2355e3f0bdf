// Batched ridge-Cholesky solves of order 160 < k <= 656, one thread-block
// cluster a system, hand-written for Hopper (sm_90a). Built by nvcc into a
// shared library with a plain C interface and called through ctypes
// (recommendation_models_tpu_torch/ops/cholesky.py).
//
// Replaces the TPU kernels of recommendation_models_tpu/ops/pallas/cholesky.py
// in their single-block regime: _cholesky_solve_kernel_pair (and, with a
// second gram, _cholesky_solve_kernel_2g) through _cholesky_solve_t at a
// padded order kp > 160, where the reference's batch block is narrower than
// 128 lanes and its grid must be one block (pallas_supported: b <=
// block_batch(kp), 120 systems at kp = 168 down to 8 at kp = 656; halved
// with a second gram). The wrappers take this kernel exactly there.
//
// The design is csrc/cholesky_cluster.cuh's frame (a cluster of C CTAs a
// system, the factor in the cluster's distributed shared memory, a
// lookahead of one panel), with B1's order of terms (BLOCK): within a
// 32-column panel one term at a time, past it the panel's 32 products
// summed from 0 and then subtracted; the substitutions column-oriented,
// one term at a time. What bounds it is in that header.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_KMAX 656   // largest system order: the reference's budget cap
#include "cholesky_common.cuh"
#include "cholesky_cluster.cuh"

extern "C" {

// x (B, k) = (G [+ G2] + diag(reg))^-1 rhs for G (and G2, or null) (B, k, k),
// rhs (B, k), reg (B,), all f32, contiguous, batch-major; kq = k rounded up
// to a multiple of 32; C the CTAs of a system's cluster (1 <= C <= 16 and
// at most kq / 32; ops/cholesky.py::cluster_size), refused where a CTA's
// share of the factor does not fit in shared memory. 1 <= k <= 656 (the
// caller keeps B to the reference's one-block batch).
int cholesky_solve_large(const void* G, const void* G2, const void* rhs,
                         const void* reg, void* out, int B, int k, int kq,
                         int C, void* stream) {
    if (!clu::valid(B, k, kq, C)) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    clu::Args p;
    p.G = static_cast<const float*>(G);
    p.G2 = static_cast<const float*>(G2);
    p.rhs = static_cast<const float*>(rhs);
    p.reg = static_cast<const float*>(reg);
    p.out = static_cast<float*>(out);
    p.B = B;
    p.k = k;
    p.kq = kq;
    p.C = C;
    p.h = k / 2;
    auto s = static_cast<cudaStream_t>(stream);
    return (int)(G2 ? clu::launch<clu::BLOCK, 1, true>(p, s)
                    : clu::launch<clu::BLOCK, 1, false>(p, s));
}

// Clusters of C CTAs of the kernel at order k that the current card holds
// at once (cudaOccupancyMaxActiveClusters, asked once); an error where the
// share does not fit or no cluster can be placed. Launches nothing.
int cholesky_large_active_clusters(int k, int C, long long* active) {
    const int kq = (k + clu::NB - 1) / clu::NB * clu::NB;
    if (!clu::valid(0, k, kq, C)) return (int)cudaErrorInvalidValue;
    return (int)clu::active_clusters(
        reinterpret_cast<const void*>(
            clu::cluster_solve_kernel<clu::BLOCK, 1, false>),
        C, clu::smem_bytes(kq, C), active);
}

}  // extern "C"
