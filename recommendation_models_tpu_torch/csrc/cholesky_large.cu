// Batched ridge-Cholesky solves of order 160 < k <= 656 in one block per
// system, hand-written for Hopper (sm_90a). Built by nvcc into a shared
// library with a plain C interface and called through ctypes
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
// Contract (as the other solves): f32 throughout, no tensor cores; the
// ridge added on load (A = G [+ G2] + reg_b I, the second gram summed in
// f32 on load); pivots clamped at max(d, 1e-30) (L_jj = d rsqrt(max(d,
// 1e-30)), the substitutions multiply by 1 / max(L_jj, 1e-30)), so
// identity-padded and all-zero systems with rhs 0 solve to exactly 0; no
// atomics and fixed orders, so a launch repeats bitwise.
//
// Design (a simple one that is right; clusters, TMA and wgmma are later
// work): one block of 256 threads per system (B <= 120: under one wave of
// 132 SMs). A lower triangle at k = 656 is 861 KB, beyond one block's 227
// KB of shared memory, so the factor lives in a global scratch (B, kq, kq),
// kq = k rounded up to the 32-column panel (identity on the padding), which
// the wrapper allocates and the L2 holds (8 x 1.8 MB at k = 656). The
// factor is right-looking in 32-column panels, three barriers each:
//   A. warp 0 factors the diagonal block column by column, a row a lane in
//      registers (the pivot and the column broadcast by shuffles), solves
//      the panel's rows of y against it (y rides along in shared memory) and
//      publishes the block to shared memory and the scratch;
//   B. each thread solves whole rows of the panel below the block against
//      it (32 values in registers), writes them to the scratch and to a
//      transposed copy of the panel in shared memory, and takes their terms
//      off its rows of y;
//   C. each warp updates whole 32 x 32 tiles of the trailing lower triangle,
//      A -= L21 L21^T, lane j holding column j of the tile and its 32 rank-32
//      sums, read from the panel copy (the tile's rows as broadcasts).
// The back substitution runs in 32-row blocks from the bottom: every warp
// sums the terms of its share of the rows below (the panel's columns of L,
// read as coalesced rows), warp 0 adds the partial sums in warp order and
// solves the block.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_KMAX 656   // largest system order: the reference's budget cap
#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;

constexpr int NB = 32;           // panel width (a warp's width)
constexpr int NTH = 256;         // threads per block
constexpr int WARPS = NTH / 32;

struct Args {
    const float* G;
    const float* G2;
    const float* rhs;
    const float* reg;
    float* scratch;
    float* out;
    int B, k, kq;
};

// rsqrt of a normal positive float (every pivot is clamped at 1e-30): the
// hardware's approximation, as rsqrtf gives it for such inputs.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// Dynamic shared memory: the panel's transposed copy (NB, kq), the
// diagonal block (NB, NB + 1), its inverse pivots (NB), y (kq), 1 / L_jj
// (kq) and the back substitution's per-warp sums (WARPS, NB).
size_t smem_bytes(int kq) {
    return sizeof(float) * ((size_t)NB * kq + NB * (NB + 1) + NB + 2 * kq
                            + WARPS * NB);
}

template <bool TWO_G>
__global__ void __launch_bounds__(NTH, 1) large_solve_kernel(const Args p) {
    extern __shared__ __align__(16) float smem[];
    const int k = p.k, kq = p.kq;
    float* PT = smem;                       // PT[c * kq + r] = L21[r][c]
    float* D = PT + NB * kq;                // D[r * (NB + 1) + c]
    float* pinv = D + NB * (NB + 1);        // rsqrt(max(d_c, floor))
    float* ys = pinv + NB;                  // y, then x
    float* rinv = ys + kq;                  // 1 / max(L_jj, floor)
    float* red = rinv + kq;                 // (WARPS, NB)
    constexpr int DL = NB + 1;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    float* A = p.scratch + (size_t)b * kq * kq;
    const float* Gb = p.G + (size_t)b * k * k;
    const float* G2b = TWO_G ? p.G2 + (size_t)b * k * k : nullptr;
    const float rb = p.reg[b];

    // A's lower triangle (the upper is never read), identity on the padding
    for (int i = warp; i < kq; i += WARPS) {
        for (int j = lane; j <= i; j += 32) {
            float v;
            if (i < k) {
                v = Gb[(size_t)i * k + j];
                if (TWO_G) v += G2b[(size_t)i * k + j];
                if (i == j) v += rb;
            } else {
                v = i == j ? 1.f : 0.f;
            }
            A[(size_t)i * kq + j] = v;
        }
    }
    for (int i = tid; i < kq; i += NTH) ys[i] = i < k ? p.rhs[(size_t)b * k + i]
                                                      : 0.f;
    __syncthreads();

    for (int j0 = 0; j0 < kq; j0 += NB) {
        const int r0 = j0 + NB;             // first row below the panel
        const int nr = kq - r0;             // rows below the panel
        // A. the diagonal block, its factor, and the panel's y. Lane r holds
        // row r of the block in registers; column c's step broadcasts the
        // pivot and each L[s][c] by shuffles (the rank-1 step's arithmetic).
        if (warp == 0) {
            const float* Ar = A + (size_t)(j0 + lane) * kq + j0;
            float row[NB];
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                const float4 q = *reinterpret_cast<const float4*>(Ar + c);
                row[c] = c <= lane ? q.x : 0.f;
                row[c + 1] = c + 1 <= lane ? q.y : 0.f;
                row[c + 2] = c + 2 <= lane ? q.z : 0.f;
                row[c + 3] = c + 3 <= lane ? q.w : 0.f;
            }
            float t = ys[j0 + lane];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                const float d = __shfl_sync(0xffffffffu, row[c], c);
                const float inv = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
                const float ljj = d * inv;
                const float rj = __frcp_rn(fmaxf(ljj, PIVOT_FLOOR));
                const float l = row[c] * inv;       // L[lane][c], lane > c
                if (lane == c) {
                    row[c] = ljj;
                    pinv[c] = inv;
                    rinv[j0 + c] = rj;
                } else if (lane > c) {
                    row[c] = l;
                }
#pragma unroll
                for (int s = c + 1; s < NB; ++s) {
                    const float ls = __shfl_sync(0xffffffffu, l, s);
                    if (lane >= s) row[s] = fmaf(-l, ls, row[s]);
                }
            }
            // the panel's forward substitution against the block
            __syncwarp();
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                const float yc = __shfl_sync(0xffffffffu, t, c)
                                 * rinv[j0 + c];
                if (lane == c) t = yc;
                else if (lane > c) t = fmaf(-row[c], yc, t);
            }
            ys[j0 + lane] = t;
            float* Aw = A + (size_t)(j0 + lane) * kq + j0;
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                *reinterpret_cast<float4*>(Aw + c)
                    = make_float4(row[c], row[c + 1], row[c + 2], row[c + 3]);
                D[lane * DL + c] = row[c];
                D[lane * DL + c + 1] = row[c + 1];
                D[lane * DL + c + 2] = row[c + 2];
                D[lane * DL + c + 3] = row[c + 3];
            }
        }
        __syncthreads();
        if (nr == 0) break;
        // B. the panel's rows below the block: l = a L11^-T, row by row
        for (int r = tid; r < nr; r += NTH) {
            float* Ar = A + (size_t)(r0 + r) * kq + j0;
            float l[NB];
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                const float4 q = *reinterpret_cast<const float4*>(Ar + c);
                l[c] = q.x; l[c + 1] = q.y; l[c + 2] = q.z; l[c + 3] = q.w;
            }
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                float v = l[c];
#pragma unroll
                for (int s = 0; s < c; ++s) v = fmaf(-l[s], D[c * DL + s], v);
                l[c] = v * pinv[c];
            }
            float yr = ys[r0 + r];
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                *reinterpret_cast<float4*>(Ar + c)
                    = make_float4(l[c], l[c + 1], l[c + 2], l[c + 3]);
            }
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                PT[c * kq + r] = l[c];
                yr = fmaf(-l[c], ys[j0 + c], yr);
            }
            ys[r0 + r] = yr;
        }
        __syncthreads();
        // C. the trailing lower triangle, a warp per 32 x 32 tile
        const int nt = nr / NB;
        const int ntiles = nt * (nt + 1) / 2;
        for (int t = warp; t < ntiles; t += WARPS) {
            int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
            while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
            while (ti * (ti + 1) / 2 > t) --ti;
            const int tj = t - ti * (ti + 1) / 2;
            float acc[NB];
#pragma unroll
            for (int r = 0; r < NB; ++r) acc[r] = 0.f;
#pragma unroll 4
            for (int c = 0; c < NB; ++c) {
                const float lj = PT[c * kq + tj * NB + lane];
                const float4* li = reinterpret_cast<const float4*>(
                    PT + c * kq + ti * NB);
#pragma unroll
                for (int r = 0; r < NB; r += 4) {
                    const float4 q = li[r >> 2];
                    acc[r] = fmaf(q.x, lj, acc[r]);
                    acc[r + 1] = fmaf(q.y, lj, acc[r + 1]);
                    acc[r + 2] = fmaf(q.z, lj, acc[r + 2]);
                    acc[r + 3] = fmaf(q.w, lj, acc[r + 3]);
                }
            }
            float* At = A + (size_t)(r0 + ti * NB) * kq + r0 + tj * NB + lane;
            const bool diag = ti == tj;
#pragma unroll
            for (int r = 0; r < NB; ++r)
                if (!diag || lane <= r) At[(size_t)r * kq] -= acc[r];
        }
        __syncthreads();
    }

    // the back substitution L^T x = y, 32 rows a step from the bottom
    for (int j0 = kq - NB; j0 >= 0; j0 -= NB) {
        float acc = 0.f;
        for (int j = j0 + NB + warp; j < kq; j += WARPS)
            acc = fmaf(A[(size_t)j * kq + j0 + lane], ys[j], acc);
        red[warp * NB + lane] = acc;
        __syncthreads();
        if (warp == 0) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += red[w * NB + lane];
            // column `lane` of the diagonal block: L[j0 + c][j0 + lane]
            float lc[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c)
                lc[c] = A[(size_t)(j0 + c) * kq + j0 + lane];
            float t = ys[j0 + lane] - s;
#pragma unroll
            for (int c = NB - 1; c >= 0; --c) {
                const float xc = __shfl_sync(0xffffffffu, t, c)
                                 * rinv[j0 + c];
                if (lane == c) t = xc;
                else if (lane < c) t = fmaf(-lc[c], xc, t);
            }
            ys[j0 + lane] = t;
        }
        __syncthreads();
    }
    for (int i = tid; i < k; i += NTH) p.out[(size_t)b * k + i] = ys[i];
}

template <bool TWO_G>
cudaError_t launch(const Args& p, cudaStream_t stream) {
    const size_t smem = smem_bytes(p.kq);
    const auto kern = large_solve_kernel<TWO_G>;
    // sets the kernel's shared-memory attributes once per device (cached)
    long long resident = 0;
    const cudaError_t err = chol::resident_blocks(
        reinterpret_cast<const void*>(kern), NTH, smem, &resident);
    if (err != cudaSuccess) return err;
    kern<<<p.B, NTH, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, k) = (G [+ G2] + diag(reg))^-1 rhs for G (and G2, or null) (B, k, k),
// rhs (B, k), reg (B,), all f32, contiguous, batch-major; scratch (B, kq,
// kq) f32 with kq = k rounded up to a multiple of 32. 1 <= k <= 656, one
// block a system (the caller keeps B to the reference's one-block batch).
int cholesky_solve_large(const void* G, const void* G2, const void* rhs,
                         const void* reg, void* scratch, void* out, int B,
                         int k, int kq, void* stream) {
    if (k < 1 || k > KMAX || B < 0 || kq != (k + NB - 1) / NB * NB)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if ((((uintptr_t)scratch) & 15) != 0) return (int)cudaErrorInvalidValue;
    Args p;
    p.G = static_cast<const float*>(G);
    p.G2 = static_cast<const float*>(G2);
    p.rhs = static_cast<const float*>(rhs);
    p.reg = static_cast<const float*>(reg);
    p.scratch = static_cast<float*>(scratch);
    p.out = static_cast<float*>(out);
    p.B = B;
    p.k = k;
    p.kq = kq;
    auto s = static_cast<cudaStream_t>(stream);
    return (int)(G2 ? launch<true>(p, s) : launch<false>(p, s));
}

}  // extern "C"
