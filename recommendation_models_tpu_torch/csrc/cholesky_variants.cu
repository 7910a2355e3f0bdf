// Batched ridge-Cholesky solves with the factor schedules of the reference's
// non-default TPU variants, hand-written for Hopper (sm_90a). Built by nvcc
// into a shared library with a plain C interface and called through ctypes
// (recommendation_models_tpu_torch/ops/cholesky.py).
//
// Replaces two TPU kernels of recommendation_models_tpu/ops/pallas/cholesky.py
// (the rank-1 and panel variants are in csrc/cholesky_rank_panel.cu):
//   cholesky_solve_schur <SROWS>       <- _cholesky_solve_kernel_schur
//       (_factor_body_schur; k % 16 == 0)
//   cholesky_solve_dual                <- _cholesky_solve_kernel_dual
//       (_factor_body_pair_multi, _substitutions_pair_multi)
//
// Contract (as csrc/cholesky_solve.cu): f32 throughout, no TF32 and no
// tensor cores; the ridge is added on load (A = G + reg_b I); pivots are
// clamped at max(d, 1e-30) (L_jj = d * rsqrt(max(d, 1e-30)), substitutions
// multiply by 1 / max(L_jj, 1e-30)), so identity-padded and all-zero systems
// with rhs 0 solve to exactly 0. G (B, k, k), rhs (B, k), reg (B,), batch
// major; 1 <= k <= 128.
//
// What bounds them on an H100: the work is the plain solve's. At k = 64 a
// system must read 8.6 KB (the lower triangle of G, rhs, reg) for ~0.1
// MFLOP, so the bound is device-memory bytes; at k = 128 it is ~0.73 MFLOP
// for 34 KB, and f32 operations bound it. In practice every schedule is a
// chain of dependent steps separated by block barriers, and its latency
// per system, hidden only by the other resident blocks, sets the time. The
// schedules differ exactly in that chain, which is why each is kept:
//   schur: h = k/2. Phase 1 runs rank-2 steps over columns [0, h) that
//       update only the tiles left of column h; phase 2 applies the deferred
//       A22 -= L21 L21^T in rank-8 groups read from L in shared memory, with
//       no barrier and no dependency between groups; phase 3 runs rank-2
//       steps over [h, k).
//   dual: two systems per block, their rank-2 chains interleaved. Every
//       thread owns the same tiles of both systems; each step publishes both
//       systems' column pairs, takes one barrier, and applies both rank-2
//       updates back to back, so a thread carries two independent FMA chains
//       and a system pays half a barrier per two columns. Then warp 0 and
//       warp 1 run the two systems' two-row substitutions side by side. The
//       cost is residency: a block holds two systems' L, so at k = 128 one
//       block (two systems) fits an SM where the pair kernel fits three.
//
// Design (shared): one block per system (dual: per two) on a persistent
// grid (grid = resident blocks). Each thread owns 4x4 tiles of the lower
// triangle of A in registers (160 threads and one tile at k <= 68, else 256
// threads and up to three; cholesky_common.cuh); G tiles load as 16-byte
// vectors. L goes to shared memory as it is
// produced. Unlike csrc/cholesky_solve.cu the forward substitution is not
// folded into the factor: after it, one warp runs the forward and the back
// substitution as their own phases, with the right-hand side in registers
// (lane l holds rows l, l+32, l+64, l+96) and SROWS rows per shuffle round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;
using chol::pick4;

constexpr int PW = 8;       // the Schur phase's group width

enum Sched { SCHUR = 16, DUAL = 32 };

// Threads own the lower-triangle 4x4 tiles (ti >= tl) only: the updates are
// symmetric, and the substitutions read L's lower half. Tile t = tid + n NTH
// of the T (T + 1) / 2 tiles, in row order, is thread tid's n-th.
template <int NTH, int NT>
__device__ __forceinline__ void own_tiles(int tid, int T, int (&ti)[NT],
                                          int (&tl)[NT], bool (&live)[NT]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int t = tid + n * NTH;
        live[n] = t < T * (T + 1) / 2;
        int r = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while ((r + 1) * (r + 2) / 2 <= t) ++r;
        while (r * (r + 1) / 2 > t) --r;
        ti[n] = live[n] ? r : 0;
        tl[n] = live[n] ? t - r * (r + 1) / 2 : 0;
    }
}

// Row i, columns l0 .. l0 + 3 of G, zero past k; 16-byte loads when vec.
__device__ __forceinline__ void load_row4(const float* Gb, int i, int l0,
                                          int k, int vec, float (&v)[4]) {
    if (vec && l0 < k) {
        const float4 q = *reinterpret_cast<const float4*>(
            Gb + (size_t)i * k + l0);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int s = 0; s < 4; ++s)
            if (l0 + s < k) v[s] = Gb[(size_t)i * k + l0 + s];
    }
}

__device__ __forceinline__ float sel4(float y0, float y1, float y2, float y3,
                                      int q) {
    return q == 0 ? y0 : q == 1 ? y1 : q == 2 ? y2 : y3;
}

// Per-thread view of the block: its tiles, and the shared buffers.
template <int NT>
struct Block {
    int ti[NT], tl[NT];
    bool live[NT];
    float a[NT][4][4];
    float* colbuf;   // (2 sets, 2 columns, kp + 4): columns, pivot in [kp]
    float* As;       // (kp, kp + 1): L, lower half
    float* ys;       // (kp,): rhs, then y, then x
    float* rinv;     // (kp,): 1 / max(L_jj, floor)
    int k, kp, ld, bs, tid, step;
};

// Owners of column j write A[i][j] for rows i > j into buf (0 for rows
// <= j) and the pivot A[j][j] into buf[kp].
template <int NT>
__device__ __forceinline__ void publish(const Block<NT>& s, int j,
                                        float* buf) {
    const int jt = j >> 2, jj = j & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (s.live[n] && s.tl[n] == jt) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = s.ti[n] * 4 + r;
                const float v = pick4(s.a[n][r], jj);
                buf[i] = i > j ? v : 0.f;
                if (i == j) buf[s.kp] = v;
            }
        }
    }
}

__device__ __forceinline__ void write_pivot(float* As, float* rinv, int ld,
                                            int j, float d, float inv) {
    const float ljj = d * inv;
    As[j * ld + j] = ljj;
    rinv[j] = 1.f / fmaxf(ljj, PIVOT_FLOOR);
}

// One right-looking column step: publish column j (begin1), one barrier,
// then write L[:, j] and apply the rank-1 update to the tiles with tile
// column < tl_end (finish1).
template <int NT>
__device__ __forceinline__ const float* begin1(Block<NT>& s, int j) {
    float* buf = s.colbuf + (s.step++ & 1) * 2 * s.bs;
    publish(s, j, buf);
    return buf;
}

template <int NT>
__device__ __forceinline__ void finish1(Block<NT>& s, int j, int tl_end,
                                        const float* buf) {
    const float d = buf[s.kp];
    const float inv = rsqrtf(fmaxf(d, PIVOT_FLOOR));
    const float inv2 = inv * inv;
    if (s.tid < s.k && s.tid >= j) {
        if (s.tid == j) write_pivot(s.As, s.rinv, s.ld, j, d, inv);
        else s.As[s.tid * s.ld + j] = buf[s.tid] * inv;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n] || s.tl[n] >= tl_end) continue;
        const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
        if (l0 + 3 > j) {   // the tile still has trailing columns
            const float4 qi = *reinterpret_cast<const float4*>(buf + i0);
            const float4 ql = *reinterpret_cast<const float4*>(buf + l0);
            const float ci[4] = {qi.x * inv2, qi.y * inv2, qi.z * inv2,
                                 qi.w * inv2};
            const float cl[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s.a[n][r][c] = fmaf(-ci[r], cl[c], s.a[n][r][c]);
        }
    }
}

// One rank-2 step over columns (j, j + 1), j even: both columns are
// published raw (begin2), one barrier; then every thread derives L[:, j]
// and, corrected by it, L[:, j+1], writes its row of both, and applies the
// rank-2 update to the tiles with tile column < tl_end (finish2). (j and
// j + 1 share a tile column.)
template <int NT>
__device__ __forceinline__ const float* begin2(Block<NT>& s, int j) {
    float* b1 = s.colbuf + (s.step++ & 1) * 2 * s.bs;
    publish(s, j, b1);
    publish(s, j + 1, b1 + s.bs);
    return b1;
}

template <int NT>
__device__ __forceinline__ void finish2(Block<NT>& s, int j, int tl_end,
                                        const float* b1) {
    const float* b2 = b1 + s.bs;
    const float d1 = b1[s.kp];
    const float inv1 = rsqrtf(fmaxf(d1, PIVOT_FLOOR));
    const float l12 = b1[j + 1] * inv1;             // L[j+1][j]
    const float d2 = fmaf(-l12, l12, b2[s.kp]);
    const float inv2 = rsqrtf(fmaxf(d2, PIVOT_FLOOR));
    if (s.tid < s.k && s.tid >= j) {
        const int i = s.tid;
        if (i == j) {
            write_pivot(s.As, s.rinv, s.ld, j, d1, inv1);
        } else {
            const float c1 = b1[i] * inv1;
            s.As[i * s.ld + j] = c1;
            if (i == j + 1) write_pivot(s.As, s.rinv, s.ld, j + 1, d2, inv2);
            else s.As[i * s.ld + j + 1] = fmaf(-c1, l12, b2[i]) * inv2;
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n] || s.tl[n] >= tl_end) continue;
        const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
        if (l0 + 3 > j) {
            const float4 p1 = *reinterpret_cast<const float4*>(b1 + i0);
            const float4 p2 = *reinterpret_cast<const float4*>(b2 + i0);
            const float4 q1 = *reinterpret_cast<const float4*>(b1 + l0);
            const float4 q2 = *reinterpret_cast<const float4*>(b2 + l0);
            const float r1[4] = {p1.x, p1.y, p1.z, p1.w};
            const float r2[4] = {p2.x, p2.y, p2.z, p2.w};
            const float s1[4] = {q1.x, q1.y, q1.z, q1.w};
            const float s2[4] = {q2.x, q2.y, q2.z, q2.w};
            float ci1[4], ci2[4], cl1[4], cl2[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                ci1[r] = r1[r] * inv1;
                ci2[r] = i0 + r > j + 1 ? fmaf(-ci1[r], l12, r2[r]) * inv2
                                        : 0.f;
                cl1[r] = s1[r] * inv1;
                cl2[r] = l0 + r > j + 1 ? fmaf(-cl1[r], l12, s2[r]) * inv2
                                        : 0.f;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    s.a[n][r][c] = fmaf(-ci2[r], cl2[c],
                                        fmaf(-ci1[r], cl1[c], s.a[n][r][c]));
        }
    }
}

template <int NT>
__device__ __forceinline__ void step2(Block<NT>& s, int j, int tl_end) {
    const float* b1 = begin2(s, j);
    __syncthreads();
    finish2(s, j, tl_end, b1);
}

// Two systems' rank-2 factors, interleaved: one barrier per step for both
// (an odd k ends on one rank-1 step, as the pair schedule does).
template <int NT>
__device__ __forceinline__ void factor_dual(Block<NT>& s0, Block<NT>& s1) {
    const int T = s0.kp / 4;
    int j = 0;
    for (; j + 1 < s0.k; j += 2) {
        const float* b0 = begin2(s0, j);
        const float* b1 = begin2(s1, j);
        __syncthreads();
        finish2(s0, j, T, b0);
        finish2(s1, j, T, b1);
    }
    if (j < s0.k) {
        const float* b0 = begin1(s0, j);
        const float* b1 = begin1(s1, j);
        __syncthreads();
        finish1(s0, j, T, b0);
        finish1(s1, j, T, b1);
    }
}

// Two-level Schur factor (see the header); k % 16 == 0, so kp == k.
template <int NT>
__device__ __forceinline__ void factor_schur(Block<NT>& s) {
    const int h = s.k / 2, ht = h / 4, T = s.kp / 4;
    for (int j = 0; j < h; j += 2) step2(s, j, ht);
    __syncthreads();   // L21 is complete in As
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (!s.live[n] || s.ti[n] < ht || s.tl[n] < ht) continue;
        const int i0 = s.ti[n] * 4, l0 = s.tl[n] * 4;
        for (int g = 0; g < h; g += PW) {
            float acc[4][4] = {};
#pragma unroll
            for (int p = g; p < g + PW; ++p) {
                float li[4], ll[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    li[r] = s.As[(i0 + r) * s.ld + p];
                    ll[r] = s.As[(l0 + r) * s.ld + p];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[r][c] = fmaf(li[r], ll[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) s.a[n][r][c] -= acc[r][c];
        }
    }
    for (int j = h; j < s.k; j += 2) step2(s, j, T);
}

// Forward (L y = b) and back (L^T x = y) substitution in one warp, SROWS
// rows per shuffle round; b arrives in ys, x leaves in out.
template <int SROWS>
__device__ __forceinline__ void substitute(const float* As,
                                           const float* rinv,
                                           const float* ys, float* ob, int k,
                                           int kp, int ld, int lane) {
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        y[q] = lane + 32 * q < kp ? ys[lane + 32 * q] : 0.f;
    int j = 0;
    if (SROWS == 2) {
#pragma unroll 1
        for (; j + 1 < k; j += 2) {
            const int q0 = j >> 5, q1 = (j + 1) >> 5;
            const float bj = __shfl_sync(
                0xffffffffu, sel4(y[0], y[1], y[2], y[3], q0), j & 31);
            const float bj1 = __shfl_sync(
                0xffffffffu, sel4(y[0], y[1], y[2], y[3], q1), (j + 1) & 31);
            const float yj = bj * rinv[j];
            const float yj1 = fmaf(-As[(j + 1) * ld + j], yj, bj1)
                              * rinv[j + 1];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = lane + 32 * q;
                if (i == j) y[q] = yj;
                else if (i == j + 1) y[q] = yj1;
                else if (i > j + 1 && i < k)
                    y[q] = fmaf(-As[i * ld + j + 1], yj1,
                                fmaf(-As[i * ld + j], yj, y[q]));
            }
        }
    }
#pragma unroll 1
    for (; j < k; ++j) {
        const float yj = __shfl_sync(
            0xffffffffu, sel4(y[0], y[1], y[2], y[3], j >> 5), j & 31)
            * rinv[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = lane + 32 * q;
            if (i == j) y[q] = yj;
            else if (i > j && i < k) y[q] = fmaf(-As[i * ld + j], yj, y[q]);
        }
    }
    // back substitution: row j of L is column j of L^T
    j = k - 1;
    if (SROWS == 2) {
#pragma unroll 1
        for (; j >= 1; j -= 2) {
            const int q0 = j >> 5, q1 = (j - 1) >> 5;
            const float xj = __shfl_sync(
                0xffffffffu, sel4(y[0], y[1], y[2], y[3], q0), j & 31)
                * rinv[j];
            const float yj1 = __shfl_sync(
                0xffffffffu, sel4(y[0], y[1], y[2], y[3], q1), (j - 1) & 31);
            const float xj1 = fmaf(-As[j * ld + j - 1], xj, yj1)
                              * rinv[j - 1];
            const float* Lj = As + j * ld;
            const float* Lj1 = As + (j - 1) * ld;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = lane + 32 * q;
                if (i == j) y[q] = xj;
                else if (i == j - 1) y[q] = xj1;
                else if (i < j - 1)
                    y[q] = fmaf(-Lj1[i], xj1, fmaf(-Lj[i], xj, y[q]));
            }
        }
    }
#pragma unroll 1
    for (; j >= 0; --j) {
        const float xj = __shfl_sync(
            0xffffffffu, sel4(y[0], y[1], y[2], y[3], j >> 5), j & 31)
            * rinv[j];
        const float* Lj = As + j * ld;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = lane + 32 * q;
            if (i == j) y[q] = xj;
            else if (i < j) y[q] = fmaf(-Lj[i], xj, y[q]);
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (lane + 32 * q < k) ob[lane + 32 * q] = y[q];
}

// Shared-memory floats of one system's buffers: the column buffers, L, y
// and 1 / L_jj. A multiple of 4, so every system's buffers stay 16-byte
// aligned.
__host__ __device__ inline size_t system_floats(int kp) {
    return 4 * (size_t)(kp + 4) + (size_t)kp * (kp + 1) + 2 * (size_t)kp;
}

template <int NT>
__device__ __forceinline__ void init_block(Block<NT>& s, float* base, int k,
                                           int kp) {
    s.k = k;
    s.kp = kp;
    s.ld = kp + 1;
    s.bs = kp + 4;
    s.tid = threadIdx.x;
    s.colbuf = base;
    s.As = base + 4 * s.bs;
    s.ys = s.As + kp * s.ld;
    s.rinv = s.ys + kp;
}

// Loads system b into s's tiles (A = G + reg_b I, identity on the padding)
// and its rhs into s.ys; a slot past the batch (present = false: the dual
// kernel's second slot when B is odd) loads the identity and rhs 0.
template <int NT>
__device__ __forceinline__ void load_system(Block<NT>& s, const float* G,
                                            const float* rhs,
                                            const float* reg, int b,
                                            bool present, int vec) {
    const int k = s.k;
    const float* Gb = G + (size_t)b * k * k;
    const float rb = present ? reg[b] : 1.f;
    s.step = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = s.ti[n] * 4 + r;
            const int l0 = s.tl[n] * 4;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (present && s.live[n] && i < k)
                load_row4(Gb, i, l0, k, vec, v);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int l = l0 + c;
                // identity on the padding rows/cols beyond k keeps the
                // padded block decoupled
                float x = v[c];
                if (i == l) x += (i < k) ? rb : 1.f;
                s.a[n][r][c] = x;
            }
        }
    }
    if (s.tid < s.kp)
        s.ys[s.tid] = present && s.tid < k ? rhs[(size_t)b * k + s.tid]
                                           : 0.f;
}

// NTH threads per block, NT lower-triangle tiles per thread (per system);
// SCHED picks the factor schedule, SROWS the substitutions' rows per step.
template <int NTH, int NT, int SCHED, int SROWS>
__global__ void __launch_bounds__(NTH)
variant_kernel(const float* __restrict__ G, const float* __restrict__ rhs,
               const float* __restrict__ reg, float* __restrict__ out, int B,
               int k, int kp, int vec) {
    constexpr int NS = SCHED == DUAL ? 2 : 1;   // systems per block
    extern __shared__ __align__(16) float smem[];
    Block<NT> s0, s1;
    init_block(s0, smem, k, kp);
    const int T = kp >> 2;
    own_tiles<NTH, NT>(s0.tid, T, s0.ti, s0.tl, s0.live);
    if constexpr (NS == 2) {
        init_block(s1, smem + system_floats(kp), k, kp);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            s1.ti[n] = s0.ti[n];
            s1.tl[n] = s0.tl[n];
            s1.live[n] = s0.live[n];
        }
    }
    const int warp = s0.tid >> 5, lane = s0.tid & 31;
    const int slots = (B + NS - 1) / NS;

    for (int p = blockIdx.x; p < slots; p += gridDim.x) {
        // the previous systems' substitutions are done with As/ys
        __syncthreads();
        const int b0 = p * NS, b1 = b0 + 1;
        load_system(s0, G, rhs, reg, b0, true, vec);
        if constexpr (NS == 2)
            load_system(s1, G, rhs, reg, b1, b1 < B, vec);

        if constexpr (SCHED == SCHUR) {
            factor_schur(s0);
        } else {
            factor_dual(s0, s1);
        }
        __syncthreads();
        if (warp == 0)
            substitute<SROWS>(s0.As, s0.rinv, s0.ys, out + (size_t)b0 * k, k,
                              kp, s0.ld, lane);
        if constexpr (NS == 2) {
            if (warp == 1 && b1 < B)
                substitute<SROWS>(s1.As, s1.rinv, s1.ys,
                                  out + (size_t)b1 * k, k, kp, s1.ld, lane);
        }
    }
}

template <int NTH, int NT, int SCHED, int SROWS>
cudaError_t launch(const float* G, const float* rhs, const float* reg,
                   float* out, int B, int k, int kp, int vec,
                   cudaStream_t stream) {
    constexpr int NS = SCHED == DUAL ? 2 : 1;
    const size_t smem = sizeof(float) * NS * system_floats(kp);
    return chol::launch_persistent(variant_kernel<NTH, NT, SCHED, SROWS>, NTH,
                                   smem, (B + NS - 1) / NS, stream, G, rhs,
                                   reg, out, B, k, kp, vec);
}

template <int SCHED, int SROWS>
cudaError_t dispatch(const void* G, const void* rhs, const void* reg,
                     void* out, int B, int k, void* stream) {
    if (k < 1 || k > KMAX || B < 0) return cudaErrorInvalidValue;
    if (SCHED == SCHUR && k % 16) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const int kp = (k + 3) & ~3;
    const int vec = (k % 4 == 0) && (((uintptr_t)G & 15) == 0);
    auto g = static_cast<const float*>(G);
    auto r = static_cast<const float*>(rhs);
    auto rg = static_cast<const float*>(reg);
    auto o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (chol::tile_config(k)) {
    case 0: return launch<160, 1, SCHED, SROWS>(g, r, rg, o, B, k, kp, vec, s);
    case 1: return launch<256, 1, SCHED, SROWS>(g, r, rg, o, B, k, kp, vec, s);
    case 2: return launch<256, 2, SCHED, SROWS>(g, r, rg, o, B, k, kp, vec, s);
    default: return launch<256, 3, SCHED, SROWS>(g, r, rg, o, B, k, kp, vec, s);
    }
}

}  // namespace

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major, k % 16 == 0, k <= 128: the two-level
// Schur factor and srows (1 or 2) rows per substitution step.
int cholesky_solve_schur(const void* G, const void* rhs, const void* reg,
                         void* out, int B, int k, int srows, void* stream) {
    if (srows == 1)
        return (int)dispatch<SCHUR, 1>(G, rhs, reg, out, B, k, stream);
    if (srows == 2)
        return (int)dispatch<SCHUR, 2>(G, rhs, reg, out, B, k, stream);
    return (int)cudaErrorInvalidValue;
}

// The same solve for two systems per block, their rank-2 factors
// interleaved, with two-row substitutions. Any B (an odd B leaves the last
// block's second slot empty).
int cholesky_solve_dual(const void* G, const void* rhs, const void* reg,
                        void* out, int B, int k, void* stream) {
    return (int)dispatch<DUAL, 2>(G, rhs, reg, out, B, k, stream);
}

// (cholesky_kernel_kmax and cholesky_error_string: cholesky_common.cuh)

}  // extern "C"
