// Batched ridge-Cholesky solves of order 160 < k <= 656 with the factor and
// substitution schedules of the reference's non-default TPU variants, one
// block per system (two for the dual schedule), hand-written for Hopper
// (sm_90a). Built by nvcc into a shared library with a plain C interface
// and called through ctypes (recommendation_models_tpu_torch/ops/cholesky.py).
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
// Contract (as the other solves): f32 throughout, no TF32 and no tensor
// cores; the ridge added on load (A = G + reg_b I); pivots clamped at
// max(d, 1e-30) (L_jj = d rsqrt(max(d, 1e-30)), the substitutions multiply
// by 1 / max(L_jj, 1e-30)), so identity-padded and all-zero systems with
// rhs 0 solve to exactly 0; no atomics and fixed orders, so a launch
// repeats bitwise.
//
// The frame is csrc/cholesky_large.cu's (B1's one-block kernel, which this
// source leaves alone): 256 threads a system; a lower triangle at k = 656
// (861 KB) is beyond a block's 227 KB, so the factor lives in a global
// scratch (B, kq, kq), kq = k rounded up to 32 (identity on the padding),
// which the wrapper allocates and the L2 holds; right-looking in 32-column
// panels, three barriers each (A: warp w factors the diagonal block of
// system w in registers and solves the panel's y; B: a thread a row below
// it; C: a warp a 32 x 32 tile of the trailing triangle). So the scratch
// moves about as B1's does (the trailing triangle read and written once a
// panel, ~12 MB a system at k = 656), where one pass over it a column, as
// the reference's schedule reads literally, would move ~32x that.
//
// What makes each schedule its own is the order in which every element
// takes its terms, which is its plain version's (ops/cholesky.py), and
// that order is independent of the memory passes: element (i, l) takes the
// terms L_ip L_lp of the columns p < l in increasing p, each either alone
// (subtracted and rounded in turn: the rank-1 and rank-2 steps) or inside
// the sum of its aligned 8-column group (the group's eight products summed
// from 0 in order, then subtracted: the panel's rank-8 update, the Schur
// factor's deferred A22 -= L21 L21^T groups). Which, is `grouped` below:
//   RANK1, PAIR, DUAL: every term alone;
//   PANEL: a term alone within its own 8-column panel (the left-looking
//          panel factor), in its group's sum past it;
//   SCHUR: in its group's sum where l >= h = k / 2 > p (A22's deferred
//          update), else alone (the two rank-2 phases).
// Phases A, B and C each apply the terms of their panel in that order; the
// rank-2 schedules (PAIR, SCHUR, DUAL) factor the diagonal block and the
// rows below two columns a step (L[i][j+1] = (A[i][j+1] - L[i][j]
// L[j+1][j]) / L[j+1][j+1]), the others a column. The forward substitution
// rides the factor (y_i takes y_j's terms in increasing j), the back
// substitution runs in 32-row blocks from the bottom (warp w solves the
// block, SROWS rows a shuffle round, then every row above takes the block's
// terms in decreasing j), so each y_i takes its terms one at a time, in the
// order of the plain version's column-oriented substitutions. DUAL's block
// carries two systems (2 p, 2 p + 1): every phase works on both, so each
// barrier serves the two chains (an odd B leaves the last block one
// system).
//
// What bounds them on an H100: at k = 656 a system needs 95 MFLOP and
// 0.86 MB, so f32 operations bound a batch of 8 at 0.011 ms; the chain of
// 21 panels, each a serial diagonal factor in one warp and three block
// barriers, on one SM a system, sets the time instead (as B1's one-block
// kernel: PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define CHOL_KMAX 656   // largest system order: the reference's budget cap
#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;

constexpr int NB = 32;           // panel width (a warp's width)
constexpr int GW = 8;            // the panel and Schur schedules' group
constexpr int NTH = 256;         // threads per block
constexpr int WARPS = NTH / 32;
constexpr int DL = NB + 1;       // the diagonal block's row stride

// the factor schedules (csrc/cholesky_rank_panel.cu's codes)
enum Sched { RANK1 = 1, PAIR = 2, PANEL = 8, SCHUR = 16, DUAL = 32 };

__host__ __device__ constexpr int systems(int sched) {
    return sched == DUAL ? 2 : 1;
}
// columns a factor step: the rank-2 schedules take two
__host__ __device__ constexpr int fcols(int sched) {
    return sched == RANK1 || sched == PANEL ? 1 : 2;
}

struct Args {
    const float* G;
    const float* rhs;
    const float* reg;
    float* scratch;
    float* out;
    int B, k, kq, h;
};

// rsqrt of a normal positive float (every pivot is clamped at 1e-30): the
// hardware's approximation, as rsqrtf gives it for such inputs.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// Whether column l takes the terms of the panel's column j0 + c (c < 32,
// j0 + c < l) inside the sum of their aligned 8-column group (else one term
// at a time). For PANEL only the group's place against l's counts, and it
// is written with the panel's own offsets, which the compiler folds.
template <int SCHED>
__device__ __forceinline__ bool grouped(int j0, int c, int l, int h) {
    if (SCHED == PANEL) return (c >> 3) < ((l - j0) >> 3);
    if (SCHED == SCHUR) return l >= h && j0 + c < h;
    return false;
}

// Dynamic shared memory of one system, in floats: the panel's transposed
// copy (NB, kq), the diagonal block of L (NB, NB + 1), its inverse pivots
// (NB), y (kq) and 1 / L_jj (kq); every region a multiple of 4.
__host__ __device__ inline int system_floats(int kq) {
    return NB * kq + NB * DL + NB + 2 * kq;
}

// A. The diagonal block of one system in warp w's registers: lane r holds
// row r (row[c], c <= r; 0 above). Column c's step broadcasts the pivot and
// each L[s][c] by shuffles. The block's columns are global j0 + c.
template <int SCHED>
__device__ __forceinline__ void factor_block(float (&row)[NB], int lane,
                                             int j0, int h, float* pinv,
                                             float* rinv) {
    constexpr int FC = fcols(SCHED);
#pragma unroll
    for (int c = 0; c < NB; c += FC) {
        if constexpr (FC == 1) {
            const float d = __shfl_sync(0xffffffffu, row[c], c);
            const float inv = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
            const float l = row[c] * inv;             // L[lane][c], lane > c
            if (lane == c) {
                row[c] = d * inv;
                pinv[c] = inv;
                rinv[c] = __frcp_rn(fmaxf(d * inv, PIVOT_FLOOR));
            } else if (lane > c) {
                row[c] = l;
            }
#pragma unroll
            for (int s = c + 1; s < NB; ++s) {
                if (grouped<SCHED>(j0, c, j0 + s, h)) continue;
                const float ls = __shfl_sync(0xffffffffu, l, s);
                if (lane >= s) row[s] = fmaf(-l, ls, row[s]);
            }
        } else {
            // a rank-2 step over (c, c + 1)
            const float d1 = __shfl_sync(0xffffffffu, row[c], c);
            const float inv1 = rsqrt_normal(fmaxf(d1, PIVOT_FLOOR));
            const float l12 = __shfl_sync(0xffffffffu, row[c], c + 1) * inv1;
            const float d2 = fmaf(-l12, l12,
                                  __shfl_sync(0xffffffffu, row[c + 1], c + 1));
            const float inv2 = rsqrt_normal(fmaxf(d2, PIVOT_FLOOR));
            const float c1 = row[c] * inv1;
            const float c2 = fmaf(-c1, l12, row[c + 1]) * inv2;
            if (lane == c) {
                row[c] = d1 * inv1;
                pinv[c] = inv1;
                rinv[c] = __frcp_rn(fmaxf(d1 * inv1, PIVOT_FLOOR));
            } else if (lane == c + 1) {
                row[c] = c1;
                row[c + 1] = d2 * inv2;
                pinv[c + 1] = inv2;
                rinv[c + 1] = __frcp_rn(fmaxf(d2 * inv2, PIVOT_FLOOR));
            } else if (lane > c + 1) {
                row[c] = c1;
                row[c + 1] = c2;
            }
#pragma unroll
            for (int s = c + 2; s < NB; ++s) {
                if (grouped<SCHED>(j0, c, j0 + s, h)) continue;
                const float a1 = __shfl_sync(0xffffffffu, c1, s);
                const float a2 = __shfl_sync(0xffffffffu, c2, s);
                if (lane >= s) row[s] = fmaf(-c2, a2, fmaf(-c1, a1, row[s]));
            }
        }
        // the end of an 8-column group: its sum into the later columns that
        // take it so
        if ((c + FC) % GW == 0 && c + FC < NB) {
            const int g0 = c + FC - GW;
#pragma unroll
            for (int s = c + FC; s < NB; ++s) {
                if (!grouped<SCHED>(j0, g0, j0 + s, h)) continue;
                float acc = 0.f;
#pragma unroll
                for (int p = g0; p < g0 + GW; ++p)
                    acc = fmaf(row[p],
                               __shfl_sync(0xffffffffu, row[p], s), acc);
                if (lane >= s) row[s] -= acc;
            }
        }
    }
}

// B. A row below the diagonal block against it (D the block's L, pinv its
// inverse pivots): a holds the row's raw values in and its L out.
template <int SCHED>
__device__ __forceinline__ void solve_row(float (&a)[NB], const float* D,
                                          const float* pinv, int j0, int h) {
    constexpr int FC = fcols(SCHED);
#pragma unroll
    for (int c = 0; c < NB; c += FC) {
        if constexpr (FC == 1) {
            a[c] *= pinv[c];
#pragma unroll
            for (int s = c + 1; s < NB; ++s)
                if (!grouped<SCHED>(j0, c, j0 + s, h))
                    a[s] = fmaf(-a[c], D[s * DL + c], a[s]);
        } else {
            a[c] *= pinv[c];
            a[c + 1] = fmaf(-a[c], D[(c + 1) * DL + c], a[c + 1])
                       * pinv[c + 1];
#pragma unroll
            for (int s = c + 2; s < NB; ++s)
                if (!grouped<SCHED>(j0, c, j0 + s, h))
                    a[s] = fmaf(-a[c + 1], D[s * DL + c + 1],
                                fmaf(-a[c], D[s * DL + c], a[s]));
        }
        if ((c + FC) % GW == 0 && c + FC < NB) {
            const int g0 = c + FC - GW;
#pragma unroll
            for (int s = c + FC; s < NB; ++s) {
                if (!grouped<SCHED>(j0, g0, j0 + s, h)) continue;
                float acc = 0.f;
#pragma unroll
                for (int p = g0; p < g0 + GW; ++p)
                    acc = fmaf(a[p], D[s * DL + p], acc);
                a[s] -= acc;
            }
        }
    }
}

// System s of a block whose first is b0: its scratch and its shared
// memory (per floats each).
struct Sys {
    float* A;      // the scratch: A, then L, row-major (kq, kq)
    float* PT;     // the panel's transposed copy: PT[c kq + r] = L21[r][c]
    float* D;      // the diagonal block of L: D[r DL + c]
    float* pinv;   // its inverse pivots
    float* ys;     // y, then x
    float* rinv;   // 1 / max(L_jj, 1e-30)
};

__device__ __forceinline__ Sys sys_of(const Args& p, float* smem, int b0,
                                      int s, int per) {
    Sys q;
    q.A = p.scratch + (size_t)(b0 + s) * p.kq * p.kq;
    q.PT = smem + s * per;
    q.D = q.PT + NB * p.kq;
    q.pinv = q.D + NB * DL;
    q.ys = q.pinv + NB;
    q.rinv = q.ys + p.kq;
    return q;
}

// tile t of a lower triangle of 32 x 32 tiles, numbered by row: (ti, tj)
__device__ __forceinline__ void tile_of(int t, int& ti, int& tj) {
    ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    while (ti * (ti + 1) / 2 > t) --ti;
    tj = t - ti * (ti + 1) / 2;
}

template <int SCHED, int SROWS>
__global__ void __launch_bounds__(NTH, 1)
variant_large_kernel(const Args p) {
    constexpr int NS = systems(SCHED);
    extern __shared__ __align__(16) float smem[];
    const int k = p.k, kq = p.kq, h = p.h;
    const int per = system_floats(kq);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * NS;
    const int ns = min(NS, p.B - b0);       // this block's systems

    // A's lower triangle (the upper is never read), identity on the padding
    for (int w = warp; w < ns * kq; w += WARPS) {
        const int s = w / kq, i = w % kq;
        const float* Gb = p.G + (size_t)(b0 + s) * k * k;
        const float rb = p.reg[b0 + s];
        float* A = sys_of(p, smem, b0, s, per).A;
        for (int j = lane; j <= i; j += 32) {
            float v;
            if (i < k) {
                v = Gb[(size_t)i * k + j];
                if (i == j) v += rb;
            } else {
                v = i == j ? 1.f : 0.f;
            }
            A[(size_t)i * kq + j] = v;
        }
    }
    for (int t = tid; t < ns * kq; t += NTH) {
        const int s = t / kq, i = t % kq;
        sys_of(p, smem, b0, s, per).ys[i]
            = i < k ? p.rhs[(size_t)(b0 + s) * k + i] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kq; j0 += NB) {
        const int r0 = j0 + NB;             // first row below the panel
        const int nr = kq - r0;             // rows below the panel
        // A. warp s: system s's diagonal block, its factor and the panel's
        // y (SROWS rows a shuffle round)
        if (warp < ns) {
            const Sys q = sys_of(p, smem, b0, warp, per);
            float* ys = q.ys;
            float* rinv = q.rinv + j0;
            const float* Ar = q.A + (size_t)(j0 + lane) * kq + j0;
            float row[NB];
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                const float4 q = *reinterpret_cast<const float4*>(Ar + c);
                row[c] = c <= lane ? q.x : 0.f;
                row[c + 1] = c + 1 <= lane ? q.y : 0.f;
                row[c + 2] = c + 2 <= lane ? q.z : 0.f;
                row[c + 3] = c + 3 <= lane ? q.w : 0.f;
            }
            factor_block<SCHED>(row, lane, j0, h, q.pinv, rinv);
            __syncwarp();
            float t = ys[j0 + lane];
            if constexpr (SROWS == 2) {
#pragma unroll
                for (int c = 0; c < NB; c += 2) {
                    const float l10 = __shfl_sync(0xffffffffu, row[c], c + 1);
                    const float yc = __shfl_sync(0xffffffffu, t, c) * rinv[c];
                    const float yc1 = fmaf(-l10, yc, __shfl_sync(
                                               0xffffffffu, t, c + 1))
                                      * rinv[c + 1];
                    if (lane == c) t = yc;
                    else if (lane == c + 1) t = yc1;
                    else if (lane > c + 1)
                        t = fmaf(-row[c + 1], yc1, fmaf(-row[c], yc, t));
                }
            } else {
#pragma unroll
                for (int c = 0; c < NB; ++c) {
                    const float yc = __shfl_sync(0xffffffffu, t, c) * rinv[c];
                    if (lane == c) t = yc;
                    else if (lane > c) t = fmaf(-row[c], yc, t);
                }
            }
            ys[j0 + lane] = t;
            float* Aw = q.A + (size_t)(j0 + lane) * kq + j0;
            float* D = q.D;
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
        // B. the panel's rows below the block, a row a thread: its L, into
        // the scratch and the panel's transposed copy, and its y takes the
        // panel's terms
        for (int t = tid; t < ns * nr; t += NTH) {
            const int r = t % nr;
            const Sys q = sys_of(p, smem, b0, t / nr, per);
            float* Ar = q.A + (size_t)(r0 + r) * kq + j0;
            float a[NB];
#pragma unroll
            for (int c = 0; c < NB; c += 4) {
                const float4 q = *reinterpret_cast<const float4*>(Ar + c);
                a[c] = q.x; a[c + 1] = q.y; a[c + 2] = q.z; a[c + 3] = q.w;
            }
            solve_row<SCHED>(a, q.D, q.pinv, j0, h);
#pragma unroll
            for (int c = 0; c < NB; c += 4)
                *reinterpret_cast<float4*>(Ar + c)
                    = make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
            float* ys = q.ys;
            float* PT = q.PT;
            float yr = ys[r0 + r];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                PT[c * kq + r] = a[c];
                yr = fmaf(-a[c], ys[j0 + c], yr);
            }
            ys[r0 + r] = yr;
        }
        __syncthreads();
        // C. the trailing lower triangle, a warp a 32 x 32 tile: lane j holds
        // column j of the tile and its 32 rows, and takes the panel's terms
        // in order, alone or as 8-column group sums
        const int nt = nr / NB;
        const int ntiles = nt * (nt + 1) / 2;
        for (int t = warp; t < ns * ntiles; t += WARPS) {
            const Sys q = sys_of(p, smem, b0, t / ntiles, per);
            int ti, tj;
            tile_of(t % ntiles, ti, tj);
            const float* PT = q.PT;
            const int col = r0 + tj * NB + lane;
            float* At = q.A + (size_t)(r0 + ti * NB) * kq + col;
            const bool diag = ti == tj;
            float a[NB];
#pragma unroll
            for (int r = 0; r < NB; ++r)
                a[r] = (!diag || lane <= r) ? At[(size_t)r * kq] : 0.f;
#pragma unroll
            for (int g = 0; g < NB; g += GW) {
                if (grouped<SCHED>(j0, g, col, h)) {
                    float acc[NB];
#pragma unroll
                    for (int r = 0; r < NB; ++r) acc[r] = 0.f;
#pragma unroll
                    for (int c = g; c < g + GW; ++c) {
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
#pragma unroll
                    for (int r = 0; r < NB; ++r) a[r] -= acc[r];
                } else {
#pragma unroll
                    for (int c = g; c < g + GW; ++c) {
                        const float lj = PT[c * kq + tj * NB + lane];
                        const float4* li = reinterpret_cast<const float4*>(
                            PT + c * kq + ti * NB);
#pragma unroll
                        for (int r = 0; r < NB; r += 4) {
                            const float4 q = li[r >> 2];
                            a[r] = fmaf(-q.x, lj, a[r]);
                            a[r + 1] = fmaf(-q.y, lj, a[r + 1]);
                            a[r + 2] = fmaf(-q.z, lj, a[r + 2]);
                            a[r + 3] = fmaf(-q.w, lj, a[r + 3]);
                        }
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < NB; ++r)
                if (!diag || lane <= r) At[(size_t)r * kq] = a[r];
        }
        __syncthreads();
    }

    // the back substitution L^T x = y, 32 rows a step from the bottom:
    // warp s solves system s's block (SROWS rows a shuffle round), then
    // every row above takes the block's terms, j decreasing
    for (int j0 = kq - NB; j0 >= 0; j0 -= NB) {
        if (warp < ns) {
            const Sys q = sys_of(p, smem, b0, warp, per);
            const float* A = q.A;
            float* ys = q.ys;
            const float* rinv = q.rinv + j0;
            // column `lane` of the diagonal block: L[j0 + c][j0 + lane]
            float lc[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c)
                lc[c] = A[(size_t)(j0 + c) * kq + j0 + lane];
            float t = ys[j0 + lane];
            if constexpr (SROWS == 2) {
#pragma unroll
                for (int c = NB - 1; c >= 1; c -= 2) {
                    // L[c][c - 1], held by lane c - 1
                    const float d = __shfl_sync(0xffffffffu, lc[c], c - 1);
                    const float xc = __shfl_sync(0xffffffffu, t, c) * rinv[c];
                    const float xc1 = fmaf(-d, xc, __shfl_sync(
                                              0xffffffffu, t, c - 1))
                                      * rinv[c - 1];
                    if (lane == c) t = xc;
                    else if (lane == c - 1) t = xc1;
                    else if (lane < c - 1)
                        t = fmaf(-lc[c - 1], xc1, fmaf(-lc[c], xc, t));
                }
            } else {
#pragma unroll
                for (int c = NB - 1; c >= 0; --c) {
                    const float xc = __shfl_sync(0xffffffffu, t, c) * rinv[c];
                    if (lane == c) t = xc;
                    else if (lane < c) t = fmaf(-lc[c], xc, t);
                }
            }
            ys[j0 + lane] = t;
        }
        __syncthreads();
        if (j0 == 0) break;
        for (int t = tid; t < ns * j0; t += NTH) {
            const int i = t % j0;
            const Sys q = sys_of(p, smem, b0, t / j0, per);
            const float* A = q.A;
            float* ys = q.ys;
            float y = ys[i];
#pragma unroll 8
            for (int c = NB - 1; c >= 0; --c)
                y = fmaf(-A[(size_t)(j0 + c) * kq + i], ys[j0 + c], y);
            ys[i] = y;
        }
        __syncthreads();
    }
    for (int t = tid; t < ns * k; t += NTH) {
        const int s = t / k, i = t % k;
        p.out[(size_t)(b0 + s) * k + i] = sys_of(p, smem, b0, s, per).ys[i];
    }
}

template <int SCHED, int SROWS>
cudaError_t launch(const Args& p, cudaStream_t stream) {
    constexpr int ns = systems(SCHED);
    const size_t smem = sizeof(float) * (size_t)ns * system_floats(p.kq);
    const auto kern = variant_large_kernel<SCHED, SROWS>;
    // sets the kernel's shared-memory attributes once per device (cached)
    long long resident = 0;
    const cudaError_t err = chol::resident_blocks(
        reinterpret_cast<const void*>(kern), NTH, smem, &resident);
    if (err != cudaSuccess) return err;
    kern<<<(p.B + ns - 1) / ns, NTH, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major; scratch (B, kq, kq) f32 with kq = k
// rounded up to a multiple of 32; 1 <= k <= 656, one block a system (two
// for DUAL; the caller keeps B to the reference's one-block batch). sched
// is csrc/cholesky_rank_panel.cu's code: 1 and 2 the rank-1 schedule's
// fcols (srows 1 or 2 at fcols 1, 1 at fcols 2), 8 the panel (srows 1), 16
// Schur (k % 16 == 0, srows 1 or 2), 32 dual (srows 2).
int cholesky_solve_variant_large(const void* G, const void* rhs,
                                 const void* reg, void* scratch, void* out,
                                 int B, int k, int kq, int sched, int srows,
                                 void* stream) {
    if (k < 1 || k > KMAX || B < 0 || kq != (k + NB - 1) / NB * NB)
        return (int)cudaErrorInvalidValue;
    if (sched == SCHUR && k % 16) return (int)cudaErrorInvalidValue;
    if ((((uintptr_t)scratch) & 15) != 0) return (int)cudaErrorInvalidValue;
    Args p;
    p.G = static_cast<const float*>(G);
    p.rhs = static_cast<const float*>(rhs);
    p.reg = static_cast<const float*>(reg);
    p.scratch = static_cast<float*>(scratch);
    p.out = static_cast<float*>(out);
    p.B = B;
    p.k = k;
    p.kq = kq;
    p.h = k / 2;
    cudaError_t (*run)(const Args&, cudaStream_t) =
        sched == RANK1 && srows == 1   ? launch<RANK1, 1>
        : sched == RANK1 && srows == 2 ? launch<RANK1, 2>
        : sched == PAIR && srows == 1  ? launch<PAIR, 1>
        : sched == PANEL && srows == 1 ? launch<PANEL, 1>
        : sched == SCHUR && srows == 1 ? launch<SCHUR, 1>
        : sched == SCHUR && srows == 2 ? launch<SCHUR, 2>
        : sched == DUAL && srows == 2  ? launch<DUAL, 2>
                                       : nullptr;
    if (!run) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    return (int)run(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
