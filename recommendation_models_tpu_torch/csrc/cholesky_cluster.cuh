// The one-block regime's frame (160 < kp <= 656), shared by
// csrc/cholesky_large.cu (B1, and B3 with a second gram) and
// csrc/cholesky_large_variants.cu (B4-B5c): one thread-block cluster of C
// CTAs a system, the factor in the cluster's distributed shared memory.
// Each source includes csrc/cholesky_common.cuh, then this header, and
// instantiates cluster_solve_kernel<SCHED, SROWS, TWO_G> behind its own C
// export.
//
// Contract (as the other solves): f32 throughout, no TF32 and no tensor
// cores; the ridge added on load (A = G [+ G2] + reg_b I, the second gram
// summed in f32 on load); pivots clamped at max(d, 1e-30) (L_jj = d
// rsqrt(max(d, 1e-30)), the substitutions multiply by 1 / max(L_jj,
// 1e-30)), so identity-padded and all-zero systems with rhs 0 solve to
// exactly 0; no atomics and fixed orders, so a launch repeats bitwise.
//
// What bounds it on an H100: a system of order 656 is 95 MFLOP, 0.6 ms of
// one SM's f32 rate, and its lower triangle (861 KB) is beyond one block's
// 227 KB of shared memory. So a system takes a cluster of C CTAs, one an
// SM (C from ops/cholesky.py::cluster_size: B x C fills the 132 SMs where
// the batch leaves room, C = 8 at B <= 8), and the lower triangle lives in
// their shared memory, padded to kq = k rounded up to 32 (identity on the
// padding), in 32-column panels: panel p (its rows p*32 .. kq - 1, 32
// wide, row-major, its 16-byte chunks swizzled by the row so that a thread
// a row and a lane a column both read without bank conflicts) lives on CTA
// owner(p), the cyclic order reflected every C panels (0 .. C-1, C-1 .. 0,
// ...), which evens the CTAs' shares (at kq = 672, C = 8: 27-32 of the 231
// 32 x 32 blocks, where p mod C gives 20-39). Device memory is read once
// (G, each CTA its own panels) and written once (x).
//
// The factor is right-looking with a lookahead of one panel. At step j
// every CTA that owns a panel past j copies the part of panel j that its
// panels need from the owner's shared memory (ld.shared::cluster) into its
// own, and updates its panels' tiles of the trailing triangle, A -= L21
// L21^T, in shared memory, a warp a 32 x 32 tile in 4 x 8 register blocks.
// The owner of panel j + 1 copies first (it waits on an mbarrier of its
// own that panel j's owner arrives on remotely when the panel is final;
// the others wait on one it arrives on when its copy is done, so the
// chain's copy has the owner's port to itself), then updates and factors
// panel j + 1 (warps 0-3 the diagonal tile, a quarter each, then warp 0
// the diagonal block in registers, the pivot and the column broadcast by
// shuffles, while warps 1-7 update the tiles below; then a thread a row
// below the block) and publishes it before it updates the rest, so the
// chain of diagonal factors runs beside the other CTAs' updates. The
// forward substitution rides the factor: each owner solves its panel's
// block of y, takes the panel's terms off the rows below and writes those
// rows into the y of the next panel's owner. The back substitution runs
// from the bottom: the owner of block j solves it (warp 0, SROWS rows a
// shuffle round) and writes x_j into the y of every CTA that owns a block
// above, then signals; each takes x_j's terms off its blocks' rows, the
// owner of block j - 1 its own first, so the next solve starts while the
// others finish. A last cluster barrier keeps every CTA until no other
// reads its memory.
//
// What holds it on an H100 (PERF.md, probes/cluster_trace.py): the chain
// of panels (the copy, the diagonal tile, the diagonal block's serial
// factor, the rows below) and the serial back substitution blocks, not the
// operations, which spread over C SMs.
//
// What makes each schedule its own is the order in which every element
// takes its terms, which is its plain version's (ops/cholesky.py) and does
// not depend on the CTAs: element (i, l) takes the terms L_ip L_lp of the
// columns p < l in increasing p, each either alone (subtracted and rounded
// in turn: the rank-1 and rank-2 steps) or inside the sum of its aligned
// group (the group's products summed from 0 in order, then subtracted).
// Which, is `grouped` below:
//   BLOCK (B1, B3): alone within its own 32-column panel, in the panel's
//          32-term sum past it (the trailing update);
//   RANK1, PAIR, DUAL: every term alone;
//   PANEL: alone within its own 8-column panel (the left-looking panel
//          factor), in its 8-column group's sum past it;
//   SCHUR: in its 8-column group's sum where l >= h = k / 2 > p (A22's
//          deferred update), else alone (the two rank-2 phases).
// The rank-2 schedules (PAIR, SCHUR, DUAL) factor the diagonal block and
// the rows below two columns a step (L[i][j+1] = (A[i][j+1] - L[i][j]
// L[j+1][j]) / L[j+1][j+1]), the others a column. y_i takes its forward
// terms in increasing j and its back terms in decreasing j, one at a time:
// the plain version's column-oriented substitutions. DUAL's two systems a
// block were the TPU's layout, not its function: here it is the rank-2
// factor with two-row substitutions, one system a cluster.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace clu {

namespace cg = cooperative_groups;
using chol::PIVOT_FLOOR;

constexpr int NB = 32;           // panel width (a warp's width)
constexpr int GW = 8;            // the panel and Schur schedules' group
constexpr int NTH = 256;         // threads per CTA
constexpr int WARPS = NTH / 32;
constexpr int CMAX = 16;         // the largest cluster taken (past 8: the
                                 // card's non-portable sizes)

// the factor schedules (csrc/cholesky_rank_panel.cu's codes; BLOCK is B1's)
enum Sched { BLOCK = 0, RANK1 = 1, PAIR = 2, PANEL = 8, SCHUR = 16,
             DUAL = 32 };

// columns a factor step: the rank-2 schedules take two
__host__ __device__ constexpr int fcols(int sched) {
    return sched == BLOCK || sched == RANK1 || sched == PANEL ? 1 : 2;
}
// the width of a grouped sum
__host__ __device__ constexpr int group_width(int sched) {
    return sched == BLOCK ? NB : GW;
}

// Whether column l takes the terms of the panel's column j0 + c (c < 32,
// j0 + c < l) inside the sum of their aligned group (else one term at a
// time). For PANEL only the group's place against l's counts, and it is
// written with the panel's own offsets, which the compiler folds.
template <int SCHED>
__device__ __forceinline__ bool grouped(int j0, int c, int l, int h) {
    if (SCHED == BLOCK) return l - j0 >= NB;
    if (SCHED == PANEL) return (c >> 3) < ((l - j0) >> 3);
    if (SCHED == SCHUR) return l >= h && j0 + c < h;
    return false;
}

// ------------------------------------------------------------ the layout

// CTA of panel p: the cyclic order reflected every C panels
__host__ __device__ inline int owner_of(int p, int C) {
    const int r = p % (2 * C);
    return r < C ? r : 2 * C - 1 - r;
}

// CTA x's m-th panel (increasing in m; >= np when it has no more)
__host__ __device__ inline int panel_of(int x, int m, int C) {
    return m * C + ((m & 1) ? C - 1 - x : x);
}

// 32 x 32 blocks of CTA x's panels (each panel p holds np - p of them)
__host__ __device__ inline int share_blocks(int x, int np, int C) {
    int n = 0;
    for (int m = 0; panel_of(x, m, C) < np; ++m) n += np - panel_of(x, m, C);
    return n;
}

// The most 32 x 32 blocks CTA x copies from another CTA's panel: at step j
// (panel j not its own), the panel's rows from x's first panel past j.
__host__ __device__ inline int copy_blocks(int x, int np, int C) {
    int most = 0;
    for (int j = 0; j + 1 < np; ++j) {
        if (owner_of(j, C) == x) continue;
        for (int m = 0; panel_of(x, m, C) < np; ++m) {
            const int q = panel_of(x, m, C);
            if (q > j) {
                most = np - q > most ? np - q : most;
                break;
            }
        }
    }
    return most;
}

// Floats ahead of the panels: the signals (3 np mbarriers of 8 bytes,
// padded to 16 bytes), the panel offsets (np ints, padded to 4), y (kq),
// 1 / L_jj (kq), the diagonal block's inverse pivots (32) and its L
// transposed (32 x 32); a multiple of 4, so the panels start 16-byte
// aligned.
__host__ __device__ inline int signal_floats(int np) {
    return (6 * np + 3) & ~3;
}
__host__ __device__ inline int fixed_floats(int kq) {
    const int np = kq / NB;
    return signal_floats(np) + ((np + 3) & ~3) + 2 * kq + NB + NB * NB;
}

// Dynamic shared memory of a CTA at (kq, C): the fixed part, then its
// panels and its copy buffer, at the CTA that needs the most.
inline size_t smem_bytes(int kq, int C) {
    const int np = kq / NB;
    int most = 0;
    for (int x = 0; x < C; ++x) {
        const int n = share_blocks(x, np, C) + copy_blocks(x, np, C);
        most = n > most ? n : most;
    }
    return sizeof(float) * ((size_t)fixed_floats(kq)
                            + (size_t)most * NB * NB);
}

// element (R, c) of a panel whose first row held is row0: row-major, 32
// wide, the 16-byte chunk q of row R at chunk q ^ (R mod 8)
struct Panel {
    float* base;
    int row0;
    __device__ __forceinline__ float& at(int R, int c) const {
        return base[(R - row0) * NB + ((((c >> 2) ^ R) & 7) << 2)
                    + (c & 3)];
    }
    __device__ __forceinline__ float4& chunk(int R, int q) const {
        return *reinterpret_cast<float4*>(base + (R - row0) * NB
                                          + (((q ^ R) & 7) << 2));
    }
};

struct Args {
    const float* G;
    const float* G2;     // null but for B3
    const float* rhs;
    const float* reg;
    float* out;
    int B, k, kq, C, h;
};

// rsqrt of a normal positive float (every pivot is clamped at 1e-30): the
// hardware's approximation, as rsqrtf gives it for such inputs.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// ------------------------------------------------- the cluster's signals

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of ptr (this CTA's shared memory) in CTA
// rank's shared memory
__device__ __forceinline__ uint32_t cluster_addr(const void* ptr, int rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(a) : "r"(smem_addr(ptr)), "r"(rank));
    return a;
}

__device__ __forceinline__ void signal_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the one arrival a signal takes has come (each is used once).
// A wait past 2^35 cycles (about 17 s) can only be a fault of the frame:
// it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void signal_wait(uint64_t* bar) {
    const uint32_t a = smem_addr(bar);
    const long long t0 = clock64();
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
            "p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(a), "r"(0u) : "memory");
        if (!done && clock64() - t0 > (1ll << 35)) __trap();
    } while (!done);
}

// Lane x < C of the calling warp arrives on the same signal in CTA x, a
// release at cluster scope: everything this CTA wrote before the call (a
// barrier orders the other threads' writes before it) is seen by a CTA
// whose wait on the signal returns.
__device__ __forceinline__ void signal_all(uint64_t* bar, int C, int lane) {
    if (lane < C)
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 "
                     "_, [%0];" :: "r"(cluster_addr(bar, lane)) : "memory");
}

// ------------------------------------------------------------ the phases

// Load CTA me's panels of system b: A = G [+ G2] + reg_b I on the lower
// triangle (above the diagonal 0), the identity on the padding. Where G's
// rows allow 16-byte copies (k % 4 == 0, aligned) and there is no second
// gram, the lower triangle's chunks go by cp.async, all in flight at once,
// and the diagonal blocks are fixed up after (the upper part 0, the ridge
// added); else a thread a chunk, four in flight, sums them in registers.
template <bool TWO_G>
__device__ __forceinline__ void load_panels(const Args& p, int b, int me,
                                            int np, float* store, int tid) {
    const int k = p.k, kq = p.kq;
    const float* Gb = p.G + (size_t)b * k * k;
    const float* G2b = TWO_G ? p.G2 + (size_t)b * k * k : nullptr;
    const float rb = p.reg[b];
    const bool vec = (k & 3) == 0
                     && ((reinterpret_cast<uintptr_t>(Gb)
                          | reinterpret_cast<uintptr_t>(G2b)) & 15) == 0;
    const bool async = vec && !TWO_G;
    float* dst = store;
    for (int m = 0; panel_of(me, m, p.C) < np; ++m) {
        const int pn = panel_of(me, m, p.C);
        const Panel P{dst, pn * NB};
        const int n4 = (kq - pn * NB) * (NB / 4);
        if (async) {
            for (int i = tid; i < n4; i += NTH) {
                const int R = pn * NB + (i >> 3), J = pn * NB + 4 * (i & 7);
                float4* d = &P.chunk(R, i & 7);
                if (R < k && J <= R) {
                    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                                 :: "r"(smem_addr(d)),
                                    "l"(Gb + (size_t)R * k + J) : "memory");
                } else if (R < k) {
                    *d = make_float4(0.f, 0.f, 0.f, 0.f);
                } else {
                    *d = make_float4(J == R ? 1.f : 0.f, J + 1 == R ? 1.f : 0.f,
                                     J + 2 == R ? 1.f : 0.f,
                                     J + 3 == R ? 1.f : 0.f);
                }
            }
            dst += (np - pn) * NB * NB;
            continue;
        }
        for (int i0 = tid; i0 < n4; i0 += 4 * NTH) {
            float4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + u * NTH;
                if (i >= n4) break;
                const int R = pn * NB + (i >> 3), J = pn * NB + 4 * (i & 7);
                float e[4];
                if (R < k) {
                    // J <= R < k, and with k % 4 == 0, J + 3 < k
                    if (vec) {
                        const float4 g = *reinterpret_cast<const float4*>(
                            Gb + (size_t)R * k + J);
                        e[0] = g.x; e[1] = g.y; e[2] = g.z; e[3] = g.w;
                        if (TWO_G) {
                            const float4 g2 = *reinterpret_cast<
                                const float4*>(G2b + (size_t)R * k + J);
                            e[0] += g2.x; e[1] += g2.y; e[2] += g2.z;
                            e[3] += g2.w;
                        }
                    } else {
#pragma unroll
                        for (int t = 0; t < 4; ++t) {
                            e[t] = 0.f;
                            if (J + t <= R) {
                                e[t] = Gb[(size_t)R * k + J + t];
                                if (TWO_G) e[t] += G2b[(size_t)R * k + J + t];
                            }
                        }
                    }
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        if (J + t > R) e[t] = 0.f;
                        else if (J + t == R) e[t] += rb;
                    }
                } else {
#pragma unroll
                    for (int t = 0; t < 4; ++t) e[t] = J + t == R ? 1.f : 0.f;
                }
                v[u] = make_float4(e[0], e[1], e[2], e[3]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + u * NTH;
                if (i >= n4) break;
                P.chunk(pn * NB + (i >> 3), i & 7) = v[u];
            }
        }
        dst += (np - pn) * NB * NB;
    }
    if (async) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
        // each diagonal block's rows: 0 above the diagonal, the ridge on it
        dst = store;
        for (int m = 0; panel_of(me, m, p.C) < np; ++m) {
            const int pn = panel_of(me, m, p.C), R = pn * NB + tid;
            if (tid < NB && R < k) {
                const Panel P{dst, pn * NB};
                for (int c = tid & ~3; c < NB; ++c) {
                    if (c > tid) P.at(R, c) = 0.f;
                    else if (c == tid) P.at(R, c) += rb;
                }
            }
            dst += (np - pn) * NB * NB;
        }
    }
}

// Copy n floats (a multiple of 4, 16-byte aligned) to dst from another
// CTA's shared memory at src (a shared::cluster address), eight 16-byte
// loads in flight a thread, by threads t = 0 .. nt - 1.
__device__ __forceinline__ void copy_from(float* dst, uint32_t src, int n,
                                          int t, int nt) {
    const int n4 = n >> 2;
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i0 = t; i0 < n4; i0 += 8 * nt) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (i0 + u * nt < n4)
                asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, "
                             "[%4];"
                             : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z),
                               "=f"(v[u].w)
                             : "r"(src + 16u * (i0 + u * nt)));
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (i0 + u * nt < n4) d[i0 + u * nt] = v[u];
    }
}

// The diagonal block in one warp's registers: lane r holds row r (row[c],
// c <= r; what lies above the diagonal is never read, so the updates run
// on every lane without a mask). Column c's step broadcasts the pivot by a
// shuffle and L[c + 1][c], which the next pivot's row waits on, by a
// shuffle too; the rest of the column goes through DT (DT[c * 32 + s] =
// L[s][c], read a 16-byte chunk at a time), which the solve of the rows
// below reads after. Selects, not branches, so the compiler can start a
// column while the one before is still updating rows. Lane c keeps its
// pivot's L_cc and 1 / sqrt in ljj and linv (the block's columns are
// global j0 + c).
template <int SCHED>
__device__ __forceinline__ void factor_block(float (&row)[NB], int lane,
                                             int j0, int h, float& ljj,
                                             float& linv, float* DT) {
    constexpr int FC = fcols(SCHED);
    constexpr int GWS = group_width(SCHED);
    const float4* DT4 = reinterpret_cast<const float4*>(DT);
#pragma unroll
    for (int c = 0; c < NB; c += FC) {
        if constexpr (FC == 1) {
            const float d = __shfl_sync(0xffffffffu, row[c], c);
            const float inv = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
            const float l = row[c] * inv;             // L[lane][c], lane > c
            ljj = lane == c ? d * inv : ljj;
            linv = lane == c ? inv : linv;
            row[c] = lane == c ? d * inv : l;
            if (c + 1 < NB && !grouped<SCHED>(j0, c, j0 + c + 1, h))
                row[c + 1] = fmaf(-l, __shfl_sync(0xffffffffu, l, c + 1),
                                  row[c + 1]);
            if (c + 2 < NB) {
                DT[c * NB + lane] = row[c];
                __syncwarp();
                float l0[NB];
#pragma unroll
                for (int q = (c + 2) >> 2; q < NB / 4; ++q) {
                    const float4 v = DT4[c * (NB / 4) + q];
                    l0[4 * q] = v.x; l0[4 * q + 1] = v.y;
                    l0[4 * q + 2] = v.z; l0[4 * q + 3] = v.w;
                }
#pragma unroll
                for (int s = c + 2; s < NB; ++s)
                    if (!grouped<SCHED>(j0, c, j0 + s, h))
                        row[s] = fmaf(-l, l0[s], row[s]);
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
            ljj = lane == c ? d1 * inv1 : lane == c + 1 ? d2 * inv2 : ljj;
            linv = lane == c ? inv1 : lane == c + 1 ? inv2 : linv;
            row[c] = lane == c ? d1 * inv1 : c1;
            row[c + 1] = lane == c + 1 ? d2 * inv2 : c2;
#pragma unroll
            for (int s = c + 2; s < NB; ++s) {
                if (grouped<SCHED>(j0, c, j0 + s, h)) continue;
                const float a1 = __shfl_sync(0xffffffffu, c1, s);
                const float a2 = __shfl_sync(0xffffffffu, c2, s);
                row[s] = fmaf(-c2, a2, fmaf(-c1, a1, row[s]));
            }
        }
        // the end of an 8-column group: its sum into the later columns that
        // take it so
        if ((c + FC) % GWS == 0 && c + FC < NB) {
            const int g0 = c + FC - GWS;
#pragma unroll
            for (int s = c + FC; s < NB; ++s) {
                if (!grouped<SCHED>(j0, g0, j0 + s, h)) continue;
                float acc = 0.f;
#pragma unroll
                for (int p = g0; p < g0 + GWS; ++p)
                    acc = fmaf(row[p],
                               __shfl_sync(0xffffffffu, row[p], s), acc);
                row[s] -= acc;
            }
        }
    }
}

// A row below the diagonal block against it (DT the block's L transposed,
// DT[c * 32 + s] = L[s][c], read a 16-byte chunk at a time; pinv its
// inverse pivots): a holds the row's values in and its L out.
template <int SCHED>
__device__ __forceinline__ void solve_row(float (&a)[NB], const float* DT,
                                          const float* pinv, int j0, int h) {
    constexpr int FC = fcols(SCHED);
    constexpr int GWS = group_width(SCHED);
    const float4* DT4 = reinterpret_cast<const float4*>(DT);
#pragma unroll
    for (int c = 0; c < NB; c += FC) {
        float d0[NB], d1[NB];      // L[s][c] and L[s][c + 1], s past them
#pragma unroll
        for (int q = (c + 1) >> 2; q < NB / 4; ++q) {
            const float4 v = DT4[c * (NB / 4) + q];
            d0[4 * q] = v.x; d0[4 * q + 1] = v.y;
            d0[4 * q + 2] = v.z; d0[4 * q + 3] = v.w;
        }
        if constexpr (FC == 1) {
            a[c] *= pinv[c];
#pragma unroll
            for (int s = c + 1; s < NB; ++s)
                if (!grouped<SCHED>(j0, c, j0 + s, h))
                    a[s] = fmaf(-a[c], d0[s], a[s]);
        } else {
#pragma unroll
            for (int q = (c + 2) >> 2; q < NB / 4; ++q) {
                const float4 v = DT4[(c + 1) * (NB / 4) + q];
                d1[4 * q] = v.x; d1[4 * q + 1] = v.y;
                d1[4 * q + 2] = v.z; d1[4 * q + 3] = v.w;
            }
            a[c] *= pinv[c];
            a[c + 1] = fmaf(-a[c], d0[c + 1], a[c + 1]) * pinv[c + 1];
#pragma unroll
            for (int s = c + 2; s < NB; ++s)
                if (!grouped<SCHED>(j0, c, j0 + s, h))
                    a[s] = fmaf(-a[c + 1], d1[s], fmaf(-a[c], d0[s], a[s]));
        }
        if ((c + FC) % GWS == 0 && c + FC < NB) {
            // the group's sums, each element's products in increasing p
            const int g0 = c + FC - GWS;
            float acc[NB];
#pragma unroll
            for (int s = c + FC; s < NB; ++s) acc[s] = 0.f;
#pragma unroll
            for (int p = g0; p < g0 + GWS; ++p) {
                float dp[NB];
#pragma unroll
                for (int q = (c + FC) >> 2; q < NB / 4; ++q) {
                    const float4 v = DT4[p * (NB / 4) + q];
                    dp[4 * q] = v.x; dp[4 * q + 1] = v.y;
                    dp[4 * q + 2] = v.z; dp[4 * q + 3] = v.w;
                }
#pragma unroll
                for (int s = c + FC; s < NB; ++s)
                    if (grouped<SCHED>(j0, g0, j0 + s, h))
                        acc[s] = fmaf(a[p], dp[s], acc[s]);
            }
#pragma unroll
            for (int s = c + FC; s < NB; ++s)
                if (grouped<SCHED>(j0, g0, j0 + s, h)) a[s] -= acc[s];
        }
    }
}

// One group's 4-column chunks of L (gw columns from g0) into a 4 x 8
// block (RB of its row blocks): HOW 0 each term alone into a, 1 into the
// group sums acc, 2 both (al the alone chain).
template <int HOW, int RB>
__device__ __forceinline__ void tile_chunks(const Panel& L, float (&a)[RB][8],
                                            float (&acc)[RB][8],
                                            float (&al)[RB][8], int R0,
                                            int C0, int g, int q, int rq,
                                            int g0, int gw) {
#pragma unroll 1
    for (int cc = g0; cc < g0 + gw; cc += 4) {
        float4 lr[RB], lc[8];
#pragma unroll
        for (int r = 0; r < RB; ++r)
            lr[r] = L.chunk(R0 + g + 8 * (rq + r), cc >> 2);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            lc[i] = L.chunk(C0 + q + 4 * i, cc >> 2);
        // a column of the chunk at a time over all the block's elements, so
        // that each element's chain of four waits on nothing else
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float x = e == 0 ? lr[r].x : e == 1 ? lr[r].y
                                    : e == 2 ? lr[r].z : lr[r].w;
                    const float y = e == 0 ? lc[i].x : e == 1 ? lc[i].y
                                    : e == 2 ? lc[i].z : lc[i].w;
                    if (HOW != 0) acc[r][i] = fmaf(x, y, acc[r][i]);
                    if (HOW == 0) a[r][i] = fmaf(-x, y, a[r][i]);
                    if (HOW == 2) al[r][i] = fmaf(-x, y, al[r][i]);
                }
        }
    }
}

// Tile (ti, c) of panel c (P) takes panel j's terms (L, its rows from at
// least c's), in 4 x 8 register blocks: lane (g, q) = (lane / 4, lane % 4)
// holds rows g + 8r (r < 4) and columns q + 4i (i < 8) of the tile, so a
// 16-byte load of L serves eight products and no two lanes of a load meet
// in one bank. RB of the four row blocks, from rq: the whole tile, or a
// quarter of it. Each element takes the terms in increasing p, a group of
// columns at a time: alone (how 0), inside the group's sum (1), or, where
// the tile straddles SCHUR's h, each element as its column says (2).
// KIND 0: every group alone; 1: every group in sums; 2: SCHUR's rule.
template <int SCHED, int KIND, int RB>
__device__ __forceinline__ void tile_pass(const Panel& L, const Panel& P,
                                          int c, int ti, int j0, int h,
                                          int lane, int rq) {
    constexpr int GWS = group_width(SCHED);
    const int g = lane >> 2, q = lane & 3, R0 = ti * NB, C0 = c * NB;
    const bool diag = ti == c;
    float a[RB][8];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i)
            a[r][i] = (!diag || q + 4 * i <= g + 8 * (rq + r))
                          ? P.at(R0 + g + 8 * (rq + r), q + 4 * i) : 0.f;
#pragma unroll 1
    for (int g0 = 0; g0 < NB; g0 += GWS) {
        int how = KIND;
        if constexpr (KIND == 2) how = j0 + g0 >= h ? 0 : C0 >= h ? 1 : 2;
        float acc[RB][8], al[RB][8];  // group sums; the alone chains (how 2)
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                acc[r][i] = 0.f;
                al[r][i] = a[r][i];
            }
        if constexpr (KIND != 2) {
            tile_chunks<KIND, RB>(L, a, acc, al, R0, C0, g, q, rq, g0, GWS);
        } else {
            if (how == 0)
                tile_chunks<0, RB>(L, a, acc, al, R0, C0, g, q, rq, g0, GWS);
            else if (how == 1)
                tile_chunks<1, RB>(L, a, acc, al, R0, C0, g, q, rq, g0, GWS);
            else
                tile_chunks<2, RB>(L, a, acc, al, R0, C0, g, q, rq, g0, GWS);
        }
        if (how != 0) {
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    a[r][i] = how == 1 || C0 + q + 4 * i >= h
                                  ? a[r][i] - acc[r][i] : al[r][i];
        }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i)
            if (!diag || q + 4 * i <= g + 8 * (rq + r))
                P.at(R0 + g + 8 * (rq + r), q + 4 * i) = a[r][i];
}

// A tile of the trailing update (columns past panel j's): BLOCK and PANEL
// take panel j's terms in group sums, RANK1, PAIR and DUAL one at a time,
// SCHUR in sums where l >= h > p, so its tiles past panel j's h by the
// group and the element, and one at a time once j0 >= h or where all the
// tile's columns are below h.
template <int SCHED, int RB>
__device__ __noinline__ void update_rows(Panel L, Panel P, int c, int ti,
                                         int j0, int h, int lane, int rq) {
    if constexpr (SCHED == BLOCK || SCHED == PANEL) {
        tile_pass<SCHED, 1, RB>(L, P, c, ti, j0, h, lane, rq);
    } else if constexpr (SCHED == SCHUR) {
        if (j0 >= h || c * NB + NB <= h)
            tile_pass<SCHED, 0, RB>(L, P, c, ti, j0, h, lane, rq);
        else
            tile_pass<SCHED, 2, RB>(L, P, c, ti, j0, h, lane, rq);
    } else {
        tile_pass<SCHED, 0, RB>(L, P, c, ti, j0, h, lane, rq);
    }
}

template <int SCHED>
__device__ __forceinline__ void update_tile(const Panel& L, const Panel& P,
                                            int c, int ti, int j0, int h,
                                            int lane) {
    update_rows<SCHED, 4>(L, P, c, ti, j0, h, lane, 0);
}

// Warp 0's part of factoring panel j: the diagonal block's factor, its
// part of y (SROWS rows a shuffle round) and the block's transposed copy DT.
template <int SCHED, int SROWS>
__device__ __noinline__ void factor_diagonal(Panel P, int j, int h, float* y,
                                             float* rinv, float* pinv,
                                             float* DT, int lane) {
    const int j0 = j * NB, R = j0 + lane;
    float row[NB];
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
        const float4 v = P.chunk(R, q);
        row[4 * q] = 4 * q <= lane ? v.x : 0.f;
        row[4 * q + 1] = 4 * q + 1 <= lane ? v.y : 0.f;
        row[4 * q + 2] = 4 * q + 2 <= lane ? v.z : 0.f;
        row[4 * q + 3] = 4 * q + 3 <= lane ? v.w : 0.f;
    }
    float ljj = 0.f, linv = 0.f;
    factor_block<SCHED>(row, lane, j0, h, ljj, linv, DT);
    const float rj = __frcp_rn(fmaxf(ljj, PIVOT_FLOOR));   // lane's 1 / L_jj
    pinv[lane] = linv;
    rinv[j0 + lane] = rj;
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
        P.chunk(R, q) = make_float4(row[4 * q], row[4 * q + 1],
                                    row[4 * q + 2], row[4 * q + 3]);
#pragma unroll
    for (int c = 0; c < NB; ++c) DT[c * NB + lane] = row[c];
    // the block's y, each y_c = (y_c - its terms) / L_cc formed on lane c
    float t = y[R];
    if constexpr (SROWS == 2) {
#pragma unroll
        for (int c = 0; c < NB; c += 2) {
            const float yc = __shfl_sync(0xffffffffu, t * rj, c);
            const float yc1 = __shfl_sync(
                0xffffffffu, fmaf(-row[c], yc, t) * rj, c + 1);
            t = lane == c ? yc : lane == c + 1 ? yc1
                : lane > c + 1 ? fmaf(-row[c + 1], yc1, fmaf(-row[c], yc, t))
                               : t;
        }
    } else {
#pragma unroll
        for (int c = 0; c < NB; ++c) {
            const float yc = __shfl_sync(0xffffffffu, t * rj, c);
            t = lane == c ? yc : lane > c ? fmaf(-row[c], yc, t) : t;
        }
    }
    y[R] = t;
}

// The rows of panel j below its diagonal block, a thread a row, against the
// block (DT, pinv): each row's L, and its y taking the panel's terms,
// written here and to ynext (the next panel's owner's y, or null where
// that is this CTA).
template <int SCHED>
__device__ __noinline__ void solve_rows(Panel P, int j, int kq, int h,
                                        float* y, float* ynext,
                                        const float* DT, const float* pinv,
                                        int tid) {
    const int j0 = j * NB;
    for (int R = j0 + NB + tid; R < kq; R += NTH) {
        float a[NB];
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
            const float4 v = P.chunk(R, q);
            a[4 * q] = v.x; a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
        }
        solve_row<SCHED>(a, DT, pinv, j0, h);
        float yr = y[R];
#pragma unroll
        for (int q = 0; q < NB / 4; ++q)
            P.chunk(R, q) = make_float4(a[4 * q], a[4 * q + 1],
                                        a[4 * q + 2], a[4 * q + 3]);
#pragma unroll
        for (int c = 0; c < NB; ++c) yr = fmaf(-a[c], y[j0 + c], yr);
        y[R] = yr;
        if (ynext) ynext[R] = yr;
    }
}

// Where the panel before a factored panel comes from: its rows of the
// factored panel's diagonal block already in L, and the rest (n floats at
// src, another CTA's) for warps 4-7 to copy to dst while warps 0-3 update
// the diagonal tile (n = 0: all of it in L already); `taken` is signalled
// when the copy is done.
struct Rest {
    float* dst;
    uint32_t src;
    int n;
    uint64_t* taken;
};

// Factor panel j (the calling CTA's, all its threads), after its tiles
// take panel j - 1's terms (L; null for panel 0): warps 0-3 the diagonal
// tile, a quarter of its rows each, while warps 4-7 copy the rest of panel
// j - 1 (rest); then warp 0 the diagonal block while warps 1-7 update the
// panel's tiles below; then the rows below the block.
template <int SCHED, int SROWS>
__device__ __forceinline__ void factor_panel(const Panel& P, int j,
                                             const Panel* L, const Rest& rest,
                                             int kq, int h, int C, float* y,
                                             float* ynext, float* rinv,
                                             float* pinv, float* DT,
                                             int tid) {
    const int j0 = j * NB, lane = tid & 31, warp = tid >> 5;
    if (L) {
        if (warp < 4) {
            update_rows<SCHED, 1>(*L, P, j, j, j0 - NB, h, lane, warp);
            asm volatile("bar.sync 1, 128;" ::: "memory");
        } else {
            copy_from(rest.dst, rest.src, rest.n, tid - 128, NTH - 128);
        }
        if (warp > 0) {
            asm volatile("bar.sync 2, 224;" ::: "memory");
            if (warp == 1) signal_all(rest.taken, C, lane);
        }
    }
    if (warp == 0) {
        factor_diagonal<SCHED, SROWS>(P, j, h, y, rinv, pinv, DT, lane);
    } else if (L) {
        for (int t = warp; t < (kq - j0) / NB; t += WARPS - 1)
            update_tile<SCHED>(*L, P, j, j + t, j0 - NB, h, lane);
    }
    __syncthreads();
    solve_rows<SCHED>(P, j, kq, h, y, ynext, DT, pinv, tid);
    __syncthreads();
}

// CTA me's m-th panels, m0 <= m < m1 (those that exist), take panel j's
// terms: a warp a tile, the tiles of all of them dealt out in turn.
template <int SCHED>
__device__ __forceinline__ void update_panels(const Panel& L, int j, int h,
                                              int m0, int m1, int np, int C,
                                              int me, float* store,
                                              const int* poff, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    int base = 0;
    for (int m = m0; m < m1 && panel_of(me, m, C) < np; ++m) {
        const int c = panel_of(me, m, C), n = np - c;
        const Panel P{store + poff[c], c * NB};
        for (int t = (warp - base) & (WARPS - 1); t < n; t += WARPS)
            update_tile<SCHED>(L, P, c, c + t, j * NB, h, lane);
        base += n;
    }
}

// Warp 0 solves block j of L^T x = y (P panel j; the block's rows have
// taken every term of the blocks below), SROWS rows a shuffle round, each
// x_c formed on lane c (x_c = (y_c - its terms) / L_cc) and broadcast.
template <int SROWS>
__device__ __noinline__ void back_block(Panel P, int j, float* y,
                                        const float* rinv, int lane) {
    const int j0 = j * NB;
    const float rj = rinv[j0 + lane];
    // column `lane` of the diagonal block: L[j0 + c][j0 + lane]
    float lc[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) lc[c] = P.at(j0 + c, lane);
    float t = y[j0 + lane];
    if constexpr (SROWS == 2) {
#pragma unroll
        for (int c = NB - 1; c >= 1; c -= 2) {
            const float xc = __shfl_sync(0xffffffffu, t * rj, c);
            // on lane c - 1: (y - L[c][c - 1] x_c) / L_{c-1, c-1}
            const float xc1 = __shfl_sync(0xffffffffu,
                                          fmaf(-lc[c], xc, t) * rj, c - 1);
            t = lane == c ? xc : lane == c - 1 ? xc1
                : lane < c - 1 ? fmaf(-lc[c - 1], xc1, fmaf(-lc[c], xc, t))
                               : t;
        }
    } else {
#pragma unroll
        for (int c = NB - 1; c >= 0; --c) {
            const float xc = __shfl_sync(0xffffffffu, t * rj, c);
            t = lane == c ? xc : lane < c ? fmaf(-lc[c], xc, t) : t;
        }
    }
    y[j0 + lane] = t;
}

// Row r of block i (P panel i) takes block j's terms (x_j in y), j
// decreasing one at a time.
__device__ __forceinline__ void back_terms(const Panel& P, int i, int r,
                                           int j, float* y) {
    const int j0 = j * NB, R = i * NB + r;
    float v = y[R];
#pragma unroll 8
    for (int c = NB - 1; c >= 0; --c) v = fmaf(-P.at(j0 + c, r), y[j0 + c], v);
    y[R] = v;
}

// ------------------------------------------------------------ the kernel

template <int SCHED, int SROWS, bool TWO_G>
__global__ void __launch_bounds__(NTH, 1)
cluster_solve_kernel(const Args p) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int k = p.k, kq = p.kq, C = p.C, h = p.h, np = kq / NB;
    const int me = static_cast<int>(cluster.block_rank());
    const int b = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the signals: panel p final; panel p copied by the owner of p + 1 (the
    // others copy after it, so the chain's copy has the owner's port to
    // itself); x_p final and in every CTA's y
    uint64_t* ready = reinterpret_cast<uint64_t*>(smem);
    uint64_t* taken = ready + np;
    uint64_t* xready = taken + np;
    int* poff = reinterpret_cast<int*>(smem + signal_floats(np));
    float* y = reinterpret_cast<float*>(poff + ((np + 3) & ~3));  // y, x
    float* rinv = y + kq;                                   // 1 / L_jj
    float* pinv = rinv + kq;
    float* DT = pinv + NB;
    float* store = DT + NB * NB;                            // my panels
    float* cp = store + share_blocks(me, np, C) * NB * NB;  // a copy

    if (tid < np) {
        const int o = owner_of(tid, C);
        int off = 0;
        for (int q = 0; q < tid; ++q)
            if (owner_of(q, C) == o) off += (np - q) * NB * NB;
        poff[tid] = off;
    }
    if (tid == 0) {
        for (int q = 0; q < 3 * np; ++q) signal_init(ready + q);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    load_panels<TWO_G>(p, b, me, np, store, tid);
    if (me == 0)        // owner_of(0): y starts here and travels
        for (int i = tid; i < kq; i += NTH)
            y[i] = i < k ? p.rhs[(size_t)b * k + i] : 0.f;
    __syncthreads();
    cluster.sync();     // every CTA's signals set before any arrives

    auto mine = [&](int q) { return Panel{store + poff[q], q * NB}; };
    // the y of the owner of panel q, where it is another CTA's
    auto y_of = [&](int q) {
        return q < np && owner_of(q, C) != me
                   ? cluster.map_shared_rank(y, owner_of(q, C)) : nullptr;
    };
    if (me == 0) {
        factor_panel<SCHED, SROWS>(mine(0), 0, nullptr, Rest{}, kq, h, C, y,
                                   y_of(1), rinv, pinv, DT, tid);
        if (warp == 0) signal_all(ready, C, lane);
    }
    // step j: my panels past j take panel j's terms
    for (int j = 0; j + 1 < np; ++j) {
        int m0 = 0;
        while (panel_of(me, m0, C) <= j) ++m0;
        const int first = panel_of(me, m0, C);
        if (first >= np) break;
        const int oj = owner_of(j, C), skip = (first - j) * NB * NB;
        const int n = (np - first) * NB * NB;     // the rows to copy
        Panel L{cp, first * NB};
        if (first == j + 1) {
            // the lookahead: panel j + 1 takes panel j's terms and is
            // factored and published before my other panels take them.
            // Panel j's rows of its diagonal block come first; the rest is
            // copied beside the diagonal tile's update.
            Rest rest{cp + NB * NB, 0u, 0, taken + j};
            if (oj == me) {
                L = Panel{store + poff[j] + skip, first * NB};
            } else {
                const uint32_t src = cluster_addr(store + poff[j] + skip, oj);
                signal_wait(ready + j);
                copy_from(cp, src, NB * NB, tid, NTH);
                rest.src = src + 4u * NB * NB;
                rest.n = n - NB * NB;
            }
            __syncthreads();
            factor_panel<SCHED, SROWS>(mine(first), first, &L, rest, kq, h,
                                       C, y, y_of(first + 1), rinv, pinv, DT,
                                       tid);
            if (warp == 0) signal_all(ready + first, C, lane);
            update_panels<SCHED>(L, j, h, m0 + 1, np, np, C, me, store,
                                 poff, tid);
        } else {
            if (oj == me) {
                L = Panel{store + poff[j] + skip, first * NB};
            } else {
                signal_wait(taken + j);
                copy_from(cp, cluster_addr(store + poff[j] + skip, oj), n,
                          tid, NTH);
            }
            __syncthreads();
            update_panels<SCHED>(L, j, h, m0, np, np, C, me, store, poff,
                                 tid);
        }
        __syncthreads();
    }

    // the back substitution, from the last block up: x_j is solved by its
    // owner's warp 0 and written into the y of every CTA that owns a block
    // above it, then signalled
    auto publish_x = [&](int j) {
        const float v = y[j * NB + lane];
        for (int q = 0; q < C && q < j; ++q)
            if (q != me) cluster.map_shared_rank(y, q)[j * NB + lane] = v;
        __syncwarp();
        signal_all(xready + j, C, lane);
    };
    const int last = np - 1;
    if (owner_of(last, C) == me && warp == 0) {
        back_block<SROWS>(mine(last), last, y, rinv, lane);
        __syncwarp();
        publish_x(last);
    }
    for (int j = last; j >= 1 && me < j; --j) {    // my first panel is me
        signal_wait(xready + j);
        // my blocks above j: m < mj (panel_of(me, mj - 1) is the last)
        int mj = 0;
        while (panel_of(me, mj, C) < j) ++mj;
        const bool next = owner_of(j - 1, C) == me;
        if (next && warp == 0) {
            back_terms(mine(j - 1), j - 1, lane, j, y);
            __syncwarp();
            back_block<SROWS>(mine(j - 1), j - 1, y, rinv, lane);
            __syncwarp();
            publish_x(j - 1);
        } else {
            const int w0 = next ? NB : 0, rows = (mj - next) * NB;
            for (int t = tid - w0; t < rows; t += NTH - w0) {
                const int i = panel_of(me, t / NB, C);
                back_terms(mine(i), i, t % NB, j, y);
            }
        }
        __syncthreads();
    }
    __syncthreads();
    for (int m = 0; panel_of(me, m, C) < np; ++m) {
        const int i = panel_of(me, m, C) * NB + lane;
        if (warp == m % WARPS && i < k) p.out[(size_t)b * k + i] = y[i];
    }
    cluster.sync();     // no CTA leaves while another reads its memory
}

// ------------------------------------------------------------ the launch

// The cluster launch's check, asked once per kernel, cluster size, shared
// memory and device (later calls read the cache): the kernel's attributes
// set (the device's largest dynamic shared memory, the carveout, clusters
// past 8 allowed), and the clusters of C CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters); a size whose share does not fit, or
// that the card cannot place, is refused.
inline cudaError_t active_clusters(const void* kern, int C, size_t smem,
                                   long long* active) {
    static std::mutex mu;
    // (kernel, C, smem, device) -> clusters; C = 0 marks a kernel whose
    // attributes are set on that device
    static std::map<std::tuple<const void*, int, size_t, int>, long long>
        cache;
    if (C < 1 || C > CMAX) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(kern, C, smem, dev);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
        *active = hit->second;
        return cudaSuccess;
    }
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
        != cudaSuccess)
        return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const auto attr_key = std::make_tuple(kern, 0, (size_t)0, dev);
    if (cache.find(attr_key) == cache.end()) {
        if ((err = cudaFuncSetAttribute(
                 kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
            != cudaSuccess)
            return err;
        if ((err = cudaFuncSetAttribute(
                 kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                 cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
            return err;
        if ((err = cudaFuncSetAttribute(
                 kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
            != cudaSuccess)
            return err;
        cache.emplace(attr_key, 0);
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg))
        != cudaSuccess)
        return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    *active = n;
    cache.emplace(key, n);
    return cudaSuccess;
}

// One launch: B clusters of C CTAs (a system each) of kern at (kq, C).
template <int SCHED, int SROWS, bool TWO_G>
cudaError_t launch(const Args& p, cudaStream_t stream) {
    const auto kern = cluster_solve_kernel<SCHED, SROWS, TWO_G>;
    const size_t smem = smem_bytes(p.kq, p.C);
    long long active = 0;
    cudaError_t err = active_clusters(reinterpret_cast<const void*>(kern),
                                      p.C, smem, &active);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.B * p.C);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return err;
    return cudaGetLastError();
}

// The checks every export makes of (k, kq, C): 1 <= k <= KMAX, kq the
// 32-padded order, 1 <= C <= CMAX and no more than the panels.
inline bool valid(int B, int k, int kq, int C) {
    return k >= 1 && k <= chol::KMAX && B >= 0 && kq == (k + NB - 1) / NB * NB
           && C >= 1 && C <= CMAX && C <= kq / NB;
}

}  // namespace clu
