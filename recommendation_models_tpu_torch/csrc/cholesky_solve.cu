// Batched ridge-Cholesky solves for the ALS sweep, hand-written for Hopper
// (sm_90a). Built by nvcc into a shared library with a plain C interface
// and called through ctypes (recommendation_models_tpu_torch/ops/cholesky.py).
//
// Replaces three TPU kernels of recommendation_models_tpu/ops/pallas/cholesky.py:
//   cholesky_solve_batched <- _cholesky_solve_kernel_pair (via _cholesky_solve_t)
//   cholesky_solve_hot     <- _cholesky_solve_kernel_hot  (via _cholesky_solve_t_hot)
//   cholesky_solve_2g      <- _cholesky_solve_kernel_2g   (via _cholesky_solve_t(Gt2=))
//
// Contract (both kernels, as on the TPU): every system is factored in f32;
// the ridge is added on load (A = G + reg_b I); pivots are clamped at
// max(d, 1e-30) (L_jj = d * rsqrt(max(d, 1e-30)), substitutions divide by
// max(L_jj, 1e-30)), so an identity-padded system with rhs 0 and the all-zero
// system with rhs 0 both solve to exactly 0.
//
// The hot kernel first adds the Zipf-head columns' terms,
//   A   += sum_c wg[b,c] v_c v_c^T,   rhs += sum_c wr[b,c] v_c,
// with (explicit) wg = [hv != 0], wr = hv or (implicit) wg = alpha hv,
// wr = [hv != 0] + alpha hv, in full f32 (no TF32), then solves as above.
//
// The two-operand kernel (TWO_G) loads A = G + G2 + reg_b I, the second
// gram's lower-triangle tile summed in f32 on load, and then solves as the
// plain kernel does. It must read two lower triangles per system, so its
// bound is about twice the plain solve's bytes; the sum costs one add per
// loaded element and no pass over device memory (G + G2 never exists
// there). With TWO_G false the kernel is the plain solve unchanged.
//
// What bounds it on an H100: at k = 64 the plain solve must read 8.6 KB per
// system (the lower triangle of G, rhs and reg) and write 256 B, and does
// ~0.1 MFLOP, so it is bound by bytes (~2.6 ns per system at 3.35 TB/s); the
// hot gram's k (k + 1) flops per nonzero hot entry make the hot kernel bound
// by f32 operations. Both run far above these bounds, because a Cholesky
// factor is a chain of k dependent pivots: latency per system sets the time.
//
// Design: one block per system (160 threads at k <= 68, else 256); each
// thread owns 4x4 tiles of the lower triangle of A in registers (one tile at
// k <= 64, three at k = 128, four at k = 160), loaded with 16-byte loads.
// Tiles are numbered by column from the right, so the tiles that still have
// trailing columns are a prefix of the threads and whole warps drop out of
// the updates as the factor advances (numbered by row, every warp kept a
// few live lanes to the end: this order cut the throughput kernel's time by
// a fifth on an H100). The forward substitution rides along the factor as
// one more column; one warp back-substitutes four rows per shuffle round,
// with the round's shared-memory loads issued ahead of its chain (each lane
// keeps NQ rows of x in registers: four up to k = 128, five to k = 160).
// Two regimes, each a kernel with its own export (cholesky_solve_batched /
// _hot / _2g: throughput; the same names with _lat: latency), both taking
// any B. The caller picks one by the batch against the latency kernel's
// resident blocks, which cholesky_solve_resident reports
// (ops/cholesky.py::solve_frame is the rule; past kp = 128 it gives B1's
// batches beyond two waves, or one past kp = 152, to the panel frame of
// csrc/cholesky_rank_panel.cu, which took 0.64-0.83x this throughput
// kernel's time there on an H100, so B1's throughput kernel is not built
// past kp = 152):
//
// - Throughput (B above one wave: the 4,201-row dense block, B = 65,536):
//   a persistent grid of resident blocks loops over systems, so barriers are
//   hidden behind the other resident blocks and issue slots and residency
//   set the time. The factor is right-looking with one barrier per column
//   (the owners of column j publish it to a double-buffered shared vector,
//   every thread applies the rank-1 update). The plain and two-operand
//   kernels are held to 48 registers at k <= 68 (__launch_bounds__(160, 8):
//   8 blocks per SM instead of 7, a few dozen bytes spilled, 6% faster at
//   B = 65,536), and every throughput kernel at k > 68 to two blocks of
//   256 threads per SM (min_blocks). The hot kernel stages all of vh
//   (C x k, 32 KB at k = 64, C = 128) once per block with 16-byte cp.async
//   copies; that shared memory, not registers, holds it to 4 blocks per SM.
//
// - Latency (B at most one wave: the sweep's 256-row blocks): one block per
//   system. Measured on an H100 with per-phase clocks, one system alone is
//   a chain of dependent steps, each of a few hundred instructions of one
//   warp, so steps and instructions, not bytes, set the time. The factor
//   takes 4-column panels, one barrier each (k / 4 instead of k), with a
//   one-panel lookahead: the owner of the next diagonal tile factors it
//   (4x4) as soon as its update is done and publishes L and the inverse
//   pivots, so the pivots' chain runs in one thread while the other warps
//   update; after the barrier every thread solves the panel rows of its
//   trailing tiles against them and applies the rank-4 update. (A second
//   barrier per panel, to solve each panel row once instead of once per
//   tile, measured slower; so did a panel factored by one warp.) The hot
//   kernel reads its first slab chunk ahead of the G tiles, compacts the
//   nonzero hot entries with warp ballots and one block barrier, and copies
//   only those rows of vh (28% of C on the ML-25M main path) into shared
//   memory with 16-byte cp.async copies as the compaction finds them.
//   (Not cp.async.bulk: a row is 256 B and a bulk copy needs an mbarrier;
//   the per-lane copies take any k.) The panel buffers reuse vh's shared
//   memory once the hot gram is done, so the latency kernel needs no more
//   shared memory than the throughput one wherever the hot kernel runs.
//
// Both regimes repeat bitwise from run to run (no atomics; fixed orders);
// explicit hot weights (all 1) skip their products, which changes no bit.
// The launches ask the runtime for residency once per kernel and size
// (chol::resident_blocks), so a launch is one kernel call on the host.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define CHOL_KMAX 160   // largest system order of these kernels
#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;
using chol::pick4;

constexpr int CMAX = 1024;  // widest hot block (the layout policy's cap)
// largest dynamic shared memory of one block on sm_90 (227 KB); a hot block
// whose vh does not fit with the rest is refused (the wrapper routes it)
constexpr size_t SMEM_MAX = 227 * 1024;

// Everything a launch passes, by value (kernel parameter space).
struct Args {
    const float* G;
    const float* G2;
    const float* rhs;
    const float* reg;
    const __nv_bfloat16* hv;
    const float* vh;
    float* out;
    int B, k, kp, C;
    int vec;        // G (and G2) rows take 16-byte loads
    int vec_vh;     // vh rows take 16-byte copies
    int has_alpha;
    float alpha;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One row of vh (k floats) into a kp-float shared row, zero-padded.
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int k, int kp, int vec) {
    if (vec) {
        for (int i = 0; i < k; i += 4) cp_async16(dst + i, src + i);
    } else {
        for (int i = 0; i < k; ++i) cp_async4(dst + i, src + i);
        for (int i = k; i < kp; ++i) dst[i] = 0.f;
    }
}

// Warp w's run of hot columns [c_lo, c_hi): whole 32-column chunks.
template <int WARPS>
__device__ __forceinline__ void hot_span(int hc, int warp, int& c_lo,
                                         int& c_hi) {
    const int span = (hc + 32 * WARPS - 1) / (32 * WARPS) * 32;
    c_lo = warp * span;
    c_hi = min(c_lo + span, hc);
}

// Compacts one system's nonzero hot entries, in column order, into nz_wg /
// nz_wr (and nz_c, or with LAT the row itself, copied into slot e of vh_s)
// and returns their count. Warp w scans its own run of columns with ballots;
// one barrier publishes the warps' counts. The caller's next barrier makes
// the entries (and, after cp_async_wait_all, the rows) visible. h_first is
// this lane's entry of the warp's first chunk, loaded by the caller ahead
// of the G tiles so that the two loads' latencies overlap.
template <int WARPS, bool LAT>
__device__ __forceinline__ int compact_hot(
    const __nv_bfloat16* __restrict__ hvb, float h_first, const Args& p,
    float* vh_s, int* nz_c, float* nz_wg, float* nz_wr, int* warp_cnt,
    int warp, int lane) {
    int c_lo, c_hi;
    hot_span<WARPS>(p.C, warp, c_lo, c_hi);
    int cnt = 0;
    for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
        const int c = c0 + lane;
        const float h = c0 == c_lo ? h_first
                        : c < c_hi ? __bfloat162float(hvb[c]) : 0.f;
        cnt += __popc(__ballot_sync(0xffffffffu, h != 0.f));
    }
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int n = warp_cnt[w];
        if (w < warp) off += n;
        total += n;
    }
    for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
        const int c = c0 + lane;
        const float h = c0 == c_lo ? h_first
                        : c < c_hi ? __bfloat162float(hvb[c]) : 0.f;
        const unsigned ballot = __ballot_sync(0xffffffffu, h != 0.f);
        if (h != 0.f) {
            const int e = off + __popc(ballot & ((1u << lane) - 1u));
            nz_wg[e] = p.has_alpha ? p.alpha * h : 1.f;
            nz_wr[e] = p.has_alpha ? 1.f + p.alpha * h : h;
            if (LAT)
                copy_row(vh_s + (size_t)e * p.kp, p.vh + (size_t)c * p.k,
                         p.k, p.kp, p.vec_vh);
            else
                nz_c[e] = c;
        }
        off += __popc(ballot);
    }
    return total;
}

// y[q] of a lane's NQ rows, selected without dynamic register indexing.
template <int NQ>
__device__ __forceinline__ float pickq(const float (&y)[NQ], int q) {
    float v = y[0];
#pragma unroll
    for (int s = 1; s < NQ; ++s) v = q == s ? y[s] : v;
    return v;
}

// Back substitution L^T x = y in one warp (x in registers: lane l holds
// rows l, l+32, .., l+32 (NQ-1)), four rows per round: the diagonal
// block's four y are broadcast together and solved against the block, then
// every row above takes the block's four terms, x_j0+3 first, so each y_i
// sees the same operations in the same order as one row per round would
// give it.
// The loads of a round do not wait on the chain. L (As, row j = column j
// of L^T), 1/L_jj (rinv) and y (ys) must be set on all kp rows: padding
// rows hold y = 0, 1/L_jj = 1 and L = 0 and solve to exactly 0.
template <int NQ>
__device__ __forceinline__ void back_substitute(const float* As,
                                                const float* rinv,
                                                const float* ys, float* ob,
                                                int k, int kp, int ld,
                                                int lane) {
    float y[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
        y[q] = lane + 32 * q < kp ? ys[lane + 32 * q] : 0.f;
#pragma unroll 1
    for (int j0 = kp - 4; j0 >= 0; j0 -= 4) {
        const float* L0 = As + j0 * ld;
        const float* L1 = L0 + ld;
        const float* L2 = L1 + ld;
        const float* L3 = L2 + ld;
        // this lane's entries of the block's four rows, for the lane slots
        // that hold a row above or in the block (warp-uniform; rows at or
        // below the block read values that the select below drops)
        float l[NQ][4];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (32 * q >= j0 + 4) break;
            const int i = min(lane + 32 * q, kp - 1);
            l[q][0] = L0[i]; l[q][1] = L1[i]; l[q][2] = L2[i];
            l[q][3] = L3[i];
        }
        const float d32 = L3[j0 + 2], d31 = L3[j0 + 1], d30 = L3[j0];
        const float d21 = L2[j0 + 1], d20 = L2[j0], d10 = L1[j0];
        const float r0 = rinv[j0], r1 = rinv[j0 + 1], r2 = rinv[j0 + 2],
                    r3 = rinv[j0 + 3];
        const float cur = pickq<NQ>(y, j0 >> 5);
        const int jl = j0 & 31;
        const float t0 = __shfl_sync(0xffffffffu, cur, jl);
        const float t1 = __shfl_sync(0xffffffffu, cur, jl + 1);
        const float t2 = __shfl_sync(0xffffffffu, cur, jl + 2);
        const float t3 = __shfl_sync(0xffffffffu, cur, jl + 3);
        const float x3 = t3 * r3;
        const float x2 = fmaf(-d32, x3, t2) * r2;
        const float x1 = fmaf(-d21, x2, fmaf(-d31, x3, t1)) * r1;
        const float x0 = fmaf(-d10, x1, fmaf(-d20, x2, fmaf(-d30, x3, t0)))
                         * r0;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (32 * q >= j0 + 4) break;
            const int i = lane + 32 * q;
            const float u = fmaf(-l[q][0], x0,
                                 fmaf(-l[q][1], x1,
                                      fmaf(-l[q][2], x2,
                                           fmaf(-l[q][3], x3, y[q]))));
            // in the block, i - j0 = i & 3
            const int c = i & 3;
            const float xi = c == 0 ? x0 : c == 1 ? x1 : c == 2 ? x2 : x3;
            float v = i < j0 + 4 ? xi : y[q];
            y[q] = i < j0 ? u : v;
        }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
        if (lane + 32 * q < k) ob[lane + 32 * q] = y[q];
}

// rsqrt of a normal positive float (every pivot is clamped at 1e-30): the
// hardware's approximation, as rsqrtf gives it for such inputs, without the
// subnormal range check on the pivots' chain.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// The factor of a 4x4 diagonal block D (lower part read): L (lower, with
// L_cc on the diagonal) and inv_c = rsqrt(max(d_c, floor)), the same
// arithmetic per column as the rank-1 step.
__device__ __forceinline__ void factor4(const float4 (&q)[4],
                                        float (&L)[4][4], float (&inv)[4]) {
    const float d0 = q[0].x;
    inv[0] = rsqrt_normal(fmaxf(d0, PIVOT_FLOOR));
    L[0][0] = d0 * inv[0];
    L[1][0] = q[1].x * inv[0];
    L[2][0] = q[2].x * inv[0];
    L[3][0] = q[3].x * inv[0];
    const float d1 = fmaf(-L[1][0], L[1][0], q[1].y);
    inv[1] = rsqrt_normal(fmaxf(d1, PIVOT_FLOOR));
    L[1][1] = d1 * inv[1];
    L[2][1] = fmaf(-L[2][0], L[1][0], q[2].y) * inv[1];
    L[3][1] = fmaf(-L[3][0], L[1][0], q[3].y) * inv[1];
    const float d2 = fmaf(-L[2][1], L[2][1], fmaf(-L[2][0], L[2][0], q[2].z));
    inv[2] = rsqrt_normal(fmaxf(d2, PIVOT_FLOOR));
    L[2][2] = d2 * inv[2];
    L[3][2] = fmaf(-L[3][1], L[2][1], fmaf(-L[3][0], L[2][0], q[3].z))
              * inv[2];
    const float d3 = fmaf(-L[3][2], L[3][2],
                          fmaf(-L[3][1], L[3][1],
                               fmaf(-L[3][0], L[3][0], q[3].w)));
    inv[3] = rsqrt_normal(fmaxf(d3, PIVOT_FLOOR));
    L[3][3] = d3 * inv[3];
}

// One row below the diagonal block: l = its 4 panel entries of L.
__device__ __forceinline__ void panel_row(const float4 a,
                                          const float (&L)[4][4],
                                          const float (&inv)[4],
                                          float (&l)[4]) {
    l[0] = a.x * inv[0];
    l[1] = fmaf(-l[0], L[1][0], a.y) * inv[1];
    l[2] = fmaf(-l[1], L[2][1], fmaf(-l[0], L[2][0], a.z)) * inv[2];
    l[3] = fmaf(-l[2], L[3][2],
                fmaf(-l[1], L[3][1], fmaf(-l[0], L[3][0], a.w))) * inv[3];
}

// The diagonal block's factor, published by its tile's owner: L's ten
// lower entries and the four inverse pivots, as four float4 at D.
__device__ __forceinline__ void publish_diag(const float (&t)[4][4],
                                             float* D) {
    const float4 q[4] = {make_float4(t[0][0], t[0][1], t[0][2], t[0][3]),
                         make_float4(t[1][0], t[1][1], t[1][2], t[1][3]),
                         make_float4(t[2][0], t[2][1], t[2][2], t[2][3]),
                         make_float4(t[3][0], t[3][1], t[3][2], t[3][3])};
    float L[4][4], inv[4];
    factor4(q, L, inv);
    float4* D4 = reinterpret_cast<float4*>(D);
    D4[0] = make_float4(L[0][0], L[1][0], L[1][1], L[2][0]);
    D4[1] = make_float4(L[2][1], L[2][2], L[3][0], L[3][1]);
    D4[2] = make_float4(L[3][2], L[3][3], inv[0], inv[1]);
    D4[3] = make_float4(inv[2], inv[3], 0.f, 0.f);
}

__device__ __forceinline__ void read_diag(const float* D, float (&L)[4][4],
                                          float (&inv)[4]) {
    const float4* D4 = reinterpret_cast<const float4*>(D);
    const float4 a = D4[0], b = D4[1], c = D4[2], d = D4[3];
    L[0][0] = a.x; L[1][0] = a.y; L[1][1] = a.z; L[2][0] = a.w;
    L[2][1] = b.x; L[2][2] = b.y; L[3][0] = b.z; L[3][1] = b.w;
    L[3][2] = c.x; L[3][3] = c.y; inv[0] = c.z; inv[1] = c.w;
    inv[2] = d.x; inv[3] = d.y;
}

// The hot gram into the thread's tiles: A += sum_e w_e v_e v_e^T over the
// compacted nonzero entries, v_e read from shared memory as float4 (row e
// of vh_s for LAT, row nz_c[e] otherwise); W false: every w_e is 1.
template <int NT, bool LAT, bool W>
__device__ __forceinline__ void hot_gram(float (&a)[NT][4][4],
                                         const float* vh_s, const int* nz_c,
                                         const float* nz_wg, int total,
                                         int kp, const int (&ti)[NT],
                                         const int (&tl)[NT],
                                         const bool (&live)[NT]) {
#pragma unroll 2
    for (int e = 0; e < total; ++e) {
        const float* vc = vh_s + (LAT ? e : nz_c[e]) * kp;
        const float w = W ? nz_wg[e] : 1.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (!live[n]) continue;
            const float4 qi = *reinterpret_cast<const float4*>(vc + ti[n] * 4);
            const float4 ql = *reinterpret_cast<const float4*>(vc + tl[n] * 4);
            const float vi[4] = {W ? w * qi.x : qi.x, W ? w * qi.y : qi.y,
                                 W ? w * qi.z : qi.z, W ? w * qi.w : qi.w};
            const float vl[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int s = 0; s < 4; ++s)
                    a[n][r][s] = fmaf(vi[r], vl[s], a[n][r][s]);
        }
    }
}

// Residency of the throughput kernels: 48 registers for the plain and
// two-operand kernels at k <= 68 (8 blocks of 160 threads per SM), and at
// most 128 at k > 68 (2 blocks of 256 threads; unbounded, the k = 128
// kernel took 135 registers, one block per SM, and ran 38% slower).
constexpr int min_blocks(int nth, bool hot, bool lat) {
    return lat ? 1 : nth == 160 ? (hot ? 1 : 8) : 2;
}

// NTH threads per block, NT lower-triangle tiles per thread; LAT selects
// the latency regime's schedule (one system per block); NQ rows of x per
// lane in the back substitution (kp <= 32 NQ).
template <int NTH, int NT, bool HOT, bool TWO_G, bool LAT, int NQ>
__global__ void __launch_bounds__(NTH, min_blocks(NTH, HOT, LAT))
chol_solve_kernel(const Args p) {
    constexpr int WARPS = NTH / 32;
    extern __shared__ __align__(16) float smem[];
    const int k = p.k, kp = p.kp;
    const int hc = HOT ? p.C : 0;
    // shared layout (smem_bytes): throughput: vh (hc, kp), the column
    // buffers (2, kp + 4); latency: one region of max(hc kp, 2 (4 kp + 20))
    // floats, the compacted hot rows and then the two panel buffers (A's
    // panel (kp, 4), the rhs block, the diagonal block's factor). Then L
    // (kp, kp + 1), y, 1 / L_jj, the hot weights (2 hc), the throughput
    // kernel's hot columns (hc) and the per-warp counts.
    float* vh_s = smem;
    const int region = LAT ? max(hc * kp, 2 * (4 * kp + 20))
                           : hc * kp + 2 * (kp + 4);
    float* colbuf = LAT ? smem : smem + hc * kp;
    float* As = smem + region;
    float* ys = As + kp * (kp + 1);
    float* rinv = ys + kp;
    float* nz_wg = rinv + kp;
    float* nz_wr = nz_wg + hc;
    int* nz_c = reinterpret_cast<int*>(nz_wr + hc);
    int* warp_cnt = nz_c + (LAT ? 0 : hc);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int T = kp >> 2;                    // 4x4 tiles per dimension
    const int ld = kp + 1;

    // threads own the lower-triangle tiles (ti >= tl) only: the update and
    // the hot gram are symmetric, and the substitutions read L's lower half.
    // Tiles are numbered by column from the right (t = 0 is the last
    // column's one tile), so the tiles that still have trailing columns at
    // any step are a prefix of the threads: whole warps drop out of the
    // factor's updates as it advances instead of idling lane by lane.
    int ti[NT], tl[NT];
    bool live[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int t = tid + n * NTH;
        live[n] = t < T * (T + 1) / 2;
        int r = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while ((r + 1) * (r + 2) / 2 <= t) ++r;
        while (r * (r + 1) / 2 > t) --r;
        tl[n] = live[n] ? T - 1 - r : 0;
        ti[n] = live[n] ? T - 1 - r + (t - r * (r + 1) / 2) : 0;
    }

    if (HOT && !LAT) {
        // all of vh, once per persistent block (published by the first
        // system's barrier)
        if (p.vec_vh) {
            for (int e = tid * 4; e < hc * kp; e += NTH * 4)
                cp_async16(vh_s + e, p.vh + e);
        } else {
            for (int e = tid; e < hc * kp; e += NTH) {
                const int c = e / kp, i = e - c * kp;
                vh_s[e] = i < k ? p.vh[(size_t)c * k + i] : 0.f;
            }
        }
        cp_async_wait_all();
    }

    if (!LAT) {
        // padding rows (k <= i < kp) are never factored here: L = 0 and
        // 1/L_ii = 1 on them let the back substitution solve them to 0
        for (int e = tid; e < (kp - k) * kp; e += NTH)
            As[(k + e / kp) * ld + e % kp] = 0.f;
        if (tid < kp - k) rinv[k + tid] = 1.f;
    }

    for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
        // the previous system's back substitution is done with As/ys; the
        // first pass also publishes vh_s
        __syncthreads();
        const float* Gb = p.G + (size_t)b * k * k;
        const float rb = p.reg[b];
        float h_first = 0.f;
        if (HOT) {
            int c_lo, c_hi;
            hot_span<WARPS>(hc, warp, c_lo, c_hi);
            if (c_lo + lane < c_hi)
                h_first = __bfloat162float(p.hv[(size_t)b * hc + c_lo + lane]);
        }

        float a[NT][4][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti[n] * 4 + r;
                const int l0 = tl[n] * 4;
                float v[4] = {0.f, 0.f, 0.f, 0.f};
                if (live[n] && i < k) {
                    if (p.vec && l0 < k) {
                        const float4 q = *reinterpret_cast<const float4*>(
                            Gb + (size_t)i * k + l0);
                        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
                        if (TWO_G) {
                            const float4 q2 = *reinterpret_cast<const float4*>(
                                p.G2 + (size_t)b * k * k + (size_t)i * k + l0);
                            v[0] += q2.x; v[1] += q2.y; v[2] += q2.z;
                            v[3] += q2.w;
                        }
                    } else {
#pragma unroll
                        for (int s = 0; s < 4; ++s)
                            if (l0 + s < k) {
                                v[s] = Gb[(size_t)i * k + l0 + s];
                                if (TWO_G)
                                    v[s] += p.G2[(size_t)b * k * k
                                                 + (size_t)i * k + l0 + s];
                            }
                    }
                }
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const int l = l0 + s;
                    // identity on the padding rows/cols beyond k keeps the
                    // padded block decoupled and solving to 0
                    float x = v[s];
                    if (i == l) x += (i < k) ? rb : 1.f;
                    a[n][r][s] = x;
                }
            }
        }

        // thread i < k carries rhs_i through the factorization
        float bi = 0.f;
        if (tid < k) bi = p.rhs[(size_t)b * k + tid];

        if (HOT) {
            const int total = compact_hot<WARPS, LAT>(
                p.hv + (size_t)b * hc, h_first, p, vh_s, nz_c, nz_wg, nz_wr,
                warp_cnt, warp, lane);
            if (LAT) cp_async_wait_all();
            __syncthreads();
            // explicit weights are all 1: no product with them (the same
            // values, bitwise)
            if (p.has_alpha)
                hot_gram<NT, LAT, true>(a, vh_s, nz_c, nz_wg, total, kp, ti,
                                        tl, live);
            else
                hot_gram<NT, LAT, false>(a, vh_s, nz_c, nz_wg, total, kp, ti,
                                         tl, live);
            if (tid < k) {
                float acc = 0.f;
                for (int e = 0; e < total; ++e)
                    acc = fmaf(nz_wr[e],
                               vh_s[(LAT ? e : nz_c[e]) * kp + tid], acc);
                bi += acc;
            }
            // the latency kernel's panel buffers reuse vh_s
            if (LAT) __syncthreads();
        }

        if (!LAT) {
            // Right-looking factorization with the forward substitution
            // folded in (rhs as one more column), one barrier per column.
            // Before the barrier the owners of column j (tiles with
            // tl == j/4) publish its rows below j (rows <= j as 0, so the
            // update needs no masks) and the pivot d; thread j publishes
            // its rhs entry. After it, thread i writes L[i][j] into As and
            // updates its rhs entry, and every thread applies the rank-1
            // update to its trailing tiles.
            const int bs = kp + 4;
            for (int j = 0; j < k; ++j) {
                float* buf = colbuf + (j & 1) * bs;
                const int jt = j >> 2, jj = j & 3;
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (live[n] && tl[n] == jt) {
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const int i = ti[n] * 4 + r;
                            const float v = pick4(a[n][r], jj);
                            buf[i] = i > j ? v : 0.f;
                            if (i == j) buf[kp] = v;
                        }
                    }
                }
                if (tid == j) buf[kp + 1] = bi;
                __syncthreads();
                const float d = buf[kp];
                const float inv = rsqrt_normal(fmaxf(d, PIVOT_FLOOR));
                const float inv2 = inv * inv;
                if (tid < k && tid >= j) {
                    const float bj = buf[kp + 1];
                    if (tid == j) {
                        const float ljj = d * inv;
                        As[j * ld + j] = ljj;
                        rinv[j] = __frcp_rn(fmaxf(ljj, PIVOT_FLOOR));
                        bi = bj * inv;                      // y_j
                    } else {
                        const float c = buf[tid];
                        As[tid * ld + j] = c * inv;         // L[i][j]
                        bi = fmaf(-c * inv2, bj, bi);
                    }
                }
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (!live[n]) continue;
                    const int i0 = ti[n] * 4, l0 = tl[n] * 4;
                    if (l0 + 3 > j) {   // the tile still has trailing columns
                        const float4 qi =
                            *reinterpret_cast<const float4*>(buf + i0);
                        const float4 ql =
                            *reinterpret_cast<const float4*>(buf + l0);
                        const float ci[4] = {qi.x * inv2, qi.y * inv2,
                                             qi.z * inv2, qi.w * inv2};
                        const float cl[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
                        for (int r = 0; r < 4; ++r)
#pragma unroll
                            for (int s = 0; s < 4; ++s)
                                a[n][r][s] = fmaf(-ci[r], cl[s], a[n][r][s]);
                    }
                }
            }
        } else {
            // Right-looking factorization in 4-column panels, one barrier
            // per panel, the forward substitution folded in, with a
            // one-panel lookahead. The diagonal block of panel jt is
            // factored by its tile's owner as soon as its last update is
            // done (in step jt - 1, or here for jt = 0) and published with
            // its inverse pivots (D); before the barrier the owners of the
            // panel's other tiles publish them as (kp, 4) rows, and threads
            // j0..j0+3 their rhs entries. After it every thread solves the
            // panel rows of its trailing tiles against D and applies their
            // rank-4 update (the owner of the next diagonal tile then
            // factors it), and thread i < kp writes row i of the panel's L
            // into As and updates its rhs entry. So the pivots' chain runs
            // in one thread while the other warps update, and the k / 4
            // barriers are the only waits. Padding rows (k <= i < kp) are
            // identity rows and solve to 0.
            const int pstride = 4 * kp + 20;   // panel rows, b (4), D (16)
#pragma unroll
            for (int n = 0; n < NT; ++n)
                if (live[n] && ti[n] == 0 && tl[n] == 0)
                    publish_diag(a[n], colbuf + 4 * kp + 4);
            for (int jt = 0; jt < T; ++jt) {
                float* P = colbuf + (jt & 1) * pstride;
                const float4* P4 = reinterpret_cast<const float4*>(P);
                const int j0 = jt * 4;
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (live[n] && tl[n] == jt && ti[n] > jt) {
#pragma unroll
                        for (int r = 0; r < 4; ++r)
                            *reinterpret_cast<float4*>(
                                P + (ti[n] * 4 + r) * 4) =
                                make_float4(a[n][r][0], a[n][r][1],
                                            a[n][r][2], a[n][r][3]);
                    }
                }
                if (tid >= j0 && tid < j0 + 4) P[4 * kp + tid - j0] = bi;
                __syncthreads();
                float L[4][4] = {}, inv[4];
                read_diag(P + 4 * kp + 4, L, inv);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (!live[n] || tl[n] <= jt) continue;
                    float li[4][4], ll[4][4];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        panel_row(P4[ti[n] * 4 + r], L, inv, li[r]);
                        panel_row(P4[tl[n] * 4 + r], L, inv, ll[r]);
                    }
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int s = 0; s < 4; ++s)
#pragma unroll
                            for (int c = 0; c < 4; ++c)
                                a[n][r][s] = fmaf(-li[r][c], ll[s][c],
                                                  a[n][r][s]);
                    if (ti[n] == jt + 1 && tl[n] == jt + 1)
                        publish_diag(a[n], colbuf + ((jt + 1) & 1) * pstride
                                               + 4 * kp + 4);
                }
                const float4 qb = P4[kp];
                float y[4];
                y[0] = qb.x * inv[0];
                y[1] = fmaf(-L[1][0], y[0], qb.y) * inv[1];
                y[2] = fmaf(-L[2][1], y[1], fmaf(-L[2][0], y[0], qb.z))
                       * inv[2];
                y[3] = fmaf(-L[3][2], y[2],
                            fmaf(-L[3][1], y[1],
                                 fmaf(-L[3][0], y[0], qb.w))) * inv[3];
                if (tid >= j0 + 4 && tid < kp) {
                    float l[4];
                    panel_row(P4[tid], L, inv, l);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        As[tid * ld + j0 + c] = l[c];
                        bi = fmaf(-l[c], y[c], bi);
                    }
                }
                if (tid >= j0 && tid < j0 + 4) {
                    // row cc of the diagonal block, picked by selects (no
                    // branch per row; one reciprocal per thread)
                    const int cc = tid - j0;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const float col[4] = {L[0][c], L[1][c], L[2][c],
                                              L[3][c]};
                        if (c <= cc) As[tid * ld + j0 + c] = pick4(col, cc);
                    }
                    const float diag[4] = {L[0][0], L[1][1], L[2][2],
                                           L[3][3]};
                    rinv[tid] = __frcp_rn(fmaxf(pick4(diag, cc),
                                                PIVOT_FLOOR));
                    bi = pick4(y, cc);
                }
            }
        }
        if (tid < kp) ys[tid] = tid < k ? bi : 0.f;
        __syncthreads();
        if (warp == 0)
            back_substitute<NQ>(As, rinv, ys, p.out + (size_t)b * k, k, kp,
                                ld, lane);
    }
}

// Dynamic shared memory of a block (the layout at the top of the kernel).
size_t smem_bytes(int kp, int hc, int warps, bool lat) {
    const size_t region = lat ? (size_t)max(hc * kp, 2 * (4 * kp + 20))
                              : (size_t)hc * kp + 2 * (size_t)(kp + 4);
    return sizeof(float) * (region + (size_t)kp * (kp + 1) + 2 * (size_t)kp
                            + 2 * (size_t)hc)
           + sizeof(int) * ((lat ? 0 : (size_t)hc) + warps);
}

// What a dispatch does: launch the throughput or the latency kernel, or
// only report the latency kernel's resident blocks.
enum Mode { THROUGHPUT, LATENCY, RESIDENT };

template <int NTH, int NT, bool HOT, bool TWO_G, int NQ>
cudaError_t run(const Args& p, cudaStream_t stream, Mode mode,
                long long* resident) {
    const int hc = HOT ? p.C : 0;
    // past kp = 152 (NT 4) B1's batches beyond the latency kernel take the
    // panel frame of csrc/cholesky_rank_panel.cu
    // (cholesky_solve_batched_panel; ops/cholesky.py::solve_frame), so its
    // throughput kernel is not built there
    if constexpr (!HOT && !TWO_G && NT == 4) {
        if (mode == THROUGHPUT) return cudaErrorInvalidValue;
    } else if (mode == THROUGHPUT) {
        return chol::launch_persistent(
            chol_solve_kernel<NTH, NT, HOT, TWO_G, false, NQ>, NTH,
            smem_bytes(p.kp, hc, NTH / 32, false), p.B, stream, p);
    }
    const size_t smem = smem_bytes(p.kp, hc, NTH / 32, true);
    const auto kern = chol_solve_kernel<NTH, NT, HOT, TWO_G, true, NQ>;
    if (mode == LATENCY)
        return smem > SMEM_MAX ? cudaErrorInvalidValue
                               : chol::launch_persistent(kern, NTH, smem, p.B,
                                                         stream, p);
    // a latency block that does not fit is resident 0 times
    *resident = 0;
    return smem > SMEM_MAX ? cudaSuccess
                           : chol::resident_blocks(
                                 reinterpret_cast<const void*>(kern), NTH,
                                 smem, resident);
}

template <bool HOT, bool TWO_G>
cudaError_t dispatch(const void* G, const void* G2, const void* rhs,
                     const void* reg, const void* hv, const void* vh,
                     void* out, int B, int k, int C, int has_alpha,
                     float alpha, void* stream, Mode mode,
                     long long* resident = nullptr) {
    if (k < 1 || k > KMAX || B < 0) return cudaErrorInvalidValue;
    const int kp = (k + 3) & ~3;
    const int config = chol::tile_config(k);
    if (HOT && (C < 1 || C > CMAX
                || smem_bytes(kp, C, chol::config_threads(config) / 32,
                              false) > SMEM_MAX))
        return cudaErrorInvalidValue;
    if (B == 0 && mode != RESIDENT) return cudaSuccess;
    Args p;
    p.G = static_cast<const float*>(G);
    p.G2 = static_cast<const float*>(G2);
    p.rhs = static_cast<const float*>(rhs);
    p.reg = static_cast<const float*>(reg);
    p.hv = static_cast<const __nv_bfloat16*>(hv);
    p.vh = static_cast<const float*>(vh);
    p.out = static_cast<float*>(out);
    p.B = B;
    p.k = k;
    p.kp = kp;
    p.C = C;
    p.vec = (k % 4 == 0) && (((uintptr_t)G & 15) == 0)
            && (((uintptr_t)G2 & 15) == 0);
    p.vec_vh = (k % 4 == 0) && (((uintptr_t)vh & 15) == 0);
    p.has_alpha = has_alpha;
    p.alpha = alpha;
    auto s = static_cast<cudaStream_t>(stream);
    // x's rows per substitution lane: four up to kp = 128, then five
    switch (config) {
    case 0: return run<160, 1, HOT, TWO_G, 4>(p, s, mode, resident);
    case 1: return run<256, 1, HOT, TWO_G, 4>(p, s, mode, resident);
    case 2: return run<256, 2, HOT, TWO_G, 4>(p, s, mode, resident);
    case 3:
        return kp <= 128 ? run<256, 3, HOT, TWO_G, 4>(p, s, mode, resident)
                         : run<256, 3, HOT, TWO_G, 5>(p, s, mode, resident);
    default: return run<256, 4, HOT, TWO_G, 5>(p, s, mode, resident);
    }
}

}  // namespace

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major. 1 <= k <= 160. The throughput kernel,
// to kp = 152 (past it B1's larger batches take the panel frame,
// cholesky_solve_batched_panel in csrc/cholesky_rank_panel.cu);
// cholesky_solve_batched_lat, of the same arguments, the latency kernel.
int cholesky_solve_batched(const void* G, const void* rhs, const void* reg,
                           void* out, int B, int k, void* stream) {
    return (int)dispatch<false, false>(G, nullptr, rhs, reg, nullptr, nullptr,
                                       out, B, k, 0, 0, 0.f, stream,
                                       THROUGHPUT);
}

int cholesky_solve_batched_lat(const void* G, const void* rhs,
                               const void* reg, void* out, int B, int k,
                               void* stream) {
    return (int)dispatch<false, false>(G, nullptr, rhs, reg, nullptr, nullptr,
                                       out, B, k, 0, 0, 0.f, stream, LATENCY);
}

// As cholesky_solve_batched for A = G + G2 + diag(reg): the second gram
// G2 (B, k, k) f32 is summed on load.
int cholesky_solve_2g(const void* G, const void* G2, const void* rhs,
                      const void* reg, void* out, int B, int k,
                      void* stream) {
    return (int)dispatch<false, true>(G, G2, rhs, reg, nullptr, nullptr, out,
                                      B, k, 0, 0, 0.f, stream, THROUGHPUT);
}

int cholesky_solve_2g_lat(const void* G, const void* G2, const void* rhs,
                          const void* reg, void* out, int B, int k,
                          void* stream) {
    return (int)dispatch<false, true>(G, G2, rhs, reg, nullptr, nullptr, out,
                                      B, k, 0, 0, 0.f, stream, LATENCY);
}

// As cholesky_solve_batched, with the hot-column terms of hv (B, C) bf16
// (0 = unobserved) against the hot factor rows vh (C, k) f32 folded in
// first. 1 <= C <= 1024, with vh fitting in shared memory (SMEM_MAX).
// has_alpha selects the implicit weights.
int cholesky_solve_hot(const void* G, const void* rhs, const void* reg,
                       const void* hv, const void* vh, void* out, int B,
                       int k, int C, int has_alpha, float alpha,
                       void* stream) {
    return (int)dispatch<true, false>(G, nullptr, rhs, reg, hv, vh, out, B, k,
                                      C, has_alpha, alpha, stream,
                                      THROUGHPUT);
}

int cholesky_solve_hot_lat(const void* G, const void* rhs, const void* reg,
                           const void* hv, const void* vh, void* out, int B,
                           int k, int C, int has_alpha, float alpha,
                           void* stream) {
    return (int)dispatch<true, false>(G, nullptr, rhs, reg, hv, vh, out, B, k,
                                      C, has_alpha, alpha, stream, LATENCY);
}

// *resident = the blocks of the latency kernel of `kind` (0
// cholesky_solve_batched, 1 cholesky_solve_hot, 2 cholesky_solve_2g) at
// order k (and hot width C) that the current device holds at once: 0 when
// its block does not fit. Launches nothing.
int cholesky_solve_resident(int kind, int k, int C, long long* resident) {
    switch (kind) {
    case 0:
        return (int)dispatch<false, false>(nullptr, nullptr, nullptr, nullptr,
                                           nullptr, nullptr, nullptr, 0, k, 0,
                                           0, 0.f, nullptr, RESIDENT,
                                           resident);
    case 1:
        return (int)dispatch<true, false>(nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, nullptr, 0, k, C,
                                          0, 0.f, nullptr, RESIDENT,
                                          resident);
    case 2:
        return (int)dispatch<false, true>(nullptr, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, nullptr, 0, k, 0,
                                          0, 0.f, nullptr, RESIDENT,
                                          resident);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// (cholesky_kernel_kmax and cholesky_error_string: cholesky_common.cuh)
int cholesky_kernel_cmax(void) { return CMAX; }
long long cholesky_kernel_smem_max(void) { return (long long)SMEM_MAX; }

}  // extern "C"
