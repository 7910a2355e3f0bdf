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
// system (the lower triangle of the symmetric G, plus rhs and reg) and write
// 256 B, and does ~0.1 MFLOP, so it is bound by device-memory bytes
// (~2.6 ns per system at 3.35 TB/s). The symmetric hot gram adds k (k + 1)
// flops per nonzero hot entry (~0.15 MFLOP per system at the ML-25M slab's
// 28% density, 0.53 MFLOP for a full C = 128 slab), which makes the hot
// kernel bound by f32 operations. In practice both run far above these
// bounds: the factorization
// is a chain of k dependent steps, each ending in a block-wide barrier, so
// latency per system sets the time and enough resident blocks must hide it.
//
// Design: one block per system (160 threads at k <= 68, else 256), persistent
// over a grid-stride loop (grid = resident blocks), so the hot factor rows vh
// (C x k, 32 KB at k = 64, C = 128) are staged in shared memory once per
// block, not per system. Each thread owns 4x4 tiles of the lower triangle of
// A in registers (one tile at k <= 64, up to three at k = 128); the G tile
// loads are 16-byte vector loads. The hot gram is accumulated straight into
// those registers over the nonzero hot columns only (the row's slab is
// compacted with warp ballots first), reading vh from shared memory as
// float4. The factorization is right-looking with one barrier per column:
// the owners of column j publish it to a double-buffered shared vector and
// every thread applies the rank-1 update to its tiles; the forward
// substitution rides along as one more column. L goes to shared memory, and
// one warp runs the back substitution with x in registers while the other
// resident blocks keep the SM busy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cholesky_common.cuh"

namespace {

using chol::KMAX;
using chol::PIVOT_FLOOR;
using chol::pick4;

constexpr int CMAX = 1024;  // widest hot block (the layout policy's cap)
// largest dynamic shared memory of one block on sm_90 (227 KB); a hot block
// whose vh does not fit with the rest is refused (the wrapper routes it)
constexpr size_t SMEM_MAX = 227 * 1024;

// NTH threads per block, NT lower-triangle tiles per thread.
template <int NTH, int NT, bool HOT, bool TWO_G>
__global__ void __launch_bounds__(NTH)
chol_solve_kernel(const float* __restrict__ G, const float* __restrict__ G2,
                  const float* __restrict__ rhs,
                  const float* __restrict__ reg,
                  const __nv_bfloat16* __restrict__ hv,
                  const float* __restrict__ vh, float* __restrict__ out,
                  int B, int k, int kp, int C, int vec, int has_alpha,
                  float alpha) {
    constexpr int WARPS = NTH / 32;
    extern __shared__ __align__(16) float smem[];
    const int hc = HOT ? C : 0;
    const int bs = kp + 4;                    // column buffer stride
    float* vh_s = smem;                       // (hc, kp), 16-byte aligned
    float* colbuf = smem + hc * kp;           // (2, kp + 4): column j, d, b_j
    float* As = colbuf + 2 * bs;              // (kp, kp + 1): L, lower half
    float* ys = As + kp * (kp + 1);           // (kp,): y, then x
    float* rinv = ys + kp;                    // (kp,): 1 / max(L_jj, floor)
    int* nz_c = reinterpret_cast<int*>(rinv + kp);     // (hc,)
    float* nz_wg = reinterpret_cast<float*>(nz_c + hc);  // (hc,)
    float* nz_wr = nz_wg + hc;                           // (hc,)
    int* warp_cnt = reinterpret_cast<int*>(nz_wr + hc);  // (WARPS,)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int T = kp >> 2;                    // 4x4 tiles per dimension
    const int ld = kp + 1;

    // threads own the lower-triangle tiles (ti >= tl) only: the update and
    // the hot gram are symmetric, and the substitutions read L's lower half.
    // (The ownership and the tile load stay written out here, not shared
    // with csrc/cholesky_variants.cu: as shared functions they change this
    // kernel's register allocation, and the main path's code stays as it
    // was measured.)
    int ti[NT], tl[NT];
    bool live[NT];
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

    if (HOT) {
        for (int e = tid; e < hc * kp; e += NTH) {
            const int c = e / kp, i = e - c * kp;
            vh_s[e] = i < k ? vh[(size_t)c * k + i] : 0.f;
        }
    }

    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        // the previous system's back substitution is done with As/ys; the
        // first pass also publishes vh_s
        __syncthreads();
        const float* Gb = G + (size_t)b * k * k;
        const float rb = reg[b];

        float a[NT][4][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti[n] * 4 + r;
                const int l0 = tl[n] * 4;
                float v[4] = {0.f, 0.f, 0.f, 0.f};
                if (live[n] && i < k) {
                    if (vec && l0 < k) {
                        const float4 q = *reinterpret_cast<const float4*>(
                            Gb + (size_t)i * k + l0);
                        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
                        if (TWO_G) {
                            const float4 q2 = *reinterpret_cast<const float4*>(
                                G2 + (size_t)b * k * k + (size_t)i * k + l0);
                            v[0] += q2.x; v[1] += q2.y; v[2] += q2.z;
                            v[3] += q2.w;
                        }
                    } else {
#pragma unroll
                        for (int s = 0; s < 4; ++s)
                            if (l0 + s < k) {
                                v[s] = Gb[(size_t)i * k + l0 + s];
                                if (TWO_G)
                                    v[s] += G2[(size_t)b * k * k
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
        if (tid < k) bi = rhs[(size_t)b * k + tid];

        if (HOT) {
            // compact this row's nonzero hot entries (in column order)
            int total = 0;
            for (int c0 = 0; c0 < hc; c0 += NTH) {
                const int c = c0 + tid;
                float h = 0.f;
                if (c < hc) h = __bfloat162float(hv[(size_t)b * hc + c]);
                const bool nz = h != 0.f;
                const unsigned ballot = __ballot_sync(0xffffffffu, nz);
                if (lane == 0) warp_cnt[warp] = __popc(ballot);
                __syncthreads();
                int off = total + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    const int cnt = warp_cnt[w];
                    if (w < warp) off += cnt;
                    total += cnt;
                }
                if (nz) {
                    nz_c[off] = c;
                    nz_wg[off] = has_alpha ? alpha * h : 1.f;
                    nz_wr[off] = has_alpha ? 1.f + alpha * h : h;
                }
                __syncthreads();
            }
            for (int e = 0; e < total; ++e) {
                const float* vc = vh_s + nz_c[e] * kp;
                const float w = nz_wg[e];
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    if (!live[n]) continue;
                    const float4 qi =
                        *reinterpret_cast<const float4*>(vc + ti[n] * 4);
                    const float4 ql =
                        *reinterpret_cast<const float4*>(vc + tl[n] * 4);
                    const float vi[4] = {w * qi.x, w * qi.y, w * qi.z,
                                         w * qi.w};
                    const float vl[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int s = 0; s < 4; ++s)
                            a[n][r][s] = fmaf(vi[r], vl[s], a[n][r][s]);
                }
            }
            if (tid < k) {
                float acc = 0.f;
                for (int e = 0; e < total; ++e)
                    acc = fmaf(nz_wr[e], vh_s[nz_c[e] * kp + tid], acc);
                bi += acc;
            }
        }

        // Right-looking factorization with the forward substitution folded
        // in (rhs as one more column), one barrier per column. Before the
        // barrier the owners of column j (tiles with tl == j/4) publish its
        // rows below j (rows <= j as 0, so the update needs no masks) and
        // the pivot d; thread j publishes its rhs entry. After it, thread i
        // writes L[i][j] into As and updates its rhs entry, and every
        // thread applies the rank-1 update to its trailing tiles.
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
            const float inv = rsqrtf(fmaxf(d, PIVOT_FLOOR));
            const float inv2 = inv * inv;
            if (tid < k && tid >= j) {
                const float bj = buf[kp + 1];
                if (tid == j) {
                    const float ljj = d * inv;
                    As[j * ld + j] = ljj;
                    rinv[j] = 1.f / fmaxf(ljj, PIVOT_FLOOR);
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
                    const float4 qi = *reinterpret_cast<const float4*>(buf + i0);
                    const float4 ql = *reinterpret_cast<const float4*>(buf + l0);
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
        if (tid < kp) ys[tid] = tid < k ? bi : 0.f;
        __syncthreads();

        if (warp == 0) {
            // back substitution L^T x = y in one warp, x in registers: lane
            // l holds rows l, l+32, l+64, l+96. Each step broadcasts the
            // finished x_j with a shuffle; row j of L is read from As
            // (it holds column j of L^T), independent of the chain.
            float y0 = lane < kp ? ys[lane] : 0.f;
            float y1 = lane + 32 < kp ? ys[lane + 32] : 0.f;
            float y2 = lane + 64 < kp ? ys[lane + 64] : 0.f;
            float y3 = lane + 96 < kp ? ys[lane + 96] : 0.f;
#pragma unroll 1
            for (int j = k - 1; j >= 0; --j) {
                const int q0 = j >> 5, jl = j & 31;
                const float cur = q0 == 0 ? y0 : q0 == 1 ? y1
                                : q0 == 2 ? y2 : y3;
                const float xj = __shfl_sync(0xffffffffu, cur, jl) * rinv[j];
                const bool own = lane == jl;
                y0 = (own && q0 == 0) ? xj : y0;
                y1 = (own && q0 == 1) ? xj : y1;
                y2 = (own && q0 == 2) ? xj : y2;
                y3 = (own && q0 == 3) ? xj : y3;
                const float* Lj = As + j * ld;
                int i = lane;
                if (i < j) y0 = fmaf(-Lj[i], xj, y0);
                i += 32;
                if (i < j) y1 = fmaf(-Lj[i], xj, y1);
                i += 32;
                if (i < j) y2 = fmaf(-Lj[i], xj, y2);
                i += 32;
                if (i < j) y3 = fmaf(-Lj[i], xj, y3);
            }
            float* ob = out + (size_t)b * k;
            if (lane < k) ob[lane] = y0;
            if (lane + 32 < k) ob[lane + 32] = y1;
            if (lane + 64 < k) ob[lane + 64] = y2;
            if (lane + 96 < k) ob[lane + 96] = y3;
        }
    }
}

size_t smem_bytes(int kp, int hc, int warps) {
    return sizeof(float) * ((size_t)hc * kp + 2 * (size_t)(kp + 4)
                            + (size_t)kp * (kp + 1) + 2 * kp + 3 * (size_t)hc)
           + sizeof(int) * warps;
}

template <int NTH, int NT, bool HOT, bool TWO_G>
cudaError_t launch(const float* G, const float* G2, const float* rhs,
                   const float* reg, const __nv_bfloat16* hv,
                   const float* vh, float* out, int B, int k, int kp, int C,
                   int vec, int has_alpha, float alpha, cudaStream_t stream) {
    return chol::launch_persistent(
        chol_solve_kernel<NTH, NT, HOT, TWO_G>, NTH,
        smem_bytes(kp, HOT ? C : 0, NTH / 32), B, stream, G, G2, rhs, reg,
        hv, vh, out, B, k, kp, C, vec, has_alpha, alpha);
}

template <bool HOT, bool TWO_G>
cudaError_t dispatch(const void* G, const void* G2, const void* rhs,
                     const void* reg, const void* hv, const void* vh,
                     void* out, int B, int k, int C, int has_alpha,
                     float alpha, void* stream) {
    if (k < 1 || k > KMAX || B < 0) return cudaErrorInvalidValue;
    const int kp = (k + 3) & ~3;
    const int config = chol::tile_config(k);
    if (HOT && (C < 1 || C > CMAX
                || smem_bytes(kp, C, chol::config_threads(config) / 32)
                       > SMEM_MAX))
        return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const int vec = (k % 4 == 0) && (((uintptr_t)G & 15) == 0)
                    && (((uintptr_t)G2 & 15) == 0);
    auto g = static_cast<const float*>(G);
    auto g2 = static_cast<const float*>(G2);
    auto r = static_cast<const float*>(rhs);
    auto rg = static_cast<const float*>(reg);
    auto h = static_cast<const __nv_bfloat16*>(hv);
    auto v = static_cast<const float*>(vh);
    auto o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (config) {
    case 0: return launch<160, 1, HOT, TWO_G>(g, g2, r, rg, h, v, o, B, k, kp, C, vec, has_alpha, alpha, s);
    case 1: return launch<256, 1, HOT, TWO_G>(g, g2, r, rg, h, v, o, B, k, kp, C, vec, has_alpha, alpha, s);
    case 2: return launch<256, 2, HOT, TWO_G>(g, g2, r, rg, h, v, o, B, k, kp, C, vec, has_alpha, alpha, s);
    default: return launch<256, 3, HOT, TWO_G>(g, g2, r, rg, h, v, o, B, k, kp, C, vec, has_alpha, alpha, s);
    }
}

}  // namespace

extern "C" {

// x (B, k) = (G + diag(reg))^-1 rhs for G (B, k, k), rhs (B, k), reg (B,),
// all f32, contiguous, batch-major. 1 <= k <= 128.
int cholesky_solve_batched(const void* G, const void* rhs, const void* reg,
                           void* out, int B, int k, void* stream) {
    return (int)dispatch<false, false>(G, nullptr, rhs, reg, nullptr, nullptr,
                                       out, B, k, 0, 0, 0.f, stream);
}

// As cholesky_solve_batched for A = G + G2 + diag(reg): the second gram
// G2 (B, k, k) f32 is summed on load.
int cholesky_solve_2g(const void* G, const void* G2, const void* rhs,
                      const void* reg, void* out, int B, int k,
                      void* stream) {
    return (int)dispatch<false, true>(G, G2, rhs, reg, nullptr, nullptr, out,
                                      B, k, 0, 0, 0.f, stream);
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
                                      C, has_alpha, alpha, stream);
}

// (cholesky_kernel_kmax and cholesky_error_string: cholesky_common.cuh)
int cholesky_kernel_cmax(void) { return CMAX; }
long long cholesky_kernel_smem_max(void) { return (long long)SMEM_MAX; }

}  // extern "C"
