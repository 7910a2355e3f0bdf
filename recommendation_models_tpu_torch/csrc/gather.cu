// Row gather-and-sum, hand-written for Hopper (sm_90a). Built by nvcc into
// a shared library with a plain C interface and called through ctypes
// (recommendation_models_tpu_torch/ops/gather.py).
//
// Replaces the TPU kernel of scripts/probe_dma_gather.py::make_probe (P1):
// a per-row manual-DMA gather, `slots` row copies in flight from the table
// in device memory into fast memory, each landed row added to a (1, k) f32
// accumulator. The TPU runs it as one serial loop on one core; here it is:
//
//   out (1, k) f32 = sum_i table[idx[i], :]
//
// for table (n, k) f32 contiguous, idx (n_gather,) int32, any n_gather >= 0
// (0 gives zeros), 1 <= k <= KMAX and 1 <= slots <= SLOTS_MAX. Ids outside
// [0, n) are the caller's fault, as in the reference: they are not checked,
// and the kernel then reads outside the table.
//
// What bounds it on an H100. The bytes bound counts each distinct row
// touched once (k * 4 bytes), the ids and the output: 9.4 us at the probe's
// shape (62,423 x 128 table, 200,000 ids). A kernel that gathers every id's
// row cannot reach it: every row after a row's first comes from the 50 MB
// L2, which holds both factor tables of the main path (16 and 41.6 MB), so
// these calls are bound by the L2's read rate, n_gather * k * 4 bytes over
// it (the L2 bound, PERF.md section 6), and, for a call of a few thousand
// rows, by one launch and a few L2 round trips. Rows an SM's L1 serves
// again (the skewed ids of the main path's user half) can beat the L2
// bound, which then bounds nothing. One add per gathered
// element, far below the f32 rate.
//
// Design: one launch per call.
//
// Lanes. A row of k floats is G = ceil(k / VEC) column groups of VEC floats
// (16-byte loads when k % 4 == 0 and the table is 16-byte aligned, else
// 4-byte). L lanes share a row, L = min(32, the power of two >= G), so a
// warp step covers R = 32 / L rows: at k = 64, 16 lanes of 16 bytes and two
// rows a step; at k = 128 one row; at k = 16 eight rows; k = 13 (4-byte)
// 16 lanes and two rows; k = 1 thirty-two rows. Every lane loads whenever
// G is a power of two. Rows wider than 32 groups (k > 128 with 16-byte
// loads) are cut into slices of 32 groups, and each block owns one slice.
//
// Loads in flight. Register-direct ld.global.nc loads (__ldg), no shared
// memory ring and no cp.async: a row is read once into the registers that
// add it. Each warp keeps D steps of loads in flight in a rotating register
// buffer with a compile-time depth D (a power of two), so the loop has no
// runtime wait switch: D = the power of two >= ceil(slots / R), i.e. the
// warp keeps `slots` row copies in flight, rounded up to whole steps and a
// power-of-two depth (k = 64, slots 8: 4 steps of 2 rows). Each lane loads
// its own rows' ids straight from idx (the lanes of a row read one word, a
// broadcast), 2 D steps ahead of their use and D steps ahead of the row
// load that needs them, so neither shuffles nor id round trips sit in the
// loop.
//
// Little's law sizes it: to stream at the L2's rate an SM must keep
// rate / 132 x latency bytes in flight. Measured on an H100 80GB HBM3 at
// 700 W (probes/gather_latency.py, csrc/l2_probe.cu): a full grid reading
// a warm 16 MB buffer past the L1 reads 6.73 TB/s from the L2, and an L2
// hit takes 142 ns (284 cycles) unloaded, so 6.73e12 / 132 x 142e-9 =
// 7.3 KB per SM. At k = 64, slots 8 a warp holds 4 steps x 2 rows x 256 B
// = 2 KB, and 5 blocks of 8 warps fit an SM (48 registers): 80 KB, 11
// times the unloaded need, which leaves room for the latency to grow under
// load; at slots 1 (6 blocks, 512 B a warp) 24 KB, 3.3 times. At k = 128,
// slots 8: 4 KB a warp, 3 blocks, 96 KB. Register-direct loads were taken over cp.async into a
// shared ring because at these depths the registers hold what is in
// flight (at most 128 floats a lane, depth 32) without a wait_group whose
// count must be an immediate, and a row is read once instead of twice.
//
// Instantiations: 42, VEC in {1, 4} x L in {1, 2, ..., 32} x D a power of
// two <= L. The gather-rate path launches four (k = 128 at slots 4, 8 and
// 16, k = 64 at slots 8); the rest serve the contract, under which any
// caller may ask for any k <= 512 and 1 <= slots <= 32 copies in flight a
// warp. The copies in flight are a lane's register array, so their count
// must be known at compile time however it is split: a depth capped at 8
// with more rows a lane a step still needs one instantiation for each
// count of rows a lane holds, and a runtime cap below the count asked for
// would break what `slots` means. The unused ones cost build time only
// (the library builds beside the others, about 20 s).
//
// The loop rotates: step s adds buf[s % D] and at once reloads it with
// step s + D, so D steps stay in flight all the time. Measured against two
// other schedules of the same depth (probes/gather_latency.py, copies of
// this source alternated in one call, H100 80GB HBM3, 700 W, device us):
// issuing a round of D steps and then adding it, and the same with two
// rounds double-buffered, ran the halves' gathers 8-17% faster (user half
// 389 and 421 against 447 us) and a row block 5-10% faster, but the
// probe's shape fell to 30-39 us (grouped, slots 4 and 8) or 36 us
// (double-buffered, slots 16) where the rotating loop holds 22.7-23.2 us
// at slots 4, 8 and 16 (the L2 bound is 15.2 us there: 4.5 of the L2's
// 6.7 TB/s). The rotating loop is the one whose time does not depend on
// `slots`.
//
// Order. Each row group (the L lanes of a row) adds its rows in id order in
// f32 registers; the R groups of a warp are combined by a fixed xor
// butterfly, the warps of a block in warp order, and the blocks' partial
// rows in block order. No atomics in the sum, so repeated calls on one card
// agree bitwise.
//
// The cross-block sum. Each block writes its partial row (or slice) to a
// (parts, k) scratch buffer, fences, and takes a ticket from an arrival
// counter (atomicInc wrapping at the grid size, so the last block's ticket
// puts the counter back to 0: the kernel resets it itself). The block that
// draws the last ticket adds the partials in block order and writes out,
// PART_BATCH partials of a column in flight per thread: one by one, each
// was an L2 round trip (176 ns a partial, a 13 us tail at 352 blocks).
// Two calls in flight at once must not share a counter: the wrapper keeps
// one scratch buffer, counter included, per (device, stream), so calls on
// one stream run one after another and calls on two streams never meet.
//
// Grid. Persistent blocks of WARPS warps; the wrapper asks for the kernel's
// resident blocks once per (vec, lanes, depth, device) and launches at most
// that many, fewer for a short index vector so that each warp runs two
// pipeline rounds of D steps (ops/gather.py::grid_for, MIN_ROUNDS; at a
// row block of 22,528 ids that is 176 blocks where the old rule gave 352:
// 5.9 us against 6.5 at one round and 7.1 at four, PERF.md section 6).
// Nothing on the per-call path queries occupancy or sets a function
// attribute: the kernel uses at most 8 KB of static shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 512;         // widest row
constexpr int SLOTS_MAX = 32;     // row copies in flight per warp
constexpr int WARPS = 8;          // warps per block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ float4 shfl_xor(const float4& a, int m) {
    return make_float4(__shfl_xor_sync(0xffffffffu, a.x, m),
                       __shfl_xor_sync(0xffffffffu, a.y, m),
                       __shfl_xor_sync(0xffffffffu, a.z, m),
                       __shfl_xor_sync(0xffffffffu, a.w, m));
}
__device__ __forceinline__ float shfl_xor(float a, int m) {
    return __shfl_xor_sync(0xffffffffu, a, m);
}
__device__ __forceinline__ void put(float* dst, const float4& a) {
    *reinterpret_cast<float4*>(dst) = a;
}
__device__ __forceinline__ void put(float* dst, float a) { *dst = a; }

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float4 load_cg(const float4* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }

// The last block's sum: out (k,) = the (parts, k) partials added over parts
// in block order. A thread owns one VEC-wide column and every q_n-th part
// (q_n threads a column), and loads PART_BATCH parts before it adds them,
// so that its loads overlap (one by one they would cost an L2 round trip
// each); then the q_n sums of a column are added in q order. Parts past
// the end are loaded as zeros (x + 0 == x). Partials are read from L2
// (ld.global.cg): other blocks wrote them in this launch.
constexpr int PART_BATCH = 8;

template <int VEC>
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials,
                                             float* __restrict__ out,
                                             long long parts, int k,
                                             typename Vec<VEC>::T* red) {
    using V = typename Vec<VEC>::T;
    const int cw = k / VEC + (k % VEC != 0);   // VEC-wide columns
    const V* rows = reinterpret_cast<const V*>(partials);
    for (int c0 = 0; c0 < cw; c0 += THREADS) {
        const int cols = cw - c0 < THREADS ? cw - c0 : THREADS;
        const int q_n = THREADS / cols;
        const int c = c0 + (int)threadIdx.x % cols;
        const int q = threadIdx.x / cols;
        V s;
        zero(s);
        if (q < q_n) {
            for (long long p0 = q; p0 < parts; p0 += (long long)PART_BATCH * q_n) {
                V v[PART_BATCH];
#pragma unroll
                for (int u = 0; u < PART_BATCH; ++u) {
                    const long long p = p0 + (long long)u * q_n;
                    if (p < parts) {
                        v[u] = load_cg(rows + p * cw + c);
                    } else {
                        zero(v[u]);
                    }
                }
#pragma unroll
                for (int u = 0; u < PART_BATCH; ++u) add(s, v[u]);
            }
        }
        red[threadIdx.x] = s;
        __syncthreads();
        if ((int)threadIdx.x < cols) {
            V t;
            zero(t);
            for (int r = 0; r < q_n; ++r) add(t, red[r * cols + threadIdx.x]);
            put(out + (size_t)c * VEC, t);
        }
        __syncthreads();
    }
}

// VEC floats a load, L lanes a row, D steps in flight. Block b owns slice
// b % slices of the columns (L * VEC of them) and part b / slices of idx.
template <int VEC, int L, int D>
__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const float* __restrict__ table,
                  const int* __restrict__ idx, float* __restrict__ partials,
                  unsigned* __restrict__ counter, float* __restrict__ out,
                  long long n, int k, int slices) {
    using V = typename Vec<VEC>::T;
    constexpr int R = 32 / L;           // rows a warp step
    constexpr int W = L * VEC;          // columns of a slice
    __shared__ __align__(16) float wsum[WARPS][W];
    __shared__ V red[THREADS];
    __shared__ bool last;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane / L;             // this lane's row of a step
    const int sub = lane % L;           // its column group
    const int slice = blockIdx.x % slices;
    const long long parts = gridDim.x / slices;
    const long long part = blockIdx.x / slices;
    const int col = slice * W + sub * VEC;
    const bool act = col < k;

    // this part's and this warp's contiguous ranges of idx
    const long long b0 = n * part / parts;
    const long long b1 = n * (part + 1) / parts;
    const long long w0 = b0 + (b1 - b0) * warp / WARPS;
    const long long cnt = b0 + (b1 - b0) * (warp + 1) / WARPS - w0;
    const long long steps = (cnt + R - 1) / R;
    const int* wid = idx + w0 + g;      // this lane's row of step s: wid[s * R]
    const float* tcol = table + col;
    auto valid = [&](long long s) { return s * R + g < cnt; };
    auto row = [&](int id) {
        return reinterpret_cast<const V*>(tcol + (long long)id * k);
    };

    // buf[j] holds step s's row when s % D == j; nid[j] the id of step
    // s + D, loaded at step s - D
    V acc, buf[D];
    int nid[D];
    zero(acc);
#pragma unroll
    for (int j = 0; j < D; ++j) {
        zero(buf[j]);
        if (act && valid(j)) buf[j] = load(row(__ldg(wid + j * R)));
        nid[j] = valid(D + j) ? __ldg(wid + (D + j) * R) : 0;
    }
    for (long long s0 = 0; s0 < steps; s0 += D) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
            const long long s = s0 + j;
            if (act && valid(s)) add(acc, buf[j]);
            if (act && valid(s + D)) buf[j] = load(row(nid[j]));
            if (valid(s + 2 * D)) nid[j] = __ldg(wid + (s + 2 * D) * R);
        }
    }

    // the warp's R row groups, combined by a fixed butterfly (every lane of
    // a column group ends with the same sum), then the warps in order
#pragma unroll
    for (int m = L; m < 32; m <<= 1) add(acc, shfl_xor(acc, m));
    if (g == 0) put(&wsum[warp][sub * VEC], acc);
    __syncthreads();
    if (threadIdx.x < W && slice * W + (int)threadIdx.x < k) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += wsum[w][threadIdx.x];
        partials[part * k + slice * W + threadIdx.x] = s;
    }

    // the ticket: the last block to arrive adds the partials in block
    // order; atomicInc wraps the counter back to 0 on the last ticket
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_partials<VEC>(partials, out, parts, k, red);
}

using Kern = void (*)(const float*, const int*, float*, unsigned*, float*,
                      long long, int, int);

// the instantiation of (VEC, L, depth): depths are powers of two <= L
template <int VEC, int L, int D = 1>
Kern pick_depth(int depth) {
    if constexpr (D > L) {
        return nullptr;
    } else {
        if (depth == D) return gather_sum_kernel<VEC, L, D>;
        return pick_depth<VEC, L, 2 * D>(depth);
    }
}

template <int VEC, int L = 1>
Kern pick(int lanes, int depth) {
    if constexpr (L > 32) {
        return nullptr;
    } else {
        if (lanes == L) return pick_depth<VEC, L>(depth);
        return pick<VEC, 2 * L>(lanes, depth);
    }
}

Kern kernel_for(int vec, int lanes, int depth) {
    if (vec == 4) return pick<4>(lanes, depth);
    if (vec == 1) return pick<1>(lanes, depth);
    return nullptr;
}

// the wrapper's lane, depth and slice choice, checked against k
bool valid(long long n, int k, int vec, int lanes, int depth, int slices) {
    if (n < 0 || k < 1 || k > KMAX || !(vec == 1 || (vec == 4 && k % 4 == 0)))
        return false;
    if (kernel_for(vec, lanes, depth) == nullptr) return false;
    const int width = lanes * vec;
    return slices >= 1 && (long long)slices * width >= k &&
           (long long)(slices - 1) * width < k;
}

}  // namespace

extern "C" {

int gather_kernel_kmax(void) { return KMAX; }
int gather_kernel_slots_max(void) { return SLOTS_MAX; }
int gather_kernel_warps(void) { return WARPS; }

const char* gather_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of the (vec, lanes, depth) instantiation on the current
// device (blocks per SM times SMs). The wrapper asks once per
// instantiation and device.
int gather_resident(int vec, int lanes, int depth, int* resident) {
    const Kern kern = kernel_for(vec, lanes, depth);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, 0)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *resident = per_sm * sms;
    return 0;
}

// out (1, k) = sum_i table[idx[i]] in one launch of `grid` blocks
// (slices x parts); partials holds (parts, k) floats, counter one unsigned
// that is 0 between calls. Returns cudaGetLastError() of the launch.
int gather_rows_sum(const float* table, const int* idx, float* partials,
                    unsigned* counter, float* out, long long n, int k,
                    int vec, int lanes, int depth, int slices, int grid,
                    cudaStream_t stream) {
    if (!valid(n, k, vec, lanes, depth, slices) || grid < slices ||
        grid % slices != 0)
        return (int)cudaErrorInvalidValue;
    kernel_for(vec, lanes, depth)<<<grid, THREADS, 0, stream>>>(
        table, idx, partials, counter, out, n, k, slices);
    return (int)cudaGetLastError();
}

}  // extern "C"
