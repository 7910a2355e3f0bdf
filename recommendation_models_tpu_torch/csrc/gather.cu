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
// What bounds it on an H100: bytes. The call must read every distinct table
// row it touches once (k * 4 bytes each), the index vector (4 bytes a row)
// and write the output; every gathered row after a row's first can come
// from the 50 MB L2. It does one add per gathered element, far below the
// f32 rate. At the probe's shape (62,423 x 128 table, 200,000 ids) that is
// ~31.4 MB, ~9.4 us at 3.35 TB/s. In practice a gather of 256- or 512-byte
// rows is bound by how many row requests are in flight, which is what
// `slots` sets.
//
// Design: a persistent grid (as many blocks as are resident, fewer for a
// short index vector). Each block owns a contiguous range of idx and each
// of its warps a contiguous sub-range. A warp keeps `slots` row copies in
// flight into its own ring of `slots` shared-memory row buffers, the
// counterpart of the TPU kernel's VMEM scratch and DMA semaphores. The
// copies are cp.async, each lane copying its own columns (16 bytes a lane
// when k % 4 == 0 and the table is 16-byte aligned, else 4 bytes), one
// commit group per row, so `cp.async.wait_group slots - 1` says the oldest
// row has landed, and each lane reads back only what it copied (no warp
// barrier). cp.async and not cp.async.bulk: the bulk form (one thread, one
// mbarrier per slot) is the closer counterpart of make_async_copy, but it
// needs 16-byte rows (k % 4 == 0), and it puts every row's issue on one
// thread; cp.async spreads a row over the warp's 32 lanes and takes any k.
// The warp reads its ids 32 at a time with one coalesced load, one chunk
// ahead, and hands them out by shuffle. Each lane sums its columns in f32
// registers in id order; the warps' sums are added in warp order into a
// (n_blocks, k) partials buffer, and a second small launch adds the blocks
// in a fixed order. No atomics, so repeated calls on one card agree
// bitwise. Shared memory per block is warps * slots * k * 4 bytes; the
// wrapper picks the warps per block (at most WARPS_MAX) so it fits in
// 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 512;         // widest row
constexpr int SLOTS_MAX = 32;     // row copies in flight per warp
constexpr int WARPS_MAX = 8;      // warps per block of the gather
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr int FINISH_WARPS = 8;   // warps per block of the block sum

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group takes an immediate: dispatch the launch's slots - 1
// (uniform over the grid) to it
__device__ __forceinline__ void cp_async_wait_pending(int n) {
#define GATHER_WAIT_CASE(N) \
    case N:                 \
        cp_async_wait<N>(); \
        break;
    switch (n) {
        GATHER_WAIT_CASE(0) GATHER_WAIT_CASE(1) GATHER_WAIT_CASE(2)
        GATHER_WAIT_CASE(3) GATHER_WAIT_CASE(4) GATHER_WAIT_CASE(5)
        GATHER_WAIT_CASE(6) GATHER_WAIT_CASE(7) GATHER_WAIT_CASE(8)
        GATHER_WAIT_CASE(9) GATHER_WAIT_CASE(10) GATHER_WAIT_CASE(11)
        GATHER_WAIT_CASE(12) GATHER_WAIT_CASE(13) GATHER_WAIT_CASE(14)
        GATHER_WAIT_CASE(15) GATHER_WAIT_CASE(16) GATHER_WAIT_CASE(17)
        GATHER_WAIT_CASE(18) GATHER_WAIT_CASE(19) GATHER_WAIT_CASE(20)
        GATHER_WAIT_CASE(21) GATHER_WAIT_CASE(22) GATHER_WAIT_CASE(23)
        GATHER_WAIT_CASE(24) GATHER_WAIT_CASE(25) GATHER_WAIT_CASE(26)
        GATHER_WAIT_CASE(27) GATHER_WAIT_CASE(28) GATHER_WAIT_CASE(29)
        GATHER_WAIT_CASE(30)
        default:
            cp_async_wait<SLOTS_MAX - 1>();
            break;
    }
#undef GATHER_WAIT_CASE
}

// VEC floats per copy (4: 16-byte copies, k % 4 == 0; 1: 4-byte copies).
// Lane l owns the VEC-wide column groups l, l + 32, ...: at most CH of them.
template <int VEC>
__global__ void __launch_bounds__(WARPS_MAX * 32)
gather_sum_kernel(const float* __restrict__ table,
                  const int* __restrict__ idx, float* __restrict__ partials,
                  long long n, int k, int slots) {
    constexpr int CH = KMAX / (32 * VEC);
    extern __shared__ __align__(16) float ring[];   // (warps, slots, k)
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    float* mine = ring + (size_t)warp * slots * k;

    // this block's and this warp's contiguous ranges of idx
    const long long nb = gridDim.x;
    const long long b0 = n * blockIdx.x / nb;
    const long long b1 = n * (blockIdx.x + 1) / nb;
    const long long w0 = b0 + (b1 - b0) * warp / warps;
    const long long cnt = b0 + (b1 - b0) * (warp + 1) / warps - w0;
    const int* wid = idx + w0;

    float acc[CH * VEC];
#pragma unroll
    for (int c = 0; c < CH * VEC; ++c) acc[c] = 0.f;

    // ids of rows [issued - issued % 32, +32) in `cur`, the next 32 in `nxt`
    auto load_ids = [&](long long r) -> int {
        return r + lane < cnt ? __ldg(wid + r + lane) : 0;
    };
    int cur = load_ids(0), nxt = load_ids(32);
    long long issued = 0;
    auto issue = [&](int slot) {
        const int row = __shfl_sync(0xffffffffu, cur, (int)(issued & 31));
        const float* src = table + (long long)row * k;
        float* dst = mine + (size_t)slot * k;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const int col = (lane + 32 * c) * VEC;
            if (col < k) {
                if constexpr (VEC == 4) {
                    cp_async16(dst + col, src + col);
                } else {
                    cp_async4(dst + col, src + col);
                }
            }
        }
        ++issued;
        if ((issued & 31) == 0) {
            cur = nxt;
            nxt = load_ids(issued + 32);
        }
    };

    // fill the ring: one commit group per slot, empty past the range's end
    for (int s = 0; s < slots; ++s) {
        if (s < cnt) issue(s);
        cp_async_commit();
    }
    int slot = 0;
    for (long long i = 0; i < cnt; ++i) {
        // slots + i groups are committed: all but the newest slots - 1 are
        // complete, so row i (group i) has landed in `slot`
        cp_async_wait_pending(slots - 1);
        const float* land = mine + (size_t)slot * k;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const int col = (lane + 32 * c) * VEC;
            if (col < k) {
                if constexpr (VEC == 4) {
                    const float4 v = *reinterpret_cast<const float4*>(land + col);
                    acc[4 * c] += v.x;
                    acc[4 * c + 1] += v.y;
                    acc[4 * c + 2] += v.z;
                    acc[4 * c + 3] += v.w;
                } else {
                    acc[c] += land[col];
                }
            }
        }
        // the refill is issued after the adds have read the slot
        if (i + slots < cnt) issue(slot);
        cp_async_commit();
        slot = slot + 1 == slots ? 0 : slot + 1;
    }
    cp_async_wait<0>();

    // the warp's sums go to its ring's first row (each lane writes the
    // columns it copied there), then the block adds its warps in order
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const int col = (lane + 32 * c) * VEC;
        if (col < k) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) mine[col + v] = acc[VEC * c + v];
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
        float s = 0.f;
        for (int w = 0; w < warps; ++w) s += ring[(size_t)w * slots * k + j];
        partials[(size_t)blockIdx.x * k + j] = s;
    }
}

// out (k,) = the sum of the (nb, k) partials over blocks: 32 columns per
// block, warp w adds blocks w, w + FINISH_WARPS, ... in order, then warp 0
// adds the warps' sums in order.
__global__ void __launch_bounds__(FINISH_WARPS * 32)
gather_finish_kernel(const float* __restrict__ partials,
                     float* __restrict__ out, int nb, int k) {
    __shared__ float part[FINISH_WARPS][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + lane;
    float s = 0.f;
    if (j < k) {
        for (int b = warp; b < nb; b += FINISH_WARPS)
            s += partials[(size_t)b * k + j];
    }
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && j < k) {
        float t = 0.f;
        for (int w = 0; w < FINISH_WARPS; ++w) t += part[w][lane];
        out[j] = t;
    }
}

size_t ring_bytes(int warps, int slots, int k) {
    return (size_t)warps * slots * k * sizeof(float);
}

bool valid(long long n, int k, int slots, int warps, int vec) {
    return n >= 0 && k >= 1 && k <= KMAX && slots >= 1 &&
           slots <= SLOTS_MAX && warps >= 1 && warps <= WARPS_MAX &&
           (vec == 1 || (vec == 4 && k % 4 == 0)) &&
           ring_bytes(warps, slots, k) <= SMEM_MAX;
}

cudaError_t prepare(const void* kern, size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

const void* gather_kernel(int vec) {
    return vec == 4 ? (const void*)gather_sum_kernel<4>
                    : (const void*)gather_sum_kernel<1>;
}

}  // namespace

extern "C" {

int gather_kernel_kmax(void) { return KMAX; }
int gather_kernel_slots_max(void) { return SLOTS_MAX; }
int gather_kernel_warps_max(void) { return WARPS_MAX; }
long long gather_kernel_smem_max(void) { return (long long)SMEM_MAX; }

const char* gather_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Blocks of the persistent grid for n ids: the resident blocks of this
// configuration, or fewer, so that each warp has about `slots` rows or
// more; at least 1 (n = 0 still writes zeros). The wrapper sizes the
// partials buffer by it.
int gather_rows_sum_grid(long long n, int k, int slots, int warps, int vec,
                         int* grid) {
    if (!valid(n, k, slots, warps, vec)) return (int)cudaErrorInvalidValue;
    const size_t smem = ring_bytes(warps, slots, k);
    const void* kern = gather_kernel(vec);
    cudaError_t err = prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, warps * 32, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    const long long per_block = (long long)warps * slots;
    long long want = (n + per_block - 1) / per_block;
    if (want < 1) want = 1;
    *grid = (int)(want < resident ? want : resident);
    return 0;
}

// out (1, k) = sum_i table[idx[i]]: the gather launch into partials
// (grid, k), then the block sum; returns cudaGetLastError() of each.
int gather_rows_sum(const float* table, const int* idx, float* partials,
                    float* out, long long n, int k, int slots, int warps,
                    int vec, int grid, cudaStream_t stream) {
    if (!valid(n, k, slots, warps, vec) || grid < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = ring_bytes(warps, slots, k);
    cudaError_t err = prepare(gather_kernel(vec), smem);
    if (err != cudaSuccess) return (int)err;
    if (vec == 4) {
        gather_sum_kernel<4><<<grid, warps * 32, smem, stream>>>(
            table, idx, partials, n, k, slots);
    } else {
        gather_sum_kernel<1><<<grid, warps * 32, smem, stream>>>(
            table, idx, partials, n, k, slots);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    gather_finish_kernel<<<(k + 31) / 32, FINISH_WARPS * 32, 0, stream>>>(
        partials, out, grid, k);
    return (int)cudaGetLastError();
}

}  // extern "C"
