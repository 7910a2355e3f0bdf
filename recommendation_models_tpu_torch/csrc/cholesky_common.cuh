// Shared by csrc/cholesky_solve.cu and csrc/cholesky_rank_panel.cu: the
// solves' limits and pivot floor, the thread configuration per order of
// cholesky_solve.cu (cholesky_rank_panel.cu has its own), the cached
// residency query, the persistent-grid launch, and the two C exports every
// library of the solves has. Each source builds into its own library and
// includes this header once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace chol {

constexpr int KMAX = 128;   // largest system order
constexpr float PIVOT_FLOOR = 1e-30f;

__device__ __forceinline__ float pick4(const float (&v)[4], int s) {
    // select without dynamic register indexing (keeps the tile in registers)
    return s == 0 ? v[0] : s == 1 ? v[1] : s == 2 ? v[2] : v[3];
}

// Thread configuration for order k: 160 threads with one tile each cover
// every tile up to k = 68 (136 tiles at k = 64); larger systems take 256
// threads with up to three tiles each. 0: <160, 1>, 1: <256, 1>,
// 2: <256, 2>, 3: <256, 3>.
inline int tile_config(int k) {
    const int T = ((k + 3) & ~3) / 4;
    const int tiles = T * (T + 1) / 2;
    return tiles <= 160 ? 0 : tiles <= 256 ? 1 : tiles <= 512 ? 2 : 3;
}

inline int config_threads(int config) { return config == 0 ? 160 : 256; }

// Blocks of kern (nth threads, smem bytes of dynamic shared memory) that
// the current device holds at once. The function attributes (the device's
// largest dynamic shared memory and carveout, so that residency is set by
// the occupancy computed here and not by a smaller carveout) are set on
// the first call for a kernel and device, and the occupancy is asked on the
// first call for a kernel, size and device; later calls read the cache.
inline cudaError_t resident_blocks(const void* kern, int nth, size_t smem,
                                   long long* resident) {
    static std::mutex mu;
    // (kernel, threads, smem, device) -> resident blocks; smem = SIZE_MAX
    // marks a kernel whose attributes are set on that device
    static std::map<std::tuple<const void*, int, size_t, int>, long long>
        cache;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(kern, nth, smem, dev);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
        *resident = hit->second;
        return cudaSuccess;
    }
    const auto attr_key = std::make_tuple(kern, 0, SIZE_MAX, dev);
    if (cache.find(attr_key) == cache.end()) {
        int optin = 0;
        if ((err = cudaDeviceGetAttribute(
                 &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess)
            return err;
        if ((err = cudaFuncSetAttribute(
                 kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
            != cudaSuccess)
            return err;
        if ((err = cudaFuncSetAttribute(
                 kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                 cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
            return err;
        cache.emplace(attr_key, 0);
    }
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, nth, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *resident = (long long)per_sm * sms;
    cache.emplace(key, *resident);
    return cudaSuccess;
}

// Launch kern with nth threads and smem bytes of dynamic shared memory on a
// persistent grid: as many blocks as are resident at once, at most `work`.
// Only the first launch of a kernel (and size) asks the runtime anything
// (resident_blocks); every launch checks cudaGetLastError.
template <typename Kern, typename... Args>
cudaError_t launch_persistent(Kern kern, int nth, size_t smem,
                              long long work, cudaStream_t stream,
                              Args... args) {
    long long resident = 0;
    const cudaError_t err = resident_blocks(
        reinterpret_cast<const void*>(kern), nth, smem, &resident);
    if (err != cudaSuccess) return err;
    const int grid = (int)(work < resident ? work : resident);
    kern<<<grid, nth, smem, stream>>>(args...);
    return cudaGetLastError();
}

}  // namespace chol

extern "C" {

int cholesky_kernel_kmax(void) { return chol::KMAX; }

const char* cholesky_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
