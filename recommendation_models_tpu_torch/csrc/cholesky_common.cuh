// Shared by csrc/cholesky_solve.cu and csrc/cholesky_variants.cu: the
// solves' limits and pivot floor, the thread configuration per order, the
// persistent-grid launch, and the two C exports every library of the solves
// has. Each source builds into its own library and includes this header
// once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Launch kern with nth threads and smem bytes of dynamic shared memory on a
// persistent grid: as many blocks as are resident at once, at most `work`.
// The largest shared-memory carveout is asked for, so that residency is set
// by the occupancy computed here and not by a smaller carveout.
template <typename Kern, typename... Args>
cudaError_t launch_persistent(Kern kern, int nth, size_t smem,
                              long long work, cudaStream_t stream,
                              Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, nth, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
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
