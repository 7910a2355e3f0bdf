// The card's L2 as the gather kernel P1 meets it, measured: a measurement
// source, not the port of a TPU kernel. probes/gather_latency.py builds it
// to state P1's L2 bound and to size its loads in flight by Little's law
// (csrc/gather.cu's header note); nothing on a path of the port calls it.
//
// l2_chase: the L2 hit latency. One thread follows `hops` links of a
// random cycle through `next`, each load `ld.global.cg` (cached in L2, not
// in L1), so each hop waits for the last: the time per hop is the latency
// of one L2 hit with nothing else in flight.
//
// l2_read: the L2's read rate. Every thread of a full grid reads `passes`
// times over `n4` float4 with `ld.global.cg`, so no read is served by an
// SM's L1 and none is written back: the bytes read over the time is the
// rate at which the L2 feeds all SMs at once. Each thread keeps four loads
// of a pass in flight before it adds them.
//
// The caller sizes both buffers to fit the 50 MB L2 and warms them first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void l2_chase_kernel(const unsigned* __restrict__ next,
                                long long hops, unsigned* sink,
                                long long* cycles) {
    unsigned p = 0;
    const long long t0 = clock64();
    for (long long i = 0; i < hops; ++i) p = __ldcg(next + p);
    const long long t1 = clock64();
    *sink = p;
    *cycles = t1 - t0;
}

__global__ void __launch_bounds__(256)
l2_read_kernel(const float4* __restrict__ x, long long n4, int passes,
               float* sink) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& v) {
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
    };
    for (int p = 0; p < passes; ++p) {
        long long i = t;
        for (; i + 3 * stride < n4; i += 4 * stride) {
            const float4 v0 = __ldcg(x + i), v1 = __ldcg(x + i + stride),
                         v2 = __ldcg(x + i + 2 * stride),
                         v3 = __ldcg(x + i + 3 * stride);
            add(v0);
            add(v1);
            add(v2);
            add(v3);
        }
        for (; i < n4; i += stride) add(__ldcg(x + i));
    }
    // a store the compiler cannot prove dead keeps every load
    const float s = acc.x + acc.y + acc.z + acc.w;
    if (s == -1.0f) *sink = s;
}

}  // namespace

extern "C" {

const char* l2_probe_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// one thread chases `hops` links from entry 0; writes the last entry to
// sink[0] and the SM clock cycles the chase took to cycles[0]
int l2_chase(const unsigned* next, long long hops, unsigned* sink,
             long long* cycles, cudaStream_t stream) {
    l2_chase_kernel<<<1, 1, 0, stream>>>(next, hops, sink, cycles);
    return (int)cudaGetLastError();
}

// `blocks` blocks of 256 threads read x (n4 float4) `passes` times
int l2_read(const float4* x, long long n4, int passes, int blocks,
            float* sink, cudaStream_t stream) {
    if (n4 < 1 || passes < 1 || blocks < 1)
        return (int)cudaErrorInvalidValue;
    l2_read_kernel<<<blocks, 256, 0, stream>>>(x, n4, passes, sink);
    return (int)cudaGetLastError();
}

}  // extern "C"
