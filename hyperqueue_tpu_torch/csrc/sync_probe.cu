// K5: the device sync-latency probe of the solve backend's cost model.
//
// Replaces hyperqueue_tpu/models/greedy.py:85-116 (`_probe`: the jitted
// `(v * 2).sum()` over `arange(256, int32)`, min of 3 timed round trips).
// The scheduler does not want the sum: it wants to know how long the
// smallest useful device program takes from launch to a value in host
// memory, which decides whether a tick's solve may go to the card at all.
//
// What bounds it: not bytes (1 KB read, 4 bytes written: 0.3 ns at the
// card's 3.35 TB/s) and not operations, but one kernel launch plus one
// 4-byte device-to-host copy and the host's wait for it. The kernel is
// therefore as small as it can be: one block of 256 threads, one load per
// thread (a block-stride loop takes longer inputs), a warp reduction with
// __shfl_down_sync, the 8 warp sums through shared memory, and thread 0
// stores the int32 sum. The sum wraps modulo 2^32, as JAX's int32 sum
// does: it is accumulated in uint32, whose overflow is defined.
//
// Plain C entry, loaded with ctypes; it returns cudaGetLastError() right
// after the launch so a refused launch reaches the caller.
//
// hq_empty_kernel launches a kernel of the same shape that does nothing:
// its device time is the card's floor for any launch, the probe's latency
// bound (a measurement entry; nothing on a path calls it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
sync_probe_kernel(const int32_t* __restrict__ v, int32_t* __restrict__ out,
                  int n) {
    __shared__ uint32_t warp_sums[kWarps];
    const int tid = threadIdx.x;
    uint32_t acc = 0;
    for (int i = tid; i < n; i += kThreads) {
        acc += static_cast<uint32_t>(v[i]) * 2u;
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if ((tid & 31) == 0) {
        warp_sums[tid >> 5] = acc;
    }
    __syncthreads();
    if (tid == 0) {
        uint32_t total = 0;
        for (int w = 0; w < kWarps; ++w) {
            total += warp_sums[w];
        }
        *out = static_cast<int32_t>(total);
    }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

extern "C" int hq_empty_kernel(void* stream) {
    empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

extern "C" int hq_sync_probe(const void* v, void* out, int n, void* stream) {
    sync_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(v), static_cast<int32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
