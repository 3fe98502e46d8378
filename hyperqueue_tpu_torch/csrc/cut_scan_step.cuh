// The int64 arithmetic of the first port's cut-scan step: floor division
// over every resource and a two-barrier int64 block scan.  The solve no
// longer uses it (cut_scan_core.cuh holds the step both kernels run); it
// stays for the measurements in cut_scan.cu that time the two against each
// other (step_split_kernel, scan_latency_legacy_kernel).  Include it after
// cut_scan_core.cuh, inside no namespace; it opens its own anonymous one.
#pragma once

#include <cuda_runtime.h>

#include "cut_scan_core.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

__device__ __forceinline__ long long warp_inclusive(long long v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive prefix of v over the block (thread order) and the block total.
// Two calls must be separated by a __syncthreads() (s_warp is reused).
__device__ long long block_exclusive(long long v, long long* s_warp,
                                     long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long inc = warp_inclusive(v, lane);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_inclusive(s_warp[lane], lane);
  __syncthreads();
  *total = s_warp[kWarps - 1];
  return inc - v + (warp ? s_warp[warp - 1] : 0);
}

// Tasks of one variant that fit on worker w right now (before the
// remaining-size clamp), as _variant_capacity computes it.
__device__ __forceinline__ long long capacity(
    const int* frow, const int* trow, const int* need, const int* amask,
    int R, int nt, int life, int mt) {
  bool any_req = false;
  long long cap = kUnneeded;
  for (int r = 0; r < R; ++r) {
    long long per;
    if (amask != nullptr && amask[r] > 0) {
      any_req = true;
      per = (frow[r] == trow[r] && trow[r] > 0) ? 1 : 0;
    } else if (need[r] > 0) {
      any_req = true;
      per = floor_div(frow[r], need[r]);
    } else {
      per = kUnneeded;
    }
    if (r == 0 || per < cap) cap = per;
  }
  if (nt < cap) cap = nt;
  if (!(mt <= life) || !any_req) cap = 0;
  return cap < 0 ? 0 : cap;
}

}  // namespace
