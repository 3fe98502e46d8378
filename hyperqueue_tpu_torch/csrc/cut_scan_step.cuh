// The arithmetic of one cut-scan step, shared by the single-block kernel
// (cut_scan.cu, K1) and the sharded one (sharded_scan.cu, K2), so that both
// compute a worker's capacity and a block's prefix sums with the same code:
// floor division, int64 prefixes, the 2^30 capacity of an unrequested
// resource and the ALL-policy fit.  Include it inside no namespace; it opens
// its own anonymous one.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;           // workers per block <= 16384
constexpr int kClasses = 16;                // N_VISIT_CLASSES
constexpr int kMaxGroups = 16384;           // MAX_KERNEL_GROUPS (2^14)
constexpr long long kUnneeded = 1LL << 30;  // cap of an unrequested resource

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

__device__ __forceinline__ unsigned long long warp_inclusive_u(
    unsigned long long v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned long long n = __shfl_up_sync(0xffffffffu, v, o);
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

// The same over 16 per-class counters packed 16 bits each into 4 words
// (a count never exceeds 16384, so no field carries into the next).
__device__ void block_exclusive_packed(const unsigned long long v[4],
                                       unsigned long long excl[4],
                                       unsigned long long total[4],
                                       unsigned long long (*s)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long inc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) inc[k] = warp_inclusive_u(v[k], lane);
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k][warp] = inc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k][lane] = warp_inclusive_u(s[k][lane], lane);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    total[k] = s[k][kWarps - 1];
    excl[k] = inc[k] - v[k] + (warp ? s[k][warp - 1] : 0ull);
  }
}

__device__ __forceinline__ unsigned field(const unsigned long long p[4],
                                          int c) {
  return (unsigned)((p[c >> 2] >> ((c & 3) * 16)) & 0xffffull);
}

__device__ __forceinline__ int clamp_class(int c) {
  return c < 0 ? 0 : (c >= kClasses ? kClasses - 1 : c);
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
