// Greedy cut-scan: the dense solve of one scheduling tick, written for
// Hopper (sm_90a).
//
// Replaces hyperqueue_tpu/ops/assign.py greedy_cut_scan (the jitted
// lax.scan of scan_batches over _variant_capacity and _water_fill_classed).
// What it computes, step by step over batches b (priority order) and their
// variants v:
//   cap[w]  = min over requested resources r of floor(free[w,r] / need[r])
//             (an ALL-policy resource instead fits one task where the pool
//             is untouched: free == total > 0), capped by nt_free[w]; 0 where
//             min_time[b,v] > lifetime[w] or the variant requests nothing;
//             then clamped to [0, remaining];
//   assign  = clip(remaining - prefix[w], 0, cap[w]) where prefix is the
//             capacity of the workers visited before w, in the order
//             (visit class class_m[order_ids[b,v], w] asc, worker index asc);
//   free   -= assign * need (and an ALL assignment empties the marked
//             pools), nt_free -= assign, remaining -= min(remaining, sum cap).
// With a policy mask, cap[w] = 0 where policy_mask[b, w] == 0 (after the
// remaining clamp).  A gang row (gang_nodes[b] = n > 0; the JAX kernel's
// _gang_select_local and the gang branch of scan_batches) replaces its
// steps with one gang step: a worker is eligible if it is idle (gang_ok),
// untouched by every earlier step of this solve, has a task slot, lives
// past min_time[b, 0] and is not masked; the row takes the first worker
// group with >= n eligible members (else the first with the most), and in
// it the n lowest-index eligible workers; those get one count each in
// variant 0 if the group had n, and are held either way (free row and
// nt_free zeroed, no longer available to gangs).
//
// What bounds it: step (b, v) reads the free resources that step (b, v-1)
// left, so the B*V steps run one after another, and every step needs one
// prefix sum across all workers.  The bytes it moves (inputs once, counts
// once: a few MB) and its integer operations take about a microsecond at the
// card's rates; its time is B*V times the latency of one step: dependent
// loads, one block-wide scan and its barriers.
//
// Design: one block of 1024 threads runs the whole solve, so steps are
// separated by __syncthreads() alone: no grid-wide sync and no relaunch.
// The TPU kernel avoided permutation gathers by expanding (B,V,W,C) one-hot
// class masks; here a prologue counting-sorts the workers of every visit-
// class row once into the visit order, into the scratch `order` (M, W), and
// in every step thread t takes the workers at sorted positions
// [t*K, t*K+K): one int64 exclusive block scan of the capacities then IS the
// water-fill prefix.  Integer division replaces the TPU's float32 division
// and its fix-up.  free and nt_free are updated in place.
//
// Gang steps visit workers in index order (thread t owns workers
// [t*K, t*K+K)), not in visit order, so they have a block scan of their own
// over the selected members.  The gang-availability carry is indexed by
// worker, whom threads do not own from step to step, so it is a W-byte
// array in shared memory; the per-group eligible counts are G ints there
// too (warp-aggregated shared atomics), both in dynamic shared memory sized
// by the launch.  The gang step is a separate, non-inlined function, so its
// state stays out of the ordinary step's registers.
//
// A worker's capacity and the block scans live in cut_scan_step.cuh, which
// the sharded kernel (sharded_scan.cu, K2) includes too.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cut_scan_step.cuh"

namespace {

// One gang row (see the header): picks and holds the gang's workers and
// writes the row's counts, all V variants.  Every thread of the block calls
// it; it ends with the step's closing barrier.
__device__ __noinline__ void gang_step(
    int n, int mt0, int* __restrict__ free_, int* __restrict__ nt_free,
    const int* __restrict__ lifetime, const int* __restrict__ group_ids,
    const int* __restrict__ pmask, int* __restrict__ crow, int W, int R,
    int V, int G, int* s_group, unsigned char* s_avail, long long* s_warp,
    int* s_sel) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int K = (W + kThreads - 1) / kThreads;
  for (int g = t; g < G; g += kThreads) s_group[g] = 0;
  if (t == 0) {
    s_sel[0] = INT_MAX;  // first group with >= n eligible
    s_sel[1] = -1;       // (count, -group) of the first group with the most
  }
  __syncthreads();

  // eligible workers of this thread (bit j = worker t*K + j), counted per
  // group; lanes with the same group add once, through their leader
  unsigned elig = 0;
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    int key = -1;
    if (w < W && s_avail[w] && mt0 <= lifetime[w] && nt_free[w] >= 1 &&
        (pmask == nullptr || pmask[w] > 0)) {
      key = group_ids[w];
      if (key >= 0) elig |= 1u << j;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s_group[key], __popc(peers));
    }
  }
  __syncthreads();

  int first = INT_MAX;
  int best = -1;
  for (int g = t; g < G; g += kThreads) {
    const int c = s_group[g];
    if (c >= n && g < first) first = g;
    const int key = (c << 14) | (kMaxGroups - 1 - g);  // c <= W <= 2^14
    if (key > best) best = key;
  }
  first = __reduce_min_sync(0xffffffffu, first);
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) {
    atomicMin(&s_sel[0], first);
    atomicMax(&s_sel[1], best);
  }
  __syncthreads();
  const bool feasible = s_sel[0] != INT_MAX;
  const int chosen =
      feasible ? s_sel[0] : kMaxGroups - 1 - (s_sel[1] & (kMaxGroups - 1));

  // the n lowest-index eligible members of the chosen group
  unsigned sel = 0;
  for (int j = 0; j < K; ++j) {
    if (((elig >> j) & 1u) && group_ids[t * K + j] == chosen) sel |= 1u << j;
  }
  long long total;
  long long before = block_exclusive(__popc(sel), s_warp, &total);
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    if (w >= W) break;
    int emit = 0;
    if ((sel >> j) & 1u) {
      if (before < n) {
        // held, feasible or not: the in-solve reservation
        int* frow = free_ + (size_t)w * R;
        for (int r = 0; r < R; ++r) frow[r] = 0;
        nt_free[w] = 0;
        s_avail[w] = 0;
        emit = feasible ? 1 : 0;
      }
      ++before;
    }
    crow[w] = emit;
  }
  for (int v = 1; v < V; ++v) {
    for (int w = t; w < W; w += kThreads) crow[(size_t)v * W + w] = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) cut_scan_kernel(
    int* __restrict__ free_, int* __restrict__ nt_free,
    const int* __restrict__ lifetime, const int* __restrict__ needs,
    const int* __restrict__ sizes, const int* __restrict__ min_time,
    const int* __restrict__ class_m, const int* __restrict__ order_ids,
    const int* __restrict__ total, const int* __restrict__ all_mask,
    const int* __restrict__ gang_nodes, const int* __restrict__ gang_ok,
    const int* __restrict__ group_ids, const int* __restrict__ policy_mask,
    int* __restrict__ counts, int* __restrict__ order, int W, int R, int B,
    int V, int M, int G) {
  __shared__ long long s_warp[kWarps];
  __shared__ unsigned long long s_pack[4][kWarps];
  __shared__ int s_sel[2];
  // gang rows only: per-group counts (G ints), then the W-byte carry
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int* s_group = reinterpret_cast<int*>(s_dyn);
  unsigned char* s_avail =
      gang_nodes != nullptr ? s_dyn + (size_t)G * sizeof(int) : nullptr;
  const int t = threadIdx.x;
  const int K = (W + kThreads - 1) / kThreads;

  if (s_avail != nullptr) {
    for (int w = t; w < W; w += kThreads) s_avail[w] = gang_ok[w] != 0;
    __syncthreads();
  }

  // Prologue: order[m] lists the workers by (class_m[m, w], w).  Thread t
  // counts the classes of workers [t*K, t*K+K) (index order), and a packed
  // block scan turns the counts into each worker's sorted position.
  for (int m = 0; m < M; ++m) {
    const int* cm = class_m + (size_t)m * W;
    unsigned long long loc[4] = {0ull, 0ull, 0ull, 0ull};
    int cls[kMaxPerThread];
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int w = t * K + j;
      cls[j] = 0;
      if (j < K && w < W) {
        const int c = clamp_class(cm[w]);
        cls[j] = c;
        loc[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    unsigned long long excl[4], tot[4];
    block_exclusive_packed(loc, excl, tot, s_pack);
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int w = t * K + j;
      if (j < K && w < W) {
        const int c = cls[j];
        unsigned before = 0;
        for (int k = 0; k < c; ++k) before += field(tot, k);
        order[(size_t)m * W + before + field(excl, c)] = w;
        excl[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    __syncthreads();
  }

  for (int b = 0; b < B; ++b) {
    if (gang_nodes != nullptr && gang_nodes[b] > 0) {
      gang_step(gang_nodes[b], min_time[(size_t)b * V], free_, nt_free,
                lifetime, group_ids,
                policy_mask != nullptr ? policy_mask + (size_t)b * W
                                       : nullptr,
                counts + (size_t)b * V * W, W, R, V, G, s_group, s_avail,
                s_warp, s_sel);
      continue;
    }
    const int* pmask =
        policy_mask != nullptr ? policy_mask + (size_t)b * W : nullptr;
    long long remaining = sizes[b];
    for (int v = 0; v < V; ++v) {
      const size_t bv = (size_t)b * V + v;
      int* crow = counts + bv * W;
      if (remaining <= 0) {
        // nothing left to place: the step assigns nothing (uniform branch)
        for (int w = t; w < W; w += kThreads) crow[w] = 0;
        continue;
      }
      int m = order_ids[bv];
      m = m < 0 ? 0 : (m >= M ? M - 1 : m);
      const int* ord = order + (size_t)m * W;
      const int* need = needs + bv * R;
      const int* amask = all_mask != nullptr ? all_mask + bv * R : nullptr;
      const int mt = min_time[bv];

      int wk[kMaxPerThread];
      int cap[kMaxPerThread];
      long long local = 0;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int p = t * K + j;
        wk[j] = -1;
        cap[j] = 0;
        if (j < K && p < W) {
          const int w = ord[p];
          long long c = capacity(free_ + (size_t)w * R,
                                 total != nullptr ? total + (size_t)w * R
                                                  : nullptr,
                                 need, amask, R, nt_free[w], lifetime[w], mt);
          if (c > remaining) c = remaining;
          if (pmask != nullptr && pmask[w] <= 0) c = 0;
          wk[j] = w;
          cap[j] = (int)c;
          local += c;
        }
      }
      long long step_total;
      long long run = block_exclusive(local, s_warp, &step_total);
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int w = wk[j];
        if (w < 0) continue;
        long long a = remaining - run;
        if (a < 0) a = 0;
        if (a > cap[j]) a = cap[j];
        run += cap[j];
        crow[w] = (int)a;
        if (a > 0) {
          // int32 wrap-around arithmetic, as the reference's int32 tensors
          const uint32_t ua = (uint32_t)a;
          uint32_t* frow = reinterpret_cast<uint32_t*>(free_ + (size_t)w * R);
          for (int r = 0; r < R; ++r) {
            uint32_t f = frow[r] - ua * (uint32_t)need[r];
            if (amask != nullptr) f *= 1u - ua * (uint32_t)amask[r];
            frow[r] = f;
          }
          nt_free[w] = (int)((uint32_t)nt_free[w] - ua);
          if (s_avail != nullptr) s_avail[w] = 0;
        }
      }
      remaining -= remaining < step_total ? remaining : step_total;
      // the next step may hand this thread's workers to another thread
      __syncthreads();
    }
  }
}

// One block-wide scan plus the step's closing barrier, `steps` times: the
// part of a cut-scan step's latency that no data makes shorter.
__global__ void __launch_bounds__(kThreads, 1)
    scan_latency_kernel(int steps, long long* out) {
  __shared__ long long s_warp[kWarps];
  long long acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    long long total;
    acc = block_exclusive(acc & 7, s_warp, &total) + total;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" {

// All pointers are device pointers to C-contiguous int32 arrays: free (W,R)
// and nt_free (W,) are updated in place; total and all_mask are both null
// or both set; gang_nodes (B,), gang_ok (W,) and group_ids (W,) (values in
// [-1, G), -1 = no group) are all null or all set, with 1 <= G <= 16384;
// policy_mask (B,W) may be null; counts (B,V,W) is written in full; order
// is (M,W) scratch.  B = 0 runs the prologue alone.  Returns the
// cudaError_t of the launch (0 = launched).
int hq_cut_scan(void* free_, void* nt_free, const void* lifetime,
                const void* needs, const void* sizes, const void* min_time,
                const void* class_m, const void* order_ids, const void* total,
                const void* all_mask, const void* gang_nodes,
                const void* gang_ok, const void* group_ids,
                const void* policy_mask, void* counts, void* order, int W,
                int R, int B, int V, int M, int G, void* stream) {
  const bool gang = gang_nodes != nullptr;
  if (W < 1 || W > kThreads * kMaxPerThread || R < 1 || B < 0 || V < 1 ||
      M < 1 || ((total == nullptr) != (all_mask == nullptr)) ||
      (gang != (gang_ok != nullptr)) || (gang != (group_ids != nullptr)) ||
      (gang && (G < 1 || G > kMaxGroups))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gang ? (size_t)G * sizeof(int) + (size_t)W : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cut_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cut_scan_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (int*)free_, (int*)nt_free, (const int*)lifetime, (const int*)needs,
      (const int*)sizes, (const int*)min_time, (const int*)class_m,
      (const int*)order_ids, (const int*)total, (const int*)all_mask,
      (const int*)gang_nodes, (const int*)gang_ok, (const int*)group_ids,
      (const int*)policy_mask, (int*)counts, (int*)order, W, R, B, V, M, G);
  return (int)cudaGetLastError();
}

int hq_scan_latency(int steps, void* out, void* stream) {
  scan_latency_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      steps, (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
