// Sharded greedy cut-scan: the dense solve of one scheduling tick with the
// worker axis split into D contiguous shards, written for Hopper (sm_90a).
//
// Replaces hyperqueue_tpu/parallel/solve.py sharded_cut_scan and
// sharded_cut_scan_donate (the shard_map of scan_batches whose water-fill is
// _sharded_water_fill_classed and whose gang choice is _sharded_gang_select).
// It computes what cut_scan.cu (K1) computes, bit for bit: the same
// (batch, variant) steps, capacities, ALL-policy fits, gang rows and policy
// mask.  What differs is where the workers live: shard d owns workers
// [d*W/D, (d+1)*W/D), and a worker's water-fill prefix is put together from
// three terms,
//
//   prefix(w) = capacity of the strictly lower visit classes, cluster-wide
//             + capacity of w's class on lower shards
//             + capacity of w's class before w on its own shard,
//
// of which the first two come from the per-class capacity sums (C = 16) of
// every shard, exchanged once per step.  A gang row exchanges the per-group
// eligible counts (G) instead, picks its group from the cluster-wide counts
// and shifts each shard's take-prefix by the chosen group's eligible count
// on the lower shards.
//
// Design: one cooperative launch, one block of 1024 threads per shard, so
// every block is resident at once and the blocks can wait for each other.
// Each block runs K1's step on its own workers (a prologue counting-sorts
// each visit-class row of its shard into visit order; one int64 block scan
// of the capacities in that order gives the in-shard prefix; the class
// starts of the sorted order turn it into per-class sums).  Per step, each
// block writes its (C,) int64 sums to a mailbox in device memory, passes
// one grid barrier, and reads all D rows: the cluster totals, the lower-
// shard offsets and `remaining` come out the same in every block.  The
// mailbox is double-buffered by barrier parity, so one barrier per step is
// enough: a block writes a buffer again only two barriers after it was
// written, when every block has read it.  Gang steps exchange their (G,)
// int32 counts the same way; the gang carry stays per worker in the
// block's shared memory.
//
// The barrier is written by hand (an arrival counter that only grows,
// released with a fence and a relaxed add, awaited with ld.acquire.gpu),
// as cooperative_groups' grid sync is, without needing relocatable device
// code.  A block that waits more than kBarrierTimeoutNs traps: a fault
// (a block that never arrives) ends the launch with an error instead of
// hanging the card.  Mailbox reads and writes bypass L1 (ld/st.cg).
//
// What bounds it: as K1, the steps are sequential, so its time is the
// executed steps times the latency of one step, which here adds a grid
// barrier to K1's block scan.  With D shards on one card it does not beat
// K1 at widths K1 takes; it solves up to D x 16,384 workers, and it is the
// program that a mesh of cards will run with the mailbox in peer memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cut_scan_step.cuh"

namespace {

constexpr int kBounds = kClasses + 1;         // class starts, and the end
constexpr int kLocalBits = 14;                // local index < 16384
constexpr int kLocalMask = (1 << kLocalBits) - 1;
constexpr int kGroupBits = 14;                // kMaxGroups == 1 << 14
constexpr long long kBarrierTimeoutNs = 10LL * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier: every block's threads have done their writes before
// any thread of any block goes past it.  `target` is (number of this
// barrier, counting from 1) x (blocks); the counter starts the launch at 0.
__device__ __forceinline__ void grid_sync(unsigned* counter,
                                          unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    if (ld_acquire(counter) < target) {
      const long long t0 = global_ns();
      while (ld_acquire(counter) < target) {
        if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long warp_max_u(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long n = __shfl_xor_sync(0xffffffffu, v, o);
    if (n > v) v = n;
  }
  return v;
}

// One gang row on this block's shard: counts its eligible workers per
// group, exchanges the counts, picks the group from the cluster-wide
// counts (first with >= n, else the first with the most), and takes the n
// lowest-index eligible members cluster-wide, of which this shard holds
// those past the lower shards' share.  Writes the row's counts of this
// shard, all V variants, and holds the members taken.  Every thread of
// every block calls it; it ends with the step's closing barrier.
__device__ __noinline__ void gang_step(
    int n, int mt0, int* __restrict__ free_, int* __restrict__ nt_free,
    const int* __restrict__ lifetime, const int* __restrict__ group_ids,
    const int* __restrict__ pmask, int* __restrict__ crow, int W, int R,
    int V, int G, int D, int* s_group, unsigned char* s_avail,
    long long* s_warp, int* __restrict__ mail_g, unsigned* barrier,
    unsigned target, unsigned parity) {
  __shared__ int s_first;
  __shared__ unsigned long long s_best;
  __shared__ long long s_lower;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int d = blockIdx.x;
  const int Wl = W / D;
  const int base = d * Wl;
  const int K = (Wl + kThreads - 1) / kThreads;
  for (int g = t; g < G; g += kThreads) s_group[g] = 0;
  if (t == 0) {
    s_first = INT_MAX;
    s_best = 0ull;
  }
  __syncthreads();

  // eligible local workers of this thread (bit j = local t*K + j), counted
  // per group; lanes with the same group add once, through their leader
  unsigned elig = 0;
  for (int j = 0; j < K; ++j) {
    const int l = t * K + j;
    const int w = base + l;
    int key = -1;
    if (l < Wl && s_avail[l] && mt0 <= lifetime[w] && nt_free[w] >= 1 &&
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
  int* mine = mail_g + ((size_t)parity * D + d) * G;
  for (int g = t; g < G; g += kThreads) __stcg(mine + g, s_group[g]);
  grid_sync(barrier, target);

  // the cluster-wide counts, the same in every block
  const int* rows = mail_g + (size_t)parity * D * G;
  int first = INT_MAX;
  unsigned long long best = 0ull;
  for (int g = t; g < G; g += kThreads) {
    long long c = 0;
    for (int e = 0; e < D; ++e) c += __ldcg(rows + (size_t)e * G + g);
    if (c >= n && g < first) first = g;
    const unsigned long long key =
        ((unsigned long long)c << kGroupBits) |
        (unsigned long long)(kMaxGroups - 1 - g);
    if (key > best) best = key;
  }
  first = __reduce_min_sync(0xffffffffu, first);
  best = warp_max_u(best);
  if (lane == 0) {
    atomicMin(&s_first, first);
    atomicMax(&s_best, best);
  }
  __syncthreads();
  const bool feasible = s_first != INT_MAX;
  const int chosen =
      feasible ? s_first
               : kMaxGroups - 1 - (int)(s_best & (kMaxGroups - 1));
  if (t == 0) {
    long long lower = 0;
    for (int e = 0; e < d; ++e) lower += __ldcg(rows + (size_t)e * G + chosen);
    s_lower = lower;
  }

  // the chosen group's members here, after the lower shards' members
  unsigned sel = 0;
  for (int j = 0; j < K; ++j) {
    if (((elig >> j) & 1u) && group_ids[base + t * K + j] == chosen) {
      sel |= 1u << j;
    }
  }
  long long total;
  long long before = block_exclusive(__popc(sel), s_warp, &total) + s_lower;
  for (int j = 0; j < K; ++j) {
    const int l = t * K + j;
    if (l >= Wl) break;
    const int w = base + l;
    int emit = 0;
    if ((sel >> j) & 1u) {
      if (before < n) {
        // held, feasible or not: the in-solve reservation
        int* frow = free_ + (size_t)w * R;
        for (int r = 0; r < R; ++r) frow[r] = 0;
        nt_free[w] = 0;
        s_avail[l] = 0;
        emit = feasible ? 1 : 0;
      }
      ++before;
    }
    crow[w] = emit;
  }
  for (int v = 1; v < V; ++v) {
    for (int l = t; l < Wl; l += kThreads) crow[(size_t)v * W + base + l] = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) sharded_scan_kernel(
    int* __restrict__ free_, int* __restrict__ nt_free,
    const int* __restrict__ lifetime, const int* __restrict__ needs,
    const int* __restrict__ sizes, const int* __restrict__ min_time,
    const int* __restrict__ class_m, const int* __restrict__ order_ids,
    const int* __restrict__ total, const int* __restrict__ all_mask,
    const int* __restrict__ gang_nodes, const int* __restrict__ gang_ok,
    const int* __restrict__ group_ids, const int* __restrict__ policy_mask,
    int* __restrict__ counts, int* __restrict__ order,
    int* __restrict__ starts, long long* __restrict__ mail,
    int* __restrict__ mail_g, unsigned* barrier, int W, int R, int B, int V,
    int M, int G, int D) {
  __shared__ long long s_warp[kWarps];
  __shared__ unsigned long long s_pack[4][kWarps];
  __shared__ int s_start[kBounds];
  __shared__ long long s_bound[kBounds];
  __shared__ long long s_off[kClasses];
  __shared__ long long s_total;
  // gang rows only: per-group counts (G ints), then the shard's carry
  extern __shared__ __align__(16) unsigned char s_dyn[];
  int* s_group = reinterpret_cast<int*>(s_dyn);
  unsigned char* s_avail =
      gang_nodes != nullptr ? s_dyn + (size_t)G * sizeof(int) : nullptr;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int d = blockIdx.x;
  const int Wl = W / D;
  const int base = d * Wl;
  const int K = (Wl + kThreads - 1) / kThreads;
  unsigned barriers = 0;

  if (s_avail != nullptr) {
    for (int l = t; l < Wl; l += kThreads) s_avail[l] = gang_ok[base + l] != 0;
    __syncthreads();
  }

  // Prologue: order[m, base + p] lists this shard's workers by
  // (class_m[m, w], w) as (class << 14 | local index), and starts[m, d]
  // holds the position where each class begins (and Wl at the end).
  for (int m = 0; m < M; ++m) {
    const int* cm = class_m + (size_t)m * W + base;
    unsigned long long loc[4] = {0ull, 0ull, 0ull, 0ull};
    int cls[kMaxPerThread];
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int l = t * K + j;
      cls[j] = 0;
      if (j < K && l < Wl) {
        const int c = clamp_class(cm[l]);
        cls[j] = c;
        loc[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    unsigned long long excl[4], tot[4];
    block_exclusive_packed(loc, excl, tot, s_pack);
    int* ord = order + (size_t)m * W + base;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int l = t * K + j;
      if (j < K && l < Wl) {
        const int c = cls[j];
        unsigned before = 0;
        for (int k = 0; k < c; ++k) before += field(tot, k);
        ord[before + field(excl, c)] = (c << kLocalBits) | l;
        excl[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    if (t == 0) {
      int* st = starts + ((size_t)m * D + d) * kBounds;
      unsigned acc = 0;
      for (int c = 0; c < kClasses; ++c) {
        st[c] = (int)acc;
        acc += field(tot, c);
      }
      st[kClasses] = (int)acc;
    }
    __syncthreads();
  }

  for (int b = 0; b < B; ++b) {
    const int* pmask =
        policy_mask != nullptr ? policy_mask + (size_t)b * W : nullptr;
    if (gang_nodes != nullptr && gang_nodes[b] > 0) {
      ++barriers;
      gang_step(gang_nodes[b], min_time[(size_t)b * V], free_, nt_free,
                lifetime, group_ids, pmask, counts + (size_t)b * V * W, W, R,
                V, G, D, s_group, s_avail, s_warp, mail_g, barrier,
                barriers * (unsigned)D, barriers & 1u);
      continue;
    }
    long long remaining = sizes[b];
    for (int v = 0; v < V; ++v) {
      const size_t bv = (size_t)b * V + v;
      int* crow = counts + bv * W;
      if (remaining <= 0) {
        // nothing left to place, in every block alike: no exchange
        for (int l = t; l < Wl; l += kThreads) crow[base + l] = 0;
        continue;
      }
      int m = order_ids[bv];
      m = m < 0 ? 0 : (m >= M ? M - 1 : m);
      const int* ord = order + (size_t)m * W + base;
      if (t < kBounds) s_start[t] = starts[((size_t)m * D + d) * kBounds + t];
      const int* need = needs + bv * R;
      const int* amask = all_mask != nullptr ? all_mask + bv * R : nullptr;
      const int mt = min_time[bv];

      int pk[kMaxPerThread];
      int cap[kMaxPerThread];
      long long local = 0;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int p = t * K + j;
        pk[j] = -1;
        cap[j] = 0;
        if (j < K && p < Wl) {
          const int packed = ord[p];
          const int w = base + (packed & kLocalMask);
          long long c = capacity(free_ + (size_t)w * R,
                                 total != nullptr ? total + (size_t)w * R
                                                  : nullptr,
                                 need, amask, R, nt_free[w], lifetime[w], mt);
          if (c > remaining) c = remaining;
          if (pmask != nullptr && pmask[w] <= 0) c = 0;
          pk[j] = packed;
          cap[j] = (int)c;
          local += c;
        }
      }
      long long shard_total;
      long long run = block_exclusive(local, s_warp, &shard_total);

      // the in-shard prefix where each class begins (its lower classes'
      // capacity here): the thread holding that position writes it
      {
        const int lo = t * K;
        for (int c = 0; c < kBounds; ++c) {
          const int s = s_start[c];
          if (s >= lo && s < lo + K && s < Wl) {
            long long acc = run;
#pragma unroll
            for (int j = 0; j < kMaxPerThread; ++j) {
              if (j < s - lo) acc += cap[j];
            }
            s_bound[c] = acc;
          } else if (t == 0 && s >= Wl) {
            s_bound[c] = shard_total;
          }
        }
      }
      __syncthreads();
      ++barriers;
      const unsigned parity = barriers & 1u;
      long long* rows = mail + (size_t)parity * D * kClasses;
      if (t < kClasses) {
        __stcg(rows + (size_t)d * kClasses + t, s_bound[t + 1] - s_bound[t]);
      }
      grid_sync(barrier, barriers * (unsigned)D);
      if (t < 32) {
        // lane c: class c's capacity cluster-wide and on the lower shards
        long long sum = 0, lower = 0;
        if (lane < kClasses) {
          for (int e = 0; e < D; ++e) {
            const long long x = __ldcg(rows + (size_t)e * kClasses + lane);
            sum += x;
            if (e < d) lower += x;
          }
        }
        const long long inc = warp_inclusive(sum, lane);
        if (lane < kClasses) s_off[lane] = inc - sum + lower - s_bound[lane];
        if (lane == kClasses - 1) s_total = inc;
      }
      __syncthreads();
      const long long step_total = s_total;
#pragma unroll
      for (int j = 0; j < kMaxPerThread; ++j) {
        const int packed = pk[j];
        if (packed < 0) continue;
        const int l = packed & kLocalMask;
        const int w = base + l;
        long long a = remaining - (run + s_off[packed >> kLocalBits]);
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
          if (s_avail != nullptr) s_avail[l] = 0;
        }
      }
      remaining -= remaining < step_total ? remaining : step_total;
      // the next step may hand this thread's workers to another thread
      __syncthreads();
    }
  }
}

// One block-wide scan plus one grid barrier, `steps` times, in every
// block: the part of a sharded step's latency that no data makes shorter.
__global__ void __launch_bounds__(kThreads, 1)
    grid_step_latency_kernel(int steps, unsigned* barrier, long long* out) {
  __shared__ long long s_warp[kWarps];
  long long acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    long long total;
    acc = block_exclusive(acc & 7, s_warp, &total) + total;
    grid_sync(barrier, (unsigned)(i + 1) * gridDim.x);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// The launch's shape check: D blocks of kThreads with `smem` dynamic
// shared memory must all be resident at once.
cudaError_t check_cooperative(const void* kernel, int D, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < D) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// As hq_cut_scan (cut_scan.cu), over D shards of W / D workers each
// (W % D == 0, W / D <= 16384, D <= the blocks the card holds at once).
// Scratch, all device memory the kernel writes: order (M, W) int32, starts
// (M, D, 17) int32, mail (2, D, 16) int64, mail_g (2, D, G) int32 (null
// without gang rows) and barrier (one uint32, zeroed here on the stream).
// Returns the cudaError_t of the launch (0 = launched).
int hq_sharded_scan(void* free_, void* nt_free, const void* lifetime,
                    const void* needs, const void* sizes,
                    const void* min_time, const void* class_m,
                    const void* order_ids, const void* total,
                    const void* all_mask, const void* gang_nodes,
                    const void* gang_ok, const void* group_ids,
                    const void* policy_mask, void* counts, void* order,
                    void* starts, void* mail, void* mail_g, void* barrier,
                    int W, int R, int B, int V, int M, int G, int D,
                    void* stream) {
  const bool gang = gang_nodes != nullptr;
  if (D < 1 || W < D || W % D != 0 || W / D > kThreads * kMaxPerThread ||
      R < 1 || B < 0 || V < 1 || M < 1 ||
      ((total == nullptr) != (all_mask == nullptr)) ||
      (gang != (gang_ok != nullptr)) || (gang != (group_ids != nullptr)) ||
      (gang != (mail_g != nullptr)) ||
      (gang && (G < 1 || G > kMaxGroups))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = gang ? (size_t)G * sizeof(int) + (size_t)(W / D) : 0;
  const void* kernel = reinterpret_cast<const void*>(sharded_scan_kernel);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sharded_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = check_cooperative(kernel, D, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  int* a_free = (int*)free_;
  int* a_nt = (int*)nt_free;
  const int* a_life = (const int*)lifetime;
  const int* a_needs = (const int*)needs;
  const int* a_sizes = (const int*)sizes;
  const int* a_mt = (const int*)min_time;
  const int* a_class = (const int*)class_m;
  const int* a_oid = (const int*)order_ids;
  const int* a_total = (const int*)total;
  const int* a_amask = (const int*)all_mask;
  const int* a_gang = (const int*)gang_nodes;
  const int* a_gok = (const int*)gang_ok;
  const int* a_gid = (const int*)group_ids;
  const int* a_pmask = (const int*)policy_mask;
  int* a_counts = (int*)counts;
  int* a_order = (int*)order;
  int* a_starts = (int*)starts;
  long long* a_mail = (long long*)mail;
  int* a_mail_g = (int*)mail_g;
  unsigned* a_barrier = (unsigned*)barrier;
  void* args[] = {&a_free,   &a_nt,    &a_life,   &a_needs,   &a_sizes,
                  &a_mt,     &a_class, &a_oid,    &a_total,   &a_amask,
                  &a_gang,   &a_gok,   &a_gid,    &a_pmask,   &a_counts,
                  &a_order,  &a_starts, &a_mail,  &a_mail_g,  &a_barrier,
                  &W,        &R,       &B,        &V,         &M,
                  &G,        &D};
  err = cudaLaunchCooperativeKernel(kernel, dim3(D), dim3(kThreads), args,
                                    smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// `steps` block scans and grid barriers in each of D blocks; out holds D
// int64, barrier one uint32 (zeroed here).  Returns the launch's error.
int hq_grid_step_latency(int steps, int D, void* barrier, void* out,
                         void* stream) {
  const void* kernel = reinterpret_cast<const void*>(grid_step_latency_kernel);
  cudaError_t err = check_cooperative(kernel, D, 0);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  unsigned* a_barrier = (unsigned*)barrier;
  long long* a_out = (long long*)out;
  void* args[] = {&steps, &a_barrier, &a_out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(D), dim3(kThreads), args, 0,
                                    s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
