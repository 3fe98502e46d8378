// Greedy cut-scan: the dense solve of one scheduling tick, written for
// Hopper (sm_90a).
//
// Replaces hyperqueue_tpu/ops/assign.py greedy_cut_scan (the jitted
// lax.scan of scan_batches over _variant_capacity and _water_fill_classed).
// What it computes, step by step over batches b (priority order) and their
// variants v:
//   cap[w]  = min over requested resources r of floor(free[w,r] / need[r])
//             (an ALL-policy resource instead fits one task where the pool
//             is untouched: free == total > 0; a resource the variant does
//             not request caps at 2^30), capped by nt_free[w]; 0 where
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
// card's rates; its time is B*V times the latency of one step.  So the
// design shortens the step's dependent chain:
//
// - One block runs the whole solve; thread t owns the sorted positions
//   [t*K, t*K+K) of every visit order (K = ceil(W / threads)).  A prologue
//   counting-sorts each visit-class row once into its visit order, so one
//   block scan of the capacities in position order IS the water-fill prefix.
// - Worker state.  The kernel body is a template over where the per-worker
//   state lives.  Resident: the prologue brings free, nt_free, lifetime,
//   total (ALL-policy) and group ids (gang rows) into shared memory with
//   one-dimensional TMA bulk copies behind an mbarrier, the visit orders
//   live there as 16-bit indices, every step reads and writes shared memory
//   only, and free/nt_free go back to device memory once, at the end.
//   Global: the same state in device memory (the orders in the `order`
//   scratch), for clusters whose state does not fit (the wrapper chooses
//   by shape before the launch; see cut_scan_layout).
// - Step inputs ahead of use.  needs, all_mask, min_time, order_ids, sizes
//   and gang_nodes arrive in chunks of whole batches (up to 64 steps, fewer
//   where the layout needs the room) in a double-buffered ring,
//   bulk-copied one chunk ahead behind mbarriers; when a chunk lands, one
//   thread per step lists the resources it touches with, for each divisor,
//   a reciprocal (a magic multiplier and a shift), so a worker's quotient
//   is a multiply and a shift and padding resources cost nothing.  On the
//   resident instantiation the policy-mask row of the next batch is copied
//   the same way.
// - Exact 32-bit arithmetic.  A negative free or nt_free can only give a
//   capacity of 0, so the division only sees dividends in [1, 2^31), and
//   the prefix is a saturating unsigned 32-bit scan (the argument is at
//   block_exclusive_sat).  free and nt_free keep int32 wrap-around.
// - Barriers.  The scan takes one barrier (its warp sums alternate between
//   two buffers by step parity).  While consecutive steps use the same
//   visit-class row, a thread's positions hold the same workers, so it
//   reads only state it wrote itself and no closing barrier is needed; one
//   is taken where the row changes, around a gang step, where the ring turns
//   over and (resident, with a policy mask) at each batch, before the next
//   row's copy overwrites the buffer of the one before.
//
// Gang steps visit workers in index order (thread t owns workers
// [t*K, t*K+K)), not in visit order, so they have a block scan of their own
// over the selected members; the gang-availability carry (W bytes) and the
// per-group eligible counts (G ints, warp-aggregated shared atomics) live in
// shared memory on both instantiations.  The gang step is a separate,
// non-inlined function, so its state stays out of the ordinary step's
// registers.
//
// The int64 step arithmetic (floor division, a two-barrier int64 scan)
// stays in cut_scan_step.cuh for the sharded kernel (sharded_scan.cu, K2)
// and for step_split_kernel, the measurement below that compares the two.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "cut_scan_step.cuh"

namespace {

// ---- the redesigned step's arithmetic ------------------------------------

constexpr unsigned kSat = 0x7fffffffu;  // 2^31 - 1: caps and prefixes top out here

// min(a + b, 2^31 - 1) for a, b <= 2^31 - 1 (the sum fits in 32 bits).
__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) {
  return min(a + b, kSat);
}

// Inclusive prefix over the first `lanes` lanes of a warp, saturating.
template <int lanes>
__device__ __forceinline__ unsigned warp_inclusive_sat(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < lanes; o <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = sat_add(v, n);
  }
  return v;
}

// Exclusive prefix of v over the block (thread order) and the block total,
// both saturated at 2^31 - 1, with ONE barrier.  Why saturating is exact:
// every v is >= 0 and sat_add(min(x, S), y) == min(x + y, S) for y >= 0,
// so any order of additions gives min(true sum, S), S = 2^31 - 1.  A step
// uses a prefix P only through clip(remaining - P, 0, cap) and a total T
// only through remaining -= min(remaining, T), with remaining <= S: a
// saturated prefix is >= remaining exactly when the true one is, and equal
// to it below that, so both results are unchanged.  `buf` holds NT/32 warp
// sums; the caller alternates two buffers by step parity, so a warp writes a
// buffer again only after the next step's barrier, when every warp has read
// it.
template <int NT>
__device__ __forceinline__ unsigned block_exclusive_sat(unsigned v,
                                                        unsigned* buf,
                                                        unsigned* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned inc = warp_inclusive_sat<32>(v, lane);
  unsigned excl = __shfl_up_sync(0xffffffffu, inc, 1);
  excl = lane ? excl : 0u;
  if (lane == 31) buf[warp] = inc;
  __syncthreads();  // every warp's sum is in buf
  const unsigned ws = lane < NW ? buf[lane] : 0u;
  const unsigned wi = warp_inclusive_sat<NW>(ws, lane);
  const unsigned off = __shfl_sync(0xffffffffu, wi, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, wi, NW - 1);
  return sat_add(warp ? off : 0u, excl);
}

// Floor division by a divisor d in [1, 2^31 - 1] of a dividend in
// [0, 2^31 - 1] as a multiply and a shift (Granlund and Montgomery, 1994,
// theorem 4.2 with N = 31): with l = ceil(log2 d) and
// m = ceil(2^(31+l) / d) (< 2^32), m*d - 2^(31+l) < d <= 2^l, so
// floor(n/d) == (m*n) >> (31+l) for every n < 2^31; m*n < 2^63.
struct Recip {
  unsigned magic;
  int shift;
};

__device__ __forceinline__ Recip make_recip(int d) {
  const int l = 32 - __clz(d - 1);  // ceil(log2 d); 0 for d == 1
  const unsigned long long num = 1ull << (31 + l);
  return {(unsigned)((num + (unsigned)d - 1) / (unsigned)d), 31 + l};
}

__device__ __forceinline__ unsigned recip_div(unsigned n, unsigned magic,
                                              int shift) {
  return (unsigned)(((unsigned long long)magic * n) >> shift);
}

// ---- shared-memory layout --------------------------------------------------
//
// Everything lives in dynamic shared memory, so one number, the layout's
// bytes, decides whether a launch fits.  ops/assign.cut_scan_smem_bytes
// repeats this computation as the CPU tests' oracle; the wrapper asks
// hq_cut_scan_smem_bytes itself, and a card test holds the two equal.

constexpr long long kSmemLimit = 232448;  // what an sm_90 block may opt into
constexpr int kChunkSteps = 64;  // most steps per ring chunk
constexpr int kHeaderBytes = 1360;  // mbarriers, scan buffers, gang choice

// mbarriers: the resident state, the two ring slots, the two mask rows
constexpr int kBarState = 0;
constexpr int kBarRing = 1;
constexpr int kBarMask = 3;

__host__ __device__ inline long long al16(long long n) {
  return (n + 15) / 16 * 16;
}
// a TMA destination: 16 more bytes, since a copy starts at the source's
// 16-byte boundary below the data (see bulk_load)
__host__ __device__ inline long long tma16(long long n) { return al16(n) + 16; }

struct Layout {
  int cb, cs;  // batches and steps per ring chunk
  int slot[2];
  // within a slot; -1 where absent
  int need, amask, mt, oid, size, gang, steps, ents;
  int cap, group, avail;
  // resident only
  int free_, nt, life, total, gid, order, mask[2];
  long long bytes;
};

// The layout with cb whole batches per ring chunk.
inline long long layout_with(Layout* L, int cb, int W, int R, int V, int M,
                             int G, bool all, bool gang, bool pmask,
                             bool resident) {
  const long long w = W, r = R;
  L->cb = cb;
  L->cs = cb * V;
  const long long cs = L->cs;
  long long o = 0;
  auto take = [&](long long n) {
    const long long at = o;
    o += n;
    return (int)(at < INT_MAX ? at : -1);
  };
  L->need = take(tma16(cs * r * 4));
  L->amask = all ? take(tma16(cs * r * 4)) : -1;
  L->mt = take(tma16(cs * 4));
  L->oid = take(tma16(cs * 4));
  L->size = take(tma16(cb * 4LL));
  L->gang = gang ? take(tma16(cb * 4LL)) : -1;
  L->steps = take(cs * 16);
  L->ents = take(cs * r * 16);
  const long long slot = o;
  o = kHeaderBytes;
  L->slot[0] = take(slot);
  L->slot[1] = take(slot);
  L->cap = take(tma16(w * 4));
  L->group = gang ? take(al16((long long)G * 4)) : -1;
  L->avail = gang ? take(al16(w)) : -1;
  L->free_ = L->nt = L->life = L->total = L->gid = L->order = -1;
  L->mask[0] = L->mask[1] = -1;
  if (resident) {
    L->free_ = take(tma16(w * r * 4));
    L->nt = take(tma16(w * 4));
    L->life = take(tma16(w * 4));
    L->total = all ? take(tma16(w * r * 4)) : -1;
    L->gid = gang ? take(tma16(w * 4)) : -1;
    L->order = take(al16((long long)M * w * 2));
    if (pmask) {
      L->mask[0] = take(tma16(w * 4));
      L->mask[1] = take(tma16(w * 4));
    }
  }
  L->bytes = o;
  return o;
}

// The ring's chunk is the most whole batches, up to kChunkSteps steps (at
// least one batch), with which the layout fits kSmemLimit: a wide cluster
// or many resources shrink the ring rather than refuse the launch.  Where
// even one batch a chunk does not fit, this is that layout's bytes, over
// the limit.
inline long long make_layout(Layout* L, int W, int R, int V, int M, int G,
                             bool all, bool gang, bool pmask, bool resident) {
  int cb = kChunkSteps / V > 1 ? kChunkSteps / V : 1;
  while (layout_with(L, cb, W, R, V, M, G, all, gang, pmask, resident) >
             kSmemLimit &&
         cb > 1) {
    --cb;
  }
  return L->bytes;
}

// ---- TMA bulk copies and mbarriers ------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity (the k-th
// use of a barrier waits with parity k & 1).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's earlier shared-memory accesses (and, after a
// barrier, the block's) before the async proxy's next writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A bulk copy moves 16-byte-aligned spans of a multiple of 16 bytes, so it
// copies the aligned span around [src, src + bytes) (every 16-byte block
// that holds a byte of a mapped allocation is mapped) and the data lands
// (src & 15) bytes into the destination (see landed).
__device__ __forceinline__ unsigned span16(const void* src, size_t bytes) {
  const uintptr_t s = (uintptr_t)src;
  return (unsigned)(((s + bytes + 15) & ~(uintptr_t)15) - (s & ~(uintptr_t)15));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          size_t bytes,
                                          unsigned long long* bar) {
  const uintptr_t s = (uintptr_t)src & ~(uintptr_t)15;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(s), "r"(span16(src, bytes)), "r"(smem_u32(bar))
      : "memory");
}

template <class T>
__device__ __forceinline__ T* landed(unsigned char* dst, const void* src) {
  return reinterpret_cast<T*>(dst + ((uintptr_t)src & 15));
}

// ---- the solve ----------------------------------------------------------------

struct Args {
  int* free_;
  int* nt_free;
  const int* lifetime;
  const int* needs;
  const int* sizes;
  const int* min_time;
  const int* class_m;
  const int* order_ids;
  const int* total;
  const int* all_mask;
  const int* gang_nodes;
  const int* gang_ok;
  const int* group_ids;
  const int* policy_mask;
  int* counts;
  int* order;
  int W, R, B, V, M, G;
};

// One step of a ring chunk: its visit-class row, min_time, how many
// resources it touches, and flags: kAny (it requests something), kUnreq
// (some resource is not requested, so capacities cap at 2^30).
struct StepInfo {
  int m, mt, nent, flags;
};
constexpr int kAny = 1;
constexpr int kUnreq = 2;

// A resource a step touches (need != 0 or an ALL mark): rk = r | kind << 16
// | shift << 24, the raw need and mark for the update, the reciprocal.
struct Entry {
  int rk;
  int need;
  int amask;
  unsigned magic;
};
constexpr int kNoCap = 0;  // touched by the update only (a need < 0)
constexpr int kDiv = 1;    // floor(free / need)
constexpr int kAllFit = 2; // ALL-policy: 1 where free == total > 0

__device__ __forceinline__ void derive_step(StepInfo* si, Entry* ent,
                                            const int* need,
                                            const int* amask, int mt, int oid,
                                            int R, int M) {
  int n = 0, flags = 0;
  for (int r = 0; r < R; ++r) {
    const int d = need[r];
    const int am = amask != nullptr ? amask[r] : 0;
    const int kind = am > 0 ? kAllFit : (d > 0 ? kDiv : kNoCap);
    flags |= kind != kNoCap ? kAny : kUnreq;
    if (d == 0 && am == 0) continue;
    Recip q = {0u, 0};
    if (kind == kDiv) q = make_recip(d);
    ent[n++] = {r | (kind << 16) | (q.shift << 24), d, am, q.magic};
  }
  si->m = oid < 0 ? 0 : (oid >= M ? M - 1 : oid);
  si->mt = mt;
  si->nent = n;
  si->flags = flags;
}

// One gang row (see the top of the file): picks and holds the gang's
// workers and writes the row's counts, all V variants.  Every thread of the
// block calls it; it starts and ends with a barrier.
__device__ __noinline__ void gang_step(
    int n, int mt0, int* fs, int* nts, const int* lifes, const int* gids,
    const int* pm, int* crow, int W, int R, int V, int G, int K,
    int* s_group, unsigned char* s_avail, unsigned* s_ws, int* s_sel) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int g = t; g < G; g += kThreads) s_group[g] = 0;
  if (t == 0) {
    s_sel[0] = INT_MAX;  // first group with >= n eligible
    s_sel[1] = -1;       // (count, -group) of the first group with the most
  }
  // every earlier step's updates (of any worker) are visible, and s_group
  // is cleared
  __syncthreads();
  auto eligible = [&](int w) {
    return s_avail[w] && mt0 <= lifes[w] && nts[w] >= 1 &&
           (pm == nullptr || pm[w] > 0);
  };

  // eligible workers of this thread counted per group; lanes with the same
  // group add once, through their leader
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    int key = -1;
    if (w < W && eligible(w)) key = gids[w];
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&s_group[key], __popc(peers));
    }
  }
  __syncthreads();  // the per-group counts are complete

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
  __syncthreads();  // the choice is complete
  const bool feasible = s_sel[0] != INT_MAX;
  const int chosen =
      feasible ? s_sel[0] : kMaxGroups - 1 - (s_sel[1] & (kMaxGroups - 1));

  // the n lowest-index eligible members of the chosen group
  unsigned sel = 0;
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    if (w < W && eligible(w) && gids[w] == chosen) ++sel;
  }
  unsigned total;
  unsigned before = block_exclusive_sat<kThreads>(sel, s_ws, &total);
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    if (w >= W) break;
    int emit = 0;
    if (eligible(w) && gids[w] == chosen) {
      if (before < (unsigned)n) {
        // held, feasible or not: the in-solve reservation
        int* frow = fs + (size_t)w * R;
        for (int r = 0; r < R; ++r) frow[r] = 0;
        nts[w] = 0;
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
  // the held rows are visible before any thread reads them, and s_ws and
  // s_sel are free
  __syncthreads();
}

// kThreads = 1,024 threads a block: on the H100 they beat 256 and 512 at
// the north star's fused inputs and tied 512 at the default ones (PERF.md)
template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1) cut_scan_kernel(const Args a,
                                                               const Layout L) {
  using OrdT = typename std::conditional<kRes, unsigned short, int>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned* s_ws = reinterpret_cast<unsigned*>(smem + 64);  // [2][32]
  auto s_pack = reinterpret_cast<unsigned long long(*)[32]>(smem + 320);
  int* s_sel = reinterpret_cast<int*>(smem + 1344);
  unsigned* s_cap = reinterpret_cast<unsigned*>(smem + L.cap);
  const int t = threadIdx.x;
  const int W = a.W, R = a.R, B = a.B, V = a.V, M = a.M, G = a.G;
  const int K = (W + kThreads - 1) / kThreads;
  const bool all = a.total != nullptr;
  const bool gang = a.gang_nodes != nullptr;
  const bool masked = a.policy_mask != nullptr;
  int* s_group = gang ? reinterpret_cast<int*>(smem + L.group) : nullptr;
  unsigned char* s_avail = gang ? smem + L.avail : nullptr;

  // where the worker state lives
  int* fs;
  int* nts;
  const int* lifes;
  const int* tots;
  const int* gids;
  OrdT* ords;
  if constexpr (kRes) {
    fs = landed<int>(smem + L.free_, a.free_);
    nts = landed<int>(smem + L.nt, a.nt_free);
    lifes = landed<const int>(smem + L.life, a.lifetime);
    tots = all ? landed<const int>(smem + L.total, a.total) : nullptr;
    gids = gang ? landed<const int>(smem + L.gid, a.group_ids) : nullptr;
    ords = reinterpret_cast<OrdT*>(smem + L.order);
  } else {
    fs = a.free_;
    nts = a.nt_free;
    lifes = a.lifetime;
    tots = a.total;
    gids = a.group_ids;
    ords = a.order;
  }

  const int nchunks = (B + L.cb - 1) / L.cb;
  // thread 0 copies chunk c of the step inputs into ring slot c & 1
  auto issue_chunk = [&](int c) {
    unsigned char* base = smem + L.slot[c & 1];
    unsigned long long* bar = bars + kBarRing + (c & 1);
    const int b0 = c * L.cb;
    const int nb = min(L.cb, B - b0);
    const size_t s0 = (size_t)b0 * V, ns = (size_t)nb * V;
    const int* src_need = a.needs + s0 * R;
    const int* src_amask = all ? a.all_mask + s0 * R : nullptr;
    unsigned tx = span16(src_need, ns * R * 4) + span16(a.min_time + s0, ns * 4) +
                  span16(a.order_ids + s0, ns * 4) + span16(a.sizes + b0, nb * 4);
    if (all) tx += span16(src_amask, ns * R * 4);
    if (gang) tx += span16(a.gang_nodes + b0, nb * 4);
    mbar_expect_tx(bar, tx);
    bulk_load(base + L.need, src_need, ns * R * 4, bar);
    if (all) bulk_load(base + L.amask, src_amask, ns * R * 4, bar);
    bulk_load(base + L.mt, a.min_time + s0, ns * 4, bar);
    bulk_load(base + L.oid, a.order_ids + s0, ns * 4, bar);
    bulk_load(base + L.size, a.sizes + b0, nb * 4, bar);
    if (gang) bulk_load(base + L.gang, a.gang_nodes + b0, nb * 4, bar);
  };
  // thread 0 copies policy-mask row b into buffer b & 1 (resident only)
  auto issue_mask = [&](int b) {
    unsigned long long* bar = bars + kBarMask + (b & 1);
    const int* src = a.policy_mask + (size_t)b * W;
    mbar_expect_tx(bar, span16(src, (size_t)W * 4));
    bulk_load(smem + L.mask[b & 1], src, (size_t)W * 4, bar);
  };

  if (t == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised
  if (t == 0) {
    if constexpr (kRes) {
      unsigned long long* bar = bars + kBarState;
      const size_t wr = (size_t)W * R * 4, w4 = (size_t)W * 4;
      unsigned tx = span16(a.free_, wr) + span16(a.nt_free, w4) +
                    span16(a.lifetime, w4);
      if (all) tx += span16(a.total, wr);
      if (gang) tx += span16(a.group_ids, w4) + span16(a.gang_ok, w4);
      mbar_expect_tx(bar, tx);
      bulk_load(smem + L.free_, a.free_, wr, bar);
      bulk_load(smem + L.nt, a.nt_free, w4, bar);
      bulk_load(smem + L.life, a.lifetime, w4, bar);
      if (all) bulk_load(smem + L.total, a.total, wr, bar);
      if (gang) {
        bulk_load(smem + L.gid, a.group_ids, w4, bar);
        // gang_ok lands in the capacity buffer until the prologue's end
        bulk_load(smem + L.cap, a.gang_ok, w4, bar);
      }
      if (masked && B > 0) issue_mask(0);
    }
    if (B > 0) issue_chunk(0);
  }

  // Prologue: ords[m] lists the workers by (class_m[m, w], w).  Thread t
  // counts the classes of workers [t*K, t*K+K) (index order), and a packed
  // block scan turns the counts into each worker's sorted position.
  for (int m = 0; m < M; ++m) {
    const int* cm = a.class_m + (size_t)m * W;
    unsigned long long loc[4] = {0ull, 0ull, 0ull, 0ull};
    for (int j = 0; j < K; ++j) {
      const int w = t * K + j;
      if (w < W) {
        const int c = clamp_class(cm[w]);
        loc[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    unsigned long long excl[4], tot[4];
    block_exclusive_packed(loc, excl, tot, s_pack);
    OrdT* ord = ords + (size_t)m * W;
    for (int j = 0; j < K; ++j) {
      const int w = t * K + j;
      if (w < W) {
        const int c = clamp_class(cm[w]);
        unsigned before = 0;
        for (int k = 0; k < c; ++k) before += field(tot, k);
        ord[before + field(excl, c)] = (OrdT)w;
        excl[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    __syncthreads();  // s_pack is rewritten by the next row
  }
  if constexpr (kRes) mbar_wait(bars + kBarState, 0);
  if (gang) {
    const int* ok = kRes ? landed<const int>(smem + L.cap, a.gang_ok)
                         : a.gang_ok;
    for (int w = t; w < W; w += kThreads) s_avail[w] = ok[w] != 0;
  }
  // the orders and s_avail are complete, and the capacity buffer is free
  __syncthreads();

  int owner_m = -1;  // the visit-class row the thread's positions follow
                     // since the last barrier (-1: none since one)
  int parity = 0;    // which scan buffer the next step's warp sums go to
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c & 1;
    unsigned char* base = smem + L.slot[slot];
    const int b0 = c * L.cb;
    const int nb = min(L.cb, B - b0);
    const size_t s0 = (size_t)b0 * V;
    const int ns = nb * V;
    mbar_wait(bars + kBarRing + slot, (c >> 1) & 1);
    StepInfo* steps = reinterpret_cast<StepInfo*>(base + L.steps);
    Entry* ents = reinterpret_cast<Entry*>(base + L.ents);
    {
      const int* r_need = landed<const int>(base + L.need, a.needs + s0 * R);
      const int* r_amask =
          all ? landed<const int>(base + L.amask, a.all_mask + s0 * R)
              : nullptr;
      const int* r_mt = landed<const int>(base + L.mt, a.min_time + s0);
      const int* r_oid = landed<const int>(base + L.oid, a.order_ids + s0);
      for (int i = t; i < ns; i += kThreads) {
        derive_step(steps + i, ents + (size_t)i * R, r_need + (size_t)i * R,
                    r_amask != nullptr ? r_amask + (size_t)i * R : nullptr,
                    r_mt[i], r_oid[i], R, M);
      }
    }
    // this chunk's step list is visible, and every thread is done with the
    // other slot (the previous chunk), which the next copy overwrites
    __syncthreads();
    owner_m = -1;
    if (t == 0 && c + 1 < nchunks) {
      fence_proxy_async();
      issue_chunk(c + 1);
    }
    const int* r_size = landed<const int>(base + L.size, a.sizes + b0);
    const int* r_gang =
        gang ? landed<const int>(base + L.gang, a.gang_nodes + b0) : nullptr;

    for (int bi = 0; bi < nb; ++bi) {
      const int b = b0 + bi;
      const int* pm = nullptr;
      if (masked) {
        if constexpr (kRes) {
          // every thread is done with row b - 1, whose buffer row b + 1
          // overwrites
          __syncthreads();
          owner_m = -1;
          if (t == 0 && b + 1 < B) {
            fence_proxy_async();
            issue_mask(b + 1);
          }
          mbar_wait(bars + kBarMask + (b & 1), (b >> 1) & 1);
          pm = landed<const int>(smem + L.mask[b & 1],
                                 a.policy_mask + (size_t)b * W);
        } else {
          pm = a.policy_mask + (size_t)b * W;
        }
      }
      int* brow = a.counts + (size_t)b * V * W;
      if (gang && r_gang[bi] > 0) {
        gang_step(r_gang[bi], steps[bi * V].mt, fs, nts, lifes, gids, pm, brow,
                  W, R, V, G, K, s_group, s_avail, s_ws, s_sel);
        owner_m = -1;
        continue;
      }
      int remaining = r_size[bi];
      for (int v = 0; v < V; ++v) {
        int* crow = brow + (size_t)v * W;
        if (remaining <= 0) {
          // nothing left to place: the step assigns nothing (uniform branch)
          for (int w = t; w < W; w += kThreads) crow[w] = 0;
          continue;
        }
        const StepInfo si = steps[bi * V + v];
        if (owner_m >= 0 && owner_m != si.m) {
          // the thread's positions now hold other workers, whose state
          // other threads updated in the previous step
          __syncthreads();
        }
        owner_m = si.m;
        const OrdT* ord = ords + (size_t)si.m * W;
        const Entry* ent = ents + (size_t)(bi * V + v) * R;
        const int nent = si.nent;
        const bool live = (si.flags & kAny) != 0;
        const unsigned cap0 = (si.flags & kUnreq) ? (unsigned)kUnneeded
                                                  : 0xffffffffu;
        const int p0 = t * K;
        unsigned local = 0, c0 = 0;
        int w0 = 0;
        for (int j = 0; j < K; ++j) {
          const int p = p0 + j;
          if (p >= W) break;
          const int w = ord[p];
          unsigned cap = 0;
          if (live && si.mt <= lifes[w]) {
            const int nt = nts[w];
            cap = nt > 0 ? min(cap0, (unsigned)nt) : 0u;
            const int* frow = fs + (size_t)w * R;
            for (int k = 0; k < nent && cap > 0; ++k) {
              const Entry q = ent[k];
              const int kind = (q.rk >> 16) & 0xff;
              if (kind == kNoCap) continue;
              const int r = q.rk & 0xffff;
              const int f = frow[r];
              unsigned per;
              if (kind == kAllFit) {
                per = (f > 0 && f == tots[(size_t)w * R + r]) ? 1u : 0u;
              } else {
                per = f > 0 ? recip_div((unsigned)f, q.magic, q.rk >> 24) : 0u;
              }
              cap = min(cap, per);
            }
            cap = min(cap, (unsigned)remaining);
            if (pm != nullptr && pm[w] <= 0) cap = 0;
          }
          if (j == 0) {
            c0 = cap;
            w0 = w;
          } else {
            s_cap[p] = cap;
          }
          local = sat_add(local, cap);
        }
        unsigned step_total;
        unsigned run = block_exclusive_sat<kThreads>(local, s_ws + parity * 32,
                                                     &step_total);
        parity ^= 1;
        for (int j = 0; j < K; ++j) {
          const int p = p0 + j;
          if (p >= W) break;
          const int w = j == 0 ? w0 : (int)ord[p];
          const unsigned cap = j == 0 ? c0 : s_cap[p];
          int assign = remaining - (int)run;  // both in [0, 2^31)
          assign = assign < 0 ? 0 : (int)min((unsigned)assign, cap);
          run = sat_add(run, cap);
          crow[w] = assign;
          if (assign > 0) {
            // int32 wrap-around arithmetic, as the reference's int32 tensors
            const uint32_t ua = (uint32_t)assign;
            uint32_t* frow = reinterpret_cast<uint32_t*>(fs + (size_t)w * R);
            for (int k = 0; k < nent; ++k) {
              const Entry q = ent[k];
              const int r = q.rk & 0xffff;
              uint32_t f = frow[r] - ua * (uint32_t)q.need;
              f *= 1u - ua * (uint32_t)q.amask;
              frow[r] = f;
            }
            nts[w] = (int)((uint32_t)nts[w] - ua);
            if (s_avail != nullptr) s_avail[w] = 0;
          }
        }
        remaining -= (int)min((unsigned)remaining, step_total);
      }
    }
  }
  if constexpr (kRes) {
    __syncthreads();  // every step's updates are in shared memory
    for (size_t i = t; i < (size_t)W * R; i += kThreads) a.free_[i] = fs[i];
    for (int w = t; w < W; w += kThreads) a.nt_free[w] = nts[w];
  }
}

// One block-wide scan with its barrier, `steps` times: the part of a
// cut-scan step's latency that no data makes shorter (the redesigned scan;
// step_split_kernel's variant (1024, 0, 0) times the int64 one's).
__global__ void __launch_bounds__(kThreads, 1)
    scan_latency_kernel(int steps, long long* out) {
  __shared__ unsigned s_ws[2][32];
  unsigned acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    unsigned total;
    acc = block_exclusive_sat<kThreads>(acc & 7, s_ws[i & 1], &total) + total;
  }
  if (threadIdx.x == 0) out[0] = acc;
}

// The int64 scan and the closing barrier it needed, `steps` times: the
// floor of the int64 step, measured beside the redesigned one.
__global__ void __launch_bounds__(kThreads, 1)
    scan_latency_legacy_kernel(int steps, long long* out) {
  __shared__ long long s_warp[kWarps];
  long long acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    long long total;
    acc = block_exclusive(acc & 7, s_warp, &total) + total;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

template <bool kRes>
int launch_cut_scan(const Args& a, cudaStream_t stream) {
  Layout L;
  const long long bytes = make_layout(&L, a.W, a.R, a.V, a.M, a.G,
                                      a.total != nullptr,
                                      a.gang_nodes != nullptr,
                                      a.policy_mask != nullptr, kRes);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = cut_scan_kernel<kRes>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kThreads, (size_t)bytes, stream>>>(a, L);
  return (int)cudaGetLastError();
}

int cut_scan_entry(void* free_, void* nt_free, const void* lifetime,
                   const void* needs, const void* sizes, const void* min_time,
                   const void* class_m, const void* order_ids,
                   const void* total, const void* all_mask,
                   const void* gang_nodes, const void* gang_ok,
                   const void* group_ids, const void* policy_mask,
                   void* counts, void* order, int W, int R, int B, int V,
                   int M, int G, void* stream, bool resident) {
  const bool gang = gang_nodes != nullptr;
  if (W < 1 || W > kThreads * kMaxPerThread || R < 1 || R > 0xffff || B < 0 ||
      V < 1 || M < 1 || ((total == nullptr) != (all_mask == nullptr)) ||
      (gang != (gang_ok != nullptr)) || (gang != (group_ids != nullptr)) ||
      (gang && (G < 1 || G > kMaxGroups))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {(int*)free_, (int*)nt_free, (const int*)lifetime,
                  (const int*)needs, (const int*)sizes, (const int*)min_time,
                  (const int*)class_m, (const int*)order_ids,
                  (const int*)total, (const int*)all_mask,
                  (const int*)gang_nodes, (const int*)gang_ok,
                  (const int*)group_ids, (const int*)policy_mask,
                  (int*)counts, (int*)order, W, R, B, V, M, gang ? G : 0};
  const cudaStream_t s = (cudaStream_t)stream;
  return resident ? launch_cut_scan<true>(a, s) : launch_cut_scan<false>(a, s);
}

// Measurement only: checks the reciprocal of every divisor in [d0, d1)
// against the hardware's division, at the dividends where a wrong
// multiplier or shift shows first (0, 1, d-1, d, d+1, the multiples of d
// just below 2^31, 2^31 - 1, 2^31 - 2, 2d - 1 and two more), and counts
// the divisors that disagree.
__global__ void recip_check_kernel(long long d0, long long d1,
                                   unsigned long long* out) {
  unsigned long long bad = 0;
  for (long long d = d0 + blockIdx.x * (long long)blockDim.x + threadIdx.x;
       d < d1; d += (long long)gridDim.x * blockDim.x) {
    const Recip q = make_recip((int)d);
    const unsigned top = kSat;
    const unsigned k = top / (unsigned)d;
    const unsigned n[12] = {0u,
                            1u,
                            (unsigned)d - 1u,
                            (unsigned)d,
                            (unsigned)d + 1u < top ? (unsigned)d + 1u : top,
                            k * (unsigned)d,
                            k * (unsigned)d - 1u,
                            top,
                            top - 1u,
                            (unsigned)(d * 2 - 1 < top ? d * 2 - 1 : top),
                            (unsigned)((d * 0x9e3779b9ull) & top),
                            top / 2u};
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      ok &= recip_div(n[i], q.magic, q.shift) == n[i] / (unsigned)d;
    }
    bad += !ok;
  }
  if (bad) atomicAdd(out, bad);
}

// ---- measurement only: where a step's time goes ---------------------------
//
// step_split_kernel runs the solve's (batch, variant) steps with every
// worker's state in registers: thread t holds workers [t*KW, t*KW+KW)
// (KW = 1024 / NT, R = 4), the step inputs are read from shared memory
// filled before the loop, and steps with no tasks left are skipped as in the
// solve.  kArith: 0 none (the scan alone), 1 the int64 capacity (floor
// division over all R), 2 the redesigned one (the reciprocal over the
// requested resources).  kScan: 0 the int64 scan (two barriers) plus
// the closing barrier, 1 the one-barrier saturating scan.  No step reads or
// writes device memory, so (full step - this) is what loads, stores and
// the solve's other barriers cost.  The solve never launches it.
template <int NT, int kArith, int kScan>
__global__ void __launch_bounds__(NT, 1) step_split_kernel(
    const int* __restrict__ free_, const int* __restrict__ nt_free,
    const int* __restrict__ lifetime, const int* __restrict__ needs,
    const int* __restrict__ sizes, const int* __restrict__ min_time, int W,
    int B, int V, long long* out) {
  constexpr int KW = 1024 / NT;
  constexpr int R = 4;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int S = B * V;
  int* s_need = reinterpret_cast<int*>(s_dyn);         // S*R
  int* s_mt = s_need + (size_t)S * R;                    // S
  int* s_size = s_mt + S;                                // B
  unsigned* s_magic = reinterpret_cast<unsigned*>(s_size + B);  // S*R
  int* s_shift = reinterpret_cast<int*>(s_magic + (size_t)S * R);  // S*R
  __shared__ long long s_warp[kWarps];
  __shared__ unsigned s_ws[2][32];
  const int t = threadIdx.x;
  for (int i = t; i < S * R; i += NT) {
    const int d = needs[i];
    s_need[i] = d;
    const Recip q = make_recip(d > 0 ? d : 1);
    s_magic[i] = q.magic;
    s_shift[i] = q.shift;
  }
  for (int i = t; i < S; i += NT) s_mt[i] = min_time[i];
  for (int i = t; i < B; i += NT) s_size[i] = sizes[i];
  int f[KW][R], nt[KW], life[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int w = t * KW + j;
#pragma unroll
    for (int r = 0; r < R; ++r) f[j][r] = w < W ? free_[(size_t)w * R + r] : 0;
    nt[j] = w < W ? nt_free[w] : 0;
    life[j] = w < W ? lifetime[w] : -1;
  }
  __syncthreads();
  int parity = 0;
  for (int b = 0; b < B; ++b) {
    long long remaining = s_size[b];
    for (int v = 0; v < V; ++v) {
      if (remaining <= 0) continue;
      const int s = b * V + v;
      const int* need = s_need + (size_t)s * R;
      const int mt = s_mt[s];
      unsigned cap[KW];
      unsigned long long local = 0;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        long long c;
        if (kArith == 0) {
          c = f[j][0] & 7;
        } else if (kArith == 1) {
          c = capacity(f[j], nullptr, need, nullptr, R, nt[j], life[j], mt);
        } else {
          unsigned cc = (unsigned)kUnneeded;
          bool any = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int d = need[r];
            if (d > 0) {
              any = true;
              const unsigned per =
                  f[j][r] > 0 ? recip_div((unsigned)f[j][r],
                                          s_magic[(size_t)s * R + r],
                                          s_shift[(size_t)s * R + r])
                              : 0u;
              cc = min(cc, per);
            }
          }
          cc = min(cc, nt[j] > 0 ? (unsigned)nt[j] : 0u);
          c = (any && mt <= life[j]) ? cc : 0;
        }
        if (c > remaining) c = remaining;
        cap[j] = (unsigned)c;
        local += (unsigned)c;
      }
      long long run, step_total;
      if (kScan == 0) {
        run = block_exclusive((long long)local, s_warp, &step_total);
      } else {
        unsigned tot;
        run = block_exclusive_sat<NT>((unsigned)min(local, (unsigned long long)kSat),
                                      s_ws[parity], &tot);
        step_total = tot;
        parity ^= 1;
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        long long a = remaining - run;
        a = a < 0 ? 0 : (a > cap[j] ? cap[j] : a);
        run += cap[j];
        if (a > 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) f[j][r] -= (int)a * need[r];
          nt[j] -= (int)a;
        }
      }
      remaining -= remaining < step_total ? remaining : step_total;
      if (kScan == 0) __syncthreads();
    }
  }
  long long acc = 0;
#pragma unroll
  for (int j = 0; j < KW; ++j) acc += f[j][0] + f[j][1] + f[j][2] + f[j][3] + nt[j];
  if (acc == 0x7fffffffffffLL) out[0] = acc;  // keeps the work alive
  if (t == 0) out[1] = parity;
}

template <int NT, int kArith, int kScan>
int launch_split(const void* free_, const void* nt_free, const void* lifetime,
                 const void* needs, const void* sizes, const void* min_time,
                 int W, int B, int V, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)B * V * 4 * 3 * sizeof(int) +
                      (size_t)B * V * sizeof(int) + (size_t)B * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_split_kernel<NT, kArith, kScan>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  step_split_kernel<NT, kArith, kScan><<<1, NT, smem, stream>>>(
      (const int*)free_, (const int*)nt_free, (const int*)lifetime,
      (const int*)needs, (const int*)sizes, (const int*)min_time, W, B, V,
      (long long*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// All pointers are device pointers to C-contiguous int32 arrays: free (W,R)
// and nt_free (W,) are updated in place; total and all_mask are both null
// or both set; gang_nodes (B,), gang_ok (W,) and group_ids (W,) (values in
// [-1, G), -1 = no group) are all null or all set, with 1 <= G <= 16384;
// policy_mask (B,W) may be null; counts (B,V,W) is written in full; order
// is (M,W) scratch.  B = 0 runs the prologue alone.  hq_cut_scan runs the
// instantiation with the worker state in device memory, hq_cut_scan_resident
// the one with the state in shared memory; each refuses a launch whose
// layout (hq_cut_scan_smem_bytes) does not fit (cudaErrorInvalidValue), and
// neither switches to the other.  Returns the cudaError_t of the launch
// (0 = launched).
int hq_cut_scan(void* free_, void* nt_free, const void* lifetime,
                const void* needs, const void* sizes, const void* min_time,
                const void* class_m, const void* order_ids, const void* total,
                const void* all_mask, const void* gang_nodes,
                const void* gang_ok, const void* group_ids,
                const void* policy_mask, void* counts, void* order, int W,
                int R, int B, int V, int M, int G, void* stream) {
  return cut_scan_entry(free_, nt_free, lifetime, needs, sizes, min_time,
                        class_m, order_ids, total, all_mask, gang_nodes,
                        gang_ok, group_ids, policy_mask, counts, order, W, R,
                        B, V, M, G, stream, false);
}

int hq_cut_scan_resident(void* free_, void* nt_free, const void* lifetime,
                         const void* needs, const void* sizes,
                         const void* min_time, const void* class_m,
                         const void* order_ids, const void* total,
                         const void* all_mask, const void* gang_nodes,
                         const void* gang_ok, const void* group_ids,
                         const void* policy_mask, void* counts, void* order,
                         int W, int R, int B, int V, int M, int G,
                         void* stream) {
  return cut_scan_entry(free_, nt_free, lifetime, needs, sizes, min_time,
                        class_m, order_ids, total, all_mask, gang_nodes,
                        gang_ok, group_ids, policy_mask, counts, order, W, R,
                        B, V, M, G, stream, true);
}

// Dynamic shared memory of a launch at these shapes, as the entries above
// compute it; G is ignored without gang rows.
long long hq_cut_scan_smem_bytes(int W, int R, int V, int M, int G, int all,
                                 int gang, int pmask, int resident) {
  Layout L;
  return make_layout(&L, W, R, V, M, gang ? G : 0, all != 0, gang != 0,
                     pmask != 0, resident != 0);
}

// The most dynamic shared memory a launch may take.
long long hq_cut_scan_smem_limit() { return kSmemLimit; }

// Threads of the solve's block.
int hq_cut_scan_block_threads() { return kThreads; }

int hq_scan_latency(int steps, void* out, void* stream) {
  scan_latency_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      steps, (long long*)out);
  return (int)cudaGetLastError();
}

int hq_scan_latency_legacy(int steps, void* out, void* stream) {
  scan_latency_legacy_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      steps, (long long*)out);
  return (int)cudaGetLastError();
}

// Measurement only: counts into out[0] (an unsigned long long) the
// divisors in [d0, d1) whose reciprocal disagrees with the hardware's
// division (see recip_check_kernel).
int hq_recip_check(long long d0, long long d1, void* out, void* stream) {
  if (d0 < 1 || d1 > (long long)kSat + 1 || d0 > d1) {
    return (int)cudaErrorInvalidValue;
  }
  recip_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      d0, d1, (unsigned long long*)out);
  return (int)cudaGetLastError();
}


// Measurement only (see step_split_kernel): variant 0..7 =
// (threads, arithmetic, scan) (1024,0,0) (1024,1,0) (1024,2,0) (1024,1,1)
// (1024,0,1) (1024,2,1) (256,0,1) (256,2,1).  R must be 4 and W <= 1024.
int hq_step_split(int variant, const void* free_, const void* nt_free,
                  const void* lifetime, const void* needs, const void* sizes,
                  const void* min_time, int W, int R, int B, int V, void* out,
                  void* stream) {
  if (R != 4 || W < 1 || W > 1024 || B < 1 || V < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
#define HQ_SPLIT(NT, A, C) \
  launch_split<NT, A, C>(free_, nt_free, lifetime, needs, sizes, min_time, W, B, V, out, s)
  switch (variant) {
    case 0: return HQ_SPLIT(1024, 0, 0);
    case 1: return HQ_SPLIT(1024, 1, 0);
    case 2: return HQ_SPLIT(1024, 2, 0);
    case 3: return HQ_SPLIT(1024, 1, 1);
    case 4: return HQ_SPLIT(1024, 0, 1);
    case 5: return HQ_SPLIT(1024, 2, 1);
    case 6: return HQ_SPLIT(256, 0, 1);
    case 7: return HQ_SPLIT(256, 2, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HQ_SPLIT
}

}  // extern "C"
