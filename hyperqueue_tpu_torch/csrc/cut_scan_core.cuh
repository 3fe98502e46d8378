// The cut-scan's step, shared by the single-block kernel (cut_scan.cu, K1)
// and the sharded one (sharded_scan.cu, K2): one templated body
// (cut_scan_body) over the threads of a block, where the worker state lives
// (shared or device memory) and how shards exchange their per-step sums
// (none, the blocks of a thread-block cluster, or every block of a grid).
// Include it inside no namespace; it opens its own anonymous one.
//
// What a block does (see cut_scan.cu for the semantics): a prologue
// counting-sorts each visit-class row of its workers into visit order; the
// (batch, variant) steps then run in order, each a capacity per worker, one
// saturating 32-bit block scan of the capacities in visit order (the
// water-fill prefix) and the update of the workers that got tasks.
//
// - Worker state.  Resident: free, nt_free, lifetime, total (ALL-policy) and
//   group ids (gang rows) come into shared memory by one-dimensional TMA bulk
//   copies behind an mbarrier, the visit orders live there too, and free and
//   nt_free go back to device memory once, at the end.  Global: the same
//   state in device memory.  The wrapper picks by the layout's bytes.
// - Step inputs ahead of use.  needs, all_mask, min_time, order_ids, sizes
//   and gang_nodes arrive in chunks of up to kChunkSteps steps in a
//   double-buffered ring, bulk-copied one chunk ahead.  A chunk is a run of
//   steps and may end inside a batch (`remaining` lives in a register across
//   chunks), so the ring shrinks step by step down to one step a chunk;
//   where even one step's R inputs do not fit beside the worker buffers, the
//   layout is "direct": needs and all_mask are read from device memory and
//   the step entries go to a scratch buffer there.  When a chunk lands, one
//   thread per step lists the resources it touches with a reciprocal of
//   each divisor, so a quotient is a multiply and a shift.
// - Exact 32-bit arithmetic.  A negative free or nt_free can only give a
//   capacity of 0, so the division sees dividends in [1, 2^31) only, and
//   every prefix and total saturates at 2^31 - 1 (the argument is at
//   block_exclusive_sat, and for the exchanged sums at exchange_sums).
// - Barriers.  The scan takes one barrier (its warp sums alternate between
//   two buffers by step parity).  While consecutive steps use the same
//   visit-class row, a thread's positions hold the same workers, so no
//   closing barrier is needed; one is taken where the row changes, around a
//   gang step, where the ring turns over and (resident, with a policy mask)
//   at each batch, before the next mask row's copy overwrites a buffer.
//
// Shards (K2).  Shard d is block d and owns workers [d*Wl, (d+1)*Wl).  A
// worker's water-fill prefix is its in-shard prefix plus the capacity of
// the other shards' lower visit classes plus its own class on lower shards;
// each block reduces its per-class capacity sums (C = 16) while it computes
// the capacities, publishes them after the scan's barrier, and reads every
// shard's sums after the exchange's barrier.  Cluster: the sums are pushed
// into every peer's shared memory (mapa + st.shared::cluster), and the
// barrier is barrier.cluster.arrive.release / wait.acquire with the rest of
// the scan between the two, so the scan hides part of the barrier.  Grid:
// the sums go to a mailbox in device memory, and a hand-written grid barrier
// (an arrival counter that only grows, awaited with ld.acquire.gpu) replaces
// the cluster's.  Both double-buffer the sums by step parity, so one
// barrier a step is enough: a block writes a buffer again only after the
// next step's barrier, which no block passes before every block has read it.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;              // K1's block
constexpr int kMaxWorkers = 16384;          // workers of one block (shard)
constexpr int kClasses = 16;                // N_VISIT_CLASSES
constexpr int kMaxGroups = 16384;           // MAX_KERNEL_GROUPS (2^14)
constexpr long long kUnneeded = 1LL << 30;  // cap of an unrequested resource
constexpr unsigned kSat = 0x7fffffffu;      // caps and prefixes top out here
constexpr int kMaxCluster = 16;            // largest cluster (non-portable)
constexpr long long kBarrierTimeoutNs = 10LL * 1000 * 1000 * 1000;

// exchanges between shards
constexpr int kExNone = 0;     // one block (K1)
constexpr int kExCluster = 1;  // the blocks of one thread-block cluster
constexpr int kExGrid = 2;     // every block of a cooperative grid

// ---- arithmetic -------------------------------------------------------------

// min(a + b, 2^31 - 1) for a, b <= 2^31 - 1 (the sum fits in 32 bits).
__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) {
  return min(a + b, kSat);
}

__device__ __forceinline__ unsigned sat64(unsigned long long x) {
  return x < kSat ? (unsigned)x : kSat;
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
// it.  The scan is split in two halves (scan_publish before the barrier,
// scan_finish after it) so that a sharded step can publish its class sums
// and arrive at the exchange's barrier in between.
__device__ __forceinline__ unsigned scan_publish(unsigned v, unsigned* buf,
                                                 unsigned* excl) {
  const int lane = threadIdx.x & 31;
  const unsigned inc = warp_inclusive_sat<32>(v, lane);
  const unsigned e = __shfl_up_sync(0xffffffffu, inc, 1);
  *excl = lane ? e : 0u;
  if (lane == 31) buf[threadIdx.x >> 5] = inc;
  return inc;
}

template <int NT>
__device__ __forceinline__ unsigned scan_finish(unsigned excl,
                                                const unsigned* buf,
                                                unsigned* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ws = lane < NW ? buf[lane] : 0u;
  const unsigned wi = warp_inclusive_sat<NW>(ws, lane);
  const unsigned off = __shfl_sync(0xffffffffu, wi, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, wi, NW - 1);
  return sat_add(warp ? off : 0u, excl);
}

template <int NT>
__device__ __forceinline__ unsigned block_exclusive_sat(unsigned v,
                                                        unsigned* buf,
                                                        unsigned* total) {
  unsigned excl;
  scan_publish(v, buf, &excl);
  __syncthreads();  // every warp's sum is in buf
  return scan_finish<NT>(excl, buf, total);
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

// The block's exclusive prefix over 16 per-class counters packed 16 bits
// each into 4 words (a count never exceeds 16384, so no field carries into
// the next), and the totals.
template <int NT>
__device__ void block_exclusive_packed(const unsigned long long v[4],
                                       unsigned long long excl[4],
                                       unsigned long long total[4],
                                       unsigned long long (*s)[32]) {
  constexpr int NW = NT / 32;
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
      s[k][lane] = warp_inclusive_u(lane < NW ? s[k][lane] : 0ull, lane);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    total[k] = s[k][NW - 1];
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

// ---- shared-memory layout ---------------------------------------------------
//
// Everything lives in dynamic shared memory, so one number, the layout's
// bytes, decides whether a launch fits.  ops/assign.cut_scan_smem_bytes and
// parallel/solve.sharded_smem_bytes repeat this computation as the CPU
// tests' oracle; the wrappers ask the libraries themselves, and card tests
// hold the two equal.

constexpr long long kSmemLimit = 232448;  // what an sm_90 block may opt into
constexpr int kChunkSteps = 64;        // most steps per ring chunk
constexpr int kDirectChunkSteps = 8;   // steps per chunk of a direct layout

// the fixed header: mbarriers, scan buffers, the gang choice (K1), then the
// per-class sums, the cluster mailbox and each warp's class offsets (K2)
constexpr int kWsOff = 64;      // [2][32] u32 warp sums
constexpr int kPackOff = 320;   // [4][32] u64 packed class counts
constexpr int kSelOff = 1344;   // int first group, int/u64 best group
constexpr int kHeaderBytes = 1360;
constexpr int kCsumOff = 1360;  // [2][16] u64 this shard's class sums
constexpr int kMboxOff = 1616;  // [2][kMaxCluster][16] u32 every shard's
constexpr int kOffOff = 3664;   // [32 warps][16] u32 class offsets
constexpr int kShardHeaderBytes = 5712;

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
  int cs, nb;  // steps per ring chunk, most batches one chunk touches
  int direct;  // needs, all_mask and the step entries in device memory
  int slot[2];
  // within a slot; -1 where absent
  int need, amask, mt, oid, size, gang, steps, ents;
  int cap, group, avail;
  // resident only
  int free_, nt, life, total, gid, order, mask[2];
  long long bytes;
};

// The layout with cs steps per ring chunk, for a block of W workers; a
// sharded block keeps 32-bit visit orders (index and class) and the larger
// header.
inline long long layout_with(Layout* L, int cs, bool direct, int W, int R,
                             int V, int M, int G, bool all, bool gang,
                             bool pmask, bool resident, bool sharded) {
  const long long w = W, r = R, c = cs;
  L->cs = cs;
  L->nb = (cs + V - 2) / V + 1;
  L->direct = direct ? 1 : 0;
  const long long nb = L->nb;
  long long o = 0;
  auto take = [&](long long n) {
    const long long at = o;
    o += n;
    return (int)(at < INT_MAX ? at : -1);
  };
  L->need = direct ? -1 : take(tma16(c * r * 4));
  L->amask = all && !direct ? take(tma16(c * r * 4)) : -1;
  L->mt = take(tma16(c * 4));
  L->oid = take(tma16(c * 4));
  L->size = take(tma16(nb * 4));
  L->gang = gang ? take(tma16(nb * 4)) : -1;
  L->steps = take(c * 16);
  L->ents = direct ? -1 : take(c * r * 16);
  const long long slot = o;
  o = sharded ? kShardHeaderBytes : kHeaderBytes;
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
    L->order = take(al16((long long)M * w * (sharded ? 4 : 2)));
    if (pmask) {
      L->mask[0] = take(tma16(w * 4));
      L->mask[1] = take(tma16(w * 4));
    }
  }
  L->bytes = o;
  return o;
}

// The ring's chunk is the most steps, up to kChunkSteps (at least one), with
// which the layout fits kSmemLimit; where not even one step's inputs fit,
// the global layout is direct (kDirectChunkSteps steps a chunk, the inputs
// of width R in device memory) and the resident one does not fit (the
// one-step layout's bytes): a resident block reads its step entries from
// the ring only, with no branch on the layout in its hot loops.  Where the
// direct layout does not fit either, this is its bytes, over the limit.
inline long long make_layout(Layout* L, int W, int R, int V, int M, int G,
                             bool all, bool gang, bool pmask, bool resident,
                             bool sharded) {
  for (int cs = kChunkSteps; cs >= 1; --cs) {
    if (layout_with(L, cs, false, W, R, V, M, G, all, gang, pmask, resident,
                    sharded) <= kSmemLimit) {
      return L->bytes;
    }
  }
  if (resident) return L->bytes;  // the one-step layout's, over the limit
  return layout_with(L, kDirectChunkSteps, true, W, R, V, M, G, all, gang,
                     pmask, resident, sharded);
}

// ---- TMA bulk copies, mbarriers, clusters, the grid barrier -----------------

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

// The shared-memory address of `p` (this block's) in the block of cluster
// rank `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_cluster(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// Every thread of every block of the cluster arrives (releasing its earlier
// writes, shared memory of peers included) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

// ... and waits for all the others (acquiring their writes).
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

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

// The grid barrier's wait: until the arrival counter (which only grows,
// from 0 at the launch) reaches `target` = (barriers passed) x (blocks).  A
// block that waits more than kBarrierTimeoutNs traps: a fault (a block that
// never arrives) ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void grid_wait(const unsigned* counter,
                                          unsigned target) {
  if (ld_acquire(counter) < target) {
    const long long t0 = global_ns();
    while (ld_acquire(counter) < target) {
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
}

// A whole grid barrier: every block's threads have done their writes
// before any thread of any block goes past it.
__device__ __forceinline__ void grid_sync(unsigned* counter,
                                          unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    grid_wait(counter, target);
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

// ---- the solve --------------------------------------------------------------

// Device pointers of one launch (int32, C-contiguous; see hq_cut_scan) and
// its shapes.  W is the whole worker axis; a sharded launch splits it into
// D blocks of W / D.  Scratch: order (M, W) for the global instantiation,
// ents_g (D, 2, cs, R) step entries for a direct layout, and for the grid
// exchange mail (2, D, 16) u32, mail_g (2, D, G) int32 (gang rows) and the
// barrier's arrival counter (zeroed before the launch).
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
  void* ents_g;
  unsigned* mail;
  int* mail_g;
  unsigned* barrier;
  int W, R, B, V, M, G, D;
};

// One step of a ring chunk: its visit-class row, min_time, how many
// resources it touches, and flags: kAny (it requests something), kUnreq
// (some resource is not requested, so capacities cap at 2^30).
struct StepInfo {
  int m, mt, nent, flags;
};
constexpr int kAny = 1;
constexpr int kUnreq = 2;

// A resource a step touches (need != 0 or an ALL mark): its index, the raw
// need for the update, the reciprocal's multiplier, and meta = kind |
// shift << 8 | (1 for an ALL mark) << 16.
struct Entry {
  int r;
  int need;
  unsigned magic;
  int meta;
};
constexpr int kNoCap = 0;   // touched by the update only (a need < 0)
constexpr int kDiv = 1;     // floor(free / need)
constexpr int kAllFit = 2;  // ALL-policy: 1 where free == total > 0; an
                            // assignment empties the pool

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
    if (d == 0 && am <= 0) continue;
    Recip q = {0u, 0};
    if (kind == kDiv) q = make_recip(d);
    ent[n++] = {r, d, q.magic,
                kind | (q.shift << 8) | ((kind == kAllFit) << 16)};
  }
  si->m = oid < 0 ? 0 : (oid >= M ? M - 1 : oid);
  si->mt = mt;
  si->nent = n;
  si->flags = flags;
}

// The k-th entry of a step: from the ring, at the 32-bit shared-memory
// address s (an LDS, whatever the compiler can prove about the pointer), or
// for a direct layout from device memory at d.
__device__ __forceinline__ Entry step_entry(unsigned s, const Entry* d, int k,
                                            bool direct) {
  if (direct) return d[k];
  Entry e;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(e.r), "=r"(e.need), "=r"(e.magic), "=r"(e.meta)
               : "r"(s + 16u * (unsigned)k));
  return e;
}

// One gang row on this block's workers (see cut_scan.cu): picks and holds
// the gang's workers and writes the row's counts, all V variants (rows of
// ldc ints).  Every thread of every block calls it; it starts and ends
// with a barrier (with shards: the exchange's).  Sharded, the per-group
// eligible counts of every shard decide the group (peers' counts read from
// their shared memory, or from the grid's mailbox), and this shard takes
// its members after the chosen group's eligible members on lower shards.
template <int NT, int kEx>
__device__ __noinline__ void gang_step(
    int n, int mt0, int* fs, int* nts, const int* lifes, const int* gids,
    const int* pm, int* crow, int ldc, int W, int R, int V, int G, int K,
    int D, int d, unsigned char* smem, int* s_group, unsigned char* s_avail,
    int* mail_g, unsigned* barrier, unsigned& barriers) {
  constexpr bool kShard = kEx != kExNone;
  unsigned* s_ws = reinterpret_cast<unsigned*>(smem + kWsOff);
  int* s_sel = reinterpret_cast<int*>(smem + kSelOff);
  unsigned long long* s_best =
      reinterpret_cast<unsigned long long*>(smem + kSelOff + 8);
  const int t = threadIdx.x;
  const int lane = t & 31;
  for (int g = t; g < G; g += NT) s_group[g] = 0;
  if (t == 0) {
    s_sel[0] = INT_MAX;  // first group with >= n eligible
    s_sel[1] = -1;       // (count, -group) of the first group with the most
    *s_best = 0ull;
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

  int chosen;
  bool feasible;
  int lower = 0;  // the chosen group's eligible members on lower shards
  if constexpr (!kShard) {
    int first = INT_MAX;
    int best = -1;
    for (int g = t; g < G; g += NT) {
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
    feasible = s_sel[0] != INT_MAX;
    chosen =
        feasible ? s_sel[0] : kMaxGroups - 1 - (s_sel[1] & (kMaxGroups - 1));
  } else {
    unsigned par = 0;
    if constexpr (kEx == kExCluster) {
      cluster_sync();  // every shard's counts are complete
    } else {
      ++barriers;
      par = barriers & 1u;
      int* mine = mail_g + ((size_t)par * D + d) * G;
      for (int g = t; g < G; g += NT) __stcg(mine + g, s_group[g]);
      grid_sync(barrier, barriers * (unsigned)D);
    }
    auto count_of = [&](int e, int g) -> int {
      if constexpr (kEx == kExCluster) {
        return (int)ld_cluster(cluster_addr(s_group + g, e));
      } else {
        return __ldcg(mail_g + ((size_t)par * D + e) * G + g);
      }
    };
    int first = INT_MAX;
    unsigned long long best = 0ull;
    for (int g = t; g < G; g += NT) {
      long long c = 0;
      for (int e = 0; e < D; ++e) c += count_of(e, g);
      if (c >= n && g < first) first = g;
      const unsigned long long key = ((unsigned long long)c << 14) |
                                     (unsigned long long)(kMaxGroups - 1 - g);
      if (key > best) best = key;
    }
    first = __reduce_min_sync(0xffffffffu, first);
    best = warp_max_u(best);
    if (lane == 0) {
      atomicMin(&s_sel[0], first);
      atomicMax(s_best, best);
    }
    __syncthreads();  // the choice is complete
    feasible = s_sel[0] != INT_MAX;
    chosen = feasible ? s_sel[0]
                      : kMaxGroups - 1 - (int)(*s_best & (kMaxGroups - 1));
    for (int e = 0; e < d; ++e) lower += count_of(e, chosen);
  }

  // the n lowest-index eligible members of the chosen group, cluster-wide
  unsigned sel = 0;
  for (int j = 0; j < K; ++j) {
    const int w = t * K + j;
    if (w < W && eligible(w) && gids[w] == chosen) ++sel;
  }
  unsigned total;
  unsigned before = block_exclusive_sat<NT>(sel, s_ws, &total) + lower;
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
    for (int w = t; w < W; w += NT) crow[(size_t)v * ldc + w] = 0;
  }
  // the held rows are visible before any thread reads them, and s_ws and
  // s_sel are free
  __syncthreads();
  if constexpr (kEx == kExCluster) {
    cluster_sync();  // no peer still reads s_group when it is cleared again
  }
}

// A sharded step's exchange, after the block's scan barrier: warp 0 takes
// this shard's per-class capacity sums (and clears them for the step after
// next), publishes them, and every thread arrives; after the rest of the
// scan, every thread waits, and each warp computes its own copy of the
// class offsets.  Why saturated sums are exact here: a worker of class c
// on shard d has the prefix
//   G = run_d + sum over c' < c of (the other shards' class c' sums)
//             + sum over lower shards of their class c sum,
// run_d being its in-shard prefix.  Every term is a sum of capacities >= 0,
// and min(sum of min(x_i, S), S) == min(sum of x_i, S) for x_i >= 0, so
// saturating each published sum, each sum over shards and each addition
// gives min(G, S) (and min(total, S) for the step's total), which is all a
// step uses (see block_exclusive_sat).
template <int kEx>
__device__ __forceinline__ void exchange_publish(
    unsigned char* smem, const Args& a, int D, int d, int parity,
    unsigned& barriers) {
  unsigned long long* s_csum =
      reinterpret_cast<unsigned long long*>(smem + kCsumOff);
  unsigned* s_mbox = reinterpret_cast<unsigned*>(smem + kMboxOff);
  const int t = threadIdx.x;
  if (t < kClasses) {
    const unsigned u = sat64(atomicExch(&s_csum[parity * kClasses + t], 0ull));
    if constexpr (kEx == kExCluster) {
      const unsigned* slot = s_mbox + (parity * kMaxCluster + d) * kClasses + t;
      for (int e = 0; e < D; ++e) st_cluster(cluster_addr(slot, e), u);
    } else {
      __stcg(a.mail + ((size_t)parity * D + d) * kClasses + t, u);
      __threadfence();
    }
  }
  if constexpr (kEx == kExCluster) {
    cluster_arrive();
  } else {
    ++barriers;
    if (t < 32) {
      __syncwarp();
      if (t == 0) atomicAdd(a.barrier, 1u);
    }
  }
}

// Returns the step's total over every shard; the warp's class offsets land
// in s_off (16 u32 of this warp).
template <int kEx>
__device__ __forceinline__ unsigned exchange_sums(unsigned char* smem,
                                                  const Args& a, int D, int d,
                                                  int parity,
                                                  unsigned barriers,
                                                  unsigned* s_off) {
  const unsigned* s_mbox = reinterpret_cast<const unsigned*>(smem + kMboxOff);
  const int lane = threadIdx.x & 31;
  if constexpr (kEx == kExCluster) {
    cluster_wait();
  } else {
    grid_wait(a.barrier, barriers * (unsigned)D);
  }
  unsigned long long others = 0, lower = 0, all = 0;
  if (lane < kClasses) {
    for (int e = 0; e < D; ++e) {
      unsigned x;
      if constexpr (kEx == kExCluster) {
        x = s_mbox[(parity * kMaxCluster + e) * kClasses + lane];
      } else {
        x = __ldcg(a.mail + ((size_t)parity * D + e) * kClasses + lane);
      }
      all += x;
      if (e != d) others += x;
      if (e < d) lower += x;
    }
  }
  const unsigned inc = warp_inclusive_sat<kClasses>(sat64(others), lane);
  unsigned excl = __shfl_up_sync(0xffffffffu, inc, 1);
  excl = lane ? excl : 0u;
  if (lane < kClasses) s_off[lane] = sat_add(excl, sat64(lower));
  const unsigned tot = warp_inclusive_sat<kClasses>(sat64(all), lane);
  __syncwarp();  // the warp's offsets are in s_off
  return __shfl_sync(0xffffffffu, tot, kClasses - 1);
}

// The solve of one block (K1: the whole cut-scan; K2: shard blockIdx.x).
// NT threads; kRes: the worker state in shared memory; kEx: the exchange.
template <int NT, bool kRes, int kEx>
__device__ __forceinline__ void cut_scan_body(const Args& a, const Layout& L) {
  constexpr bool kShard = kEx != kExNone;
  // a visit-order entry: the worker's index in the block, and (sharded)
  // its visit class << 16
  using OrdT = typename std::conditional<
      kShard, unsigned,
      typename std::conditional<kRes, unsigned short, int>::type>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  unsigned* s_ws = reinterpret_cast<unsigned*>(smem + kWsOff);  // [2][32]
  auto s_pack = reinterpret_cast<unsigned long long(*)[32]>(smem + kPackOff);
  unsigned long long* s_csum =
      reinterpret_cast<unsigned long long*>(smem + kCsumOff);
  unsigned* s_off = reinterpret_cast<unsigned*>(smem + kOffOff) +
                    (threadIdx.x >> 5) * kClasses;
  unsigned* s_cap = reinterpret_cast<unsigned*>(smem + L.cap);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int D = kShard ? a.D : 1;
  const int d = kShard ? (int)blockIdx.x : 0;
  const int ldw = a.W;       // the worker axis in device memory
  const int W = ldw / D;     // this block's workers
  const size_t base = (size_t)d * W;
  const int R = a.R, B = a.B, V = a.V, M = a.M, G = a.G;
  const int K = (W + NT - 1) / NT;
  const bool all = a.total != nullptr;
  const bool gang = a.gang_nodes != nullptr;
  const bool masked = a.policy_mask != nullptr;
  int* s_group = gang ? reinterpret_cast<int*>(smem + L.group) : nullptr;
  unsigned char* s_avail = gang ? smem + L.avail : nullptr;
  unsigned barriers = 0;  // grid barriers passed (kExGrid)

  // where this block's worker state lives
  int* fs;
  int* nts;
  const int* lifes;
  const int* tots;
  const int* gids;
  OrdT* ords;
  if constexpr (kRes) {
    fs = landed<int>(smem + L.free_, a.free_ + base * R);
    nts = landed<int>(smem + L.nt, a.nt_free + base);
    lifes = landed<const int>(smem + L.life, a.lifetime + base);
    tots = all ? landed<const int>(smem + L.total, a.total + base * R)
               : nullptr;
    gids = gang ? landed<const int>(smem + L.gid, a.group_ids + base)
                : nullptr;
    ords = reinterpret_cast<OrdT*>(smem + L.order);
  } else {
    fs = a.free_ + base * R;
    nts = a.nt_free + base;
    lifes = a.lifetime + base;
    tots = all ? a.total + base * R : nullptr;
    gids = gang ? a.group_ids + base : nullptr;
    ords = reinterpret_cast<OrdT*>(a.order) + (size_t)d * M * W;
  }

  const int S = B * V;
  const int cs = L.cs;
  const bool direct = !kRes && L.direct != 0;  // never resident (make_layout)
  const int nchunks = (S + cs - 1) / cs;
  Entry* g_ents = direct ? reinterpret_cast<Entry*>(a.ents_g) +
                                 (size_t)d * 2 * cs * R
                           : nullptr;
  // thread 0 copies chunk c of the step inputs into ring slot c & 1
  auto issue_chunk = [&](int c) {
    unsigned char* sb = smem + L.slot[c & 1];
    unsigned long long* bar = bars + kBarRing + (c & 1);
    const int s0 = c * cs;
    const int ns = min(cs, S - s0);
    const int b0 = s0 / V;
    const int nb = (s0 + ns - 1) / V - b0 + 1;
    unsigned tx = span16(a.min_time + s0, ns * 4) +
                  span16(a.order_ids + s0, ns * 4) +
                  span16(a.sizes + b0, nb * 4);
    if (!direct) {
      tx += span16(a.needs + (size_t)s0 * R, (size_t)ns * R * 4);
      if (all) tx += span16(a.all_mask + (size_t)s0 * R, (size_t)ns * R * 4);
    }
    if (gang) tx += span16(a.gang_nodes + b0, nb * 4);
    mbar_expect_tx(bar, tx);
    if (!direct) {
      bulk_load(sb + L.need, a.needs + (size_t)s0 * R, (size_t)ns * R * 4,
                bar);
      if (all) {
        bulk_load(sb + L.amask, a.all_mask + (size_t)s0 * R,
                  (size_t)ns * R * 4, bar);
      }
    }
    bulk_load(sb + L.mt, a.min_time + s0, ns * 4, bar);
    bulk_load(sb + L.oid, a.order_ids + s0, ns * 4, bar);
    bulk_load(sb + L.size, a.sizes + b0, nb * 4, bar);
    if (gang) bulk_load(sb + L.gang, a.gang_nodes + b0, nb * 4, bar);
  };
  // thread 0 copies this block's part of policy-mask row b into buffer
  // b & 1 (resident only)
  auto issue_mask = [&](int b) {
    unsigned long long* bar = bars + kBarMask + (b & 1);
    const int* src = a.policy_mask + (size_t)b * ldw + base;
    mbar_expect_tx(bar, span16(src, (size_t)W * 4));
    bulk_load(smem + L.mask[b & 1], src, (size_t)W * 4, bar);
  };

  if (t == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kShard) {
    if (t < 2 * kClasses) s_csum[t] = 0ull;
  }
  __syncthreads();  // the mbarriers are initialised
  if constexpr (kEx == kExCluster) {
    cluster_sync();  // every block of the cluster runs: peers may write here
  }
  if (t == 0) {
    if constexpr (kRes) {
      unsigned long long* bar = bars + kBarState;
      const size_t wr = (size_t)W * R * 4, w4 = (size_t)W * 4;
      unsigned tx = span16(a.free_ + base * R, wr) +
                    span16(a.nt_free + base, w4) +
                    span16(a.lifetime + base, w4);
      if (all) tx += span16(a.total + base * R, wr);
      if (gang) {
        tx += span16(a.group_ids + base, w4) + span16(a.gang_ok + base, w4);
      }
      mbar_expect_tx(bar, tx);
      bulk_load(smem + L.free_, a.free_ + base * R, wr, bar);
      bulk_load(smem + L.nt, a.nt_free + base, w4, bar);
      bulk_load(smem + L.life, a.lifetime + base, w4, bar);
      if (all) bulk_load(smem + L.total, a.total + base * R, wr, bar);
      if (gang) {
        bulk_load(smem + L.gid, a.group_ids + base, w4, bar);
        // gang_ok lands in the capacity buffer until the prologue's end
        bulk_load(smem + L.cap, a.gang_ok + base, w4, bar);
      }
      if (masked && B > 0) issue_mask(0);
    }
    if (S > 0) issue_chunk(0);
  }

  // Prologue: ords[m] lists the block's workers by (class_m[m, w], w).
  // Thread t counts the classes of workers [t*K, t*K+K) (index order), and
  // a packed block scan turns the counts into each worker's sorted position.
  for (int m = 0; m < M; ++m) {
    const int* cm = a.class_m + (size_t)m * ldw + base;
    unsigned long long loc[4] = {0ull, 0ull, 0ull, 0ull};
    for (int j = 0; j < K; ++j) {
      const int w = t * K + j;
      if (w < W) {
        const int c = clamp_class(cm[w]);
        loc[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    unsigned long long excl[4], tot[4];
    block_exclusive_packed<NT>(loc, excl, tot, s_pack);
    OrdT* ord = ords + (size_t)m * W;
    for (int j = 0; j < K; ++j) {
      const int w = t * K + j;
      if (w < W) {
        const int c = clamp_class(cm[w]);
        unsigned before = 0;
        for (int k = 0; k < c; ++k) before += field(tot, k);
        ord[before + field(excl, c)] =
            kShard ? (OrdT)(w | (c << 16)) : (OrdT)w;
        excl[c >> 2] += 1ull << ((c & 3) * 16);
      }
    }
    __syncthreads();  // s_pack is rewritten by the next row
  }
  if constexpr (kRes) mbar_wait(bars + kBarState, 0);
  if (gang) {
    const int* ok = kRes ? landed<const int>(smem + L.cap, a.gang_ok + base)
                         : a.gang_ok + base;
    for (int w = t; w < W; w += NT) s_avail[w] = ok[w] != 0;
  }
  // the orders and s_avail are complete, and the capacity buffer is free
  __syncthreads();

  int owner_m = -1;  // the visit-class row the thread's positions follow
                     // since the last barrier (-1: none since one)
  int parity = 0;    // which scan buffer the next step's warp sums go to
  int remaining = 0;     // tasks of the current batch left to place
  bool gang_row = false;  // the current batch is a gang row
  const int* pm = nullptr;  // the current batch's policy-mask row
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c & 1;
    unsigned char* sb = smem + L.slot[slot];
    const int s0 = c * cs;
    const int ns = min(cs, S - s0);
    const int b0 = s0 / V;
    mbar_wait(bars + kBarRing + slot, (c >> 1) & 1);
    StepInfo* steps = reinterpret_cast<StepInfo*>(sb + L.steps);
    // the step entries: in the ring slot (shared memory) or, for a direct
    // layout, in device memory; each path keeps its pointers in one memory
    // space, so the hot loops below read the ring with shared loads
    Entry* s_ents = reinterpret_cast<Entry*>(sb + L.ents);
    Entry* d_ents = direct ? g_ents + (size_t)slot * cs * R : nullptr;
    {
      const int* r_mt = landed<const int>(sb + L.mt, a.min_time + s0);
      const int* r_oid = landed<const int>(sb + L.oid, a.order_ids + s0);
      const int* g_need = a.needs + (size_t)s0 * R;
      const int* g_amask = all ? a.all_mask + (size_t)s0 * R : nullptr;
      if (direct) {
        for (int i = t; i < ns; i += NT) {
          const size_t o = (size_t)i * R;
          derive_step(steps + i, d_ents + o, g_need + o,
                      all ? g_amask + o : nullptr, r_mt[i], r_oid[i], R, M);
        }
      } else {
        const int* r_need = landed<const int>(sb + L.need, g_need);
        const int* r_amask =
            all ? landed<const int>(sb + L.amask, g_amask) : nullptr;
        for (int i = t; i < ns; i += NT) {
          const size_t o = (size_t)i * R;
          derive_step(steps + i, s_ents + o, r_need + o,
                      all ? r_amask + o : nullptr, r_mt[i], r_oid[i], R, M);
        }
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
    const int* r_size = landed<const int>(sb + L.size, a.sizes + b0);
    const int* r_gang =
        gang ? landed<const int>(sb + L.gang, a.gang_nodes + b0) : nullptr;

    // the chunk's steps [s0, s1), batch by batch: variants [v0, v1) of b
    const int s1 = s0 + ns;
    for (int b = b0; b * V < s1; ++b) {
      const int bs = b * V;
      const int v0 = max(s0 - bs, 0);
      const int v1 = min(s1 - bs, V);
      int* brow = a.counts + (size_t)bs * ldw + base;
      if (v0 == 0) {  // a batch starts
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
                                   a.policy_mask + (size_t)b * ldw + base);
          } else {
            pm = a.policy_mask + (size_t)b * ldw + base;
          }
        }
        remaining = r_size[b - b0];
        gang_row = gang && r_gang[b - b0] > 0;
        if (gang_row) {
          gang_step<NT, kEx>(r_gang[b - b0], steps[bs - s0].mt, fs, nts,
                             lifes, gids, pm, brow, ldw, W, R, V, G, K, D, d,
                             smem, s_group, s_avail, a.mail_g, a.barrier,
                             barriers);
          owner_m = -1;
        }
      }
      if (gang_row) continue;  // the gang step wrote every variant's row
      for (int v = v0; v < v1; ++v) {
        const int i = bs + v - s0;
        int* crow = brow + (size_t)v * ldw;
        if (remaining <= 0) {
          // nothing left to place, in every block alike: the step assigns
          // nothing and exchanges nothing (uniform branch)
          for (int w = t; w < W; w += NT) crow[w] = 0;
          continue;
        }
        const StepInfo si = steps[i];
        if (owner_m >= 0 && owner_m != si.m) {
          // the thread's positions now hold other workers, whose state
          // other threads updated in the previous step
          __syncthreads();
        }
        owner_m = si.m;
        const OrdT* ord = ords + (size_t)si.m * W;
        const unsigned ent_s = smem_u32(s_ents) + (unsigned)i * R * 16u;
        const Entry* ent_d = direct ? d_ents + (size_t)i * R : nullptr;
        const int nent = si.nent;
        const bool live = (si.flags & kAny) != 0;
        const unsigned cap0 = (si.flags & kUnreq) ? (unsigned)kUnneeded
                                                  : 0xffffffffu;
        const int p0 = t * K;
        unsigned local = 0, c0 = 0, e0 = 0;
        int cur_c = kClasses;  // sharded: the class of the thread's last
        unsigned cur = 0;      // position so far, and its capacity
        for (int j = 0; j < K; ++j) {
          const int p = p0 + j;
          if (p >= W) break;
          const unsigned e = ord[p];
          const int w = kShard ? (int)(e & 0xffffu) : (int)e;
          unsigned cap = 0;
          if (live && si.mt <= lifes[w]) {
            const int nt = nts[w];
            cap = nt > 0 ? min(cap0, (unsigned)nt) : 0u;
            const int* frow = fs + (size_t)w * R;
            for (int k = 0; k < nent && cap > 0; ++k) {
              const Entry q = step_entry(ent_s, ent_d, k, direct);
              const int kind = q.meta & 0xff;
              if (kind == kNoCap) continue;
              const int f = frow[q.r];
              unsigned per;
              if (kind == kAllFit) {
                per = (f > 0 && f == tots[(size_t)w * R + q.r]) ? 1u : 0u;
              } else {
                per = f > 0 ? recip_div((unsigned)f, q.magic,
                                        (q.meta >> 8) & 0xff)
                            : 0u;
              }
              cap = min(cap, per);
            }
            cap = min(cap, (unsigned)remaining);
            if (pm != nullptr && pm[w] <= 0) cap = 0;
          }
          if (j == 0) {
            c0 = cap;
            e0 = e;
          } else {
            s_cap[p] = cap;
          }
          local = sat_add(local, cap);
          if constexpr (kShard) {
            const int cc = (int)(e >> 16);
            if (cc != cur_c) {
              // a class ends inside the thread's positions: its part here
              if (cur_c < kClasses && cur) {
                atomicAdd(&s_csum[parity * kClasses + cur_c],
                          (unsigned long long)cur);
              }
              cur_c = cc;
              cur = 0;
            }
            cur = sat_add(cur, cap);
          }
        }
        unsigned step_total;
        unsigned run;
        if constexpr (kShard) {
          // the lanes of a warp hold consecutive positions, so the lanes whose
          // last class is the same are contiguous: one segmented sum each,
          // added once per class and warp
          const unsigned peers = __match_any_sync(0xffffffffu, cur_c);
          const int first = __ffs(peers) - 1;
          const int last = 31 - __clz(peers);
  #pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned n = __shfl_up_sync(0xffffffffu, cur, o);
            if (lane - o >= first) cur = sat_add(cur, n);
          }
          if (lane == last && cur_c < kClasses && cur) {
            atomicAdd(&s_csum[parity * kClasses + cur_c],
                      (unsigned long long)cur);
          }
          unsigned* buf = s_ws + parity * 32;
          unsigned excl;
          scan_publish(local, buf, &excl);
          __syncthreads();  // the warp sums and the class sums are complete
          exchange_publish<kEx>(smem, a, D, d, parity, barriers);
          unsigned shard_total;
          run = scan_finish<NT>(excl, buf, &shard_total);
          step_total =
              exchange_sums<kEx>(smem, a, D, d, parity, barriers, s_off);
        } else {
          run = block_exclusive_sat<NT>(local, s_ws + parity * 32, &step_total);
        }
        parity ^= 1;
        for (int j = 0; j < K; ++j) {
          const int p = p0 + j;
          if (p >= W) break;
          const unsigned e = j == 0 ? e0 : (unsigned)ord[p];
          const int w = kShard ? (int)(e & 0xffffu) : (int)e;
          const unsigned cap = j == 0 ? c0 : s_cap[p];
          unsigned pre = run;
          if constexpr (kShard) pre = sat_add(run, s_off[e >> 16]);
          int assign = remaining - (int)pre;  // both in [0, 2^31)
          assign = assign < 0 ? 0 : (int)min((unsigned)assign, cap);
          run = sat_add(run, cap);
          crow[w] = assign;
          if (assign > 0) {
            // int32 wrap-around arithmetic, as the reference's int32 tensors
            const uint32_t ua = (uint32_t)assign;
            uint32_t* frow = reinterpret_cast<uint32_t*>(fs + (size_t)w * R);
            for (int k = 0; k < nent; ++k) {
              const Entry q = step_entry(ent_s, ent_d, k, direct);
              uint32_t f = frow[q.r] - ua * (uint32_t)q.need;
              f *= 1u - ua * (uint32_t)(q.meta >> 16);  // an ALL mark empties
              frow[q.r] = f;
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
    int* gf = a.free_ + base * R;
    for (size_t i = t; i < (size_t)W * R; i += NT) gf[i] = fs[i];
    for (int w = t; w < W; w += NT) a.nt_free[base + w] = nts[w];
  }
  if constexpr (kEx == kExCluster) {
    cluster_sync();  // no block exits while a peer may touch its memory
  }
}

}  // namespace
