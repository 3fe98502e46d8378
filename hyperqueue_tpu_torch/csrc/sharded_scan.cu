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
//   prefix(w) = capacity of the strictly lower visit classes, all shards
//             + capacity of w's class on lower shards
//             + capacity of w's class before w on its own shard,
//
// of which the first two come from the per-class capacity sums (C = 16) of
// every shard, exchanged once per step.  A gang row exchanges the per-group
// eligible counts (G) instead, picks its group from the counts of every
// shard and shifts each shard's take-prefix by the chosen group's eligible
// count on the lower shards.
//
// Design: one block per shard, each running K1's step on its own workers
// (cut_scan_core.cuh: the worker state resident in shared memory or in
// device memory, the step-input ring, the reciprocal, the saturating
// one-barrier scan, the closing barrier only where the visit-class row
// changes); the exchange is a template parameter.
//
// - Cluster (D <= 16 and the card fits the cluster): the D blocks are one
//   thread-block cluster (cudaLaunchKernelEx with a cluster dimension of D).
//   Each block pushes its 16 class sums into every peer's shared memory and
//   passes barrier.cluster.arrive.release right after its scan's barrier;
//   it finishes the scan and only then waits (barrier.cluster.wait.acquire),
//   so the scan hides part of the barrier.  Gang rows read the peers'
//   per-group counts through distributed shared memory.
// - Grid (beyond a cluster, up to the blocks the card holds at once): one
//   cooperative launch; the sums go to a mailbox in device memory and a
//   hand-written grid barrier (an arrival counter, ld.acquire.gpu) takes
//   the cluster barrier's place.  It is also the exchange a mesh of cards
//   will run with the mailbox in peer memory.
//
// What bounds it: as K1, the steps are sequential, so its time is the
// executed steps times the latency of one step, which here adds the
// exchange's barrier to K1's block scan (cluster_step_latency_kernel and
// grid_step_latency_kernel time that floor).  With D shards on one card it
// does not beat K1 at widths K1 takes; it solves up to D x 16,384 workers.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "cut_scan_core.cuh"

namespace {

// Threads of a shard's block: one worker a thread on the multichip path's
// shards of 256 workers, where 1,024 threads took longer a step on the
// H100; a shard of more workers loops over W/D/256 of them a thread.
constexpr int kShardThreads = 256;

template <bool kRes, int kEx>
__global__ void __launch_bounds__(kShardThreads, 1)
    sharded_scan_kernel(const Args a, const Layout L) {
  cut_scan_body<kShardThreads, kRes, kEx>(a, L);
}

inline long long sharded_layout(Layout* L, int Wl, int R, int V, int M,
                                int G, bool all, bool gang, bool pmask,
                                bool resident) {
  return make_layout(L, Wl, R, V, M, G, all, gang, pmask, resident, true);
}

// The cluster launch of `kernel` over D blocks of NT threads with `smem`
// bytes each (its attributes set by cluster_attributes).
template <class Kernel>
void cluster_config(Kernel kernel, int D, int NT, size_t smem,
                    cudaStream_t stream, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(D);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = D;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// What a cluster launch of `kernel` over D blocks with `smem` bytes needs
// set on the function.
template <class Kernel>
cudaError_t cluster_attributes(Kernel kernel, int D, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || D <= 8) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Whether one cluster of D shard blocks with `smem` bytes fits the card at
// once (the kernel's attributes set for it).
template <class Kernel>
cudaError_t cluster_fits(Kernel kernel, int D, size_t smem) {
  cudaError_t err = cluster_attributes(kernel, D, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(kernel, D, kShardThreads, smem, 0, &cfg, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return n >= 1 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// Whether D blocks of NT threads with `smem` bytes are resident at once
// (the grid exchange's cooperative launch; the kernel's shared-memory
// attribute set for it).
cudaError_t grid_fits(const void* kernel, int D, int NT, size_t smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < D) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

// Refuses (never switches) a launch whose D blocks do not fit the card at
// once.  The attribute calls and the occupancy query run once per
// instantiation and (device, shared memory, D): a launch of the shape that
// the instantiation launched last skips them; any other shape checks
// again.
template <bool kRes, int kEx>
int launch_sharded(Args a, const Layout& L, cudaStream_t stream) {
  static std::atomic<long long> fitted{-1};
  auto kernel = sharded_scan_kernel<kRes, kEx>;
  const void* k = reinterpret_cast<const void*>(kernel);
  const size_t smem = (size_t)L.bytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const long long key =
      ((long long)dev << 40) | ((long long)smem << 16) | (long long)a.D;
  if (fitted.load(std::memory_order_relaxed) != key) {
    err = kEx == kExCluster ? cluster_fits(kernel, a.D, smem)
                            : grid_fits(k, a.D, kShardThreads, smem);
    if (err != cudaSuccess) return (int)err;
    fitted.store(key, std::memory_order_relaxed);
  }
  if constexpr (kEx == kExCluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(kernel, a.D, kShardThreads, smem, stream, &cfg, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, a, L);
    if (err != cudaSuccess) return (int)err;
  } else {
    err = cudaMemsetAsync(a.barrier, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    Layout l = L;
    void* args[] = {&a, &l};
    err = cudaLaunchCooperativeKernel(k, dim3(a.D), dim3(kShardThreads),
                                      args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// One block-wide scan of the solve's kind plus one cluster barrier, `steps`
// times, in every block of a cluster: the part of a sharded step's latency
// that no data makes shorter (the cluster exchange's floor).
__global__ void __launch_bounds__(kShardThreads, 1)
    cluster_step_latency_kernel(int steps, long long* out) {
  __shared__ unsigned s_ws[2][32];
  cluster_sync();
  unsigned acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    unsigned total, excl;
    scan_publish(acc & 7, s_ws[i & 1], &excl);
    __syncthreads();
    cluster_arrive();
    acc = scan_finish<kShardThreads>(excl, s_ws[i & 1], &total) + total;
    cluster_wait();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// The same with the grid barrier (the grid exchange's floor): thread 0
// arrives after the scan's barrier, every thread waits.
__global__ void __launch_bounds__(kShardThreads, 1)
    grid_step_latency_kernel(int steps, unsigned* barrier, long long* out) {
  __shared__ unsigned s_ws[2][32];
  unsigned acc = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    unsigned total, excl;
    scan_publish(acc & 7, s_ws[i & 1], &excl);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(barrier, 1u);
    }
    acc = scan_finish<kShardThreads>(excl, s_ws[i & 1], &total) + total;
    grid_wait(barrier, (unsigned)(i + 1) * gridDim.x);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// As hq_cut_scan (cut_scan.cu), over D shards of Wl = W / D workers each
// (W % D == 0, Wl <= 16384), one block of 256 threads each.  exchange 1 =
// cluster (D <= 16), 2 = grid; resident 1 = the shard's worker state in
// shared memory.  Scratch, all device memory the kernel writes: order
// (M, W) int32 (global instantiation), ents_g (D, 2, cs, R) x 16 bytes
// (direct layouts, hq_sharded_ring), and for the grid exchange mail
// (2, D, 16) uint32, mail_g (2, D, G) int32 (gang rows) and barrier (one
// uint32, zeroed here on the stream); what a launch does not use may be
// null.  Refuses (never switches) a launch whose layout does not fit
// 232,448 bytes or whose blocks do not fit the card at once (a cluster:
// cudaOccupancyMaxActiveClusters; a grid: the blocks resident at once).
// Returns the cudaError_t of the launch (0 = launched).
int hq_sharded_scan(void* free_, void* nt_free, const void* lifetime,
                    const void* needs, const void* sizes,
                    const void* min_time, const void* class_m,
                    const void* order_ids, const void* total,
                    const void* all_mask, const void* gang_nodes,
                    const void* gang_ok, const void* group_ids,
                    const void* policy_mask, void* counts, void* order,
                    void* ents_g, void* mail, void* mail_g, void* barrier,
                    int W, int R, int B, int V, int M, int G, int D,
                    int exchange, int resident, void* stream) {
  const bool gang = gang_nodes != nullptr;
  const bool grid = exchange == kExGrid;
  if (D < 1 || W < D || W % D != 0 || W / D > kMaxWorkers || R < 1 ||
      B < 0 || V < 1 || M < 1 || (exchange != kExCluster && !grid) ||
      (exchange == kExCluster && D > kMaxCluster) ||
      ((total == nullptr) != (all_mask == nullptr)) ||
      (gang != (gang_ok != nullptr)) || (gang != (group_ids != nullptr)) ||
      (gang && (G < 1 || G > kMaxGroups)) ||
      (grid && (mail == nullptr || barrier == nullptr ||
                (gang && mail_g == nullptr))) ||
      (!resident && order == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Layout L;
  const long long bytes =
      sharded_layout(&L, W / D, R, V, M, gang ? G : 0, total != nullptr,
                     gang, policy_mask != nullptr, resident != 0);
  if (bytes > kSmemLimit || (L.direct && ents_g == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {(int*)free_, (int*)nt_free, (const int*)lifetime,
                  (const int*)needs, (const int*)sizes, (const int*)min_time,
                  (const int*)class_m, (const int*)order_ids,
                  (const int*)total, (const int*)all_mask,
                  (const int*)gang_nodes, (const int*)gang_ok,
                  (const int*)group_ids, (const int*)policy_mask,
                  (int*)counts, (int*)order, ents_g, (unsigned*)mail,
                  (int*)mail_g, (unsigned*)barrier, W, R, B, V, M,
                  gang ? G : 0, D};
  const cudaStream_t s = (cudaStream_t)stream;
  if (grid) {
    return resident ? launch_sharded<true, kExGrid>(a, L, s)
                    : launch_sharded<false, kExGrid>(a, L, s);
  }
  return resident ? launch_sharded<true, kExCluster>(a, L, s)
                  : launch_sharded<false, kExCluster>(a, L, s);
}

// Dynamic shared memory of one shard's block at these shapes (Wl workers a
// shard; G is ignored without gang rows); the same for every exchange.
long long hq_sharded_smem_bytes(int Wl, int R, int V, int M, int G, int all,
                                int gang, int pmask, int resident) {
  Layout L;
  return sharded_layout(&L, Wl, R, V, M, gang ? G : 0, all != 0, gang != 0,
                        pmask != 0, resident != 0);
}

// Steps per ring chunk of that layout, negated where it is direct.
int hq_sharded_ring(int Wl, int R, int V, int M, int G, int all, int gang,
                    int pmask, int resident) {
  Layout L;
  sharded_layout(&L, Wl, R, V, M, gang ? G : 0, all != 0, gang != 0,
                 pmask != 0, resident != 0);
  return L.direct ? -L.cs : L.cs;
}

// The largest D (at most 16) for which one cluster of D shard blocks of
// this layout and instantiation fits the card; 0 where none does or the
// layout is past the limit.
int hq_sharded_max_cluster(int Wl, int R, int V, int M, int G, int all,
                           int gang, int pmask, int resident) {
  Layout L;
  const long long bytes =
      sharded_layout(&L, Wl, R, V, M, gang ? G : 0, all != 0, gang != 0,
                     pmask != 0, resident != 0);
  if (bytes > kSmemLimit) return 0;
  for (int D = kMaxCluster; D >= 1; --D) {
    const cudaError_t err =
        resident ? cluster_fits(sharded_scan_kernel<true, kExCluster>, D,
                                (size_t)bytes)
                 : cluster_fits(sharded_scan_kernel<false, kExCluster>, D,
                                (size_t)bytes);
    if (err == cudaSuccess) return D;
    cudaGetLastError();  // a refused query leaves no error behind
  }
  return 0;
}

// Threads of a shard's block.
int hq_sharded_block_threads() { return kShardThreads; }

// The largest cluster the kernel takes (the non-portable limit).
int hq_sharded_cluster_limit() { return kMaxCluster; }

// The most dynamic shared memory a shard's block may take.
long long hq_sharded_smem_limit() { return kSmemLimit; }

// `steps` block scans of the solve's kind with a cluster barrier each, in
// every block of a cluster of D; out holds D int64.
int hq_cluster_step_latency(int steps, int D, void* out, void* stream) {
  if (D < 1 || D > kMaxCluster) return (int)cudaErrorInvalidValue;
  auto kernel = cluster_step_latency_kernel;
  cudaError_t err = cluster_attributes(kernel, D, 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(kernel, D, kShardThreads, 0, (cudaStream_t)stream, &cfg,
                 &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, steps, (long long*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The same with a grid barrier over D blocks; barrier is one uint32
// (zeroed here).
int hq_grid_step_latency(int steps, int D, void* barrier, void* out,
                         void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const void* k = reinterpret_cast<const void*>(grid_step_latency_kernel);
  cudaError_t err = grid_fits(k, D, kShardThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  unsigned* bar = (unsigned*)barrier;
  long long* o = (long long*)out;
  void* args[] = {&steps, &bar, &o};
  err = cudaLaunchCooperativeKernel(k, dim3(D), dim3(kShardThreads), args, 0,
                                    s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
