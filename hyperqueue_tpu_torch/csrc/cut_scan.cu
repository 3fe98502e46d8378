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
// design shortens the step's dependent chain (csrc/cut_scan_core.cuh holds
// the body, which the sharded kernel shares):
//
// - One block runs the whole solve; thread t owns the sorted positions
//   [t*K, t*K+K) of every visit order (K = ceil(W / threads)).  A prologue
//   counting-sorts each visit-class row once into its visit order, so one
//   block scan of the capacities in position order IS the water-fill prefix.
// - Worker state: resident in shared memory (TMA bulk copies in, one
//   write-back) or in device memory, two instantiations of one body; the
//   wrapper chooses by shape before the launch (see cut_scan_layout).
// - Step inputs in a double-buffered ring of step chunks one chunk ahead,
//   a reciprocal per divisor, the saturating one-barrier 32-bit scan, and
//   the closing barrier only where the visit-class row changes.
//
// Gang steps visit workers in index order (thread t owns workers
// [t*K, t*K+K)), not in visit order, so they have a block scan of their own
// over the selected members; the gang-availability carry (W bytes) and the
// per-group eligible counts (G ints, warp-aggregated shared atomics) live in
// shared memory on both instantiations.  The gang step is a separate,
// non-inlined function, so its state stays out of the ordinary step's
// registers.
//
// The int64 step arithmetic of the first port (floor division, a
// two-barrier int64 scan) stays in cut_scan_step.cuh for the measurements
// below that compare the two (step_split_kernel, scan_latency_legacy).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cut_scan_core.cuh"
#include "cut_scan_step.cuh"

namespace {

// kThreads = 1,024 threads a block: on the H100 they beat 256 and 512 at
// the north star's fused inputs and tied 512 at the default ones (PERF.md)
template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1) cut_scan_kernel(const Args a,
                                                               const Layout L) {
  cut_scan_body<kThreads, kRes, kExNone>(a, L);
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
                                      a.policy_mask != nullptr, kRes, false);
  if (bytes > kSmemLimit || (L.direct && a.ents_g == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
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
                   void* counts, void* order, void* ents_g, int W, int R,
                   int B, int V, int M, int G, void* stream, bool resident) {
  const bool gang = gang_nodes != nullptr;
  if (W < 1 || W > kMaxWorkers || R < 1 || B < 0 ||
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
                  (int*)counts, (int*)order, ents_g, nullptr, nullptr,
                  nullptr, W, R, B, V, M, gang ? G : 0, 1};
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
// is (M,W) scratch (global instantiation), ents_g (2, cs, R) x 16 bytes of
// scratch where the layout is direct (hq_cut_scan_ring), else either may be
// null.  B = 0 runs the prologue alone.  hq_cut_scan runs the
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
                const void* policy_mask, void* counts, void* order,
                void* ents_g, int W, int R, int B, int V, int M, int G,
                void* stream) {
  return cut_scan_entry(free_, nt_free, lifetime, needs, sizes, min_time,
                        class_m, order_ids, total, all_mask, gang_nodes,
                        gang_ok, group_ids, policy_mask, counts, order,
                        ents_g, W, R, B, V, M, G, stream, false);
}

int hq_cut_scan_resident(void* free_, void* nt_free, const void* lifetime,
                         const void* needs, const void* sizes,
                         const void* min_time, const void* class_m,
                         const void* order_ids, const void* total,
                         const void* all_mask, const void* gang_nodes,
                         const void* gang_ok, const void* group_ids,
                         const void* policy_mask, void* counts, void* order,
                         void* ents_g, int W, int R, int B, int V, int M,
                         int G, void* stream) {
  return cut_scan_entry(free_, nt_free, lifetime, needs, sizes, min_time,
                        class_m, order_ids, total, all_mask, gang_nodes,
                        gang_ok, group_ids, policy_mask, counts, order,
                        ents_g, W, R, B, V, M, G, stream, true);
}

// Dynamic shared memory of a launch at these shapes, as the entries above
// compute it; G is ignored without gang rows.
long long hq_cut_scan_smem_bytes(int W, int R, int V, int M, int G, int all,
                                 int gang, int pmask, int resident) {
  Layout L;
  return make_layout(&L, W, R, V, M, gang ? G : 0, all != 0, gang != 0,
                     pmask != 0, resident != 0, false);
}

// Steps per ring chunk of that layout, negated where it is direct (the
// step inputs of width R in device memory, the entries in ents_g).
int hq_cut_scan_ring(int W, int R, int V, int M, int G, int all, int gang,
                     int pmask, int resident) {
  Layout L;
  make_layout(&L, W, R, V, M, gang ? G : 0, all != 0, gang != 0, pmask != 0,
              resident != 0, false);
  return L.direct ? -L.cs : L.cs;
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
