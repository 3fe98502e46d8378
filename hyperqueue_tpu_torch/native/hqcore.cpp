// hqcore: native host structures of the scheduling tick, for the PyTorch
// port.
//
// An own copy of the JAX package's native core, behind a C ABI consumed via
// ctypes (hyperqueue_tpu_torch/utils/native.py). Host C++, not a GPU
// kernel:
//
//   * TaskQueue: the per-request-class ready queue, a priority-bucketed
//     FIFO of u64 task ids with tombstone removal (the semantics of
//     scheduler/queues.TaskQueue), and hq_map_take, which pops every
//     solver cell's ids of one tick in one call;
//   * hq_cut_scan: the host-side scan of the tick, which the solve
//     backend's cost model picks over the CUDA kernel when the device
//     round trip would cost the tick more;
//   * hq_nonzero: the mapping phase's nonzero pass.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared, done by utils/native.py at
// first use into hyperqueue_tpu_torch/_build/.

#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

using Priority = std::pair<int64_t, int64_t>;  // compared lexicographically

struct TaskQueue {
    // descending priority: std::map with reverse comparator
    std::map<Priority, std::deque<uint64_t>, std::greater<Priority>> levels;
    std::unordered_set<uint64_t> tombstones;
    int64_t size = 0;

    void compact_level(std::deque<uint64_t>& level) {
        if (tombstones.empty()) return;
        std::deque<uint64_t> kept;
        for (uint64_t id : level) {
            auto it = tombstones.find(id);
            if (it != tombstones.end()) {
                tombstones.erase(it);
            } else {
                kept.push_back(id);
            }
        }
        level.swap(kept);
    }
};

}  // namespace

extern "C" {

void* hq_queue_new() { return new TaskQueue(); }

void hq_queue_free(void* handle) { delete static_cast<TaskQueue*>(handle); }

void hq_queue_add(void* handle, int64_t prio_user, int64_t prio_sched,
                  uint64_t task_id) {
    auto* q = static_cast<TaskQueue*>(handle);
    q->levels[{prio_user, prio_sched}].push_back(task_id);
    q->size += 1;
}

void hq_queue_remove(void* handle, uint64_t task_id) {
    auto* q = static_cast<TaskQueue*>(handle);
    q->tombstones.insert(task_id);
    q->size -= 1;
}

int64_t hq_queue_len(void* handle) {
    return static_cast<TaskQueue*>(handle)->size;
}

// Fill up to max_levels (priority_user, priority_sched, count) triples in
// descending priority order, compacting tombstones on the way. Returns the
// number of levels written.
int64_t hq_queue_priority_sizes(void* handle, int64_t* out_prio_user,
                                int64_t* out_prio_sched, int64_t* out_counts,
                                int64_t max_levels) {
    auto* q = static_cast<TaskQueue*>(handle);
    int64_t n = 0;
    for (auto it = q->levels.begin(); it != q->levels.end();) {
        q->compact_level(it->second);
        if (it->second.empty()) {
            it = q->levels.erase(it);
            continue;
        }
        if (n < max_levels) {
            out_prio_user[n] = it->first.first;
            out_prio_sched[n] = it->first.second;
            out_counts[n] = static_cast<int64_t>(it->second.size());
            ++n;
        }
        ++it;
    }
    return n;
}

// Pop up to `count` ids at the given priority level (FIFO). Returns the
// number written to out_ids.
int64_t hq_queue_take(void* handle, int64_t prio_user, int64_t prio_sched,
                      int64_t count, uint64_t* out_ids) {
    auto* q = static_cast<TaskQueue*>(handle);
    auto it = q->levels.find({prio_user, prio_sched});
    if (it == q->levels.end()) return 0;
    q->compact_level(it->second);
    int64_t n = 0;
    while (!it->second.empty() && n < count) {
        out_ids[n++] = it->second.front();
        it->second.pop_front();
    }
    q->size -= n;
    if (it->second.empty()) q->levels.erase(it);
    return n;
}

// Batched mapping take: for each nonzero solver cell i, pop cell_count[i]
// ids from the queue of batch cell_batch[i] at that batch's priority and
// append them to out_ids; out_cell_n[i] records how many were written for
// the cell. One C call replaces one ctypes round trip per cell in the
// tick's counts -> assignments mapping. Returns total ids written.
int64_t hq_map_take(void** queue_handles, const int64_t* prio_user,
                    const int64_t* prio_sched, const int64_t* cell_batch,
                    const int64_t* cell_count, int64_t n_cells,
                    uint64_t* out_ids, int64_t* out_cell_n) {
    int64_t total = 0;
    for (int64_t i = 0; i < n_cells; ++i) {
        int64_t b = cell_batch[i];
        int64_t got = hq_queue_take(queue_handles[b], prio_user[b],
                                    prio_sched[b], cell_count[i],
                                    out_ids + total);
        out_cell_n[i] = got;
        total += got;
    }
    return total;
}

// Every id (descending priority, FIFO within a level) into out_ids, at
// most `max` (the caller sizes it with hq_queue_len).
int64_t hq_queue_all(void* handle, uint64_t* out_ids, int64_t max) {
    auto* q = static_cast<TaskQueue*>(handle);
    int64_t n = 0;
    for (auto& [prio, level] : q->levels) {
        q->compact_level(level);
        for (uint64_t id : level) {
            if (n >= max) return n;
            out_ids[n++] = id;
        }
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// hq_cut_scan: the host-side dense tick solve (the numpy fallback's exact
// semantics — ops/assign.greedy_cut_scan_numpy — as one native pass).
//
// Priority-ordered batches water-fill over workers in (visit-class asc,
// worker-index asc) order; variants in user preference order share one
// `remaining`; ALL-policy resources require an untouched pool and drain it
// whole. Two early exits numpy cannot express cheaply: the scan stops when
// every task slot is gone, and a per-resource free-maximum upper bound
// skips variants no worker can fit anymore (after the cluster saturates,
// hundreds of tail batches cost O(R) instead of O(W x R) each).
// ---------------------------------------------------------------------------

extern "C" void hq_cut_scan(
    const int64_t* free_in,   // (W,R) row-major
    const int64_t* total,     // (W,R) or nullptr (no ALL requests)
    const int64_t* nt_in,     // (W)
    const int32_t* lifetime,  // (W)
    const int64_t* needs,     // (B,V,R)
    const int32_t* all_mask,  // (B,V,R) or nullptr
    const int64_t* sizes,     // (B)
    const int32_t* min_time,  // (B,V)
    const int32_t* class_m,   // (M,W) visit class per mask row per worker
    const int32_t* order_ids, // (B,V) mask row per batch/variant
    int64_t W, int64_t R, int64_t B, int64_t V, int64_t M,
    int32_t* counts)          // (B,V,W) out, caller-zeroed
{
    std::vector<int64_t> free(free_in, free_in + W * R);
    std::vector<int64_t> nt(nt_in, nt_in + W);
    int64_t nt_total = 0;
    for (int64_t w = 0; w < W; ++w) nt_total += nt[w] > 0 ? nt[w] : 0;

    // per-resource upper bound of the column max (only ever decreases;
    // tightened to the exact max whenever a scan touches the column)
    std::vector<int64_t> ub_max(R, 0);
    for (int64_t w = 0; w < W; ++w)
        for (int64_t r = 0; r < R; ++r)
            if (free[w * R + r] > ub_max[r]) ub_max[r] = free[w * R + r];

    // per mask row: workers in (class asc, index asc) order via counting
    // sort (classes < 16 — ops/assign.N_VISIT_CLASSES)
    std::vector<std::vector<int32_t>> visit(M);
    {
        std::vector<std::vector<int32_t>> buckets(16);
        for (int64_t m = 0; m < M; ++m) {
            for (auto& b : buckets) b.clear();
            for (int64_t w = 0; w < W; ++w) {
                int32_t c = class_m[m * W + w];
                if (c < 0) c = 0;
                if (c > 15) c = 15;
                buckets[c].push_back(static_cast<int32_t>(w));
            }
            auto& ord = visit[m];
            ord.reserve(W);
            for (auto& b : buckets) ord.insert(ord.end(), b.begin(), b.end());
        }
    }

    for (int64_t b = 0; b < B; ++b) {
        int64_t remaining = sizes[b];
        if (remaining <= 0) continue;
        if (nt_total <= 0) break;  // no task slots anywhere: nothing more
        for (int64_t v = 0; v < V && remaining > 0; ++v) {
            const int64_t* need = needs + (b * V + v) * R;
            const int32_t* am =
                all_mask ? all_mask + (b * V + v) * R : nullptr;
            bool any_req = false, feasible = true;
            for (int64_t r = 0; r < R; ++r) {
                bool is_all = am && am[r] > 0;
                if (need[r] > 0 || is_all) {
                    any_req = true;
                    if (!is_all && need[r] > ub_max[r]) {
                        feasible = false;  // no worker can fit this anymore
                        break;
                    }
                }
            }
            if (!any_req || !feasible) continue;
            int32_t mt = min_time[b * V + v];
            const auto& ord = visit[order_ids[b * V + v]];
            for (int32_t w : ord) {
                if (remaining <= 0) break;
                if (nt[w] <= 0 || mt > lifetime[w]) continue;
                int64_t cap = INT64_MAX;
                const int64_t* fw = &free[static_cast<int64_t>(w) * R];
                for (int64_t r = 0; r < R; ++r) {
                    bool is_all = am && am[r] > 0;
                    if (is_all) {
                        const int64_t tw = total[static_cast<int64_t>(w) * R + r];
                        int64_t c = (tw > 0 && fw[r] == tw) ? 1 : 0;
                        if (c < cap) cap = c;
                    } else if (need[r] > 0) {
                        int64_t c = fw[r] / need[r];
                        if (c < cap) cap = c;
                    }
                    if (cap == 0) break;
                }
                if (cap <= 0) continue;
                if (cap > nt[w]) cap = nt[w];
                if (cap > remaining) cap = remaining;
                // assign `cap` tasks of (b, v) to worker w
                counts[(b * V + v) * W + w] = static_cast<int32_t>(cap);
                int64_t* fwm = &free[static_cast<int64_t>(w) * R];
                for (int64_t r = 0; r < R; ++r) {
                    bool is_all = am && am[r] > 0;
                    if (is_all) {
                        fwm[r] = 0;
                    } else if (need[r] > 0) {
                        fwm[r] -= cap * need[r];
                    }
                }
                nt[w] -= cap;
                nt_total -= cap;
                remaining -= cap;
            }
            // tighten the column bounds for the resources this variant
            // consumed (exact recompute, amortized over the skips it buys)
            for (int64_t r = 0; r < R; ++r) {
                if (need[r] > 0 || (am && am[r] > 0)) {
                    int64_t mx = 0;
                    for (int64_t w2 = 0; w2 < W; ++w2) {
                        const int64_t f = free[w2 * R + r];
                        if (f > mx) mx = f;
                    }
                    ub_max[r] = mx;
                }
            }
        }
    }
}

// Nonzero cells of a (B,V,W) int32 counts array in row-major order —
// replaces np.nonzero in the tick's mapping phase (~1.5 ms at 256x2x1024).
// Returns the number of cells written; out arrays must hold at least
// min(n, capacity) entries.
extern "C" int64_t hq_nonzero(
    const int32_t* counts, int64_t n,
    int64_t* bs_vs_ws,   // flattened flat-index per cell
    int64_t* vals,
    int64_t capacity
) {
    int64_t out = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = counts[i];
        if (c != 0) {
            if (out >= capacity) return out;
            bs_vs_ws[out] = i;
            vals[out] = c;
            ++out;
        }
    }
    return out;
}
