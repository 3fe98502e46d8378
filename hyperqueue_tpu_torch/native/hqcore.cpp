// hqcore: the host-side scan of the scheduling tick, for the PyTorch port.
//
// An own copy of the JAX package's native host solve (hq_cut_scan) and the
// mapping phase's nonzero pass (hq_nonzero), behind a C ABI consumed via
// ctypes (hyperqueue_tpu_torch/utils/native.py). Host C++, not a GPU
// kernel: the solve backend's cost model picks it over the CUDA kernel
// when the device round trip would cost the tick more.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared, done by utils/native.py at
// first use into hyperqueue_tpu_torch/_build/.

#include <cstdint>
#include <vector>

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
