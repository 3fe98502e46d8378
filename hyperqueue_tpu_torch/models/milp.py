"""MILP scheduling model: the host-solver accuracy oracle.

Reference: crates/tako/src/internal/scheduler/solver.rs builds ONE integer
program per tick — variables per (worker, batch, variant) with a
share-density x request-weight objective (solver.rs:520-549), priority
blocking variables with gap relaxation (solver.rs:211-330), min-utilization
all-or-nothing worker constraints (solver.rs:479-518) and multi-node gang
count variables per worker group (solver.rs:177-209) — and solves it with an
LP backend. This model re-creates that decision quality on the host via
scipy's HiGHS MILP, for use as a second `--scheduler` backend and as the
makespan/accuracy oracle the greedy kernel is tested against.

Priority dominance is enforced by LEXICOGRAPHIC solves over one joint
variable set instead of the reference's blocking variables: levels are
maximized highest-first, each next solve pinning the previous levels'
achieved scores as lower-bound constraints while every variable stays free.
This yields the same cut-with-gap-relaxation outcome (lower levels only fill
capacity higher levels cannot use) and — unlike solving each level on the
residual capacity — lets a lower-priority task help satisfy a shared
constraint such as a min-utilization floor, exactly like the reference's one
joint program.

Per-level score: task count when every request weight in the level is 1.0
(the packing objective the golden tests pin), else the reference's
share-density x weight value (solver.rs:528-546), so `--weight` biases which
same-priority class wins under this backend too.

This is a HOST model (numpy + scipy, imported at the first solve): its
solve takes numpy and never touches the card. Tens of workers x dozens of
batches solve in well under a second, which is plenty for the oracle role
and for small clusters; the greedy kernel remains the scale path.
"""

from __future__ import annotations

import logging

import numpy as np

from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger(__name__)


class MilpModel:
    """Same interface as GreedyCutScanModel.solve; joint lexicographic MILP."""

    # run_tick routes min-utilization workers through the joint program
    # instead of the greedy carve-out (reference solver.rs:479-518)
    supports_cpu_floor = True

    def __init__(self, time_limit_secs: float = 10.0):
        # budget for the WHOLE tick (split across priority levels): the
        # solve runs synchronously inside the server's scheduler loop, so it
        # must finish well under the worker-heartbeat reaper limit (~32 s)
        self.time_limit_secs = time_limit_secs

    def solve(
        self,
        free: np.ndarray,       # (W, R) int32
        nt_free: np.ndarray,    # (W,) int32
        lifetime: np.ndarray,   # (W,) int32 seconds
        needs: np.ndarray,      # (B, V, R) int32
        sizes: np.ndarray,      # (B,) int32
        min_time: np.ndarray,   # (B, V) int32 seconds
        priorities: list | None = None,  # per-batch priority (row order =
                                         # descending priority when absent)
        total: np.ndarray | None = None,     # (W, R) pool totals
        all_mask: np.ndarray | None = None,  # (B, V, R) 0/1 ALL-policy
        weights: np.ndarray | None = None,   # (B, V) request weights
        cpu_floor: np.ndarray | None = None,  # (W,) min-utilization floors
    ) -> np.ndarray:
        from scipy.optimize import Bounds, LinearConstraint, milp
        from scipy.sparse import lil_matrix

        free = np.asarray(free, dtype=np.int64)
        nt_free = np.asarray(nt_free, dtype=np.int64)
        lifetime = np.asarray(lifetime)
        needs = np.asarray(needs, dtype=np.int64)
        sizes = np.asarray(sizes, dtype=np.int64)
        min_time = np.asarray(min_time)
        if total is not None:
            total = np.asarray(total, dtype=np.int64)
        n_b, n_v, n_r = needs.shape
        n_w = free.shape[0]
        counts = np.zeros((n_b, n_v, n_w), dtype=np.int32)

        if priorities is None:
            # every batch row its own dominance level is wrong for rows that
            # SHARE a priority (they must pack jointly); with no information
            # the safe default is one joint level (callers that care —
            # run_tick — always pass the real levels)
            priorities = [0] * n_b

        if weights is None:
            weights = np.ones((n_b, n_v), dtype=np.float64)
        else:
            weights = np.asarray(weights, dtype=np.float64)

        # --- candidate variables over ALL levels: (b, v, w) ---
        # per-variable resource needs (ALL-policy entries take the worker's
        # whole pool and require it untouched, solver.rs:120-124)
        variables: list[tuple[int, int, int]] = []
        var_needs: list[np.ndarray] = []
        var_upper: list[int] = []
        for b in range(n_b):
            if sizes[b] <= 0:
                continue
            for v in range(n_v):
                is_all = (
                    all_mask[b, v] > 0
                    if all_mask is not None
                    else np.zeros(n_r, dtype=bool)
                )
                if not (needs[b, v] > 0).any() and not is_all.any():
                    continue  # absent variant row
                for w in range(n_w):
                    if min_time[b, v] > lifetime[w]:
                        continue
                    if nt_free[w] <= 0:
                        continue
                    nv = needs[b, v].copy()
                    if is_all.any():
                        if total is None:
                            continue
                        if (
                            (free[w][is_all] != total[w][is_all])
                            | (total[w][is_all] <= 0)
                        ).any():
                            continue  # pool not fully idle
                        nv[is_all] = total[w][is_all]
                    if (nv > free[w]).any():
                        continue
                    variables.append((b, v, w))
                    var_needs.append(nv)
                    cap = min(int(sizes[b]), int(nt_free[w]))
                    if is_all.any():
                        cap = min(cap, 1)
                    var_upper.append(cap)
        if not variables:
            return counts
        n_x = len(variables)

        # min-utilization bool variables, one per floored worker
        floors = {}
        if cpu_floor is not None:
            cpu_floor = np.asarray(cpu_floor, dtype=np.int64)
            for w in range(n_w):
                if cpu_floor[w] > 0:
                    floors[w] = n_x + len(floors)
        n_y = len(floors)
        n_all = n_x + n_y

        # --- shared constraint matrix ---
        rows = lil_matrix((n_w * (n_r + 1) + n_b + 2 * n_y, n_all))
        lo: list[float] = []
        hi: list[float] = []
        row = 0
        by_worker: dict[int, list[int]] = {}
        by_batch: dict[int, list[int]] = {}
        for xi, (b, v, w) in enumerate(variables):
            by_worker.setdefault(w, []).append(xi)
            by_batch.setdefault(b, []).append(xi)
        for w, xis in by_worker.items():
            for r in range(n_r):
                touched = False
                for xi in xis:
                    if var_needs[xi][r]:
                        rows[row, xi] = float(var_needs[xi][r])
                        touched = True
                if touched:
                    lo.append(0.0)
                    hi.append(float(free[w, r]))
                    row += 1
            for xi in xis:
                rows[row, xi] = 1.0
            lo.append(0.0)
            hi.append(float(nt_free[w]))
            row += 1
        for b, xis in by_batch.items():
            for xi in xis:
                rows[row, xi] = 1.0
            lo.append(0.0)
            hi.append(float(sizes[b]))
            row += 1
        # min-utilization: cpu use on w is 0, or at least the floor
        # (reference add_min_utilization, solver.rs:479-518): with bool y_w,
        #   sum(cpu) - floor*y >= 0  and  sum(cpu) - free_cpu*y <= 0
        for w, yi in floors.items():
            for xi in by_worker.get(w, []):
                if var_needs[xi][0]:
                    rows[row, xi] = float(var_needs[xi][0])
                    rows[row + 1, xi] = float(var_needs[xi][0])
            rows[row, yi] = -float(cpu_floor[w])
            lo.append(0.0)
            hi.append(np.inf)
            row += 1
            rows[row, yi] = -float(free[w, 0])
            lo.append(-np.inf)
            hi.append(0.0)
            row += 1
        rows = rows[:row].tocsr()
        base_constraints = [LinearConstraint(rows, np.array(lo), np.array(hi))]

        # --- per-level lexicographic objective rows ---
        # share-density x weight value (solver.rs:528-546) with a tiny
        # lower-worker-index bonus as the tie-break the reference folds into
        # the objective
        res_sums = np.maximum(free, 0).sum(axis=0).astype(np.float64)
        value = np.zeros(n_all)
        for xi, (b, v, w) in enumerate(variables):
            share = sum(
                var_needs[xi][r] / res_sums[r]
                for r in range(n_r)
                if var_needs[xi][r] > 0 and res_sums[r] > 0
            )
            value[xi] = share * weights[b, v] * (
                1.0 + 1e-6 * (n_w - w) / max(n_w, 1)
            )

        levels: dict = {}
        for bi, p in enumerate(priorities):
            levels.setdefault(p, []).append(bi)
        level_keys = sorted(levels, reverse=True)

        level_rows = []
        for level in level_keys:
            batch_set = set(levels[level])
            weighted = any(
                abs(weights[b, v] - 1.0) > 1e-9
                for b in batch_set
                for v in range(n_v)
            )
            srow = np.zeros(n_all)
            for xi, (b, v, w) in enumerate(variables):
                if b in batch_set:
                    # count objective with a value tie-break, or pure value
                    # when the level carries non-default weights
                    srow[xi] = (
                        value[xi] if weighted else 1.0 + 1e-6 * value[xi]
                    )
            level_rows.append(srow)

        deadline = clock.monotonic() + self.time_limit_secs
        integrality = np.ones(n_all)
        upper = np.array(
            var_upper + [1] * n_y, dtype=np.float64
        )
        pins: list = []
        x_final = None
        for li, srow in enumerate(level_rows):
            if not srow.any():
                continue
            budget = max(deadline - clock.monotonic(), 0.1) / (
                len(level_rows) - li
            )
            result = milp(
                -srow,
                constraints=base_constraints + pins,
                integrality=integrality,
                bounds=Bounds(0, upper),
                options={"time_limit": budget},
            )
            # status 1 = time limit with a feasible incumbent in result.x;
            # discarding it would assign nothing on over-budget instances
            if result.x is None or result.status not in (0, 1):
                logger.warning(
                    "milp level %s failed: %s", level_keys[li], result.message
                )
                continue
            x_final = result.x
            achieved = float(srow @ result.x)
            # pin this level's score (small slack absorbs solver tolerance)
            pins.append(
                LinearConstraint(srow[None, :], achieved - 1e-6, np.inf)
            )

        if x_final is None:
            return counts
        x = np.round(np.asarray(x_final)[:n_x]).astype(np.int64)
        for xi, (b, v, w) in enumerate(variables):
            if x[xi] > 0:
                counts[b, v, w] = int(x[xi])
        return counts
