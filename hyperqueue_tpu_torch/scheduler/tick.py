"""One scheduling tick: queues -> batches -> dense inputs -> solve -> mapping.

Reference factoring: crates/tako/src/internal/scheduler/main.rs:40-46
(batches -> solver -> mapping). The dense inputs are the seam where the work
moves to the device: everything up to `model.solve` is host bookkeeping over
dicts; the solve itself sees only integer tensors.

Batches: per rq-id queue, each distinct priority level becomes a cut, capped
at MAX_CUTS_PER_QUEUE with the tail merged into the last cut (reference
batches.rs:183-217 prunes similarly). Batches from all queues are solved
jointly, globally ordered by priority.

Fused mode (the JAX package's `--scheduler greedy-fused`): gang batches
ride the solve as all-or-nothing rows (`gang_ok=`, `group_ids=`), and a
policy (`policy=`, a scheduler/policy.TickPolicyContext) reorders the batches
by its job boosts and the workers by its affinity rows.

The server's tick reads its workers from the incremental dense snapshot
(`dense=`, scheduler/tick_cache.py) and may run pipelined (`pipeline=`,
scheduler/pipeline.py).

Min-utilization workers (a cpu floor: all of it or no cpu work this tick)
are solved jointly by a model that can express the floor
(`supports_cpu_floor`, models/milp.MilpModel); under the greedy models they
are carved out of the main solve and each gets an exact host search over
the leftovers (_solve_mu_workers), the JAX package's documented deviation.
"""

from __future__ import annotations

import ctypes
import logging
import time as _time
from dataclasses import dataclass

import numpy as np

from hyperqueue_tpu_torch.ops.assign import scarcity_weights
from hyperqueue_tpu_torch.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu_torch.resources.request import AllocationPolicy
from hyperqueue_tpu_torch.utils.trace import ranges as _ranges
from hyperqueue_tpu_torch.scheduler.queues import (
    BLEVEL_STRIDE,
    Priority,
    TaskQueues,
)
from hyperqueue_tpu_torch.utils.constants import INF_TIME
from hyperqueue_tpu_torch.utils.native import NativeTaskQueue, native_nonzero

logger = logging.getLogger(__name__)

MAX_CUTS_PER_QUEUE = 32
# Node budget of the per-worker min-utilization branch-and-bound
# (_solve_mu_workers): past it the best fill FOUND still ships (the first
# dive is a greedy max-take seed) and a warning names the worker.
MU_DFS_NODE_BUDGET = 50_000
# Values above this get range-compressed before entering the solve. The
# CUDA kernel divides exactly at any int32 amount; the compression is kept
# because it changes decisions, and the solve must decide as the reference
# scheduler does.
MAX_SAFE_AMOUNT = 2**23


@dataclass(slots=True)
class Batch:
    rq_id: int
    priority: Priority
    size: int
    # fused gang rows: gang_task is the multi-node task this row represents,
    # gang_nodes its node count (0 = an ordinary row)
    gang_task: int = 0
    gang_nodes: int = 0


@dataclass(slots=True)
class WorkerRow:
    worker_id: int
    free: list[int]       # dense fractions, aligned to ResourceIdMap
    nt_free: int
    lifetime_secs: int    # INF_TIME if unlimited
    # pool totals (None = use free; only read for ALL-policy requests)
    total: list[int] | None = None
    # min-utilization floor in cpu fractions still to fill before this worker
    # may take any task at all (reference solver.rs:479-518); 0 = normal
    cpu_floor: int = 0
    # worker group (gang members come from one group; the policy's worker
    # class)
    group: str = "default"


# One assignment is a plain (task_id, worker_id, rq_id, variant) tuple.
Assignment = tuple[int, int, int, int]


def create_batches(queues: TaskQueues) -> list[Batch]:
    batches: list[Batch] = []
    for rq_id, queue in queues.items():
        sizes = queue.priority_sizes()
        if len(sizes) > MAX_CUTS_PER_QUEUE:
            head = sizes[: MAX_CUTS_PER_QUEUE - 1]
            tail_count = sum(n for _, n in sizes[MAX_CUTS_PER_QUEUE - 1 :])
            tail_priority = sizes[MAX_CUTS_PER_QUEUE - 1][0]
            sizes = head + [(tail_priority, tail_count)]
        for priority, count in sizes:
            batches.append(Batch(rq_id=rq_id, priority=priority, size=count))
    batches.sort(key=lambda b: (b.priority, -b.rq_id), reverse=True)
    return batches


def _compress_shifts(
    needs: np.ndarray, free: np.ndarray, total: np.ndarray | None = None
) -> list[int]:
    """Per-column right shifts that bring every amount below
    MAX_SAFE_AMOUNT. Pure: reads peaks only, mutates nothing."""
    shifts = [0] * free.shape[1]
    for r in range(free.shape[1]):
        peak = max(
            int(free[:, r].max(initial=0)), int(needs[:, :, r].max(initial=0))
        )
        if total is not None:
            peak = max(peak, int(total[:, r].max(initial=0)))
        shift = 0
        while (peak >> shift) >= MAX_SAFE_AMOUNT:
            shift += 1
        shifts[r] = shift
    return shifts


def _apply_compression(
    shifts: list[int],
    needs: np.ndarray,
    free: np.ndarray,
    total: np.ndarray | None = None,
) -> None:
    """Apply precomputed column shifts IN PLACE.

    needs are ceil-shifted (request never shrinks to zero) and free floor-
    shifted, so feasibility decisions stay sound (never optimistic). When
    `total` is present (ALL-policy requests in this tick) it shifts with
    free, and a partially-used pool is kept STRICTLY below its shifted total
    so the kernel's free == total idle check can never go optimistic.
    """
    for r, shift in enumerate(shifts):
        if not shift:
            continue
        nonzero = needs[:, :, r] > 0
        needs[:, :, r] = np.where(
            nonzero,
            np.maximum((needs[:, :, r] + (1 << shift) - 1) >> shift, 1),
            0,
        )
        was_partial = (
            free[:, r] < total[:, r] if total is not None else None
        )
        free[:, r] >>= shift
        if total is not None:
            total[:, r] >>= shift
            np.minimum(
                free[:, r],
                np.where(was_partial, total[:, r] - 1, free[:, r]),
                out=free[:, r],
            )


def _range_compress(
    needs: np.ndarray, free: np.ndarray, total: np.ndarray | None = None
) -> list[int]:
    """Shift-compress out-of-range columns in place; returns the shifts."""
    shifts = _compress_shifts(needs, free, total)
    _apply_compression(shifts, needs, free, total)
    return shifts


def run_tick(
    queues: TaskQueues,
    workers: list[WorkerRow] | None,
    rq_map: ResourceRqMap,
    resource_map: ResourceIdMap,
    model,
    batches: list[Batch] | None = None,
    dense=None,
    phases: dict | None = None,
    key_cache=None,
    decision: dict | None = None,
    pipeline=None,
    gang_ok=None,
    group_ids=None,
    policy=None,
) -> list[Assignment]:
    """Solve one tick and pop assigned tasks from the queues.

    Removes assigned tasks from `queues`; does NOT touch worker resource
    accounting — the caller applies each Assignment to its worker state,
    which keeps one owner for the free/nt_free bookkeeping.

    `batches` lets the caller pass a precomputed create_batches(queues)
    result, with fused gang batches appended; the caller's list order is
    left untouched. `phases` (optional dict) collects a per-phase latency
    breakdown in ms: assemble, solve_dispatch, device_sync, solve_host_prep
    and mapping.

    `dense` (a scheduler/tick_cache.DenseSnapshot) replaces `workers` with
    the persistent incremental snapshot; the cache serves only ticks
    without min-utilization workers, so the floors below are skipped
    structurally. `key_cache` (a TickStateCache) memoizes sort keys and the
    batch layout across ticks. `decision` (optional dict) receives the
    solver's verdict under "solver": status, backend, backend_reason,
    solve_ms and objective.

    `pipeline` (a scheduler/pipeline.TickPipeline, dense path only)
    switches this tick to ASYNC dispatch: the solve is enqueued through
    `model.solve_async` and registered as the pipeline's pending solve,
    and THIS call returns no assignments — the caller maps the pending
    solve at the top of its next tick (pipeline.take_result).

    Fused mode: `gang_ok` (W,) 0/1 marks the idle workers and `group_ids`
    (W,) gives each worker's group index, both aligned with the worker
    rows (or the snapshot's rows); a gang batch comes back as one
    (gang_task, worker_id, rq_id, -1) sentinel per member. `policy` (a
    scheduler/policy.TickPolicyContext) carries this tick's affinity rows
    and per-job boosts. The JAX package passes gang_ok and group_ids to the
    solve on its dense-snapshot path only; here they reach the solve from
    `workers` as well (filtered with the rows where the min-utilization
    carve-out drops workers).
    """
    if batches is None:
        batches = create_batches(queues)
    else:
        batches = list(batches)  # sorted in place below; don't reorder caller
    if dense is not None:
        if not batches or not dense.worker_ids:
            return []
        return _run_main_solve(
            queues, None, rq_map, resource_map, model, batches,
            dense=dense, phases=phases, key_cache=key_cache,
            decision=decision, pipeline=pipeline,
            gang_ok=gang_ok, group_ids=group_ids, policy=policy,
        )
    if not batches or not workers:
        return []

    # min-utilization workers take tasks all-or-nothing (enough cpu work to
    # clear their floor, or none). A model that can express that jointly
    # (supports_cpu_floor: MilpModel, `--scheduler milp`) solves normal and
    # mu workers in one program, the reference semantics (solver.rs:479-518
    # add_min_utilization). The water-fill cannot, so under the greedy
    # models the mu workers are carved out of the main solve and each gets
    # an exact host search over the leftovers — the JAX package's
    # documented deviation: a task never chooses BETWEEN a normal and a mu
    # worker in one decision.
    mu_workers = [w for w in workers if w.cpu_floor > 0]
    if mu_workers and getattr(model, "supports_cpu_floor", False):
        return _run_main_solve(
            queues, workers, rq_map, resource_map, model, batches,
            cpu_floor=np.fromiter(
                (max(w.cpu_floor, 0) for w in workers), dtype=np.int64,
                count=len(workers),
            ),
            phases=phases, key_cache=key_cache, decision=decision,
            gang_ok=gang_ok, group_ids=group_ids, policy=policy,
        )
    if mu_workers:
        keep = np.fromiter((w.cpu_floor <= 0 for w in workers), dtype=bool,
                           count=len(workers))
        workers = [w for w in workers if w.cpu_floor <= 0]
        if not workers:
            return _solve_mu_workers(queues, mu_workers, rq_map,
                                     resource_map)
        # the carve-out dropped workers from the row list: the (W,) gang
        # inputs are filtered with the rows, and the (B, W) affinity rows
        # (built against the unfiltered order) no longer align — keep only
        # the alignment-free priority boosts
        if gang_ok is not None:
            gang_ok = np.asarray(gang_ok)[keep]
        if group_ids is not None:
            group_ids = np.asarray(group_ids)[keep]
        if policy is not None and policy.rows:
            policy = type(policy)(rows={}, boosts=policy.boosts)
    assignments = _run_main_solve(
        queues, workers, rq_map, resource_map, model, batches,
        phases=phases, key_cache=key_cache, decision=decision,
        gang_ok=gang_ok, group_ids=group_ids, policy=policy,
    )
    if mu_workers:
        assignments.extend(
            _solve_mu_workers(queues, mu_workers, rq_map, resource_map)
        )
    return assignments


def assemble_solve_inputs(workers, batches, rq_map, resource_map,
                          cpu_floor=None, dense=None, key_cache=None,
                          gang_ok=None, group_ids=None, policy=None):
    """Build the dense model.solve inputs for `batches` over `workers`.

    Sorts `batches` IN PLACE into the production solve order (priority,
    gang rows first within a user priority, boosted scheduler priority,
    scarcity, achievable objective) and applies range compression. The
    kwargs carry every batch's `priorities` (the MILP's lexicographic
    levels) and, when a class carries a non-default request weight, the
    (B, V) `weights`; the greedy models accept and ignore both. Adds the
    policy's (B, W) `affinity` rows, when a gang batch is present
    `gang_nodes`, `gang_ok` and `group_onehot`, and with `cpu_floor` (the
    joint min-utilization path of run_tick) the (W,) floors, ceil-shifted
    with the cpu column. Returns the kwargs dict for model.solve().

    Two input forms, bit-identical by contract (tick_cache.paranoid_check):

    - `workers`: a list of WorkerRow — the from-scratch path, rebuilding
      the (W, R) arrays from Python lists each call;
    - `dense`: a tick_cache.DenseSnapshot — the incremental path; the
      persistent cache arrays are used directly (read-only: copied only
      when a range-compression shift must mutate them).

    `key_cache` (a TickStateCache, optional) memoizes the per-request-class
    (scarcity, objective) sort keys across ticks (they are pure in the rq
    class and this tick's free column totals, which steady-state ticks
    repeat) and the batch-shaped layout arrays (pure in the sorted rq-id
    sequence).
    """
    n_r = len(resource_map)
    n_b = len(batches)
    n_v = max(
        len(rq_map.get_variants(b.rq_id).variants) for b in batches
    )

    # ALL-policy requests need the pool totals alongside free (the kernel's
    # idle check); only materialized when some batch actually uses ALL
    has_all = any(
        entry.policy is AllocationPolicy.ALL
        for b in batches
        for variant in rq_map.get_variants(b.rq_id).variants
        for entry in variant.entries
    )

    if dense is not None:
        n_w = len(dense.worker_ids)
        free = dense.free
        total = dense.total if has_all else None
        nt_free = dense.nt_free
        lifetime = dense.lifetime
        cache_owns_arrays = True
    else:
        n_w = len(workers)
        free_lists = [row.free for row in workers]
        if all(len(f) == n_r for f in free_lists):
            # uniform rows (steady state): one C-level conversion instead
            # of a per-worker Python fill loop
            free = np.array(free_lists, dtype=np.int64)
        else:
            # a worker's dense row can lag the global resource map right
            # after a new resource name is interned
            free = np.zeros((n_w, n_r), dtype=np.int64)
            for i, f in enumerate(free_lists):
                free[i, : len(f)] = f
        total = None
        if has_all:
            total = np.zeros((n_w, n_r), dtype=np.int64)
            for i, row in enumerate(workers):
                src = row.total if row.total is not None else row.free
                total[i, : min(len(src), n_r)] = src[:n_r]
        nt_free = np.fromiter(
            (row.nt_free if row.nt_free > 0 else 0 for row in workers),
            dtype=np.int32,
            count=n_w,
        )
        lifetime = np.fromiter(
            (row.lifetime_secs for row in workers), dtype=np.int32, count=n_w
        )
        cache_owns_arrays = False

    # Most-constrained-first within a priority level: a class that can ONLY
    # run on scarce resources is placed before same-priority classes with
    # more options, so flexible work cannot strand the few workers carrying
    # a scarce pool (the reference MILP reaches the same outcome by solving
    # the level jointly, solver.rs). Constrainedness is the MINIMUM over
    # variants: a class with a commodity-resource fallback is flexible no
    # matter how scarce its preferred variant is. One scarcity notion for
    # the whole solve (also used for the worker visit order): zero-capacity
    # resources weigh 0, and free is clamped at 0 — over-commit from
    # prefill races can drive worker free negative.
    col_totals = np.maximum(free, 0).sum(axis=0)
    weights = scarcity_weights(col_totals)

    def _scarcity(batch: Batch) -> float:
        score = float("inf")
        for variant in rq_map.get_variants(batch.rq_id).variants:
            v_score = 0.0
            for entry in variant.entries:
                if (
                    entry.amount > 0
                    or entry.policy is AllocationPolicy.ALL
                ) and entry.resource_id < n_r:
                    s = float(weights[entry.resource_id])
                    if s > v_score:
                        v_score = s
            if v_score < score:
                score = v_score
        return 0.0 if score == float("inf") else score

    # plain Python list: the sort key touches these per batch per entry and
    # numpy scalar indexing is ~10x a list index on this path
    totals_by_r = col_totals.tolist()
    # the (scarcity, objective) key is pure per request class + this tick's
    # totals; distinct classes per tick << batches, so memoize per rq_id —
    # and ACROSS ticks through `key_cache` when the totals signature repeats
    sig = (n_w, n_r, tuple(totals_by_r))
    if key_cache is not None:
        if key_cache.sort_key_sig == sig:
            sort_keys = key_cache.sort_keys
        else:
            sort_keys = {}
            key_cache.sort_key_sig = sig
            key_cache.sort_keys = sort_keys
    else:
        sort_keys = {}

    def _objective_value(rq_id: int) -> list[tuple[float, float]]:
        """Within equal scarcity, emulate the reference LP objective
        (solver.rs:528-546): classes are taken in descending ACHIEVABLE
        share value — weight x per-task share-density x how many could run
        now (aggregate upper bound, O(R)) — with equal-value ties going to
        the smaller per-task ask. Request weights (request.rs:137) scale the
        value.

        Returns [(value, fit), ...] per variant; the sort maximizes
        (value x min(size, fit), -value) over them with the batch size."""
        out = []
        for variant in rq_map.get_variants(rq_id).variants:
            share = 0.0
            fit = float("inf")
            for entry in variant.entries:
                if entry.resource_id >= n_r:
                    fit = 0.0
                    break
                tot = totals_by_r[entry.resource_id]
                if entry.policy is AllocationPolicy.ALL:
                    # amount is the worker's whole pool; approximate the
                    # share with the per-worker average
                    share += 1.0 / max(n_w, 1)
                    fit = min(fit, float(n_w))
                elif entry.amount > 0:
                    if tot <= 0:
                        fit = 0.0
                        break
                    share += entry.amount / tot
                    fit = min(fit, tot // entry.amount)
            if fit == float("inf"):
                fit = 0.0
            out.append((variant.weight * share, fit))
        return out

    # policy priority boosts (scheduler/policy.py): a boosted job's batches
    # sort as if the job had been submitted `boost` jobs earlier — one
    # BLEVEL_STRIDE per boost step, the arithmetic of the scheduler-priority
    # encoding (queues.encode_sched_priority). The batch's own priority
    # tuple is NOT mutated: the mapping keeps the submission order.
    pol_boosts = policy is not None and bool(policy.boosts)

    def _sort_key(b: Batch):
        cached = sort_keys.get(b.rq_id)
        if cached is None:
            cached = (_scarcity(b), _objective_value(b.rq_id))
            sort_keys[b.rq_id] = cached
        scarcity, per_variant = cached
        # the achievable objective depends on the batch SIZE, so the best
        # variant is chosen here, per batch, from the cached class values
        best = (0.0, 0.0)
        size = b.size
        for value, fit in per_variant:
            cand = (value * (size if size < fit else fit), -value)
            if cand > best:
                best = cand
        sched = b.priority[1]
        if pol_boosts:
            boost = policy.boost_for_sched(sched)
            if boost:
                sched = sched + boost * BLEVEL_STRIDE
        # gang rows sort ahead of same-user-priority single-node work: else
        # a deep filler backlog would touch every idle worker before any
        # gang row scans, starving gangs forever
        return (
            (b.priority[0], 1 if b.gang_nodes else 0, sched),
            scarcity, best,
        )

    batches.sort(key=_sort_key, reverse=True)

    # per-tick sizes always refresh; the batch-shaped LAYOUT arrays
    # (needs/min_time/all_mask/weights) are pure in the sorted rq-id
    # sequence and
    # reusable across ticks through `key_cache` — steady state repeats the
    # sequence exactly
    sizes = np.fromiter(
        (b.size if b.size < 2**30 else 2**30 for b in batches),
        dtype=np.int32, count=n_b,
    )
    layout = None
    layout_sig = None
    if key_cache is not None:
        layout_sig = (
            n_b, n_v, n_r, has_all, tuple(b.rq_id for b in batches)
        )
        if key_cache.batch_layout_sig == layout_sig:
            layout = key_cache.batch_layout
    if layout is not None:
        needs = layout["needs64"]
        min_time = layout["min_time"]
        all_mask = layout["all_mask"]
        w_arr = layout["w_arr"]
        needs_cache_owned = True
    else:
        needs = np.zeros((n_b, n_v, n_r), dtype=np.int64)
        min_time = np.zeros((n_b, n_v), dtype=np.int32)
        min_time[:] = int(INF_TIME)  # absent variants never eligible
        all_mask = (
            np.zeros((n_b, n_v, n_r), dtype=np.int32) if has_all else None
        )
        # dense rows per request class are immutable — cache them on the
        # rq_map (keyed by the resource-map width, which can grow) instead
        # of re-walking every entry of every batch each tick
        cache_key, dense_cache = getattr(rq_map, "_dense_cache", (None, None))
        if cache_key != n_r:
            dense_cache = {}
            rq_map._dense_cache = (n_r, dense_cache)
        weighted_rows: list[tuple[int, int, np.ndarray]] = []
        for bi, batch in enumerate(batches):
            row = dense_cache.get(batch.rq_id)
            if row is None:
                variants = rq_map.get_variants(batch.rq_id).variants
                k = len(variants)
                nd = np.zeros((k, n_r), dtype=np.int64)
                am = np.zeros((k, n_r), dtype=np.int32)
                mt = np.empty(k, dtype=np.int32)
                for vi, variant in enumerate(variants):
                    mt[vi] = min(int(variant.min_time_secs), int(INF_TIME))
                    for entry in variant.entries:
                        if entry.policy is AllocationPolicy.ALL:
                            am[vi, entry.resource_id] = 1
                        else:
                            nd[vi, entry.resource_id] = entry.amount
                wt = np.array([v.weight for v in variants], dtype=np.float64)
                row = (k, nd, am if am.any() else None, mt,
                       wt if (wt != 1.0).any() else None)
                dense_cache[batch.rq_id] = row
            k, nd, am, mt, wt = row
            needs[bi, :k] = nd
            min_time[bi, :k] = mt
            if am is not None and all_mask is not None:
                all_mask[bi, :k] = am
            if wt is not None:
                weighted_rows.append((bi, k, wt))
        w_arr = None
        if weighted_rows:
            # request weights, only where a class carries a non-default
            # one: the greedy models consumed them through the batch order
            # above; the MILP folds them into its objective
            w_arr = np.ones((n_b, n_v), dtype=np.float64)
            for bi, k, wt in weighted_rows:
                w_arr[bi, :k] = wt
        needs_cache_owned = False
        if key_cache is not None:
            key_cache.batch_layout_sig = layout_sig
            key_cache.batch_layout = {
                "needs64": needs,
                "min_time": min_time,
                "all_mask": all_mask,
                "w_arr": w_arr,
                "needs32": None,
            }
            needs_cache_owned = True  # stored: shifts must copy-on-write

    shifts = _compress_shifts(needs, free, total)
    any_shift = any(shifts)
    if any_shift:
        # a shift mutates arrays in place — never the cache-owned
        # persistent ones (the common no-shift tick copies nothing)
        if cache_owns_arrays:
            free = free.copy()
            if total is not None:
                total = total.copy()
        if needs_cache_owned:
            needs = needs.copy()
    _apply_compression(shifts, needs, free, total)
    if not any_shift and needs_cache_owned:
        needs32 = key_cache.batch_layout["needs32"]
        if needs32 is None:
            needs32 = needs.astype(np.int32)
            key_cache.batch_layout["needs32"] = needs32
    else:
        needs32 = needs.astype(np.int32)
    extra = {}
    if all_mask is not None and all_mask.any():
        extra = {"total": total.astype(np.int32), "all_mask": all_mask}
    if w_arr is not None:
        extra["weights"] = w_arr
    if policy is not None and policy.rows:
        # heterogeneity affinity (B, W): one row per batch in the SORTED
        # order, index-aligned with the solve's worker axis; classes the
        # policy does not name keep a flat 1.0 row
        aff = None
        for bi, b in enumerate(batches):
            row = policy.affinity_for(b.rq_id)
            if row is None:
                continue
            if aff is None:
                aff = np.ones((n_b, n_w), dtype=np.float32)
            aff[bi, : min(len(row), n_w)] = row[:n_w]
        if aff is not None:
            extra["affinity"] = aff
    if any(b.gang_nodes for b in batches):
        # fused gang rows: per-batch gang sizes plus the worker-side
        # idleness and group inputs of the all-or-nothing selection
        extra["gang_nodes"] = np.fromiter(
            (b.gang_nodes for b in batches), dtype=np.int32, count=n_b
        )
        extra["gang_ok"] = (
            np.zeros(n_w, dtype=np.int32) if gang_ok is None
            else np.asarray(gang_ok, dtype=np.int32)
        )
        gids = (
            np.zeros(n_w, dtype=np.int32) if group_ids is None
            else np.asarray(group_ids, dtype=np.int32)
        )
        n_g = int(gids.max(initial=0)) + 1
        extra["group_onehot"] = (
            gids[:, None] == np.arange(n_g, dtype=np.int32)[None, :]
        ).astype(np.int32)
    if cpu_floor is not None:
        # a floor must never become EASIER to meet than in the unshifted
        # program: ceil-shift it with the cpu column
        if shifts[0]:
            s = shifts[0]
            cpu_floor = (cpu_floor + (1 << s) - 1) >> s
        extra["cpu_floor"] = cpu_floor
    return {
        "free": free.astype(np.int32),
        "nt_free": nt_free,
        "lifetime": lifetime,
        "needs": needs32,
        "sizes": sizes,
        "min_time": min_time,
        "priorities": [b.priority for b in batches],
        **extra,
    }


def _run_main_solve(queues, workers, rq_map, resource_map, model, batches,
                    cpu_floor=None, dense=None, phases=None, key_cache=None,
                    decision=None, pipeline=None, gang_ok=None,
                    group_ids=None, policy=None):
    _t0 = _time.perf_counter()
    ranges = _ranges()
    ranges.begin("assemble")
    kwargs = assemble_solve_inputs(
        workers, batches, rq_map, resource_map, cpu_floor=cpu_floor,
        dense=dense, key_cache=key_cache, gang_ok=gang_ok,
        group_ids=group_ids, policy=policy,
    )
    _t1 = _time.perf_counter()
    ranges.end("assemble")
    if pipeline is not None and hasattr(model, "solve_async"):
        # pipelined dispatch: enqueue the solve and return WITHOUT mapping
        # — the caller maps this solve at the top of its next tick
        # (pipeline.take_result), after the device had the whole inter-tick
        # window to execute. Only reachable on the dense path (run_tick),
        # where worker_ids come from the snapshot.
        from hyperqueue_tpu_torch.scheduler.pipeline import PendingSolve

        handle = model.solve_async(**kwargs)
        if phases is not None:
            phases["assemble"] = (
                phases.get("assemble", 0.0) + (_t1 - _t0) * 1e3
            )
            phases["solve_dispatch"] = (
                phases.get("solve_dispatch", 0.0)
                + (_time.perf_counter() - _t1) * 1e3
            )
        if decision is not None:
            decision.setdefault("solver", {
                "status": "pipelined",
                "backend": getattr(model, "last_backend", None),
                "backend_reason": getattr(model, "last_backend_reason", ""),
                "pipelined": True,
            })
        pipeline.put(PendingSolve(
            handle=handle,
            batches=batches,
            worker_ids=list(dense.worker_ids),
            queues=queues,
            backend=getattr(model, "last_backend", None),
            backend_reason=getattr(model, "last_backend_reason", ""),
        ))
        return []
    counts = model.solve(**kwargs)
    _t2 = _time.perf_counter()
    if decision is not None:
        # the solver's verdict for this tick: a watchdog-wrapped model
        # reports whether THIS solve ran degraded/skipped; plain models are
        # always "ok". The objective is how many tasks the solve placed.
        if getattr(model, "last_solve_skipped", False):
            status = "skipped"
        elif getattr(model, "last_solve_degraded", False):
            status = "fallback"
        else:
            status = "ok"
        decision["solver"] = {
            "status": status,
            "backend": getattr(model, "last_backend", None),
            "backend_reason": getattr(model, "last_backend_reason", ""),
            "solve_ms": round((_t2 - _t1) * 1e3, 4),
            "objective": int(np.asarray(counts).sum()),
        }
    if phases is not None:
        phases["assemble"] = phases.get("assemble", 0.0) + (_t1 - _t0) * 1e3
        solve_ms = (_t2 - _t1) * 1e3
        # models that time their own dispatch/readback split report it
        # (last_phases); the remainder is host-side padding + visit-class
        # prep inside solve()
        model_phases = getattr(model, "last_phases", None) or {}
        dispatch = model_phases.get("dispatch_ms", solve_ms)
        sync = model_phases.get("sync_ms", 0.0)
        phases["solve_dispatch"] = (
            phases.get("solve_dispatch", 0.0) + dispatch
        )
        phases["device_sync"] = phases.get("device_sync", 0.0) + sync
        phases["solve_host_prep"] = phases.get("solve_host_prep", 0.0) + max(
            solve_ms - dispatch - sync, 0.0
        )
    worker_ids = (
        dense.worker_ids if dense is not None
        else [w.worker_id for w in workers]
    )
    return _map_counts(queues, batches, worker_ids, counts, phases=phases)


def _map_counts(queues, batches, worker_ids, counts,
                phases=None) -> list[Assignment]:
    """Pop the solver's counts out of the queues as Assignment tuples.

    The one mapping path for the synchronous tick AND the pipelined tick
    (scheduler/pipeline.TickPipeline.take_result): `batches`/`worker_ids`
    are the solve-time snapshot, `queues` is live — a cell whose tasks
    were canceled while a pipelined solve was in flight simply pops fewer
    ids than the count, which is safe.

    One global nonzero over (B, V, W): row-major order preserves the
    per-batch FIFO take semantics of a nested (batch, variant, worker)
    loop. Every backend hands over C-contiguous int32 counts, so the
    native nonzero (utils/native.py) applies where the library is built,
    and where every batch's queue is native one call pops every cell's
    ids (_native_map_take); gang ticks take per cell in Python.
    """
    _t2 = _time.perf_counter()
    ranges = _ranges()
    ranges.begin("mapping")
    assignments: list[Assignment] = []
    try:
        counts = np.asarray(counts)
        nz = native_nonzero(counts)
        if nz is not None:
            flat, vals = nz
            if flat.size == 0:
                return assignments
            bs, vs, ws = np.unravel_index(flat, counts.shape)
        else:
            bs, vs, ws = np.nonzero(counts)
            if bs.size == 0:
                return assignments
            vals = counts[bs, vs, ws]
        if any(b.gang_nodes for b in batches):
            # gang cells never touch the queues (the gang task is held by
            # the caller until its assignment is applied): one
            # (gang_task, worker, rq, -1) sentinel per selected worker.
            # Ordinary cells pop from queues fetched LAZILY: fetching a
            # queue for a gang rq-id would create an empty single-node one.
            queue_by_bi: dict = {}
            for bi, vi, wi, n in zip(
                bs.tolist(), vs.tolist(), ws.tolist(), vals.tolist()
            ):
                batch = batches[bi]
                if batch.gang_nodes:
                    assignments.append(
                        (batch.gang_task, worker_ids[wi], batch.rq_id, -1)
                    )
                    continue
                queue = queue_by_bi.get(bi)
                if queue is None:
                    queue = queue_by_bi[bi] = queues.queue(batch.rq_id)
                task_ids = queue.take(batch.priority, n)
                worker_id = worker_ids[wi]
                assignments.extend(
                    [(task_id, worker_id, batch.rq_id, vi)
                     for task_id in task_ids]
                )
            return assignments
        batch_queues = [queues.queue(b.rq_id) for b in batches]
        native = _native_map_take(batch_queues, batches, bs, vals)
        extend = assignments.extend
        if native is not None:
            # one C call popped every cell's ids; stitch the tuples here
            out_ids, cell_n = native
            pos = 0
            for ci, (bi, vi, wi) in enumerate(
                zip(bs.tolist(), vs.tolist(), ws.tolist())
            ):
                end = pos + cell_n[ci]
                rq_id = batches[bi].rq_id
                worker_id = worker_ids[wi]
                extend(
                    [(tid, worker_id, rq_id, vi)
                     for tid in out_ids[pos:end]]
                )
                pos = end
            return assignments
        cur_bi = -1
        queue = rq_id = priority = None
        for bi, vi, wi, n in zip(
            bs.tolist(), vs.tolist(), ws.tolist(), vals.tolist()
        ):
            if bi != cur_bi:  # bs is sorted: hoist per-batch lookups per run
                cur_bi = bi
                batch = batches[bi]
                rq_id = batch.rq_id
                priority = batch.priority
                queue = batch_queues[bi]
            task_ids = queue.take(priority, n)
            worker_id = worker_ids[wi]
            extend(
                [(task_id, worker_id, rq_id, vi) for task_id in task_ids]
            )
        return assignments
    finally:
        if phases is not None:
            phases["mapping"] = phases.get("mapping", 0.0) + (
                _time.perf_counter() - _t2
            ) * 1e3
        ranges.end("mapping")


def _solve_mu_workers(queues, mu_rows, rq_map, resource_map):
    """Exact all-or-nothing solve for min-utilization workers (host side).

    Reference semantics (solver.rs:479-518 add_min_utilization): a worker
    with min_utilization either receives enough cpu work to push its busy
    cpus to at least mu x all_cpus, or receives no CPU-consuming work this
    tick (the constraint binds only cpu-consuming variables, so zero-cpu
    tasks — e.g. gpu-only — may land regardless). Per
    worker, a depth-first branch-and-bound over (request class, priority,
    variant) candidate counts maximizes the priority-lexicographic score
    (per level: task count, or weight x resource-share value when the level
    carries non-default request weights — mirroring the LP objective,
    solver.rs:520-549) subject to the worker's resources and the cpu floor.

    Candidates are capped at the 32 best (priority, value) classes and the
    search at MU_DFS_NODE_BUDGET nodes — past the budget the best fill
    found so far ships (usually the greedy first dive; possibly empty, in
    which case the worker stays idle this tick, a warning names it, and it
    retries next tick). mu workers are rare; exactness on small instances
    matters more than scale here.
    """
    assignments: list[Assignment] = []
    n_r = len(resource_map)

    for row in sorted(mu_rows, key=lambda r: r.worker_id):
        free0 = list(row.free[:n_r]) + [0] * (n_r - len(row.free))
        total0 = list((row.total or row.free)[:n_r])
        total0 += [0] * (n_r - len(total0))
        floor = row.cpu_floor
        nt0 = max(row.nt_free, 0)
        if nt0 == 0:
            continue

        # --- gather candidates from the current queue state ---
        # group = (rq_id, priority): variants of one class share the queued
        # count, so the DFS constrains the SUM of their takes (mirrors the
        # kernel's one `remaining` across the variant axis in scan_batches)
        cands = []  # (priority, value, rq_id, vi, needs(R,), max_count, grp)
        group_count: dict[tuple[int, tuple], int] = {}
        for rq_id, queue in queues.items():
            rqv = rq_map.get_variants(rq_id)
            if rqv.is_multi_node:
                continue
            for priority, count in queue.priority_sizes():
                if count <= 0:
                    continue
                group_count[(rq_id, priority)] = count
                for vi, variant in enumerate(rqv.variants):
                    if variant.min_time_secs > row.lifetime_secs:
                        continue
                    needs_vec = [0] * n_r
                    ok = True
                    for e in variant.entries:
                        if e.resource_id >= n_r:
                            ok = False
                            break
                        amt = (
                            total0[e.resource_id]
                            if e.policy is AllocationPolicy.ALL
                            else e.amount
                        )
                        if e.policy is AllocationPolicy.ALL and (
                            amt <= 0 or free0[e.resource_id] != amt
                        ):
                            ok = False
                            break
                        needs_vec[e.resource_id] = amt
                    if not ok:
                        continue
                    fit = nt0
                    for r in range(n_r):
                        if needs_vec[r] > 0:
                            fit = min(fit, free0[r] // needs_vec[r])
                    if fit <= 0:
                        continue
                    value = variant.weight * sum(
                        needs_vec[r] / total0[r]
                        for r in range(n_r)
                        if needs_vec[r] > 0 and total0[r] > 0
                    )
                    cands.append(
                        (priority, value, rq_id, vi, needs_vec,
                         min(count, fit), (rq_id, priority))
                    )
        if not cands:
            continue
        cands.sort(key=lambda c: (c[0], c[1]), reverse=True)
        cands = cands[:32]
        group_left0 = dict(group_count)

        # priority levels and their scoring mode (count vs weighted value)
        levels = sorted({c[0] for c in cands}, reverse=True)
        level_of = {p: i for i, p in enumerate(levels)}
        weighted_level = [False] * len(levels)
        for c in cands:
            if abs(rq_map.get_variants(c[2]).variants[c[3]].weight - 1.0) \
                    > 1e-9:
                weighted_level[level_of[c[0]]] = True

        def task_score(c):
            return c[1] if weighted_level[level_of[c[0]]] else 1.0

        # optimistic per-level remaining score from candidate i onward
        n_c = len(cands)
        opt = [[0.0] * len(levels) for _ in range(n_c + 1)]
        for i in range(n_c - 1, -1, -1):
            opt[i] = list(opt[i + 1])
            c = cands[i]
            opt[i][level_of[c[0]]] += task_score(c) * c[5]

        # static suffix bound on addable cpus (ignores shared resources:
        # an over-estimate, which is what a prune needs)
        suffix_cpu = [0] * (n_c + 1)
        for i in range(n_c - 1, -1, -1):
            suffix_cpu[i] = suffix_cpu[i + 1] + cands[i][4][0] * cands[i][5]

        best_score: list[float] | None = None
        best_take: list[int] | None = None
        nodes = 0

        def dfs(i, free, nt, cpu_used, score, take):
            nonlocal best_score, best_take, nodes
            nodes += 1
            if nodes > MU_DFS_NODE_BUDGET:
                return
            # prune: even everything remaining cannot beat the best
            if best_score is not None:
                bound = [s + o for s, o in zip(score, opt[i])]
                if bound <= best_score:
                    return
            # prune: floor unreachable even with all remaining cpus (only
            # once cpus are committed — an all-zero-cpu completion stays
            # feasible from cpu_used == 0)
            if 0 < cpu_used and cpu_used + suffix_cpu[i] < floor:
                return
            if i == n_c:
                # all-or-nothing applies to CPU usage (reference
                # solver.rs:479-518 constrains only cpu-consuming variables):
                # zero-cpu assignments (e.g. gpu-only tasks) are always
                # allowed on a floored worker
                if (cpu_used == 0 or cpu_used >= floor) and (
                    best_score is None or score > best_score
                ):
                    best_score = list(score)
                    best_take = list(take)
                return
            c = cands[i]
            needs_vec = c[4]
            x_max = min(c[5], nt, group_left[c[6]])
            for r in range(n_r):
                if needs_vec[r] > 0:
                    x_max = min(x_max, free[r] // needs_vec[r])
            for x in range(x_max, -1, -1):
                if x:
                    new_free = [
                        free[r] - x * needs_vec[r] for r in range(n_r)
                    ]
                else:
                    new_free = free
                li = level_of[c[0]]
                new_score = list(score)
                new_score[li] += task_score(c) * x
                take.append(x)
                group_left[c[6]] -= x
                dfs(
                    i + 1, new_free, nt - x,
                    cpu_used + x * needs_vec[0], new_score, take,
                )
                group_left[c[6]] += x
                take.pop()

        group_left = dict(group_left0)
        dfs(0, free0, nt0, 0, [0.0] * len(levels), [])

        if nodes > MU_DFS_NODE_BUDGET:
            # budget exhausted: the best solution FOUND so far still ships
            # (the first dive is a greedy max-take seed, so one is almost
            # always in hand); log so an idle mu worker is explainable
            logger.warning(
                "min-utilization solve for worker %d hit the %d-node "
                "budget; shipping the best fill found (%s)",
                row.worker_id, MU_DFS_NODE_BUDGET,
                "non-empty" if best_take and any(best_take) else "empty",
            )
        if not best_take or not any(best_take):
            continue
        for c, x in zip(cands, best_take):
            if x <= 0:
                continue
            priority, _value, rq_id, vi = c[0], c[1], c[2], c[3]
            for task_id in queues.queue(rq_id).take(priority, x):
                assignments.append((task_id, row.worker_id, rq_id, vi))
    return assignments


def _native_map_take(batch_queues, batches, bs, vals):
    """Pop every solver cell's task ids with ONE native call when all batch
    queues are C++-backed (native/hqcore.cpp hq_map_take); returns
    (ids_list, per_cell_counts) or None to use the per-cell Python path."""
    if not all(isinstance(q, NativeTaskQueue) for q in batch_queues):
        return None
    lib = batch_queues[0]._lib
    n_b = len(batches)
    handles = (ctypes.c_void_p * n_b)(*(q._handle for q in batch_queues))
    pu = (ctypes.c_int64 * n_b)(*(b.priority[0] for b in batches))
    ps = (ctypes.c_int64 * n_b)(*(b.priority[1] for b in batches))
    n_cells = bs.size
    # the solver's ndarrays go to C directly
    cell_batch = np.ascontiguousarray(bs, dtype=np.int64)
    cell_count = np.ascontiguousarray(vals, dtype=np.int64)
    out_ids = np.empty(int(cell_count.sum()), dtype=np.uint64)
    cell_n = np.empty(n_cells, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hq_map_take(
        handles, pu, ps,
        cell_batch.ctypes.data_as(i64p),
        cell_count.ctypes.data_as(i64p),
        n_cells,
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cell_n.ctypes.data_as(i64p),
    )
    return out_ids.tolist(), cell_n.tolist()
