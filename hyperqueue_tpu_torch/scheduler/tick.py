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
scheduler/pipeline.py). Not in this module yet, raising
NotImplementedError: min-utilization workers.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np

from hyperqueue_tpu_torch.ops.assign import scarcity_weights
from hyperqueue_tpu_torch.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu_torch.resources.request import AllocationPolicy
from hyperqueue_tpu_torch.scheduler.queues import (
    BLEVEL_STRIDE,
    Priority,
    TaskQueues,
)
from hyperqueue_tpu_torch.utils.constants import INF_TIME
from hyperqueue_tpu_torch.utils.native import native_nonzero

MAX_CUTS_PER_QUEUE = 32
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
    without min-utilization workers, so the carve-out below is skipped
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
    `workers` as well.
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
    mu_workers = [w for w in workers if w.cpu_floor > 0]
    if mu_workers and policy is not None and policy.rows:
        # the mu carve-out drops workers from the row list, so the (B, W)
        # affinity rows (built against the unfiltered order) no longer
        # align — keep only the alignment-free priority boosts
        policy = type(policy)(rows={}, boosts=policy.boosts)
    if mu_workers:
        raise NotImplementedError(
            "min-utilization workers (_solve_mu_workers) are not ported "
            "yet; they come with their own slice"
        )
    return _run_main_solve(
        queues, workers, rq_map, resource_map, model, batches,
        phases=phases, key_cache=key_cache, decision=decision,
        gang_ok=gang_ok, group_ids=group_ids, policy=policy,
    )


def assemble_solve_inputs(workers, batches, rq_map, resource_map,
                          dense=None, key_cache=None, gang_ok=None,
                          group_ids=None, policy=None):
    """Build the dense model.solve inputs for `batches` over `workers`.

    Sorts `batches` IN PLACE into the production solve order (priority,
    gang rows first within a user priority, boosted scheduler priority,
    scarcity, achievable objective) and applies range compression. Adds
    the policy's (B, W) `affinity` rows and, when a gang batch is present,
    `gang_nodes`, `gang_ok` and `group_onehot`. Returns the kwargs dict for
    model.solve().

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
    # (needs/min_time/all_mask) are pure in the sorted rq-id sequence and
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
                row = (k, nd, am if am.any() else None, mt)
                dense_cache[batch.rq_id] = row
            k, nd, am, mt = row
            needs[bi, :k] = nd
            min_time[bi, :k] = mt
            if am is not None and all_mask is not None:
                all_mask[bi, :k] = am
        needs_cache_owned = False
        if key_cache is not None:
            key_cache.batch_layout_sig = layout_sig
            key_cache.batch_layout = {
                "needs64": needs,
                "min_time": min_time,
                "all_mask": all_mask,
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
    return {
        "free": free.astype(np.int32),
        "nt_free": nt_free,
        "lifetime": lifetime,
        "needs": needs32,
        "sizes": sizes,
        "min_time": min_time,
        **extra,
    }


def _run_main_solve(queues, workers, rq_map, resource_map, model, batches,
                    dense=None, phases=None, key_cache=None, decision=None,
                    pipeline=None, gang_ok=None, group_ids=None,
                    policy=None):
    _t0 = _time.perf_counter()
    kwargs = assemble_solve_inputs(
        workers, batches, rq_map, resource_map, dense=dense,
        key_cache=key_cache, gang_ok=gang_ok, group_ids=group_ids,
        policy=policy,
    )
    _t1 = _time.perf_counter()
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
    native nonzero (utils/native.py) applies where the library is built.
    """
    _t2 = _time.perf_counter()
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
        extend = assignments.extend
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
