"""Worker-type queries: "how many NEW workers of each shape would get load?"

Reference: crates/tako/src/internal/scheduler/query.rs
compute_new_worker_query — build `max_sn_workers` fake workers per query,
rerun the production batches+solver over (real + fake) workers, and count
the fake workers that received at least one task, per query.  All queries
are solved JOINTLY: an earlier query's fake workers absorb demand so a
later query only sees the leftovers (test_query.rs sn_leftovers/partial
cases).  `partial` queries pad every resource the query did not declare to
an effectively unlimited amount (query.rs:35-47 ResourceAmount::MAX) —
"we know nothing about this worker type beyond what the CLI args say, so
assume the best".  Padding covers exactly the names registered in the
resource map: amounts are never invented for resources no task or worker
ever named (test_query.rs:730 unknown_do_not_add_extra).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hyperqueue_tpu_torch.ops.assign import INF_TIME
from hyperqueue_tpu_torch.resources.worker_resources import (
    TASK_MAX_COUNT_CAP,
    WorkerResources,
)
from hyperqueue_tpu_torch.scheduler.tick import (
    WorkerRow,
    assemble_solve_inputs,
    create_batches,
)

# Stand-in for "unlimited" on padded partial resources.  Must stay BELOW
# the kernel's float32-exact bound (scheduler/tick.MAX_SAFE_AMOUNT = 2**23
# fractions): a larger pad would trigger _range_compress's column shift and
# destroy the real workers' fit precision (a 4-cpu worker would round down
# to 3 tasks).  2**23-1 fractions ≈ 838 units — far above any plausible
# single-task request, never above the compression threshold.
PARTIAL_MAX_FRACTIONS = 2**23 - 1
# Concurrency bound for a padded fake worker (WorkerResources would derive
# it from real pool sizes, which padding distorts).  Equal to the bound
# every REAL worker gets (worker_resources.TASK_MAX_COUNT_CAP), so a
# partial fake worker is never more constrained than the worker the
# allocation would actually spawn; demand beyond it spills into the next
# fake worker of the same query (max_sn_workers permitting).
PARTIAL_TASK_CAP = TASK_MAX_COUNT_CAP


@dataclass
class WorkerTypeQuery:
    """One worker shape the autoalloc planner may spawn.

    Mirrors reference control.rs WorkerTypeQuery (descriptor, partial,
    time_limit, max_sn_workers, max_workers_per_allocation,
    min_utilization)."""

    resources: WorkerResources
    partial: bool = False
    time_limit_secs: float | None = None
    max_sn_workers: int = 1
    max_workers_per_allocation: int = 1
    min_utilization: float = 0.0
    # resource ids the query's descriptor explicitly declares (partial
    # padding skips these — an explicit 0 means "this worker type has
    # none", not "unknown")
    declared_ids: frozenset[int] = field(default_factory=frozenset)


@dataclass
class MultiNodeAllocation:
    """Reference gateway.rs MultiNodeAllocationResponse."""

    worker_type: int          # index into the queries list
    workers_per_allocation: int
    max_allocations: int


@dataclass
class WorkerQueryResponse:
    single_node_workers_per_query: list[int]
    multi_node_allocations: list[MultiNodeAllocation]


def _fake_rows(
    queries: list[WorkerTypeQuery],
    n_r: int,
    pad_floor: list[int] | None = None,
) -> list[WorkerRow]:
    rows: list[WorkerRow] = []
    fake_id = 0
    for query in queries:
        amounts = list(query.resources.amounts)
        amounts += [0] * (n_r - len(amounts))
        if query.partial:
            for rid in range(n_r):
                if rid not in query.declared_ids:
                    # a task requesting MORE than the stand-in "unlimited"
                    # pad must still register demand (reference uses
                    # ResourceAmount::MAX): raise the pad to the peak
                    # pending need and let _range_compress shift that
                    # column (sound: needs ceil, free floor)
                    amounts[rid] = max(
                        PARTIAL_MAX_FRACTIONS,
                        pad_floor[rid] if pad_floor else 0,
                    )
            nt = PARTIAL_TASK_CAP
        else:
            nt = query.resources.task_max_count()
        lifetime = (
            min(int(query.time_limit_secs), int(INF_TIME))
            if query.time_limit_secs is not None
            else int(INF_TIME)
        )
        for _ in range(query.max_sn_workers):
            fake_id -= 1
            rows.append(
                WorkerRow(
                    worker_id=fake_id,
                    free=amounts[:],
                    nt_free=nt,
                    lifetime_secs=lifetime,
                    total=amounts[:],
                )
            )
    return rows


def compute_new_worker_query(
    core, model, queries: list[WorkerTypeQuery]
) -> WorkerQueryResponse:
    """Non-destructive joint solve; see module docstring. `model` is the
    server's (a SolverWatchdog, or a model with `solve_query`)."""
    n_r = len(core.resource_map)
    # Real min-utilization workers are carved out of the production solve
    # and may leave ANY load unserved (all-or-nothing floors,
    # scheduler/tick.py run_tick) — counting their capacity here would
    # absorb demand that production won't serve and starve the queues, so
    # the demand estimate drops them (conservative: may spawn a worker a
    # mu-host would in fact have taken).
    real_rows = [r for r in core.worker_rows() if r.cpu_floor <= 0]
    first_fake = len(real_rows)
    batches = create_batches(core.queues)
    pad_floor = [0] * n_r
    for batch in batches:
        for variant in core.rq_map.get_variants(batch.rq_id).variants:
            for entry in variant.entries:
                if entry.amount > pad_floor[entry.resource_id]:
                    pad_floor[entry.resource_id] = entry.amount
    rows = real_rows + _fake_rows(queries, n_r, pad_floor)

    sn_counts = np.zeros(max(sum(q.max_sn_workers for q in queries), 1))
    if batches and len(rows) > first_fake:
        # the EXACT production assembly (dense rows, scarcity batch order,
        # range compression for float32-exactness, weights) — the fake
        # workers simply ride along as extra rows
        kwargs = assemble_solve_inputs(
            rows, batches, core.rq_map, core.resource_map
        )
        # solve_query, not solve: the model's tick keeps resident state
        # that a solve over other rows would replace (models/greedy.py)
        counts = np.asarray(model.solve_query(**kwargs))
        fake_counts = counts[:, :, first_fake:]
        sn_counts = fake_counts.sum(axis=(0, 1))

        # per-query min-utilization filter: a projected worker only counts
        # if the work it would attract keeps it above its utilization
        # floor (reference query.rs min_utilization,
        # test_query.rs:273-442).  Judged on cpus (resource 0), like the
        # production floor.  needs/free here are the (identically
        # compressed) solve inputs, so the ratio is consistent.
        needs = kwargs["needs"]
        all_mask = kwargs.get("all_mask")
        offset = 0
        for query in queries:
            k = query.max_sn_workers
            # an undeclared (padded) cpu pool has no meaningful utilization
            # floor — reference test_query.rs:420 min_utilization_vs_partial2
            # expects demand at mu=1.0 from an empty partial descriptor
            cpus_padded = query.partial and 0 not in query.declared_ids
            if query.min_utilization > 0.001 and k and not cpus_padded:
                span = slice(offset, offset + k)
                cpu_fr = np.einsum(
                    "bvw,bv->w", fake_counts[:, :, span], needs[:, :, 0]
                ).astype(np.float64)
                pool = float(kwargs["free"][first_fake + offset, 0])
                if all_mask is not None:
                    # an ALL-policy cpu task occupies the whole pool (its
                    # needs row is zero; the amount lives in the mask)
                    cpu_fr += np.einsum(
                        "bvw,bv->w", fake_counts[:, :, span],
                        all_mask[:, :, 0],
                    ) * pool
                floor = query.min_utilization * pool
                sn_counts[span] = np.where(cpu_fr >= floor, cpu_fr, 0.0)
            offset += k

    per_query: list[int] = []
    offset = 0
    for query in queries:
        k = query.max_sn_workers
        per_query.append(int((sn_counts[offset : offset + k] > 0).sum()))
        offset += k

    # mn allocations: each pending gang class maps to the FIRST query able
    # to host a whole gang in one allocation (reference query.rs:97-125)
    mn: list[MultiNodeAllocation] = []
    gang_classes: dict[int, int] = {}
    for task_id in core.mn_queue:
        task = core.tasks.get(task_id)
        if task is None or task.is_done:
            continue
        gang_classes[task.rq_id] = gang_classes.get(task.rq_id, 0) + 1
    for rq_id, n_pending in gang_classes.items():
        req = core.rq_map.get_variants(rq_id).variants[0]
        for i, query in enumerate(queries):
            if (
                query.time_limit_secs is not None
                and req.min_time_secs > query.time_limit_secs
            ):
                continue
            if query.max_workers_per_allocation >= req.n_nodes:
                mn.append(
                    MultiNodeAllocation(
                        worker_type=i,
                        workers_per_allocation=req.n_nodes,
                        max_allocations=n_pending,
                    )
                )
                break
    mn.sort(key=lambda x: (x.worker_type, x.workers_per_allocation))
    return WorkerQueryResponse(
        single_node_workers_per_query=per_query,
        multi_node_allocations=mn,
    )
