"""Server core state, the part the scheduling tick reads.

Reference: crates/tako/src/internal/server/core.rs:42-62 — the single source
of truth mutated only by the reactor on the single-threaded server loop:
worker map, interning maps, ready queues, id counters. Purity of the
scheduler (a function of a snapshot of this state) is what makes the device
offload possible; nothing here holds locks.

The task map, the lazy array store, the flight recorder, the traces and the
paused jobs come with the host planes (the reactor and its task state).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperqueue_tpu_torch.ids import IdCounter
from hyperqueue_tpu_torch.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu_torch.resources.request import (
    AllocationPolicy,
    ResourceRequestVariants,
)
from hyperqueue_tpu_torch.scheduler.queues import TaskQueues
from hyperqueue_tpu_torch.scheduler.tick import WorkerRow
from hyperqueue_tpu_torch.scheduler.tick_cache import (
    TickPhaseStats,
    TickStateCache,
)
from hyperqueue_tpu_torch.server.worker import Worker


@dataclass
class Core:
    workers: dict[int, Worker] = field(default_factory=dict)
    resource_map: ResourceIdMap = field(default_factory=ResourceIdMap)
    rq_map: ResourceRqMap = field(default_factory=ResourceRqMap)
    queues: TaskQueues = field(default_factory=TaskQueues)
    worker_id_counter: IdCounter = field(default_factory=IdCounter)
    # (rq_id, variant) -> (has_all, [(resource_id, amount)]) memo for
    # variant_amounts (per-assignment hot path)
    amounts_cache: dict = field(default_factory=dict)
    # persistent dense tick snapshot, updated by dirty-tracking deltas
    # instead of rebuilt per tick (scheduler/tick_cache.py)
    tick_cache: TickStateCache = field(default_factory=TickStateCache)
    # per-phase tick latency breakdown, recorded per tick
    tick_stats: TickPhaseStats = field(default_factory=TickPhaseStats)
    # debug: every N ticks, assert the incremental assembly is
    # bit-identical to a from-scratch one (0 = off; --paranoid-tick N)
    paranoid_tick: int = 0
    # two-stage async tick pipeline (scheduler/pipeline.TickPipeline) when
    # the server runs pipelined ticks; None = synchronous ticks
    tick_pipeline: object = None
    tick_counter: int = 0
    # bumped on every change of the schedulable-worker SET (connect,
    # disconnect, gang reservation/claim/release): lets the tick cache
    # skip the O(W) membership walk on the common unchanged tick.
    # Row CONTENT changes (free/nt_free) ride on Worker.epoch instead.
    membership_epoch: int = 0
    # rq_id -> (membership_epoch, amount_capable, lifetime_ok, stable) memo
    # for scheduler/decision.classify_class (pure in the worker set per
    # class)
    capable_memo: dict = field(default_factory=dict)

    def bump_membership(self) -> None:
        self.membership_epoch += 1

    def intern_rqv(self, rqv: ResourceRequestVariants) -> int:
        return self.rq_map.get_or_create(rqv)

    def worker_rows(self) -> list[WorkerRow]:
        """Snapshot rows for the tick; excludes workers reserved for gangs
        and workers draining toward a graceful stop."""
        return [
            WorkerRow(
                worker_id=w.worker_id,
                free=w.free,
                nt_free=w.nt_free,
                lifetime_secs=w.lifetime_secs(),
                total=w.resources.amounts,
                cpu_floor=w.cpu_floor(),
                group=w.group,
            )
            for w in self.workers.values()
            if w.mn_task == 0 and w.mn_reserved == 0 and not w.draining
        ]

    def variant_amounts(
        self, rq_id: int, variant: int, worker=None
    ) -> list[tuple[int, int]]:
        """[(resource_id, amount)] of the chosen variant for accounting.

        ALL-policy entries take the WORKER's whole pool (reference
        solver.rs:120-124 amount_or_none_if_all), so `worker` must be passed
        whenever the request could contain one — assign and release then
        stay symmetric because the pool size is static per worker.

        Classes without ALL entries (the overwhelming majority) get their
        amount list memoized per (rq_id, variant): this is called once per
        assignment on the apply path (callers treat it read-only).
        """
        key = (rq_id, variant)
        cached = self.amounts_cache.get(key)
        if cached is None:
            entries = self.rq_map.get_variants(rq_id).variants[variant].entries
            if any(e.policy is AllocationPolicy.ALL for e in entries):
                cached = (True, None)
            else:
                cached = (
                    False, [(e.resource_id, e.amount) for e in entries]
                )
            self.amounts_cache[key] = cached
        has_all, static = cached
        if not has_all:
            return static
        rqv = self.rq_map.get_variants(rq_id)
        return [
            (
                e.resource_id,
                worker.resources.amount(e.resource_id)
                if worker is not None
                and e.policy is AllocationPolicy.ALL
                else e.amount,
            )
            for e in rqv.variants[variant].entries
        ]
