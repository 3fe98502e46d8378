"""Elasticity controller: the consumer of the autoscaler signal feed.

The subscribe plane exports queue depths, ``pending_reasons``
(``insufficient-capacity`` counts from the per-tick DecisionRecords) and
per-worker idle samples — this controller consumes the same server-side
signals every tick of the autoalloc service and drives:

- **scale-up** corroboration + decision records: the fake-worker demand
  query stays authoritative (it answers "would a new worker of this shape
  receive load?"), and every verdict — scaled, held, blocked — is recorded
  with the backlog/pending-reason evidence so ``hq alloc events`` can
  answer "why did/didn't it scale";
- **scale-down**: a worker that has idled for the queue's idle timeout is
  gracefully DRAINED (masked from the solve by ``Worker.draining``, so no
  assignment can race its departure); once an allocation's last worker is
  gone its backing manager job is cancelled — capacity leaves, task state
  never;
- **failure containment**: crash-loop quarantine release (geometric
  backoff lives in state.py), and a zombie reaper for allocations that
  reach ``running`` but never produce a registered worker.

Pure policy: the controller never touches sockets or subprocesses itself;
it calls ``server.start_drain`` and the queue handlers the service owns.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque

from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.autoalloc")

# an allocation that reached `running` but never produced a registered
# worker within this window is a zombie: its manager job is cancelled
ZOMBIE_TIMEOUT_SECS = float(
    os.environ.get("HQ_AUTOALLOC_ZOMBIE_TIMEOUT", "120.0")
)

# how many (time, backlog) samples feed the backlog-slope estimate
_BACKLOG_WINDOW = 16

ALLOCATIONS_TOTAL = REGISTRY.counter(
    "hq_autoalloc_allocations_total",
    "allocations successfully submitted to a queue manager",
    labels=("manager",),
)
SUBMIT_FAILURES_TOTAL = REGISTRY.counter(
    "hq_autoalloc_submit_failures_total",
    "allocation submits that failed (manager error, timeout, chaos)",
)
QUARANTINES_TOTAL = REGISTRY.counter(
    "hq_autoalloc_quarantines_total",
    "allocation queues quarantined by the crash-loop detector",
)
ZOMBIES_REAPED_TOTAL = REGISTRY.counter(
    "hq_autoalloc_zombies_reaped_total",
    "running allocations cancelled because no worker ever registered "
    "within the zombie timeout",
)
SCALE_UP_SECONDS = REGISTRY.histogram(
    "hq_autoalloc_scale_up_seconds",
    "allocation submit to its first registered worker",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 300.0, 1800.0),
)


class ElasticityController:
    """Per-server scale policy + decision journal (see module docstring)."""

    def __init__(self, service):
        self.service = service
        self.server = service.server
        # decision records, newest last; consecutive identical verdicts
        # for a queue collapse into one record with a tick count
        self.decisions: deque[dict] = deque(maxlen=512)
        # wid -> monotonic stamp of when the worker was last seen busy
        # (absent = not yet observed); sustained idle = now - stamp
        self._idle_since: dict[int, float] = {}
        # (time, total_ready) ring for the backlog-slope signal
        self._backlog: deque[tuple[float, int]] = deque(maxlen=_BACKLOG_WINDOW)
        # allocation ids the scale-down path drained: when their last
        # live worker departs, the backing manager job is cancelled
        self._draining_allocs: set[str] = set()

    # --- decision journal ------------------------------------------------
    def record(self, queue_id: int, verdict: str, reason: str,
               detail: str = "") -> None:
        """Append one scale verdict; consecutive repeats collapse."""
        now = clock.now()
        if self.decisions:
            last = self.decisions[-1]
            if (
                last["queue"] == queue_id
                and last["verdict"] == verdict
                and last["reason"] == reason
            ):
                last["ticks"] += 1
                last["last_time"] = now
                return
        self.decisions.append({
            "time": now, "last_time": now, "ticks": 1,
            "queue": queue_id, "verdict": verdict,
            "reason": reason, "detail": detail,
        })

    # --- signal sampling -------------------------------------------------
    def sample_signals(self) -> dict:
        """One tick's worth of the same signals the subscribe plane
        streams: backlog, its slope, and insufficient-capacity counts."""
        core = self.server.core
        now = clock.monotonic()
        ready = core.queues.total_ready() + len(core.mn_queue)
        self._backlog.append((now, ready))
        slope = 0.0
        if len(self._backlog) >= 2:
            t0, r0 = self._backlog[0]
            t1, r1 = self._backlog[-1]
            if t1 > t0:
                slope = (r1 - r0) / (t1 - t0)
        pending = {}
        latest = core.flight.latest() or {}
        for entry in latest.get("unplaced") or ():
            reason = entry.get("reason")
            if reason:
                pending[reason] = pending.get(reason, 0) + entry.get("count", 0)
        # per-worker idle tracking (all workers; scale-down below only
        # ever acts on allocation-bound ones)
        live = set()
        for w in core.workers.values():
            live.add(w.worker_id)
            busy = (
                w.assigned_tasks or w.prefilled_tasks or w.mn_task
                or w.mn_reserved
            )
            if busy:
                self._idle_since[w.worker_id] = now
            else:
                self._idle_since.setdefault(w.worker_id, now)
        for wid in [w for w in self._idle_since if w not in live]:
            del self._idle_since[wid]
        return {
            "ready": ready,
            "slope": slope,
            "insufficient_capacity": pending.get("insufficient-capacity", 0),
            "pending_reasons": pending,
        }

    def idle_for(self, worker_id: int) -> float:
        stamp = self._idle_since.get(worker_id)
        return 0.0 if stamp is None else clock.monotonic() - stamp

    # --- per-tick policy -------------------------------------------------
    def tick(self, signals: dict) -> None:
        service = self.service
        # a drained allocation usually ends on its own (the stopped worker
        # exits the batch script); drop tracking for anything no longer
        # active so the set cannot grow unboundedly
        if self._draining_allocs:
            active_ids = {
                a.allocation_id
                for q in service.state.queues.values()
                for a in q.active_allocations()
            }
            self._draining_allocs.intersection_update(active_ids)
        for queue in list(service.state.queues.values()):
            if queue.maybe_release_quarantine():
                service.emit("alloc-queue-resumed", {
                    "queue_id": queue.queue_id, "from": "quarantine",
                    "quarantines": queue.quarantines,
                })
                self.record(
                    queue.queue_id, "quarantine-released",
                    "backoff-expired",
                    f"quarantine #{queue.quarantines} expired; submits "
                    "re-enabled (next offense backs off twice as long)",
                )
            self._scale_down(queue, signals)
            self._reap_zombies(queue)

    def _scale_down(self, queue, signals: dict) -> None:
        """Drain sustained-idle allocation workers; cancel allocations
        whose last worker left."""
        threshold = max(queue.params.idle_timeout_secs, 0.1)
        core = self.server.core
        # drain idle workers bound to this queue's active allocations
        for alloc in queue.active_allocations():
            live = [
                wid for wid in alloc.connected_workers
                if wid in core.workers
            ]
            for wid in live:
                worker = core.workers[wid]
                if worker.draining:
                    continue
                idle_s = self.idle_for(wid)
                if idle_s < threshold:
                    continue
                started = self.server.start_drain(
                    [wid], timeout=max(threshold, 30.0),
                    source="scale-down",
                )
                if started:
                    self._draining_allocs.add(alloc.allocation_id)
                    self.record(
                        queue.queue_id, "scale-down", "sustained-idle",
                        f"worker {wid} idle {idle_s:.1f}s >= "
                        f"{threshold:.1f}s; draining (allocation "
                        f"{alloc.allocation_id})",
                    )
            if (
                alloc.allocation_id in self._draining_allocs
                and not live
            ):
                # the last drained worker is gone: release the backing
                # manager job — the allocation's capacity has left the pool
                self._draining_allocs.discard(alloc.allocation_id)
                self.service.cancel_allocation(
                    queue, alloc, reason="scale-down"
                )
                self.record(
                    queue.queue_id, "scale-down", "allocation-released",
                    f"allocation {alloc.allocation_id} drained to empty; "
                    "manager job cancelled",
                )

    def _reap_zombies(self, queue) -> None:
        now = clock.now()
        for alloc in queue.active_allocations():
            if (
                alloc.status == "running"
                and alloc.started_at
                and not alloc.ever_bound
                and now - alloc.started_at >= ZOMBIE_TIMEOUT_SECS
            ):
                ZOMBIES_REAPED_TOTAL.inc()
                logger.warning(
                    "allocation %s has been running %.0fs without a "
                    "registered worker; reaping as zombie",
                    alloc.allocation_id, now - alloc.started_at,
                )
                self.service.cancel_allocation(
                    queue, alloc, reason="zombie", failed=True
                )
                self.service.emit("alloc-zombie-reaped", {
                    "queue_id": queue.queue_id,
                    "alloc": alloc.allocation_id,
                    "ran_for": round(now - alloc.started_at, 1),
                })
                self.record(
                    queue.queue_id, "zombie-reaped", "never-registered",
                    f"allocation {alloc.allocation_id} ran "
                    f"{now - alloc.started_at:.0f}s with no worker",
                )

    def to_wire(self) -> list[dict]:
        return [dict(d) for d in self.decisions]
