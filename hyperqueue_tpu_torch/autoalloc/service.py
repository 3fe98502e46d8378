"""Autoalloc service: the periodic planning/submission loop.

Reference: crates/hyperqueue/src/server/autoalloc/process.rs —
autoalloc_process (:41): interval tick doing refresh_queue_allocations (:800)
via the queue handler, then perform_submits (:367): a fake-worker query
against the scheduler (:416 -> tako query.rs:12) decides how many allocations
each queue should have in flight, bounded by compute_submission_permit (:500).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from pathlib import Path

from hyperqueue_tpu_torch.autoalloc.controller import (
    ALLOCATIONS_TOTAL,
    QUARANTINES_TOTAL,
    SCALE_UP_SECONDS,
    SUBMIT_FAILURES_TOTAL,
    ZOMBIE_TIMEOUT_SECS,
    ElasticityController,
)
from hyperqueue_tpu_torch.autoalloc.handlers import SubmitError, make_handler
from hyperqueue_tpu_torch.autoalloc.query import (
    WorkerTypeQuery,
    compute_new_worker_query,
)
from hyperqueue_tpu_torch.autoalloc.state import (
    CRASH_LOOP_WINDOW_SECS,
    Allocation,
    AutoAllocState,
    QueueParams,
)
from hyperqueue_tpu_torch.resources.worker_resources import WorkerResources
from hyperqueue_tpu_torch.utils import chaos
from hyperqueue_tpu_torch.worker.hwdetect import detect_resources
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.autoalloc")

REFRESH_INTERVAL = float(os.environ.get("HQ_AUTOALLOC_INTERVAL", "2.0"))


class AutoAllocService:
    def __init__(self, server, work_dir: Path):
        self.server = server
        self.state = AutoAllocState()
        self.work_dir = Path(work_dir)
        self._handlers: dict[int, object] = {}
        # queue params are immutable after `alloc add`; the parsed worker
        # descriptor (which probes host hardware as its base) is cached
        self._queue_descriptors: dict[int, object] = {}
        # exact resources of a worker that connected from this queue's
        # allocation — once known, demand queries use them verbatim
        # (partial=False; reference queue.get_worker_resources())
        self._queue_known_resources: dict[int, WorkerResources] = {}
        self._task: asyncio.Task | None = None
        self.controller = ElasticityController(self)
        # wid -> (queue_id, alloc_id, registered_at monotonic): the
        # crash-loop detector's registration clock + scale-down linkage
        self._worker_alloc: dict[int, tuple[int, str, float]] = {}
        # submits in flight between their alloc-submit-attempt record and
        # the alloc-queued/alloc-submit-failed outcome; snapshots carry
        # them so a crash mid-submit stays adoptable after compaction
        self._pending_attempts: list[dict] = []
        # strong refs to fire-and-forget cancel tasks: the loop keeps only
        # weak refs, so an unreferenced task can be GC'd before it runs —
        # and a collected scancel is a leaked cluster job
        self._bg_tasks: set[asyncio.Task] = set()
        # allocation-exact restore: the journal/snapshot replay
        # left the reconstructed table on the server; adopt it, then let
        # the first refresh reconcile the live set against the manager
        restored = getattr(server, "restored_autoalloc", None)
        if restored:
            self.state.restore(restored)
            n_active = sum(
                len(q.active_allocations())
                for q in self.state.queues.values()
            )
            if self.state.queues:
                logger.info(
                    "restored %d allocation queue(s) with %d active "
                    "allocation(s); reconciling against the manager",
                    len(self.state.queues), n_active,
                )
            self._adopt_orphans(restored.get("attempts") or ())

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def emit(self, kind: str, payload: dict) -> None:
        emit = getattr(self.server, "emit_event", None)
        if emit is not None:
            emit(kind, payload)

    def capture(self) -> dict:
        """Snapshot table: the allocation state plus submits in flight
        (events/snapshot.py capture_state carries this)."""
        return {
            **self.state.capture(),
            "attempts": [dict(a) for a in self._pending_attempts],
        }

    def _adopt_orphans(self, attempts) -> None:
        """A crash BETWEEN a submit and its journal record leaves a live
        allocation the journal does not know. Every submit script writes
        its pid to <alloc workdir>/pid, and the journaled submit-attempt
        names the queue's workdir tree — scanning it for live pids the
        restored table does not know finds the orphan. Local allocations
        are adopted exactly (their allocation id IS ``local-<pid>``);
        external managers get a loud event for the operator (their manager
        job id is not recoverable from a pid)."""
        known_dirs = {
            a.workdir
            for q in self.state.queues.values()
            for a in q.allocations.values()
        }
        for attempt in attempts:
            queue = self.state.queues.get(attempt.get("queue_id"))
            if queue is None:
                continue
            if queue.params.manager != "local":
                # the manager may have accepted the submit (the job can
                # even still be sitting in ITS queue, script never run),
                # and a compute-node pid is meaningless on this host —
                # nothing can be verified locally, so any unresolved
                # attempt is surfaced loudly for the operator to check
                # against qstat/squeue
                logger.error(
                    "a %s allocation submit for queue %d has no journaled "
                    "outcome (server died mid-submit); check the manager "
                    "for an orphan job and cancel it manually (workdir "
                    "tree: %s)",
                    queue.params.manager, queue.queue_id,
                    attempt.get("workdir"),
                )
                self.emit("alloc-orphan-detected", {
                    "queue_id": queue.queue_id,
                    "workdir": attempt.get("workdir") or "",
                })
                continue
            root = Path(attempt.get("workdir") or "")
            if not root.is_dir():
                continue
            for pid_file in sorted(root.rglob("pid")):
                workdir = str(pid_file.parent)
                if workdir in known_dirs:
                    continue
                try:
                    pid = int(pid_file.read_text().strip())
                    os.kill(pid, 0)
                except (ValueError, OSError):
                    continue  # never started or already gone: no leak
                # pid-recycling guard: the live process must actually be
                # this workdir's submit script, not an innocent bystander
                # that inherited the pid
                try:
                    cmdline = Path(
                        f"/proc/{pid}/cmdline"
                    ).read_bytes().replace(b"\0", b" ").decode(
                        errors="replace"
                    )
                    if workdir not in cmdline:
                        continue
                except OSError:
                    pass  # no /proc: fall back to the liveness check alone
                allocation_id = f"local-{pid}"
                if allocation_id in queue.allocations:
                    continue
                known_dirs.add(workdir)
                queue.allocations[allocation_id] = Allocation(
                    allocation_id=allocation_id,
                    queue_id=queue.queue_id,
                    worker_count=queue.params.workers_per_alloc,
                    status="running",
                    started_at=clock.now(),
                    workdir=workdir,
                )
                logger.warning(
                    "adopted orphan local allocation %s (submit raced "
                    "the crash; journal never saw it)", allocation_id,
                )
                self.emit("alloc-queued", {
                    "queue_id": queue.queue_id, "alloc": allocation_id,
                    "worker_count": queue.params.workers_per_alloc,
                    "workdir": workdir, "adopted": True,
                })

    def forget_queue(self, queue_id: int) -> None:
        """Drop per-queue caches after `alloc remove`."""
        self._handlers.pop(queue_id, None)
        self._queue_descriptors.pop(queue_id, None)
        self._queue_known_resources.pop(queue_id, None)

    def handler_for(self, queue):
        handler = self._handlers.get(queue.queue_id)
        if handler is None:
            handler = make_handler(
                queue.params.manager,
                str(self.server.server_dir),
                self.work_dir / f"queue-{queue.queue_id}",
            )
            self._handlers[queue.queue_id] = handler
        return handler

    # ------------------------------------------------------------------
    async def _loop(self) -> None:
        logger.info("autoalloc service started")
        while True:
            try:
                await self.refresh_allocations()
                # ONE signal sample per tick, shared by the submit
                # decisions and the controller policy (a second sample
                # would double the O(workers) walk and skew the
                # backlog-slope window)
                signals = self.controller.sample_signals()
                await self.perform_submits(signals)
                # elasticity policy: quarantine release, scale-down
                # drains, allocation release, zombie reap
                self.controller.tick(signals)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - autoalloc must not die
                logger.exception("autoalloc tick failed")
            await asyncio.sleep(REFRESH_INTERVAL)

    async def refresh_allocations(self) -> None:
        for queue in self.state.queues.values():
            active = [a.allocation_id for a in queue.active_allocations()
                      if not a.allocation_id.startswith("dry-run:")]
            if not active:
                continue
            handler = self.handler_for(queue)
            try:
                statuses = await handler.refresh_statuses(active)
            except Exception as e:  # noqa: BLE001
                logger.warning("status refresh failed for queue %d: %s",
                               queue.queue_id, e)
                continue
            order = {"queued": 0, "running": 1, "finished": 2, "failed": 2,
                     "cancelled": 2}
            for allocation_id, status in statuses.items():
                alloc = queue.allocations.get(allocation_id)
                if alloc is None or alloc.status == status:
                    continue
                # never move backwards: a worker connecting marks the
                # allocation running even while the manager still reports it
                # queued (status propagation lag)
                if order[status] < order[alloc.status]:
                    continue
                self._transition(queue, alloc, status)

    def _transition(self, queue, alloc: Allocation, status: str) -> None:
        alloc.status = status
        now = clock.now()
        if status == "running" and not alloc.started_at:
            alloc.started_at = now
            self.emit(
                "alloc-started",
                {"queue_id": queue.queue_id, "alloc": alloc.allocation_id},
            )
        elif status in ("finished", "failed", "cancelled"):
            alloc.ended_at = now
            self.emit(
                f"alloc-{status}",
                {"queue_id": queue.queue_id, "alloc": alloc.allocation_id,
                 **({"reason": alloc.reason} if alloc.reason else {})},
            )

    def cancel_allocation(
        self, queue, alloc: Allocation, reason: str, failed: bool = False
    ) -> "asyncio.Task":
        """Cancel an allocation's backing manager job (scale-down drain
        completed, zombie reap, queue removal). The table transition is
        synchronous — decisions and restore see it immediately — while
        the manager call runs in the background; the returned task lets
        callers that must not outrun the cancel (alloc remove, shutdown)
        await it."""
        alloc.reason = reason
        self._transition(queue, alloc, "failed" if failed else "cancelled")
        handler = self.handler_for(queue)

        async def _remove() -> None:
            try:
                await handler.remove_allocation(alloc.allocation_id)
            except Exception as e:  # noqa: BLE001 - best-effort cancel
                logger.warning(
                    "failed to cancel allocation %s: %s",
                    alloc.allocation_id, e,
                )

        task = asyncio.ensure_future(_remove())
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return task

    async def drain_background(self, timeout: float = 10.0) -> None:
        """Let in-flight manager cancellations finish (server shutdown):
        a scancel lost to process exit would leak a live cluster job
        that the journal already believes cancelled."""
        if self._bg_tasks:
            await asyncio.wait(set(self._bg_tasks), timeout=timeout)

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_worker_args(queue):
        """(cpus, {name: item}) declared by the queue's worker args —
        the same --cpus / --resource parsing `hq worker start` applies."""
        from hyperqueue_tpu_torch.worker.parser import parse_resource_definition

        args = list(queue.params.worker_args or [])
        cpus = None
        overrides = {}
        i = 0
        while i < len(args):
            arg = args[i]
            value = None
            for flag in ("--cpus", "--resource"):
                if arg == flag and i + 1 < len(args):
                    value = args[i + 1]
                    i += 1
                    break
                if arg.startswith(flag + "="):
                    value = arg.split("=", 1)[1]
                    break
            if value is not None:
                if arg.startswith("--cpus") or arg == "--cpus":
                    try:
                        cpus = int(value)
                    except ValueError:
                        pass
                else:
                    try:
                        item = parse_resource_definition(value)
                        overrides[item.name] = item
                    except ValueError:
                        pass
            i += 1
        return cpus, overrides

    def _queue_worker_descriptor(self, queue):
        """Resource descriptor of the workers this queue would spawn.

        Parsed from the queue's worker args (--cpus / --resource overrides
        applied over host detection, exactly as `hq worker start` would
        apply them) — the reference stores the same thing as the queue's
        cli_resource_descriptor (autoalloc/queue/mod.rs:32). Falls back to
        plain host detection when the queue declares nothing. Used for the
        mn gang-hosting check; the sn demand query uses _build_query."""
        cached = self._queue_descriptors.get(queue.queue_id)
        if cached is not None:
            return cached
        cpus, overrides = self._parse_worker_args(queue)
        base = detect_resources(n_cpus=cpus)
        if overrides:
            from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor

            items = {item.name: item for item in base.items}
            items.update(overrides)
            base = ResourceDescriptor(items=tuple(items.values()))
        self._queue_descriptors[queue.queue_id] = base
        return base

    def _build_query(self, queue) -> WorkerTypeQuery:
        """Reference process.rs:416 create_queue_worker_query — exact
        resources from a previously connected worker of this queue when
        known (partial=False); else the CLI-declared items with everything
        undeclared padded as unknown-best (partial=True); else an empty
        fully-partial descriptor."""
        core = self.server.core
        wpa = max(queue.params.workers_per_alloc, 1)
        known = self._queue_known_resources.get(queue.queue_id)
        if known is not None:
            resources, partial, declared = known, False, frozenset()
        else:
            from hyperqueue_tpu_torch.resources.descriptor import (
                ResourceDescriptor,
                ResourceDescriptorItem,
            )

            cpus, overrides = self._parse_worker_args(queue)
            items = []
            if "cpus" in overrides:
                # an explicit `--resource cpus=...` declaration wins, like
                # `hq worker start` resource overrides
                items.append(overrides["cpus"])
            elif cpus is not None:
                items.append(
                    ResourceDescriptorItem.range("cpus", 0, cpus - 1)
                )
            items.extend(
                item for item in overrides.values() if item.name != "cpus"
            )
            resources = WorkerResources.from_descriptor(
                ResourceDescriptor(items=tuple(items)), core.resource_map
            )
            partial = True
            declared = frozenset(
                core.resource_map.get_or_create(item.name) for item in items
            )
        return WorkerTypeQuery(
            resources=resources,
            partial=partial,
            time_limit_secs=queue.params.time_limit_secs,
            max_sn_workers=queue.params.backlog * wpa,
            max_workers_per_allocation=wpa,
            min_utilization=self._queue_min_utilization(queue),
            declared_ids=declared,
        )

    @staticmethod
    def _queue_min_utilization(queue) -> float:
        """min_utilization the queue's spawned workers will carry (parsed
        from worker args like the descriptor; reference WorkerTypeQuery
        carries it explicitly, query.rs + test_query.rs:273-342)."""
        args = list(queue.params.worker_args or [])
        for i, arg in enumerate(args):
            if arg == "--min-utilization" and i + 1 < len(args):
                try:
                    return float(args[i + 1])
                except ValueError:
                    return 0.0
            if arg.startswith("--min-utilization="):
                try:
                    return float(arg.split("=", 1)[1])
                except ValueError:
                    return 0.0
        return 0.0

    def _fake_worker_demand(self, queue) -> int:
        """How many NEW single-node workers of this queue's shape would
        receive load right now?  Single-queue convenience wrapper over the
        joint compute_new_worker_query (autoalloc/query.py — reference
        scheduler/query.rs:12-80)."""
        if queue.params.backlog * queue.params.workers_per_alloc <= 0:
            return 0
        response = compute_new_worker_query(
            self.server.core, self.server.model, [self._build_query(queue)]
        )
        return response.single_node_workers_per_query[0]

    def _mn_demand_joint(self, queues) -> dict[int, list[int]]:
        """n_nodes of each pending multi-node task, assigned to the FIRST
        eligible queue (first-query-wins dedup, reference query.rs:97-125):
        two queues that could both host a pending gang must not each
        provision an allocation for it.

        Reference process.rs:500 (compute_submission_permit) counts mn
        allocations separately from sn workers: a pending gang that no
        current worker group can host needs a whole fresh allocation of at
        least n_nodes workers with enough lifetime."""
        from hyperqueue_tpu_torch.server.reactor import _mn_member_eligible

        core = self.server.core
        out: dict[int, list[int]] = {q.queue_id: [] for q in queues}
        shapes = {
            q.queue_id: (
                max(q.params.workers_per_alloc, 1),
                WorkerResources.from_descriptor(
                    self._queue_worker_descriptor(q), core.resource_map
                ),
            )
            for q in queues
        }
        for task_id in core.mn_queue:
            task = core.tasks.get(task_id)
            if task is None or task.is_done:
                continue
            req = core.rq_map.get_variants(task.rq_id).variants[0]
            groups: dict[str, int] = {}
            for w in core.workers.values():
                if w.mn_task or w.draining or not _mn_member_eligible(w, req):
                    continue
                groups[w.group] = groups.get(w.group, 0) + 1
            if any(n >= req.n_nodes for n in groups.values()):
                continue  # an existing worker group can already host it
            for queue in queues:
                wpa, queue_worker = shapes[queue.queue_id]
                if req.n_nodes > wpa:
                    continue  # one allocation of this queue can't host it
                if req.min_time_secs > queue.params.time_limit_secs:
                    continue
                if any(
                    queue_worker.amount(e.resource_id) < e.amount
                    for e in req.entries
                ):
                    continue  # this queue's workers can't be members
                out[queue.queue_id].append(req.n_nodes)
                break
        return out

    async def perform_submits(self, signals: dict | None = None) -> None:
        # all eligible queues are planned in ONE joint query: an earlier
        # queue's projected workers absorb demand so a later queue only
        # provisions for the leftovers (reference process.rs:380-407 —
        # queries built per queue and solved together in query.rs)
        for queue in self.state.queues.values():
            if queue.can_submit_now():
                continue
            # blocked queues get a decision record too: "why didn't it
            # scale" is half the controller's observability contract
            if queue.state in ("paused", "quarantined"):
                self.controller.record(
                    queue.queue_id, "hold", queue.state,
                    "submits disabled while the queue is "
                    f"{queue.state}",
                )
            elif queue.next_submit_at > clock.now():
                self.controller.record(
                    queue.queue_id, "hold", "submit-backoff",
                    f"{queue.consecutive_failures} consecutive submit "
                    "failure(s); backing off",
                )
        eligible = [
            q for q in self.state.queues.values() if q.can_submit_now()
        ]
        if not eligible:
            return
        # SLO gate: while a page-severity burn-rate alert is
        # firing, the control plane is already failing its objectives —
        # buying MORE workers would pile registration/dispatch load onto
        # a struggling server (and spend allocation budget on capacity
        # it cannot drive). Hold scale-up, with a verdict per queue so
        # `hq alloc events` explains the pause; ticket-severity alerts
        # do not gate (slow burn leaves time for capacity to help).
        slo = getattr(self.server, "slo", None)
        paging = slo.paging_alerts() if slo is not None else []
        if paging:
            names = ",".join(sorted(a["alert"] for a in paging))
            for queue in eligible:
                self.controller.record(
                    queue.queue_id, "hold", "slo-page",
                    f"scale-up held: page alert(s) firing ({names})",
                )
            return
        response = compute_new_worker_query(
            self.server.core,
            self.server.model,
            [self._build_query(q) for q in eligible],
        )
        mn_by_queue = self._mn_demand_joint(eligible)
        for queue, sn_workers in zip(
            eligible, response.single_node_workers_per_query
        ):
            wpa = max(queue.params.workers_per_alloc, 1)
            mn_nodes = mn_by_queue[queue.queue_id]
            # in-flight capacity first satisfies mn demand (a whole alloc
            # per gang), the rest counts against sn demand (reference
            # process.rs:500 step 1). In-flight = workers an active
            # allocation has NOT yet connected: queued allocations
            # entirely (a batch job may legitimately sit queued for
            # hours), plus a bounded boot/reconnect window of running
            # ones — a restored `running` allocation whose workers are
            # still re-registering must absorb demand or a restart would
            # double-submit (allocation-exact restore). The
            # window is bounded by the zombie timeout: past it, a
            # running allocation's missing workers are presumed dead and
            # must not suppress scale-up for the allocation's lifetime.
            workers = self.server.core.workers
            now = clock.now()
            queued = queue.queued_allocations()
            for alloc in queue.active_allocations():
                if alloc.status == "running" and (
                    now - (alloc.started_at or alloc.queued_at)
                    > ZOMBIE_TIMEOUT_SECS
                ):
                    continue
                live = sum(
                    1 for wid in alloc.connected_workers if wid in workers
                )
                inflight = max(alloc.worker_count - live, 0)
                if inflight <= 0:
                    continue
                if mn_nodes and inflight >= mn_nodes[0]:
                    inflight -= mn_nodes.pop(0)
                sn_workers = max(0, sn_workers - inflight)
            allocs_needed = len(mn_nodes) + -(-sn_workers // wpa)
            logger.debug(
                "queue %d sn_demand=%d mn_demand=%d allocs_needed=%d",
                queue.queue_id, sn_workers, len(mn_nodes), allocs_needed,
            )
            if allocs_needed <= 0:
                self.controller.record(
                    queue.queue_id, "hold", "no-demand",
                    "fake-worker query: no new worker of this shape "
                    "would receive load",
                )
                continue
            # permit: stay within backlog and max worker count
            permit = queue.params.backlog - len(queued)
            if queue.params.max_worker_count:
                headroom = (
                    queue.params.max_worker_count - queue.active_worker_count()
                )
                permit = min(permit, headroom // wpa)
            n_submit = max(0, min(allocs_needed, permit))
            if signals is None:
                # standalone callers (tests) without a shared tick sample
                signals = self.controller.sample_signals()
            if n_submit <= 0:
                self.controller.record(
                    queue.queue_id, "hold", "backlog-full",
                    f"demand {allocs_needed} allocation(s) but "
                    f"{len(queued)} already queued (backlog "
                    f"{queue.params.backlog}, max workers "
                    f"{queue.params.max_worker_count or 'unlimited'})",
                )
                continue
            self.controller.record(
                queue.queue_id, "scale-up", "insufficient-capacity",
                f"submitting {n_submit} allocation(s): demand "
                f"{sn_workers} sn worker(s) + {len(mn_nodes)} gang(s), "
                f"backlog {signals['ready']} ready "
                f"(slope {signals['slope']:+.1f}/s, "
                f"{signals['insufficient_capacity']} marked "
                "insufficient-capacity last tick)",
            )
            for _ in range(n_submit):
                await self._submit_one(queue)

    async def _submit_one(self, queue) -> None:
        handler = self.handler_for(queue)
        # write-ahead intent: a kill -9 BETWEEN the submit and its
        # alloc-queued record would otherwise leak the allocation — the
        # attempt names the workdir, whose pidfile makes the orphan
        # findable at restore (see _adopt_orphans)
        # the handler's next allocation dir is deterministic enough for
        # adoption: the pidfile scan walks every numbered dir under it
        workdir_hint = str(
            self.work_dir / f"queue-{queue.queue_id}"
        )
        attempt = {"queue_id": queue.queue_id, "workdir": workdir_hint}
        self._pending_attempts.append(attempt)
        self.emit("alloc-submit-attempt", dict(attempt))
        try:
            allocation_id, workdir = await handler.submit_allocation(
                queue.queue_id, queue.params
            )
        except Exception as e:  # noqa: BLE001 - ANY failure must clear
            # the attempt, or it would ride every future snapshot and
            # trigger a spurious orphan scan on each restore
            self._pending_attempts.remove(attempt)
            logger.warning("allocation submit failed: %s", e)
            SUBMIT_FAILURES_TOTAL.inc()
            self.emit(
                "alloc-submit-failed",
                {"queue_id": queue.queue_id, "error": str(e)},
            )
            self.controller.record(
                queue.queue_id, "scale-up-failed", "submit-error", str(e)
            )
            if queue.on_submit_fail():
                queue.state = "paused"
                self.emit(
                    "alloc-queue-paused", {"queue_id": queue.queue_id}
                )
            return
        try:
            if chaos.ACTIVE:
                # the adoption window: the allocation exists at the
                # manager but alloc-queued has not hit the journal yet —
                # kill here proves the pidfile scan finds the orphan
                chaos.fire("autoalloc.post-spawn", op=queue.params.manager)
        finally:
            # a non-kill chaos action (raise) must not leave a LIVE
            # allocation untracked: the bookkeeping always completes
            # (SIGKILL bypasses finally, which is the point of the site)
            self._pending_attempts.remove(attempt)
            queue.on_submit_ok()
            ALLOCATIONS_TOTAL.labels(queue.params.manager).inc()
            queue.allocations[allocation_id] = Allocation(
                allocation_id=allocation_id,
                queue_id=queue.queue_id,
                worker_count=queue.params.workers_per_alloc,
                workdir=workdir,
            )
            self.emit(
                "alloc-queued",
                {"queue_id": queue.queue_id, "alloc": allocation_id,
                 "worker_count": queue.params.workers_per_alloc,
                 "workdir": workdir},
            )

    # ------------------------------------------------------------------
    def on_worker_connected(self, worker_id: int, alloc_id: str) -> None:
        queue, alloc = self.state.find_allocation(alloc_id)
        if alloc is None:
            return
        alloc.connected_workers.add(worker_id)
        self._worker_alloc[worker_id] = (
            queue.queue_id, alloc_id, clock.monotonic()
        )
        if not alloc.ever_bound:
            alloc.ever_bound = True
            # scale-up latency: submit accepted -> first usable capacity
            if alloc.queued_at:
                SCALE_UP_SECONDS.observe(
                    max(clock.now() - alloc.queued_at, 0.0)
                )
            self.emit(
                "alloc-worker-bound",
                {"queue_id": queue.queue_id, "alloc": alloc_id,
                 "worker": worker_id},
            )
        worker = self.server.core.workers.get(worker_id)
        if worker is not None:
            self._queue_known_resources[queue.queue_id] = (
                worker.resources
            )
        if alloc.status == "queued":
            self._transition(queue, alloc, "running")

    def on_worker_lost(self, worker_id: int, reason: str) -> None:
        """Crash-loop containment: an allocation worker that died
        (uncleanly) within CRASH_LOOP_WINDOW_SECS of registering counts
        toward the queue's crash streak; the K-th tips it into
        quarantine with geometric backoff (state.py)."""
        linked = self._worker_alloc.pop(worker_id, None)
        if linked is None:
            return
        queue_id, alloc_id, registered_at = linked
        queue = self.state.queues.get(queue_id)
        if queue is None:
            return
        alloc = queue.allocations.get(alloc_id)
        if alloc is not None:
            alloc.connected_workers.discard(worker_id)
        lifetime = clock.monotonic() - registered_at
        clean = reason == "stopped" or reason.startswith("lent")
        fast = not clean and lifetime < CRASH_LOOP_WINDOW_SECS
        if queue.on_worker_death(fast):
            QUARANTINES_TOTAL.inc()
            backoff = queue.quarantine_until - clock.now()
            logger.warning(
                "queue %d quarantined: workers keep dying within %.0fs of "
                "registration (%.0fs backoff, offense #%d)",
                queue_id, CRASH_LOOP_WINDOW_SECS, backoff,
                queue.quarantines,
            )
            self.emit(
                "alloc-queue-quarantined",
                {"queue_id": queue_id,
                 "backoff": round(backoff, 1),
                 "until": queue.quarantine_until,
                 "quarantines": queue.quarantines},
            )
            self.controller.record(
                queue_id, "quarantined", "crash-loop",
                f"worker {worker_id} of allocation {alloc_id} died "
                f"{lifetime:.1f}s after registering ({reason}); "
                f"backing off {backoff:.0f}s",
            )

    async def dry_run(self, params: QueueParams) -> dict:
        handler = make_handler(
            params.manager, str(self.server.server_dir), self.work_dir / "dryrun"
        )
        script = handler.build_script(0, params)
        return {"script": script, "submit_binary": handler.submit_binary}

    async def probe_submit(self, params: QueueParams) -> str | None:
        """Submit a probing allocation and immediately cancel it — `alloc add`
        verifies queue parameters this way unless --no-dry-run (reference
        commands/autoalloc.rs no_dry_run, process.rs dry-run submit).
        Returns an error message, or None if the probe succeeded."""
        handler = make_handler(
            params.manager, str(self.server.server_dir), self.work_dir / "dryrun"
        )
        try:
            allocation_id, _workdir = await handler.submit_allocation(0, params)
        except (SubmitError, OSError) as e:
            return str(e)
        try:
            await handler.remove_allocation(allocation_id)
        except Exception:  # noqa: BLE001 — cancel is best-effort
            logger.warning("failed to cancel probe allocation %s", allocation_id)
        return None
