"""Reactor: every mutation of the server core happens here.

Reference: crates/tako/src/internal/server/reactor.rs — on_new_worker,
on_remove_worker (requeue + crash counters), on_new_tasks (dep counting),
on_task_update, on_cancel_tasks. The scheduler is invoked between reactor
batches via an "ask_for_scheduling" flag + wakeup, never reentrantly
(reference server/comm.rs:61-101).
"""

from __future__ import annotations

import logging
import time as _time
from typing import Protocol

from hyperqueue_tpu_torch.ids import task_id_job, task_id_task
from hyperqueue_tpu_torch.scheduler import decision as decision_mod
from hyperqueue_tpu_torch.scheduler.queues import (
    BLEVEL_STRIDE,
    Priority as Priority_t,
    decode_sched_blevel,
    decode_sched_job,
    encode_sched_priority,
)
from hyperqueue_tpu_torch.scheduler.tick import Batch, create_batches, run_tick
from hyperqueue_tpu_torch.server.core import Core
from hyperqueue_tpu_torch.server.task import Task, TaskState
from hyperqueue_tpu_torch.server.worker import Worker
from hyperqueue_tpu_torch.transport.framing import attach_trace_wire
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils.trace import TRACER
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

# tick telemetry in the process-wide metrics plane (utils/metrics.py):
# per-phase latency histograms plus assignment counters. Observed once per
# tick (not per task) so the cost is a handful of dict ops per schedule().
_TICK_PHASE_SECONDS = REGISTRY.histogram(
    "hq_tick_phase_seconds",
    "scheduler tick latency per phase (snapshot/batches/gangs/assemble/"
    "solve/mapping/prefill/decide/total)",
    labels=("phase",),
)
_TICKS_TOTAL = REGISTRY.counter(
    "hq_scheduler_ticks_total", "scheduling ticks run"
)
_ASSIGNED_TOTAL = REGISTRY.counter(
    "hq_scheduler_assigned_tasks_total",
    "tasks assigned to workers by the dense solve + gang phases",
)
_PREFILLED_TOTAL = REGISTRY.counter(
    "hq_scheduler_prefilled_tasks_total",
    "tasks proactively prefilled onto busy workers",
)
_RETRACTED_TOTAL = REGISTRY.counter(
    "hq_scheduler_retracts_total",
    "prefilled tasks asked back from workers",
    labels=("reason",),
)
_SOLVE_GANG_GROUPS = REGISTRY.counter(
    "hq_solve_gang_groups",
    "multi-node gangs co-scheduled atomically by the fused dense solve "
    "(all-or-nothing column groups, --scheduler greedy-fused)",
)
_SOLVE_LOOKAHEAD_DEPTH = REGISTRY.gauge(
    "hq_solve_lookahead_depth",
    "critical-path depth (b-level) of the deepest task in the last "
    "dependency-carrying submit batch",
)
_POLICY_JAIN = REGISTRY.gauge(
    "hq_policy_fairness_jain",
    "Jain fairness index of per-job running resource usage at the last "
    "tick that had work running (1.0 = perfectly even; --policy-file "
    "fairness fold, scheduler/policy.py)",
)
_POLICY_HIT_RATE = REGISTRY.gauge(
    "hq_policy_predictor_hit_rate",
    "fraction of runtime-predictor lookups that had a learned EWMA "
    "(scheduler/predict.py; 0 until the table warms or is journal-seeded)",
)
_POLICY_BOOST_MAX = REGISTRY.gauge(
    "hq_policy_boost_max",
    "largest per-job priority boost (fairness + prediction) applied to "
    "the last scheduling tick's batch sort",
)

# at most this many gang rows ride one fused solve: gangs are rare and a
# deep mn backlog must not grow the padded batch axis (each row holds its
# selected workers for the whole scan, so later rows see a drained pool
# anyway — exactly like the host phase's one-reservation-at-a-time drain)
MAX_FUSED_GANG_ROWS = 16

# max tasks queued on a worker beyond its current capacity. The reference
# uses 40 (scheduler/state.rs:4-21) with its own tick cadence; ours is sized
# so that the refill round-trip (scheduler min-delay + two plane RTTs +
# batch processing, ~35 ms measured) amortized over a full prefill batch
# stays well under the <0.1 ms/task overhead target even when every task
# completes instantly.
PREFILL_MAX = 512


class Comm(Protocol):
    def send_compute(self, worker_id: int, tasks: list[dict]) -> None: ...
    def send_cancel(self, worker_id: int, task_ids: list[int]) -> None: ...
    def send_retract(
        self, worker_id: int, task_refs: list[tuple[int, int]]
    ) -> None: ...  # (task_id, instance_id) pairs
    def ask_for_scheduling(self) -> None: ...


class EventSink(Protocol):
    """Upward channel to the product (jobs) layer.

    Reference: the EventProcessor trait (tako events.rs:7-33) — the only way
    task-graph news reaches jobs/journal/clients.
    """

    def on_task_started(self, task_id: int, instance_id: int,
                        worker_ids: list[int], variant: int = 0,
                        wtrace: dict | None = None) -> None: ...
    def on_task_restarted(self, task_id: int) -> None: ...
    def on_task_finished(self, task_id: int,
                         wtrace: dict | None = None) -> None: ...
    def on_task_failed(self, task_id: int, message: str,
                       wtrace: dict | None = None) -> None: ...
    def on_task_canceled(self, task_id: int) -> None: ...
    def on_worker_new(self, worker: Worker) -> None: ...
    def on_worker_lost(self, worker_id: int, reason: str) -> None: ...


def on_new_tasks(core: Core, comm: Comm, tasks: list[Task]) -> None:
    """Insert tasks, count dependencies, enqueue the ready ones.

    Reference reactor.rs:188 (on_new_tasks).
    """
    for task in tasks:
        core.tasks[task.task_id] = task
    _apply_blevel_lookahead(core, tasks)
    for task in tasks:
        unfinished = 0
        for dep_id in task.deps:
            dep = core.tasks.get(dep_id)
            if dep is None or dep.state is TaskState.FINISHED:
                continue
            dep.consumers.add(task.task_id)
            unfinished += 1
        task.unfinished_deps = unfinished
        if unfinished == 0:
            _make_ready(core, task)
    comm.ask_for_scheduling()


def _apply_blevel_lookahead(core: Core, tasks: list[Task]) -> None:
    """Critical-path (b-level) lookahead over one submitted batch.

    Re-encodes the scheduler-priority component (scheduler/queues.py
    encoding) so that within a job, a task with more dependent work below
    it outranks its siblings: blevel = 1 + max over in-batch consumers,
    0 for sinks. Tasks carrying raw test-literal priorities are left
    untouched, so explicit priority assertions stay bit-exact; production
    submits always carry the encoding.
    """
    if not any(t.deps for t in tasks):
        return
    batch = {t.task_id: t for t in tasks}
    n_children: dict[int, int] = {}
    for t in tasks:
        for dep_id in t.deps:
            if dep_id in batch:
                n_children[dep_id] = n_children.get(dep_id, 0) + 1
    blevel = dict.fromkeys(batch, 0)
    stack = [t for t in tasks if n_children.get(t.task_id, 0) == 0]
    while stack:
        t = stack.pop()
        lvl = blevel[t.task_id] + 1
        for dep_id in t.deps:
            if dep_id not in batch:
                continue
            if lvl > blevel[dep_id]:
                blevel[dep_id] = lvl
            n_children[dep_id] -= 1
            if n_children[dep_id] == 0:
                stack.append(batch[dep_id])
    depth = 0
    for tid, lvl in blevel.items():
        if lvl <= 0:
            continue
        t = batch[tid]
        user, sched = t.priority
        if sched > -BLEVEL_STRIDE:
            continue  # raw literal scheduler priority: no blevel channel
        t.priority = (
            user, encode_sched_priority(decode_sched_job(sched), lvl)
        )
        if lvl > depth:
            depth = lvl
    if depth:
        _SOLVE_LOOKAHEAD_DEPTH.set(depth)


def _make_ready(core: Core, task: Task) -> None:
    task.state = TaskState.READY
    task.t_ready = clock.now()
    if core.paused_jobs:
        job_id = task_id_job(task.task_id)
        if job_id in core.paused_jobs:
            # the job is paused: the task is READY but held out of the
            # queues until `hq job resume` re-enqueues it
            core.paused_held.setdefault(job_id, set()).add(task.task_id)
            return
    rqv = core.rq_map.get_variants(task.rq_id)
    if rqv.is_multi_node:
        core.mn_queue.append(task.task_id)
        core.mn_queue.sort(key=lambda t: core.tasks[t].priority, reverse=True)
    else:
        core.queues.add(task.rq_id, task.priority, task.task_id)


def pause_jobs(core: Core, comm: Comm, job_ids: list[int]) -> tuple[int, int]:
    """Hold the READY tasks of these jobs out of the scheduler queues.

    Tasks already RUNNING (or assigned with resources accounted) are not
    recalled — pause gates placement, it does not preempt.  PREFILLED
    backlog (queued on a worker, not started) IS asked back via the
    retract path: a successful retract requeues through _make_ready,
    which holds the task because the job is paused.  WAITING tasks whose
    dependencies finish while paused are held the same way.  Returns
    (newly held, retracts sent)."""
    wanted = set(job_ids)
    core.paused_jobs |= wanted
    held = 0
    for job_id in wanted:
        # lazy array segments leave the scheduler levels as whole chunks
        # (no materialization — a paused 1M-task array stays O(chunks));
        # resume_jobs re-enqueues them the same way
        held += core.lazy.detach_job(core, job_id)
    for _rq_id, queue in core.queues.items():
        for task_id in queue.all_tasks():
            if task_id_job(task_id) in wanted:
                queue.remove(task_id)
                core.paused_held.setdefault(
                    task_id_job(task_id), set()
                ).add(task_id)
                held += 1
    for task_id in list(core.mn_queue):
        if task_id_job(task_id) in wanted:
            core.mn_queue.remove(task_id)
            _clear_mn_reservations(core, task_id)
            core.paused_held.setdefault(
                task_id_job(task_id), set()
            ).add(task_id)
            held += 1
    retracts: dict[int, list[tuple[int, int]]] = {}
    for worker in core.workers.values():
        for task_id in worker.prefilled_tasks:
            if task_id_job(task_id) not in wanted:
                continue
            task = core.tasks[task_id]
            if task.retract_pending:
                continue  # an earlier retract already covers it
            task.retract_pending = True
            retracts.setdefault(worker.worker_id, []).append(
                (task_id, task.instance_id)
            )
    n_retracted = 0
    for worker_id, refs in retracts.items():
        _RETRACTED_TOTAL.labels("pause").inc(len(refs))
        n_retracted += len(refs)
        comm.send_retract(worker_id, refs)
    return held, n_retracted


def resume_jobs(core: Core, comm: Comm, job_ids: list[int]) -> int:
    """Re-enqueue the held READY tasks of paused jobs."""
    released = 0
    mn_added = False
    for job_id in job_ids:
        core.paused_jobs.discard(job_id)
        released += core.lazy.requeue_job(core, job_id)
        held = core.paused_held.pop(job_id, None)
        if not held:
            continue
        for task_id in sorted(held):
            task = core.tasks.get(task_id)
            if (
                task is None
                or task.is_done
                or task.state is not TaskState.READY
            ):
                continue
            if core.rq_map.get_variants(task.rq_id).is_multi_node:
                core.mn_queue.append(task_id)
                mn_added = True
            else:
                core.queues.add(task.rq_id, task.priority, task_id)
            released += 1
    if mn_added:
        core.mn_queue.sort(key=lambda t: core.tasks[t].priority, reverse=True)
    if released:
        comm.ask_for_scheduling()
    return released


def recall_tasks(core: Core, comm: Comm, task_ids: list[int]) -> int:
    """Recall ASSIGNED/RUNNING tasks from their workers (migration
    export): release resources, cancel the incarnation on the
    worker, bump the instance — a late uplink from the recalled
    incarnation then carries a stale instance id and is discarded — and
    requeue through _make_ready (the caller pauses the job first, so the
    task lands in the pause ledger, not a queue).  Never charges the
    crash counter: the recall is deliberate, not a worker failure."""
    per_worker: dict[int, list[int]] = {}
    recalled = 0
    for tid in task_ids:
        task = core.tasks.get(tid)
        if task is None or task.is_done:
            continue
        if task.state not in (TaskState.ASSIGNED, TaskState.RUNNING):
            continue
        notify = list(task.mn_workers) or [task.assigned_worker]
        _release_task_resources(core, task)
        for wid in notify:
            if wid:
                per_worker.setdefault(wid, []).append(tid)
        task.increment_instance()
        task.state = TaskState.WAITING
        _make_ready(core, task)
        recalled += 1
    for wid, tids in per_worker.items():
        comm.send_cancel(wid, tids)
    return recalled


def on_new_worker(core: Core, comm: Comm, events: EventSink, worker: Worker) -> None:
    core.workers[worker.worker_id] = worker
    core.bump_membership()
    events.on_worker_new(worker)
    comm.ask_for_scheduling()


def on_remove_worker(
    core: Core, comm: Comm, events: EventSink, worker_id: int, reason: str
) -> None:
    """Worker lost: requeue its tasks with crash accounting.

    Reference reactor.rs:64 — sn tasks go back to the queues with
    crash_counter+1 and die at the crash limit (deliberate stops are
    exempt). mn tasks: a RUNNING gang losing a NON-root member keeps
    running on the root with the member dropped (reference
    RunningMultiNode retain; CHANGELOG v0.25.1); root loss — or any
    member loss before the gang reports running — tears the gang down
    and reschedules it.
    """
    worker = core.workers.pop(worker_id, None)
    if worker is None:
        return
    core.bump_membership()
    events.on_worker_lost(worker_id, reason)
    for task_id in list(worker.prefilled_tasks):
        task = core.tasks.get(task_id)
        if task is None or task.is_done:
            continue
        task.prefilled = False
        task.retract_pending = False
        task.assigned_worker = 0
        task.increment_instance()
        task.state = TaskState.WAITING
        _make_ready(core, task)
    for task_id in list(worker.assigned_tasks):
        task = core.tasks.get(task_id)
        if task is None or task.is_done:
            continue
        was_running = task.state is TaskState.RUNNING
        task.assigned_worker = 0
        task.increment_instance()
        # never-restart tasks fail on ANY worker loss while running, even a
        # deliberate stop (reference reactor.rs:166, outside the
        # reason.is_failure() gate)
        if was_running and task.never_restart:
            task.state = TaskState.FAILED
            _propagate_failure(
                core, events, task,
                "task was running on a lost worker while never-restart was set",
            )
            continue
        # a deliberate stop (hq worker stop, idle/time limit) restarts the
        # task without charging its crash counter (reference CrashLimit)
        if was_running and not worker.clean_stop and task.crashed():
            task.state = TaskState.FAILED
            _propagate_failure(core, events, task, "worker lost too many times")
            continue
        if was_running:
            events.on_task_restarted(task_id)
        task.state = TaskState.WAITING
        _make_ready(core, task)
    if worker.mn_task:
        task = core.tasks.get(worker.mn_task)
        if task is not None and not task.is_done:
            if (
                task.state is TaskState.RUNNING
                and task.mn_workers
                and worker_id != task.mn_workers[0]
            ):
                # non-root member lost while RUNNING: the task keeps running
                # on the root — the user's launcher inside the task decides
                # what a dead node means (reference reactor.rs
                # RunningMultiNode ws.retain; CHANGELOG v0.25.1)
                task.mn_workers = tuple(
                    w for w in task.mn_workers if w != worker_id
                )
            else:
                _teardown_gang(core, comm, events, task,
                               lost_worker=worker_id,
                               clean=worker.clean_stop)
    comm.ask_for_scheduling()


def _teardown_gang(
    core: Core, comm: Comm, events: EventSink, task: Task, lost_worker: int,
    clean: bool = False
) -> None:
    root = task.mn_workers[0] if task.mn_workers else 0
    core.bump_membership()
    for wid in task.mn_workers:
        w = core.workers.get(wid)
        if w is not None:
            w.mn_task = 0
            # cancel on surviving workers for ASSIGNED too: the compute
            # message may already be in flight to the root even though
            # task_running has not come back yet; worker-side cancel of an
            # unknown task id is a no-op, so this is always safe
            if wid != lost_worker and task.state in (
                TaskState.ASSIGNED,
                TaskState.RUNNING,
            ):
                comm.send_cancel(wid, [task.task_id])
    task.mn_workers = ()
    task.increment_instance()
    if lost_worker == root and task.state is TaskState.RUNNING:
        if task.never_restart:
            task.state = TaskState.FAILED
            _propagate_failure(
                core, events, task,
                "task was running on a lost worker while never-restart was "
                "set",
            )
            return
        if not clean and task.crashed():
            task.state = TaskState.FAILED
            _propagate_failure(
                core, events, task, "gang root lost too many times"
            )
            return
    if task.state is TaskState.RUNNING:
        events.on_task_restarted(task.task_id)
    task.state = TaskState.WAITING
    _make_ready(core, task)


def on_task_reattached(
    core: Core, events: EventSink, task: Task, worker: Worker
) -> None:
    """A reconnecting worker claimed a restored maybe-running task.

    The task was held out of the queues by restore (server.reattach_pending)
    with its pre-crash instance id and chosen variant preserved; the worker
    proved it still runs that exact incarnation, so it is attached to the
    new worker record as RUNNING — no requeue, no crash-counter charge, no
    instance bump (the worker's in-flight completion message must still
    match)."""
    task.state = TaskState.RUNNING
    task.assigned_worker = worker.worker_id
    if not task.t_started:
        # restore pre-seeds t_started from the journal's task-started time;
        # a reattach must NOT restart the clock — the task kept running
        # through the outage and its timeline is one unbroken span
        task.t_started = clock.now()
    worker.assign(
        task.task_id,
        core.variant_amounts(task.rq_id, task.assigned_variant, worker),
    )
    events.on_task_started(
        task.task_id, task.instance_id, [worker.worker_id],
        task.assigned_variant,
    )


def requeue_reattach_expired(core: Core, comm: Comm, task: Task) -> None:
    """No worker reclaimed this restored maybe-running task within the
    reattach window: fence out the (presumed dead) pre-crash incarnation,
    then queue it like any other ready task. The fence jumps to this
    boot's generation base — the crashed boot may have requeued/restarted
    the task past the journaled instance inside its lost tail, so a plain
    +1 could collide with an incarnation that still runs somewhere. No
    crash-counter charge — a server restart is not the task's fault."""
    task.fence_instance(core.instance_fence_floor)
    task.state = TaskState.WAITING
    _make_ready(core, task)
    comm.ask_for_scheduling()


def on_task_running(
    core: Core, events: EventSink, task_id: int, instance_id: int,
    wtrace: dict | None = None
) -> None:
    task = core.tasks.get(task_id)
    if task is None or task.instance_id != instance_id or task.is_done:
        return  # stale message from a previous incarnation
    if task.state is TaskState.ASSIGNED:
        if task.prefilled:
            # the prefilled task actually started: account its resources now
            worker = core.workers.get(task.assigned_worker)
            if worker is not None:
                worker.prefilled_tasks.discard(task_id)
                worker.assign(
                    task_id,
                    core.variant_amounts(
                        task.rq_id, task.assigned_variant, worker
                    ),
                )
            task.prefilled = False
            task.retract_pending = False
        task.state = TaskState.RUNNING
        task.t_started = clock.now()
        workers = list(task.mn_workers) or [task.assigned_worker]
        events.on_task_started(
            task_id, instance_id, workers, task.assigned_variant,
            wtrace=wtrace,
        )


def on_task_finished(
    core: Core, comm: Comm, events: EventSink, task_id: int, instance_id: int,
    wtrace: dict | None = None
) -> None:
    task = core.tasks.get(task_id)
    if task is None or task.instance_id != instance_id or task.is_done:
        return
    _release_task_resources(core, task)
    task.state = TaskState.FINISHED
    events.on_task_finished(task_id, wtrace=wtrace)
    for consumer_id in sorted(task.consumers):
        consumer = core.tasks.get(consumer_id)
        if consumer is None or consumer.state is not TaskState.WAITING:
            continue
        consumer.unfinished_deps -= 1
        if consumer.unfinished_deps == 0:
            _make_ready(core, consumer)
    task.consumers.clear()
    comm.ask_for_scheduling()


def on_task_failed(
    core: Core,
    comm: Comm,
    events: EventSink,
    task_id: int,
    instance_id: int,
    message: str,
    wtrace: dict | None = None,
) -> None:
    task = core.tasks.get(task_id)
    if task is None or task.instance_id != instance_id or task.is_done:
        return
    _release_task_resources(core, task)
    task.state = TaskState.FAILED
    _propagate_failure(core, events, task, message, wtrace=wtrace)
    comm.ask_for_scheduling()


def _propagate_failure(
    core: Core, events: EventSink, task: Task, message: str,
    wtrace: dict | None = None
) -> None:
    """Fail the task and transitively cancel waiting consumers."""
    events.on_task_failed(task.task_id, message, wtrace=wtrace)
    stack = sorted(task.consumers)
    task.consumers.clear()
    while stack:
        tid = stack.pop()
        consumer = core.tasks.get(tid)
        if consumer is None or consumer.is_done:
            continue
        consumer.state = TaskState.CANCELED
        events.on_task_canceled(tid)
        stack.extend(sorted(consumer.consumers))
        consumer.consumers.clear()


def on_cancel_tasks(
    core: Core, comm: Comm, events: EventSink, task_ids: list[int]
) -> list[int]:
    """Cancel tasks (and transitively their consumers). Returns ids actually
    canceled. Reference reactor.rs:706."""
    canceled: list[int] = []
    stack = list(task_ids)
    per_worker: dict[int, list[int]] = {}
    while stack:
        tid = stack.pop()
        task = core.tasks.get(tid)
        if task is None or task.is_done:
            continue
        stack.extend(sorted(task.consumers))
        task.consumers.clear()
        if task.state is TaskState.READY:
            held = core.paused_held.get(task_id_job(tid))
            if held is not None and tid in held:
                held.discard(tid)  # paused: held out of the queues
            else:
                rqv = core.rq_map.get_variants(task.rq_id)
                if rqv.is_multi_node:
                    if tid in core.mn_queue:
                        core.mn_queue.remove(tid)
                    _clear_mn_reservations(core, tid)
                else:
                    core.queues.remove(task.rq_id, tid)
        elif task.state in (TaskState.ASSIGNED, TaskState.RUNNING):
            notify = list(task.mn_workers) or [task.assigned_worker]
            _release_task_resources(core, task)
            for wid in notify:
                if wid:
                    per_worker.setdefault(wid, []).append(tid)
        task.state = TaskState.CANCELED
        events.on_task_canceled(tid)
        canceled.append(tid)
    for wid, tids in per_worker.items():
        comm.send_cancel(wid, tids)
    if canceled:
        comm.ask_for_scheduling()
    return canceled


def _release_task_resources(core: Core, task: Task) -> None:
    if task.mn_workers:
        core.bump_membership()
        for wid in task.mn_workers:
            w = core.workers.get(wid)
            if w is not None:
                w.mn_task = 0
        task.mn_workers = ()
        return
    worker = core.workers.get(task.assigned_worker)
    if worker is not None:
        if task.prefilled:
            worker.prefilled_tasks.discard(task.task_id)
            task.prefilled = False
            task.retract_pending = False
        elif task.task_id in worker.assigned_tasks:
            amounts = core.variant_amounts(
                task.rq_id, task.assigned_variant, worker
            )
            worker.unassign(task.task_id, amounts)
    task.assigned_worker = 0


def _mn_member_eligible(worker: Worker, req) -> bool:
    """Can this worker serve as a gang member for `req`?

    Reference worker.rs:273-344 (is_capable_to_run): remaining lifetime must
    cover the request's min_time; resource entries (absent on reference mn
    requests, permitted here) must fit the empty worker.
    """
    if worker.lifetime_secs() < req.min_time_secs:
        return False
    for entry in req.entries:
        if worker.resources.amount(entry.resource_id) < entry.amount:
            return False
    return True


def _rqv_fit_count(resources, rqv) -> int:
    """How many tasks of this request class the worker could run AT ONCE
    on empty resources — the best variant's min over entries of
    pool // amount. ALL-policy entries (amount 0) take a whole pool:
    count 1. Used to bound displacement retraction to what a worker
    could plausibly absorb from the displacing batch."""
    best = 0
    for req in rqv.variants:
        fit: int | None = None
        for entry in req.entries:
            if entry.amount <= 0:
                fit = 1
                break
            count = resources.amount(entry.resource_id) // entry.amount
            fit = count if fit is None else min(fit, count)
        if fit is None:
            # no resource entries: bounded only by the task-count slots
            fit = resources.task_max_count()
        best = max(best, fit)
    return max(best, 1)


def _top_sn_priority(core: Core) -> Priority_t | None:
    """Highest priority among ready single-node tasks that at least one
    worker is capable of running (an unschedulable high-priority task must
    not suppress gang reservations forever)."""
    best: Priority_t | None = None
    for rq_id, queue in core.queues.items():
        sizes = queue.priority_sizes()
        if not sizes or (best is not None and sizes[0][0] <= best):
            continue
        rqv = core.rq_map.get_variants(rq_id)
        if any(
            w.resources.is_capable_of_rqv(rqv) for w in core.workers.values()
        ):
            best = sizes[0][0]
    return best


def _sn_runnable_on(core: Core, above_user_priority: int, workers) -> bool:
    """Is some ready single-node class with user priority strictly above
    `above_user_priority` runnable on one of these (idle) workers right
    now? (User-priority comparison only — the tuple's second component is
    -job_id and an older job must not permanently outrank a gang.)"""
    for rq_id, queue in core.queues.items():
        sizes = queue.priority_sizes()
        if not any(p[0] > above_user_priority for p, n in sizes if n > 0):
            continue
        rqv = core.rq_map.get_variants(rq_id)
        if any(w.resources.is_capable_of_rqv(rqv) for w in workers):
            return True
    return False


def _clear_mn_reservations(core: Core, task_id: int) -> None:
    for w in core.workers.values():
        if w.mn_reserved == task_id:
            w.mn_reserved = 0
            core.bump_membership()


def _apply_fused_gangs(
    core: Core, mapped, per_worker_msgs: dict, now: float
) -> tuple[list, int]:
    """Apply the gang sentinel assignments (variant == -1) a fused solve
    emitted, validating against CURRENT state — a pipelined solve maps one
    tick late, so a member may have been claimed, drained or disconnected
    while the solve was in flight; the whole gang is then dropped and
    retried next tick (it is still in core.mn_queue).

    Returns (the non-gang assignments, gangs applied)."""
    gang_cells: dict[int, list[int]] = {}
    sn = []
    for a in mapped:
        if a[3] == -1:
            gang_cells.setdefault(a[0], []).append(a[1])
        else:
            sn.append(a)
    n_gangs = 0
    for task_id, member_ids in gang_cells.items():
        task = core.tasks.get(task_id)
        if task is None or task.is_done or task_id not in core.mn_queue:
            continue
        rqv = core.rq_map.get_variants(task.rq_id)
        n_nodes = rqv.variants[0].n_nodes
        members = [core.workers.get(wid) for wid in member_ids]
        if len(members) != n_nodes or any(
            w is None or w.mn_task or w.draining or not w.is_idle()
            for w in members
        ):
            continue  # stale solve: the gang retries next tick
        core.mn_queue.remove(task_id)
        core.bump_membership()
        for w in members:
            w.mn_task = task_id
        task.mn_workers = tuple(w.worker_id for w in members)
        task.state = TaskState.ASSIGNED
        task.t_assigned = now
        root = members[0]
        msg = _compute_message(core, task, variant=0)
        msg["node_ids"] = list(task.mn_workers)
        msg["node_hostnames"] = [
            core.workers[wid].configuration.hostname
            for wid in task.mn_workers
        ]
        per_worker_msgs.setdefault(root.worker_id, []).append(msg)
        n_gangs += 1
    if n_gangs:
        _SOLVE_GANG_GROUPS.inc(n_gangs)
    return sn, n_gangs


def schedule(
    core: Core, comm: Comm, events: EventSink, model, prefill: bool = True
) -> int:
    """Run one scheduling tick: gangs first (host-side), then the dense solve.

    Returns the number of tasks assigned (prefilled tasks not counted).
    Reference scheduler/main.rs:48 (run_scheduling = batches -> solver ->
    mapping -> send). `prefill=False` disables proactive filling (used by
    deterministic scheduler tests).
    """
    assigned = 0
    prefilled = 0
    gang_assigned = 0
    per_worker_msgs: dict[int, list[dict]] = {}
    # per-phase latency breakdown of THIS tick (ms), recorded into
    # core.tick_stats at the end and surfaced via `hq server stats`
    phases: dict = {}
    _t_tick = _time.perf_counter()
    # one wall-clock stamp per tick: every task assigned this tick shares it
    # (the timeline's resolution is the tick itself)
    now = clock.now()
    # DecisionRecord collection (scheduler/decision.py + utils/flight.py):
    # gang_unplaced gathers per-gang reasons during the gang phase,
    # decision_info receives the solver verdict from run_tick, and the
    # leftover classification runs once at the end of the tick
    record_decision = core.flight.enabled
    gang_unplaced: list[dict] = []
    decision_info: dict = {}

    # --- multi-node gangs: all-or-nothing N eligible workers from one
    # group.  Per-member eligibility matches the reference's
    # is_capable_to_run_rqv (worker.rs:273-344): enough remaining lifetime
    # for the request's min_time (mn entries are ignored by design, like the
    # reference; if present they are checked too).  A gang that cannot be
    # placed yet RESERVES workers so they drain (see Worker.mn_reserved) —
    # unless strictly-higher-priority sn work is still pending, which keeps
    # the reference's priority interleaving (the MILP schedules higher
    # classes first and only blocks lower ones, solver.rs:479-518). ---
    _t_phase = _time.perf_counter()
    # fused mode (--scheduler greedy-fused): gangs become all-or-nothing
    # column groups INSIDE the dense solve instead of this host phase —
    # but only when the dense snapshot can serve the tick (tick_cache
    # refuses min-utilization workers; the scratch/mu path keeps the host
    # gang semantics)
    fused_tick = core.fused_solve and not any(
        w.configuration.min_utilization > 0.001
        for w in core.workers.values()
        if not (w.mn_task or w.mn_reserved or w.draining)
    )
    if core.mn_queue and not fused_tick:
        top_sn = _top_sn_priority(core)
        remaining_mn = []
        for task_id in core.mn_queue:
            task = core.tasks.get(task_id)
            if task is None or task.is_done:
                _clear_mn_reservations(core, task_id)
                continue
            rqv = core.rq_map.get_variants(task.rq_id)
            req = rqv.variants[0]
            n_nodes = req.n_nodes
            groups: dict[str, list[Worker]] = {}
            for w in core.workers.values():
                if w.mn_task or w.mn_reserved not in (0, task_id):
                    continue
                if w.draining or not _mn_member_eligible(w, req):
                    continue
                groups.setdefault(w.group, []).append(w)
            chosen: list[Worker] | None = None
            for members in groups.values():
                idle = [w for w in members if w.is_idle()]
                if len(idle) >= n_nodes:
                    # prefer the workers already drained for this gang so
                    # other reservations lift as soon as possible
                    idle.sort(
                        key=lambda w: (w.mn_reserved != task_id, w.worker_id)
                    )
                    chosen = idle[:n_nodes]
                    break
            deferred_for_sn = False
            if (
                chosen is not None
                and top_sn is not None
                and top_sn[0] > task.priority[0]
                and _sn_runnable_on(core, task.priority[0], chosen)
            ):
                # strictly-higher-priority single-node work can use these
                # workers: it goes first this tick (the reference MILP
                # blocks the gang the same way, solver.rs:479-518); the
                # gang retries on what the sn solve leaves idle
                chosen = None
                deferred_for_sn = True
            if chosen is None:
                remaining_mn.append(task_id)
                if record_decision:
                    if deferred_for_sn:
                        # the gang WAS placeable: the solver deferred it
                        # behind higher-priority single-node work, which is
                        # not a group shortfall
                        reason = decision_mod.REASON_SOLVER_DEFERRED
                        detail = (
                            f"{n_nodes} idle same-group workers are "
                            "available, but strictly-higher-priority "
                            "single-node work goes first this tick"
                        )
                    else:
                        best = max(groups.values(), key=len, default=None)
                        n_idle = (
                            sum(1 for w in best if w.is_idle())
                            if best else 0
                        )
                        reason = decision_mod.REASON_GANG_INCOMPLETE
                        detail = (
                            f"needs {n_nodes} idle same-group workers; "
                            f"largest eligible group has "
                            f"{len(best) if best else 0} "
                            f"({n_idle} idle)"
                        )
                    gang_unplaced.append({
                        "rq_id": task.rq_id,
                        "job": task_id_job(task_id),
                        "task": task_id_task(task_id),
                        "priority": task.priority[0],
                        "count": 1,
                        "reason": reason,
                        "detail": detail,
                    })
                # user-priority comparison only: the scheduler component of
                # the tuple is -job_id, and an older sn job must not
                # strictly outrank a same-user-priority gang forever
                if top_sn is not None and top_sn[0] > task.priority[0]:
                    # higher-priority sn work outranks this gang; do not
                    # hold workers hostage for it yet
                    _clear_mn_reservations(core, task_id)
                    continue
                # reserve (and start draining) n_nodes eligible workers in
                # the group closest to satisfying the gang
                best = max(groups.values(), key=len, default=None)
                if best is None or len(best) < n_nodes:
                    # no group can currently host the gang at all; release
                    # any stale reservations rather than wedging workers
                    _clear_mn_reservations(core, task_id)
                    continue
                best.sort(
                    key=lambda w: (
                        not w.is_idle(),
                        len(w.assigned_tasks) + len(w.prefilled_tasks),
                        w.worker_id,
                    )
                )
                target = {w.worker_id for w in best[:n_nodes]}
                for w in core.workers.values():
                    if w.mn_reserved == task_id and w.worker_id not in target:
                        w.mn_reserved = 0
                        core.bump_membership()
                for w in best[:n_nodes]:
                    newly_reserved = w.mn_reserved != task_id
                    if newly_reserved:
                        core.bump_membership()
                    w.mn_reserved = task_id
                    if newly_reserved and w.prefilled_tasks:
                        # steal the queued backlog back so the drain is
                        # bounded by the currently-running tasks only (sent
                        # once per reservation, not per tick); mark pending
                        # or on_retract_response drops the answers
                        refs = []
                        for tid in sorted(w.prefilled_tasks):
                            victim = core.tasks[tid]
                            if victim.retract_pending:
                                continue  # an earlier retract already covers it
                            victim.retract_pending = True
                            refs.append((tid, victim.instance_id))
                        if refs:
                            _RETRACTED_TOTAL.labels("gang-drain").inc(
                                len(refs)
                            )
                            comm.send_retract(w.worker_id, refs)
                continue
            _clear_mn_reservations(core, task_id)
            core.bump_membership()
            for w in chosen:
                w.mn_task = task_id
            task.mn_workers = tuple(w.worker_id for w in chosen)
            task.state = TaskState.ASSIGNED
            task.t_assigned = now
            root = chosen[0]
            msg = _compute_message(core, task, variant=0)
            msg["node_ids"] = list(task.mn_workers)
            msg["node_hostnames"] = [
                core.workers[wid].configuration.hostname
                for wid in task.mn_workers
            ]
            per_worker_msgs.setdefault(root.worker_id, []).append(msg)
            assigned += 1
            gang_assigned += 1
        core.mn_queue = remaining_mn
        phases["gangs"] = (_time.perf_counter() - _t_phase) * 1e3
        TRACER.record("scheduler/gangs", _time.perf_counter() - _t_phase)

    # --- fused gangs: the head of the mn queue rides the dense solve as
    # all-or-nothing gang rows (scheduler/tick.py Batch.gang_nodes; kernel
    # semantics in ops/assign.py scan_batches).  Tasks STAY in mn_queue
    # until their sentinel assignments come back and validate — a stale
    # pipelined solve simply drops its gang and the next tick retries. ---
    fused_gang_batches: list[Batch] = []
    if fused_tick and core.mn_queue:
        remaining_mn = []
        for task_id in core.mn_queue:
            task = core.tasks.get(task_id)
            if task is None or task.is_done:
                _clear_mn_reservations(core, task_id)
                continue
            remaining_mn.append(task_id)
            if len(fused_gang_batches) < MAX_FUSED_GANG_ROWS:
                # fused mode never reserves: lift any reservation left
                # over from a host-phase tick so the workers rejoin the
                # dense row set
                _clear_mn_reservations(core, task_id)
                rqv = core.rq_map.get_variants(task.rq_id)
                fused_gang_batches.append(Batch(
                    rq_id=task.rq_id, priority=task.priority, size=1,
                    gang_task=task_id,
                    gang_nodes=rqv.variants[0].n_nodes,
                ))
        core.mn_queue = remaining_mn
        phases["gangs"] = (_time.perf_counter() - _t_phase) * 1e3

    # Soft drain for fused gangs: the kernel holds members WITHIN one
    # solve, but between ticks the prefill phase would keep piling backlog
    # onto the busy members a waiting gang needs (the host phase used the
    # mn_reserved drain for this).  Mark each pending gang's best-group
    # candidate set prefill-exempt instead — no membership change, so the
    # rows stay in the dense solve for the gang row to take.  Mirrors the
    # host interleave: a gang outranked by strictly-higher-priority ready
    # single-node work holds nothing yet.
    fused_gang_hold: set[int] = set()
    if fused_gang_batches:
        top_sn = _top_sn_priority(core)
        for gb in fused_gang_batches:
            if top_sn is not None and top_sn[0] > gb.priority[0]:
                continue
            req = core.rq_map.get_variants(gb.rq_id).variants[0]
            groups: dict[str, list[Worker]] = {}
            for w in core.workers.values():
                if (
                    w.mn_task
                    or w.draining
                    or w.worker_id in fused_gang_hold
                    or not _mn_member_eligible(w, req)
                ):
                    continue
                groups.setdefault(w.group, []).append(w)
            best = max(groups.values(), key=len, default=None)
            if best is None or len(best) < gb.gang_nodes:
                continue
            best.sort(key=lambda w: (
                not w.is_idle(),
                len(w.assigned_tasks) + len(w.prefilled_tasks),
                w.worker_id,
            ))
            fused_gang_hold.update(w.worker_id for w in best[:gb.gang_nodes])

    # --- single-node: dense solve ---
    # Batches are built ONCE per schedule(): run_tick consumes this list,
    # and the prefill phase below reuses it with per-batch taken counts
    # subtracted (the queues see no other mutation in between), instead of
    # re-walking every queue's priority levels two more times (measurable
    # host work at 1k queues x 32 cuts).
    #
    # The dense snapshot is INCREMENTAL: tick_cache.sync applies
    # dirty-tracking deltas to persistent (W, R) arrays instead of
    # rebuilding WorkerRows (sync must run AFTER the gang phase — gang
    # reservations above change row membership).  The cache refuses ticks
    # with min-utilization workers; those fall back to the from-scratch
    # WorkerRow path, whose mu carve-out needs per-worker floors.
    core.tick_counter += 1
    # --- pipelined tick (scheduler/pipeline.py): map the solve dispatched
    # LAST tick first — its device execution overlapped all the host work
    # since then, so the readback is usually free.  This must happen before
    # tick_cache.sync: applying the mapped assignments dirties the worker
    # rows, and the snapshot this tick dispatches from has to include them
    # (the device already does, via the donated free_after).  `--paranoid-
    # tick` ticks force the synchronous path: the pending solve is drained
    # here and the fresh solve below runs sync + bit-checked. ---
    pipeline = core.tick_pipeline
    paranoid_now = (
        core.paranoid_tick > 0
        and core.tick_counter % core.paranoid_tick == 0
    )
    if pipeline is not None and pipeline.pending is not None:
        decision_target = decision_info if record_decision else None
        mapped = (
            pipeline.drain(model=model, phases=phases,
                           decision=decision_target)
            if paranoid_now
            else pipeline.take_result(model=model, phases=phases,
                                      decision=decision_target)
        )
        mapped, n_gangs = _apply_fused_gangs(core, mapped, per_worker_msgs, now)
        assigned += n_gangs
        gang_assigned += n_gangs
        for task_id, worker_id, rq_id, variant in mapped:
            task = core.tasks.get(task_id)
            if task is None:
                continue  # vanished while the solve was in flight
            worker = core.workers.get(worker_id)
            if worker is None:
                # its worker disconnected while the solve was in flight:
                # back to the queue, a later tick re-places it
                core.queues.add(rq_id, task.priority, task_id)
                continue
            task.state = TaskState.ASSIGNED
            task.t_assigned = now
            task.assigned_worker = worker_id
            task.assigned_variant = variant
            worker.assign(
                task_id, core.variant_amounts(rq_id, variant, worker)
            )
            per_worker_msgs.setdefault(worker_id, []).append(
                _compute_message(core, task, variant)
            )
            assigned += 1
    snapshot = core.tick_cache.sync(core)
    rows = core.worker_rows() if snapshot is None else None
    leftover_batches = None
    _t_phase = _time.perf_counter()
    have_workers = (
        bool(snapshot.worker_ids) if snapshot is not None else bool(rows)
    )
    run_gangs_fused = bool(fused_gang_batches) and snapshot is not None
    placed_blevel: dict[int, int] | None = None
    policy_ctx = None
    fairness_placed: tuple | None = None
    if have_workers and (core.queues.total_ready() or run_gangs_fused):
        _t_batches = _time.perf_counter()
        batches = create_batches(core.queues)
        gang_ok = group_ids = None
        if run_gangs_fused:
            batches = batches + fused_gang_batches
            # worker-side gang inputs, aligned to the snapshot rows: host
            # idleness (prefilled backlog does not show in `free`, so the
            # kernel cannot derive it) and the worker-group index map
            gmap: dict[str, int] = {}
            gang_ok = []
            group_ids = []
            for wid in snapshot.worker_ids:
                w = core.workers[wid]
                gang_ok.append(1 if w.is_idle() else 0)
                group_ids.append(gmap.setdefault(w.group, len(gmap)))
        phases["batches"] = (_time.perf_counter() - _t_batches) * 1e3
        if core.policy is not None:
            # weighted objective (--policy-file): resolve this tick's
            # affinity rows + priority boosts against the tick's worker
            # order — the dense snapshot's worker_ids when the cache
            # served, else the row list order (run_tick only reorders
            # workers on the mu path, which strips the rows itself and
            # keeps the alignment-free boosts).
            wids = (
                snapshot.worker_ids if snapshot is not None
                else [r.worker_id for r in rows]
            )
            policy_ctx = core.policy.tick_context(
                core.workers, core.rq_map, core.resource_map,
                wids, batches,
            )
        if snapshot is not None and paranoid_now:
            from hyperqueue_tpu_torch.scheduler.tick_cache import paranoid_check

            paranoid_check(
                core, snapshot, batches, core.rq_map, core.resource_map,
                gang_ok=gang_ok, group_ids=group_ids, policy=policy_ctx,
            )
        pipeline_this_tick = (
            pipeline
            if pipeline is not None and not paranoid_now
            and snapshot is not None
            else None
        )
        if (
            pipeline_this_tick is not None
            and pipeline_this_tick.idle_sig is not None
            and pipeline_this_tick.idle_sig == (
                core.membership_epoch, core.queues.version,
                core.queues.total_ready(),
            )
            and core.tick_cache.rows_rewritten_last == 0
        ):
            # the last pipelined solve mapped NOTHING and no queue
            # mutation, membership change or worker-row drift happened
            # since it was dispatched: a re-solve would see bit-identical
            # inputs and assign nothing again.  Skip the dispatch — with
            # no pending solve the end-of-tick self-request stays off, so
            # an unplaceable backlog costs one extra tick instead of
            # spinning at the min-delay cadence until the next event.
            assignments = []
        else:
            assignments = run_tick(
                core.queues, rows, core.rq_map, core.resource_map, model,
                batches=batches, dense=snapshot, phases=phases,
                key_cache=core.tick_cache,
                decision=decision_info if record_decision else None,
                pipeline=pipeline_this_tick,
                gang_ok=gang_ok, group_ids=group_ids, policy=policy_ctx,
            )
            if (
                pipeline_this_tick is not None
                and pipeline_this_tick.pending is not None
            ):
                # stamp the solve-input state so an EMPTY mapping next tick
                # can prove a re-solve redundant (PendingSolve.state_sig)
                pipeline_this_tick.pending.state_sig = (
                    core.membership_epoch, core.queues.version,
                    core.queues.total_ready(),
                )
        if run_gangs_fused:
            assignments, n_gangs = _apply_fused_gangs(
                core, assignments, per_worker_msgs, now
            )
            assigned += n_gangs
            gang_assigned += n_gangs
        taken_by_batch: dict[tuple[int, Priority_t], int] = {}
        for task_id, worker_id, rq_id, variant in assignments:
            task = core.tasks[task_id]
            worker = core.workers[worker_id]
            task.state = TaskState.ASSIGNED
            task.t_assigned = now
            task.assigned_worker = worker_id
            task.assigned_variant = variant
            worker.assign(
                task_id, core.variant_amounts(rq_id, variant, worker)
            )
            per_worker_msgs.setdefault(worker_id, []).append(
                _compute_message(core, task, variant)
            )
            assigned += 1
            key = (rq_id, task.priority)
            taken_by_batch[key] = taken_by_batch.get(key, 0) + 1
        leftover_batches = []
        for batch in batches:
            if batch.gang_nodes:
                continue  # gang rows never feed prefill/displacement
            batch.size -= taken_by_batch.get(
                (batch.rq_id, batch.priority), 0
            )
            if batch.size > 0:
                leftover_batches.append(batch)
        if record_decision:
            # per-job max b-level among the batches that PLACED work this
            # tick: a same-job leftover with a shallower critical path was
            # deliberately held behind deeper work (lookahead-held)
            placed_blevel = {}
            for (_rq, prio), _n in taken_by_batch.items():
                if prio[1] <= -BLEVEL_STRIDE:
                    j = decode_sched_job(prio[1])
                    bl = decode_sched_blevel(prio[1])
                    if bl > placed_blevel.get(j, -1):
                        placed_blevel[j] = bl
            if policy_ctx is not None and policy_ctx.boosts:
                # lowest original priority among placed batches of
                # fairness/prediction-boosted jobs: a leftover class whose
                # own priority sits ABOVE it was overtaken by the boost
                # (decision.build_unplaced_entries fairness-deferred)
                for (_rq, prio), _n in taken_by_batch.items():
                    if policy_ctx.boost_for_sched(prio[1]) > 0:
                        t = tuple(prio)
                        if fairness_placed is None or t < fairness_placed:
                            fairness_placed = t
            if run_gangs_fused:
                still_waiting = set(core.mn_queue)
                for gb in fused_gang_batches:
                    if gb.gang_task not in still_waiting:
                        continue
                    per_group: dict[str, int] = {}
                    for w in core.workers.values():
                        if w.mn_task or w.draining:
                            continue
                        per_group[w.group] = per_group.get(w.group, 0) + 1
                    feasible = (
                        max(per_group.values(), default=0) >= gb.gang_nodes
                    )
                    reason = (
                        decision_mod.REASON_GANG_GROUP_DEFERRED
                        if feasible
                        else decision_mod.REASON_GANG_INCOMPLETE
                    )
                    gang_unplaced.append({
                        "rq_id": gb.rq_id,
                        "job": task_id_job(gb.gang_task),
                        "task": task_id_task(gb.gang_task),
                        "priority": gb.priority[0],
                        "count": 1,
                        "reason": reason,
                        "detail": (
                            f"fused solve held {gb.gang_nodes} group "
                            "members this tick (busy or taken by the "
                            "scan)" if feasible else
                            f"no group musters {gb.gang_nodes} eligible "
                            "members"
                        ),
                    })
        TRACER.record("scheduler/solve", _time.perf_counter() - _t_phase)

    # --- proactive prefilling: push extra top-priority tasks to busy
    # workers so short tasks pipeline without a server round-trip per task
    # (reference mapping.rs:159 process_proactive_filling, max 40/worker) ---
    _t_phase = _time.perf_counter()
    if prefill and core.queues.total_ready():
        budgets = {
            w.worker_id: PREFILL_MAX - len(w.prefilled_tasks)
            for w in core.workers.values()
            if not w.mn_task
            and not w.mn_reserved
            and not w.draining
            and w.worker_id not in fused_gang_hold
            and (w.assigned_tasks or w.prefilled_tasks)
            and len(w.prefilled_tasks) < PREFILL_MAX
        }
        # starvation guard (reference reservation vars, solver.rs:479-518):
        # each request class with leftover ready tasks reserves ONE capable
        # worker where strictly-lower-priority tasks may not prefill, so a
        # big task eventually sees a fully drained worker instead of losing
        # every race against streams of small tasks.
        if leftover_batches is None:
            leftover_batches = create_batches(core.queues)
        if policy_ctx is not None and policy_ctx.boosts:
            # the solve's boost-weighted order lives in run_tick's COPY of
            # the batch list; prefill consumes the caller's list, so fold
            # the same boost arithmetic here — under deep prefill budgets
            # this order, not the solve's ~capacity-sized mapping, decides
            # which job's backlog reaches the workers first
            leftover_batches.sort(key=lambda b: (
                b.priority[0],
                b.priority[1]
                + policy_ctx.boost_for_sched(b.priority[1]) * BLEVEL_STRIDE,
            ), reverse=True)
        reservations: dict[int, Priority_t] = {}
        for batch in leftover_batches:
            rqv = core.rq_map.get_variants(batch.rq_id)
            for w in sorted(core.workers.values(), key=lambda w: w.worker_id):
                if (
                    w.mn_task or w.mn_reserved or w.draining
                    or w.worker_id in reservations
                ):
                    continue
                if w.resources.is_capable_of_rqv(rqv):
                    reservations[w.worker_id] = batch.priority
                    break
        # prefill in GLOBAL priority order (batches are priority-sorted), so
        # high-priority classes claim worker budgets first; workers are fed
        # least-backlog-first so a deep budget cannot pile onto one worker
        # while its peers run dry between refills
        workers_by_backlog = sorted(
            core.workers.values(),
            key=lambda w: (
                len(w.prefilled_tasks) + len(w.assigned_tasks),
                w.worker_id,
            ),
        )
        for batch in leftover_batches:
            queue = core.queues.queue(batch.rq_id)
            rqv = core.rq_map.get_variants(batch.rq_id)
            eligible: list[tuple[Worker, int]] = []
            for worker in workers_by_backlog:
                if budgets.get(worker.worker_id, 0) <= 0:
                    continue
                blocking = reservations.get(worker.worker_id)
                if blocking is not None and batch.priority < blocking:
                    continue
                variant = next(
                    (
                        i
                        for i, v in enumerate(rqv.variants)
                        if worker.resources.is_capable_of(v)
                    ),
                    None,
                )
                if variant is None:
                    continue
                eligible.append((worker, variant))
            if not eligible:
                continue
            # fair-share split across eligible workers (multiple passes so
            # budget-capped workers' leftovers flow to the others); without
            # this a deep budget lets the first worker swallow the batch
            fair = max(-(-batch.size // len(eligible)), 1)
            progress = True
            while progress:
                progress = False
                for worker, variant in eligible:
                    budget = budgets.get(worker.worker_id, 0)
                    if budget <= 0:
                        continue
                    taken = queue.take(batch.priority, min(budget, fair))
                    if not taken:
                        break
                    progress = True
                    batch.size -= len(taken)  # keeps leftover sizes true
                    for task_id in taken:
                        task = core.tasks[task_id]
                        task.state = TaskState.ASSIGNED
                        task.t_assigned = now
                        task.assigned_worker = worker.worker_id
                        task.assigned_variant = variant
                        task.prefilled = True
                        prefilled += 1
                        worker.prefilled_tasks.add(task_id)
                        budgets[worker.worker_id] -= 1
                        per_worker_msgs.setdefault(
                            worker.worker_id, []
                        ).append(_compute_message(core, task, variant))

    # --- displacement: strictly-higher-user-priority READY work must not
    # sit in the queues while lower-priority prefilled backlog holds the
    # workers that could run it.  Retract the lowest-priority settled
    # victims; once they answer, the next tick prefills in global priority
    # order (reference redirects the prefilled task on submit,
    # test_reactor.rs test_prefill_submit_high_priority) ---
    if prefill and core.queues.total_ready():
        # per-worker victim lists are built ONCE (ascending priority, with
        # this tick's sends and in-flight retracts excluded), then consumed
        # across the batch loop — not rebuilt per (batch x worker).  The
        # common saturated case (all leftover and backlog at one user
        # priority) exits on the first victim comparison per worker.
        victim_lists: dict[int, list] = {}
        for worker in core.workers.values():
            if worker.mn_task or worker.mn_reserved:
                continue
            if not worker.prefilled_tasks:
                continue
            just_sent = {
                m["id"] for m in per_worker_msgs.get(worker.worker_id, ())
            }
            victims = sorted(
                (
                    core.tasks[tid]
                    for tid in worker.prefilled_tasks
                    if tid not in just_sent
                    and not core.tasks[tid].retract_pending
                ),
                key=lambda t: t.priority,
            )
            if victims:
                victims.reverse()  # pop() consumes lowest-priority first
                victim_lists[worker.worker_id] = victims
        if victim_lists:
            # leftover_batches already carries the post-solve post-prefill
            # sizes (both phases decrement batch.size) — no third
            # create_batches walk
            if leftover_batches is None:
                leftover_batches = create_batches(core.queues)
            retract_by_worker: dict[int, list[tuple[int, int]]] = {}
            # per-worker retract cap: one large leftover batch must not
            # strip every lower-priority prefilled task from every capable
            # worker in a single tick (far more than those workers could
            # run) — that just churns retract/re-prefill under deep
            # backlogs. Per displacing batch, a worker gives up at most
            # 2× the batch tasks it could simultaneously RUN (the extra
            # factor leaves backlog headroom), within a PREFILL_MAX
            # overall budget.
            retract_budget = {wid: PREFILL_MAX for wid in victim_lists}
            for batch in leftover_batches:
                if batch.size <= 0:
                    continue
                rqv = core.rq_map.get_variants(batch.rq_id)
                need = batch.size
                for worker_id, victims in victim_lists.items():
                    if need <= 0:
                        break
                    if not victims or retract_budget[worker_id] <= 0:
                        continue
                    worker = core.workers[worker_id]
                    if not worker.resources.is_capable_of_rqv(rqv):
                        continue
                    allowance = min(
                        retract_budget[worker_id],
                        2 * _rqv_fit_count(worker.resources, rqv),
                    )
                    while victims and need > 0 and allowance > 0:
                        if victims[-1].priority[0] >= batch.priority[0]:
                            break  # ascending: nothing lower remains
                        victim = victims.pop()
                        victim.retract_pending = True
                        retract_by_worker.setdefault(
                            worker_id, []
                        ).append((victim.task_id, victim.instance_id))
                        need -= 1
                        allowance -= 1
                        retract_budget[worker_id] -= 1
            for wid, refs in retract_by_worker.items():
                _RETRACTED_TOTAL.labels("displacement").inc(len(refs))
                comm.send_retract(wid, refs)

    # --- retract: steal prefilled backlog back from loaded workers
    # whenever idle capacity appears that the backlog could use — not only
    # when the queues are drained; under sustained arrivals the remaining
    # ready work may simply not fit the idle workers (reference runs this
    # check periodically on the worker, worker/rpc.rs:322; RetractTasks /
    # on_retract_response, reactor.rs:462) ---
    if prefill:
        idle = [
            w for w in core.workers.values()
            if w.is_idle()
            and not w.mn_reserved
            and not w.draining
            and w.worker_id not in per_worker_msgs
        ]
        if idle:
            donors = sorted(
                (w for w in core.workers.values() if w.prefilled_tasks),
                key=lambda w: -len(w.prefilled_tasks),
            )
            # per-class slot budget over CAPABLE idle workers only:
            # retracting a class toward slots that cannot host it would
            # churn the tasks straight back to the donor next tick
            class_slots: dict[int, int] = {}

            def slots_for(rq_id: int) -> int:
                slots = class_slots.get(rq_id)
                if slots is None:
                    rqv = core.rq_map.get_variants(rq_id)
                    slots = sum(
                        w.nt_free
                        for w in idle
                        if w.resources.is_capable_of_rqv(rqv)
                    )
                    class_slots[rq_id] = slots
                return slots

            for donor in donors:
                # tasks prefilled THIS tick have their compute message still
                # queued behind us; a retract would outrun it and no-op
                # (FIFO), so only settled, not-already-asked tasks qualify —
                # oldest first, they are at the worker's queue tail risk
                just_sent = {
                    m["id"] for m in per_worker_msgs.get(donor.worker_id, ())
                }
                victims = []
                budget = len(donor.prefilled_tasks) // 2
                for tid in sorted(donor.prefilled_tasks):
                    if len(victims) >= budget:
                        break
                    task = core.tasks[tid]
                    if tid in just_sent or task.retract_pending:
                        continue
                    if slots_for(task.rq_id) <= 0:
                        continue
                    class_slots[task.rq_id] -= 1
                    task.retract_pending = True
                    victims.append((tid, task.instance_id))
                if victims:
                    _RETRACTED_TOTAL.labels("rebalance").inc(len(victims))
                    comm.send_retract(donor.worker_id, victims)
        phases["prefill"] = (_time.perf_counter() - _t_phase) * 1e3
        TRACER.record("scheduler/prefill", _time.perf_counter() - _t_phase)

    for worker_id, msgs in per_worker_msgs.items():
        comm.send_compute(worker_id, msgs)

    # --- decision record: attribute everything this tick left unplaced
    # to a reason code (scheduler/decision.py) and push the record into
    # the flight recorder ring. Cost is O(leftover classes), never
    # O(tasks) — `phases["decide"]` makes any regression visible in the
    # same place the <=5% budget is enforced. ---
    record = None
    if record_decision:
        _t_phase = _time.perf_counter()
        try:
            # tick-local: only a solve that actually ran THIS tick can mark
            # it degraded (a stale flag from a previous tick must not leak)
            solver = decision_info.get("solver") or {"status": "idle"}
            degraded = solver["status"] in ("fallback", "skipped")
            unplaced = list(gang_unplaced)
            ready_left = core.queues.total_ready()
            if ready_left:
                if leftover_batches is None:
                    leftover_batches = create_batches(core.queues)
                unplaced.extend(decision_mod.build_unplaced_entries(
                    core, leftover_batches, {}, degraded=degraded,
                    placed_blevel=placed_blevel,
                    fairness_placed=fairness_placed,
                ))
            n_paused = 0
            for job_id, held in core.paused_held.items():
                if held:
                    n_paused += len(held)
                    unplaced.append({
                        "rq_id": None, "job": job_id, "priority": None,
                        "count": len(held),
                        "reason": decision_mod.REASON_QUEUE_PAUSED,
                    })
            record = {
                "tick": core.tick_counter,
                "time": now,
                "solver": solver,
                "counts": {
                    "workers": len(core.workers),
                    "assigned": assigned - gang_assigned,
                    "gang_assigned": gang_assigned,
                    "prefilled": prefilled,
                    "unplaced": sum(
                        e["count"] for e in unplaced
                        if e["reason"] != decision_mod.REASON_QUEUE_PAUSED
                    ),
                    "paused": n_paused,
                    "ready_left": ready_left,
                    "mn_waiting": len(core.mn_queue),
                },
                "unplaced": unplaced,
            }
        except Exception:  # noqa: BLE001 - explainability must never
            # take the scheduling loop down with it
            logger.exception("decision-record assembly failed; tick %d "
                             "goes unrecorded", core.tick_counter)
            record = None
        phases["decide"] = (_time.perf_counter() - _t_phase) * 1e3

    phases["total"] = (_time.perf_counter() - _t_tick) * 1e3
    core.tick_stats.record(phases)
    if core.policy is not None:
        # fairness/prediction telemetry: one ledger fold + two dict reads
        # per tick, surfaced as gauges and through `hq server stats`
        jain = core.policy.observe_jain()
        if jain is not None:
            _POLICY_JAIN.set(jain)
        if core.policy.predictor is not None:
            _POLICY_HIT_RATE.set(core.policy.predictor.hit_rate())
        _POLICY_BOOST_MAX.set(core.policy.last_boost_range[1])
    _TICKS_TOTAL.inc()
    if assigned:
        _ASSIGNED_TOTAL.inc(assigned)
    if prefilled:
        _PREFILLED_TOTAL.inc(prefilled)
    for name, ms in phases.items():
        _TICK_PHASE_SECONDS.labels(name).observe(ms / 1e3)
    if record is not None:
        record["duration_ms"] = round(phases["total"], 4)
        record["phases"] = {k: round(v, 4) for k, v in phases.items()}
        core.flight.record_tick(record)
    if pipeline is not None and pipeline.pending is not None:
        # a solve is in flight: without another event (submit, completion,
        # worker change) no further tick would run and the pending solve
        # would never be mapped — ask for one more pass.  The server's
        # schedule_min_delay throttle paces the follow-up, which doubles as
        # the window the device has to finish before the readback.
        comm.ask_for_scheduling()
    return assigned


def on_retract_response(
    core: Core, comm: Comm, task_id: int, ok: bool, instance_id: int
) -> None:
    """Worker answered a retract: ok=True means the task had not started and
    is back in our hands; requeue it for the next tick.

    instance_id is the echo of the instance named in the retract request —
    the same staleness token every other task message carries. A STALE
    response (the task was since requeued and re-prefilled, possibly even
    onto the same worker) carries an old instance and must not steal the
    task off its new placement while that placement's compute message is in
    flight (duplicate execution)."""
    task = core.tasks.get(task_id)
    if task is None or task.is_done or not task.prefilled:
        return
    if task.instance_id != instance_id:
        return  # answer about a previous incarnation
    if not task.retract_pending:
        return  # nothing asked
    task.retract_pending = False
    if not ok:
        return  # it started racing; task_running accounting takes over
    worker = core.workers.get(task.assigned_worker)
    if worker is not None:
        worker.prefilled_tasks.discard(task_id)
    task.prefilled = False
    task.assigned_worker = 0
    task.increment_instance()
    task.state = TaskState.WAITING
    _make_ready(core, task)
    comm.ask_for_scheduling()


def _compute_message(core: Core, task: Task, variant: int) -> dict:
    # entries/n_nodes depend only on (rq_id, variant) within a Core (rq
    # interning is append-only): cache on the Core instance — at 100k-task
    # arrays this is per-task hot path
    key = (task.rq_id, variant)
    cached = core.entries_cache.get(key)
    if cached is None:
        rqv = core.rq_map.get_variants(task.rq_id)
        request = rqv.variants[variant]
        entries = [
            {
                "name": core.resource_map.name_of(e.resource_id),
                "amount": e.amount,
                "policy": e.policy.value,
            }
            for e in request.entries
            # mask subcolumns (gpus#k) are server-side placement
            # constraints; workers only know physical resource names
            if not core.resource_map.is_masked(e.resource_id)
        ]
        cached = (entries, request.n_nodes)
        core.entries_cache[key] = cached
    entries, n_nodes = cached
    msg = {
        "id": task.task_id,
        "instance": task.instance_id,
        "body": task.body,
        "entries": entries,
        "n_nodes": n_nodes,
        "variant": variant,
        "priority": list(task.priority),
    }
    if task.entry is not None:
        msg["entry"] = task.entry
    # trace-context header: the worker stamps accept/launch/spawn clocks
    # against this id and echoes the parent span in its uplinks, so the
    # server-side trace assembly can link the hops causally (the cost on
    # the per-task dispatch path is one small dict)
    traces = core.traces
    if traces.enabled:
        ctx = traces.wire_ctx(task.task_id)
        if ctx is not None:
            attach_trace_wire(msg, ctx[0], ctx[1])
    return msg
