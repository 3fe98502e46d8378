"""Server process: the parts that feed and read the event journal.

The port's copy of the JAX package's `server/bootstrap.py`, so far its
durability plane: `CommSender` (the reactor's Comm), `EventBridge` (the
reactor's EventSink, which folds every task and worker event into the jobs
layer, the trace store, the usage ledger and the journal),
`Server.__init__` with the planes the port holds, `emit_event` and the
journal's group commit, `compact_journal` (snapshot + GC), the submit path
(`_client_submit`, lazy array chunks at or above `lazy_array_threshold`)
and the journal's open and close (`_open_journal`, `_close_journal`: the
journal blocks of the JAX `start()` and `stop()`).

The network planes, the loops, `start()` and the rest of `Server` come
with `hq server start` (ROADMAP Queue 1 item 8); `start()` raises until
then, and so does a constructor keyword whose plane is not here yet.

Reference: crates/hyperqueue/src/server/bootstrap.rs (init_hq_server).
The whole server is one asyncio event loop: state is mutated only from
reactor handlers running on this loop, so the scheduler snapshot needs no
locks.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import socket
import time
from pathlib import Path

from hyperqueue_tpu_torch.events.journal import Journal
from hyperqueue_tpu_torch.ids import task_id_job, task_id_task, make_task_id
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.models.milp import MilpModel
from hyperqueue_tpu_torch.models.multichip import MultichipModel
from hyperqueue_tpu_torch.server import reactor
from hyperqueue_tpu_torch.server.accounting import (
    ACCOUNTED_KINDS,
    AccountingLedger,
)
from hyperqueue_tpu_torch.server.core import Core
from hyperqueue_tpu_torch.server.jobs import JobManager, JobTaskInfo
from hyperqueue_tpu_torch.server.journal_plane import JournalPlane
from hyperqueue_tpu_torch.server.lazy import ArrayChunk
from hyperqueue_tpu_torch.server.protocol import rqv_from_wire, submit_record
from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.server.task import Task
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.server")

SCHEDULE_MIN_DELAY = 0.01  # seconds; reference msd: 500ms prod / 20ms in benches

# the item of ROADMAP Queue 1 that brings the rest of the server
_ITEM_8 = "ROADMAP Queue 1 item 8 (`hq server start`)"

_SUBSCRIBERS_DROPPED = REGISTRY.counter(
    "hq_subscribers_dropped_total",
    "subscribe-RPC consumers dropped because their bounded event queue "
    "overflowed (slow consumer)",
)
_SUB_EVENTS_DROPPED = REGISTRY.counter(
    "hq_sub_events_dropped_total",
    "events not delivered to subscribers whose queue had overflowed",
)
# queue-age distribution backing the queue-age SLO: how long each
# dispatched task sat READY before being assigned. Buckets stretch past the
# default latency decades — queue ages are minutes on a saturated cluster,
# not milliseconds.
_TASK_QUEUE_AGE = REGISTRY.histogram(
    "hq_task_queue_age_seconds",
    "ready -> assigned latency of dispatched tasks",
    buckets=(0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0,
             1800.0, 7200.0),
)


# reusable/stateless, so one instance serves every frame
_NOOP_BATCH = contextlib.nullcontext()


@contextlib.contextmanager
def _journal_batch(journal, fsync: bool, flush: bool):
    """One group-committed journal batch (see _journal_group_commit)."""
    journal.begin_batch()
    try:
        yield
    finally:
        if journal.commit_batch():
            if fsync:
                journal.flush(sync=True)
            elif flush:
                journal.flush()


class CommSender:
    """Per-worker outgoing queues + the scheduling wakeup flag.

    Reference: internal/server/comm.rs (CommSender) — unbounded channel per
    worker so the reactor never blocks on a slow connection.
    """

    def __init__(self):
        self._queues: dict[int, asyncio.Queue] = {}
        self.scheduling_event = asyncio.Event()

    def register_worker(self, worker_id: int) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._queues[worker_id] = q
        return q

    def unregister_worker(self, worker_id: int) -> None:
        self._queues.pop(worker_id, None)

    def _send(self, worker_id: int, message: dict) -> None:
        q = self._queues.get(worker_id)
        if q is not None:
            # the enqueue stamp feeds the fan-out plane's handoff-latency
            # probe (reactor enqueue -> frame on the wire)
            q.put_nowait((clock.monotonic(), message))

    # reactor.Comm protocol
    def send_compute(self, worker_id: int, tasks: list[dict]) -> None:
        # shared/separate split (reference messages/worker.rs:28-54
        # ComputeTasksMsg): tasks of one array share a body OBJECT, so an
        # identity dedup sends each distinct body once per message and the
        # tasks carry an index — at 512-task prefill batches this turns
        # ~512 serialized bodies into 1
        shared: list[dict] = []
        index: dict[int, int] = {}
        # trace ids dedup the same way: one submit's array shares ONE
        # trace id, so the frame carries it once and each task an index —
        # on the pure-python ChaCha fallback the 17-byte id string per
        # task was measurable encryption work at 512-task batches
        shared_traces: list = []
        trace_index: dict[str, int] = {}
        out = []
        for msg in tasks:
            body = msg.get("body")
            key = id(body)
            idx = index.get(key)
            if idx is None:
                idx = len(shared)
                index[key] = idx
                shared.append(body)
            slim = dict(msg)
            del slim["body"]
            slim["b"] = idx
            tr = slim.get("trace")
            if tr is not None:
                ti = trace_index.get(tr[0])
                if ti is None:
                    ti = len(shared_traces)
                    trace_index[tr[0]] = ti
                    shared_traces.append(tr[0])
                slim["trace"] = [ti, tr[1]]
            out.append(slim)
        payload = {"op": "compute", "tasks": out, "shared_bodies": shared}
        if shared_traces:
            payload["shared_traces"] = shared_traces
        self._send(worker_id, payload)

    def send_cancel(self, worker_id: int, task_ids: list[int]) -> None:
        self._send(worker_id, {"op": "cancel", "task_ids": task_ids})

    def send_retract(
        self, worker_id: int, task_refs: list[tuple[int, int]]
    ) -> None:
        self._send(
            worker_id,
            {"op": "retract", "tasks": [list(ref) for ref in task_refs]},
        )

    def send_stop(self, worker_id: int) -> None:
        self._send(worker_id, {"op": "stop"})

    def send_redirect(
        self, worker_id: int, to_shard: int, from_shard: int
    ) -> None:
        # federation worker lending: the worker re-registers with the
        # sibling shard dir (worker/runtime.py handles the op)
        self._send(
            worker_id,
            {"op": "redirect", "shard": to_shard, "from_shard": from_shard},
        )

    def send_overview_override(
        self, worker_id: int, interval: float | None
    ) -> None:
        self._send(
            worker_id, {"op": "set_overview_override", "interval": interval}
        )

    def broadcast_overview_override(self, interval: float | None) -> None:
        for worker_id in list(self._queues):
            self.send_overview_override(worker_id, interval)

    def ask_for_scheduling(self) -> None:
        self.scheduling_event.set()



class EventBridge:
    """reactor.EventSink -> jobs layer, trace store, usage ledger, journal
    and waiters."""

    def __init__(self, server: "Server"):
        self.server = server

    def _record_start_spans(
        self, task, task_id, instance_id, worker_ids, wtrace
    ) -> None:
        """Fold the worker's task_running stamps + the core task's
        lifecycle stamps into the trace store. Deduplicated on
        (span, instance), so a reattach re-reporting the same incarnation
        keeps ONE unbroken trace."""
        traces = self.server.core.traces
        if not traces.enabled or task is None:
            return
        wt = wtrace or {}
        wid = worker_ids[0] if worker_ids else 0
        parent = traces.last_span_id(task_id)
        if task.t_ready and task.t_assigned:
            parent = traces.span(
                task_id, "server/queue", task.t_ready, task.t_assigned,
                "server", instance_id, parent,
            ) or parent
        accepted = wt.get("accepted_at")
        if task.t_assigned and accepted:
            parent = traces.span(
                task_id, "server/dispatch", task.t_assigned, accepted,
                "server", instance_id, parent,
            ) or parent
        launch = wt.get("launch_at")
        if accepted and launch:
            parent = traces.span(
                task_id, "worker/accept", accepted, launch,
                f"worker:{wid}", instance_id, parent,
            ) or parent
        spawned = wt.get("spawned_at")
        if launch and spawned:
            traces.span(
                task_id, "worker/spawn", launch, spawned,
                f"worker:{wid}", instance_id, parent,
            )

    def _record_finish_spans(self, task_id, wtrace) -> None:
        """Completion-side spans (run / uplink / commit) from the worker's
        task_finished/task_failed stamps. The worker re-sends spawned_at so
        a trace whose start event died in a crashed server's lost journal
        tail still closes with the execution span intact."""
        traces = self.server.core.traces
        if not traces.enabled:
            return
        rec = traces.get(task_id)
        task = self.server.core.tasks.get(task_id)
        instance = task.instance_id if task else 0
        if rec is None and task is None:
            return
        wt = wtrace or {}
        now = clock.now()
        # the reactor released resources (assigned_worker = 0) before this
        # sink fires: the worker identity lives in the earlier worker spans
        wid = task.assigned_worker if task else 0
        if not wid and rec is not None:
            for s in reversed(rec["spans"]):
                if s["proc"].startswith("worker:"):
                    wid = s["proc"].partition(":")[2]
                    break
        parent = traces.last_span_id(task_id)
        spawned = wt.get("spawned_at") or (task.t_started if task else 0.0)
        exited = wt.get("exited_at")
        if spawned and exited:
            parent = traces.span(
                task_id, "worker/run", spawned, exited,
                f"worker:{wid}", instance, parent,
            ) or parent
        sent = wt.get("sent_at")
        if sent:
            parent = traces.span(
                task_id, "worker/uplink", sent, now,
                f"worker:{wid}", instance, parent,
            ) or parent
        # commit time == receive time at trace resolution: the journal
        # group-commit covers the whole frame at block exit
        traces.span(
            task_id, "server/commit", now, now, "server",
            instance, parent,
        )
        traces.close(task_id)

    def on_task_started(self, task_id, instance_id, worker_ids, variant=0,
                        wtrace=None):
        task = self.server.core.tasks.get(task_id)
        # the core task's lifecycle stamps ride along: started_at survives a
        # reattach (the task never stopped running through the outage), and
        # queued/assigned let a journal consumer rebuild the full
        # submit->queued->assigned->spawned chain offline
        started_at = task.t_started if task else 0.0
        self.server.jobs.on_task_started(
            task_id_job(task_id), task_id, worker_ids,
            started_at=started_at or None,
        )
        self._record_start_spans(task, task_id, instance_id, worker_ids,
                                 wtrace)
        # fleet trace stitching: a task started on a BORROWED
        # worker notes the lend — home shard, host shard — on its trace;
        # the fact also rides the journal event so a restored successor
        # rebuilds the same annotation
        lends = []
        for wid_ in worker_ids:
            w = self.server.core.workers.get(wid_)
            lf = (getattr(w.configuration, "lent_from", -1)
                  if w is not None else -1)
            if lf >= 0:
                lends.append((wid_, lf))
        for wid_, lf in lends:
            self.server.core.traces.annotate(task_id, {
                "kind": "lend",
                "worker": wid_,
                "home_shard": lf,
                "host_shard": self.server.shard_id,
                "instance": instance_id,
                "time": started_at or clock.now(),
            })
        # instance + chosen variant ride along (reference task-started
        # events carry instance/worker/variant, tests/test_events.py
        # test_event_running_variant)
        payload = {
            "job": task_id_job(task_id), "task": task_id_task(task_id),
            "workers": worker_ids, "instance": instance_id,
            "variant": variant,
            "queued_at": task.t_ready if task else 0.0,
            "assigned_at": task.t_assigned if task else 0.0,
            "started_at": started_at,
        }
        # resource amounts (human units) ride the journal record so the
        # accounting fold is journal-self-contained: a restored or
        # migrated-to server charges the same usage without the core
        # task's request tables (server/accounting.py)
        if task is not None:
            names = self.server.core.resource_map.names()
            gang = max(len(worker_ids), 1)
            usage: dict[str, float] = {}
            worker0 = (
                self.server.core.workers.get(worker_ids[0])
                if worker_ids else None
            )
            for rid, amount in self.server.core.variant_amounts(
                task.rq_id, variant, worker0
            ):
                if amount > 0 and rid < len(names):
                    usage[names[rid]] = (
                        usage.get(names[rid], 0.0)
                        + (amount / 10_000) * gang
                    )
            if usage:
                payload["usage"] = usage
            # queue-age SLO input: READY -> ASSIGNED latency (a reattach
            # re-emit carries the original stamps and would re-observe;
            # skip it — instance 0 reattaches are rare enough that the
            # p95 is unaffected, and restarts legitimately re-observe)
            queued, assigned = payload["queued_at"], payload["assigned_at"]
            if queued and assigned and assigned >= queued:
                _TASK_QUEUE_AGE.observe(assigned - queued)
        # the worker-side stamps + trace id ride the journal event so a
        # restored server rebuilds the SAME trace (replay feeds them back
        # through events/restore.py)
        trace_id = self.server.core.traces.trace_id(task_id)
        if trace_id is not None:
            tctx = {"id": trace_id, **(wtrace or {})}
            if lends:
                # all (worker, home_shard) lend pairs ride the journal so
                # restore rebuilds every gang member's annotation, not just
                # the first worker's
                tctx["lends"] = [[wid_, lf] for wid_, lf in lends]
            payload["trace"] = tctx
        self.server.emit_event("task-started", payload)

    def on_task_restarted(self, task_id):
        self.server.jobs.on_task_restarted(task_id_job(task_id), task_id)
        # crash counter + new instance ride along so restore can rebuild
        # both exactly (tests/test_journal.py counter round-trip)
        task = self.server.core.tasks.get(task_id)
        self.server.emit_event(
            "task-restarted",
            {"job": task_id_job(task_id), "task": task_id_task(task_id),
             "crash_count": task.crash_counter if task else 0,
             "instance": task.instance_id if task else 0},
        )

    def _terminal_trace_payload(self, task_id, wtrace) -> dict | None:
        trace_id = self.server.core.traces.trace_id(task_id)
        if trace_id is None:
            return None
        return {"id": trace_id, **(wtrace or {})}

    def _observe_runtime(self, task_id, wtrace) -> None:
        """Feed the runtime predictor (scheduler/policy.py) with this
        task's observed execution time: worker-side spawn/exit stamps when
        they rode the uplink, else the server-side start stamp vs now."""
        policy = self.server.core.policy
        if policy is None or policy.predictor is None:
            return
        job = self.server.jobs.jobs.get(task_id_job(task_id))
        if job is None:
            return
        wt = wtrace or {}
        spawned = wt.get("spawned_at")
        exited = wt.get("exited_at")
        if spawned and exited and exited >= spawned:
            runtime = exited - spawned
        else:
            task = self.server.core.tasks.get(task_id)
            t0 = task.t_started if task else 0.0
            if not t0:
                return
            runtime = clock.now() - t0
        policy.predictor.observe(job.name, runtime)

    def on_task_finished(self, task_id, wtrace=None):
        self.server.reattach_pending.pop(task_id, None)
        self.server.jobs.on_task_finished(task_id_job(task_id), task_id)
        self._record_finish_spans(task_id, wtrace)
        self._observe_runtime(task_id, wtrace)
        payload = {"job": task_id_job(task_id), "task": task_id_task(task_id)}
        trace = self._terminal_trace_payload(task_id, wtrace)
        if trace is not None:
            payload["trace"] = trace
        self.server.emit_event("task-finished", payload)
        self.server.check_job_completion(task_id_job(task_id))

    def on_task_failed(self, task_id, message, wtrace=None):
        self.server.reattach_pending.pop(task_id, None)
        to_cancel = self.server.jobs.on_task_failed(
            task_id_job(task_id), task_id, message
        )
        self._record_finish_spans(task_id, wtrace)
        payload = {"job": task_id_job(task_id), "task": task_id_task(task_id),
                   "error": message}
        trace = self._terminal_trace_payload(task_id, wtrace)
        if trace is not None:
            payload["trace"] = trace
        self.server.emit_event("task-failed", payload)
        if to_cancel:
            self.server.schedule_cancel(to_cancel)
        self.server.check_job_completion(task_id_job(task_id))

    def on_task_canceled(self, task_id):
        self.server.reattach_pending.pop(task_id, None)
        self.server.core.traces.close(task_id)  # eviction candidate
        self.server.jobs.on_task_canceled(task_id_job(task_id), task_id)
        self.server.emit_event(
            "task-canceled",
            {"job": task_id_job(task_id), "task": task_id_task(task_id)},
        )
        self.server.check_job_completion(task_id_job(task_id))

    def on_worker_new(self, worker):
        # resources ride along so report/dashboard can group workers by
        # config (reference report.rs running_workers keyed on ResCount)
        names = self.server.core.resource_map.names()
        resources = {
            names[rid]: amount / 10_000
            for rid, amount in enumerate(worker.resources.amounts)
            if amount > 0 and rid < len(names)
        }
        payload = {
            "id": worker.worker_id,
            "hostname": worker.configuration.hostname,
            "group": worker.group, "resources": resources,
            "alloc_id": worker.configuration.alloc_id,
        }
        lent_from = getattr(worker.configuration, "lent_from", -1)
        if lent_from >= 0:
            # the borrow side of a lend: the fleet feed pairs this with
            # the lender's worker-lost `lent_to` to draw the flow
            payload["lent_from"] = lent_from
        self.server.emit_event("worker-connected", payload)

    def on_worker_lost(self, worker_id, reason):
        # structured loss record: how stale the last heartbeat was, and
        # whether the worker may legitimately come back (a deliberate stop
        # won't; a heartbeat timeout / connection loss might — it would
        # re-register under a new id, its stale tasks fenced by instance)
        past = self.server.past_workers.get(worker_id) or {}
        payload = {"id": worker_id, "reason": reason,
                   "heartbeat_age": past.get("heartbeat_age"),
                   "reattach_eligible": reason != "stopped"}
        if past.get("lent_to") is not None:
            # structured lend target: consumers render lending flows
            # without parsing the human reason string
            payload["lent_to"] = past["lent_to"]
        self.server.emit_event("worker-lost", payload)
        self.server._draining.pop(worker_id, None)
        # crash-loop containment: the autoalloc service tracks how long
        # allocation-spawned workers survived after registration
        autoalloc = getattr(self.server, "autoalloc", None)
        if autoalloc is not None:
            autoalloc.on_worker_lost(worker_id, reason)


class Server:
    def __init__(
        self,
        server_dir: Path,
        host: str | None = None,
        client_port: int = 0,
        worker_port: int = 0,
        disable_client_auth: bool = False,
        disable_worker_auth: bool = False,
        scheduler: str = "auto",
        schedule_min_delay: float = SCHEDULE_MIN_DELAY,
        journal_path: Path | None = None,
        idle_timeout: float = 0.0,
        journal_flush_period: float = 0.0,
        access_file: Path | None = None,
        paranoid_tick: int = 0,
        journal_fsync: str = "never",
        journal_compact_interval: float = 0.0,
        journal_compact_threshold: int = 0,
        journal_salvage: bool = False,
        heartbeat_timeout_factor: float = 4.0,
        reattach_timeout: float = 15.0,
        solver_watchdog_timeout: float = 5.0,
        solver_rearm_ticks: int = 20,
        metrics_port: int | None = None,
        metrics_host: str = "0.0.0.0",
        flight_recorder_ticks: int = 512,
        tick_pipeline: bool = False,
        stall_budget: float = 1.0,
        stall_dumps: int = 8,
        profile_hz: float = 19.0,
        task_trace_capacity: int = 16384,
        client_plane: str = "thread",
        journal_plane: str = "thread",
        fanout_senders: int = 2,
        ingest_window: int = 64,
        ingest_handoff_max: int = 8192,
        lazy_array_threshold: int = 4096,
        shard_id: int = 0,
        shard_count: int = 1,
        federation_root: Path | None = None,
        lease_timeout: float = 15.0,
        promoted: bool = False,
        failover_watch: bool = False,
        memory_transport: bool = False,
        policy_file: Path | None = None,
        device="cuda",
    ):
        # idle_timeout: default worker idle timeout, adopted at registration
        # by workers that set none (reference ServerStartOpts idle_timeout,
        # tako rpc.rs sync_worker_configuration). journal_flush_period: 0 =
        # flush the journal on every event (stronger than the reference's
        # 30 s default); > 0 = flush on that period instead.
        # journal_fsync: "never" = fsync only on clean close/explicit
        # `hq journal flush` (flush-to-OS still happens per policy above);
        # "periodic" = fsync on the flush period (default 30 s if none);
        # "always" = fsync after every event (survives an OS crash at the
        # cost of one fsync per event).
        # device: where the scheduler's models solve (the card unless the
        # caller asks for the CPU, as everywhere in the port).
        #
        # Keywords whose plane is not ported yet are stored as the JAX
        # server stores them; a value that would need that plane before
        # start() refuses here instead of being ignored.
        unported = {
            "metrics_port": metrics_port is not None,
            "federation_root": federation_root is not None,
            "shard_count": shard_count > 1,
            "promoted": bool(promoted),
            "failover_watch": bool(failover_watch),
            "memory_transport": bool(memory_transport),
        }
        refused = [name for name, used in unported.items() if used]
        if refused:
            raise NotImplementedError(
                f"Server({', '.join(refused)}=...) needs a plane that comes "
                f"with {_ITEM_8}"
            )
        self.server_dir = Path(server_dir)
        self.host = host or socket.gethostname()
        self.client_port = client_port
        self.worker_port = worker_port
        self.disable_client_auth = disable_client_auth
        self.disable_worker_auth = disable_worker_auth
        self.access_file = access_file
        self.idle_timeout = idle_timeout
        self.journal_flush_period = journal_flush_period
        if journal_fsync not in ("never", "periodic", "always"):
            raise ValueError(f"unknown journal fsync policy {journal_fsync!r}")
        self.journal_fsync = journal_fsync
        # journal compaction (events/snapshot.py): snapshot live state +
        # GC the superseded journal prefix, every --journal-compact-interval
        # seconds and/or whenever the journal exceeds
        # --journal-compact-threshold bytes (0 = that trigger off)
        self.journal_compact_interval = journal_compact_interval
        self.journal_compact_threshold = journal_compact_threshold
        # --journal-salvage: skip CRC-corrupt mid-file journal records
        # (counted in hq_journal_salvaged_records_total) instead of
        # refusing to start
        self.journal_salvage = journal_salvage
        # boots that have written this journal lineage (server-uid records
        # up to now, self included once _open_journal emits ours): the
        # instance-generation fence base a snapshot must carry
        self.n_boots = 0
        self.last_restore: dict | None = None
        self.last_compaction: dict | None = None
        self._compacting = False
        self.heartbeat_timeout_factor = heartbeat_timeout_factor
        # restored maybe-running tasks wait this long for their pre-crash
        # worker to reconnect and reclaim them before being fenced and
        # requeued (task_id -> monotonic deadline); 0 = requeue immediately
        self.reattach_timeout = reattach_timeout
        self.reattach_pending: dict[int, float] = {}
        # server uids that have written this journal (restored from
        # server-uid records + this instance's own): a reattach claim must
        # name one of them, or the worker's tasks belong to a DIFFERENT
        # server lineage (same dir, different --journal) and task ids could
        # collide at instance 0
        self.journal_uids: set[str] = set()
        self.schedule_min_delay = schedule_min_delay
        # disconnected workers, for `worker list --all` / `worker info` on a
        # dead id (reference keeps them in the HQ State worker map)
        self.past_workers: dict[int, dict] = {}
        self.core = Core()
        # debug: every N ticks, assert the incremental tick assembly is
        # bit-identical to a from-scratch one (scheduler/tick_cache.py
        # paranoid_check; `--paranoid-tick N`)
        self.core.paranoid_tick = paranoid_tick
        # --tick-pipeline: two-stage async ticks (scheduler/pipeline.py) —
        # solve N dispatches without blocking and is mapped at tick N+1,
        # overlapping device execution with the inter-tick host work.
        # Paranoid ticks and watchdog fallbacks force the synchronous path.
        if tick_pipeline:
            from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline

            self.core.tick_pipeline = TickPipeline()
        # flight recorder: ring of the last N per-tick DecisionRecords +
        # control-plane events (`--flight-recorder-ticks`, 0 = off)
        from hyperqueue_tpu_torch.utils.flight import FlightRecorder
        from hyperqueue_tpu_torch.utils.trace import TaskTraceStore

        self.core.flight = FlightRecorder(flight_recorder_ticks)
        # per-task distributed traces (`hq task trace`): bounded store,
        # `--task-trace-capacity 0` disables the whole plane (no store, no
        # trace headers on compute messages, no worker stamps)
        self.core.traces = TaskTraceStore(task_trace_capacity)
        # reactor loop-lag tracking + stall watchdog: the loop-lag tracker
        # comes with the server loop (ROADMAP Queue 1 item 8); until then
        # the journal plane gets lag=None
        self.lag = None
        # continuous profiling plane (its sampler is item 8's)
        self.profile_hz = float(profile_hz)
        self._profiler_started = False
        self.stall_budget = float(stall_budget)
        self.stall_dumps = max(int(stall_dumps), 1)
        self.stalls_captured = 0
        self.last_stall: dict | None = None
        self._last_stall_capture = 0.0
        # subscribe-RPC consumers: bounded per-subscriber queues (the
        # subscribe plane is item 8's; emit_event already delivers to them)
        self._subscribers: list = []
        # client-connection plane (server/ingest.py in the JAX package):
        # "thread" moves accept/auth/framing/decode off the reactor loop;
        # "reactor" keeps the in-loop handling
        if client_plane not in ("thread", "reactor"):
            raise ValueError(f"unknown client plane {client_plane!r}")
        self.client_plane = client_plane
        self.memory_transport = bool(memory_transport)
        self._conn_tasks: set = set()
        # journal plane (server/journal_plane.py): "thread" (default)
        # moves group commit + fsync onto a commit thread with
        # watermark-gated visibility; "reactor" keeps the inline
        # group-commit block (escape hatch, mirrors --client-plane)
        if journal_plane not in ("thread", "reactor"):
            raise ValueError(f"unknown journal plane {journal_plane!r}")
        self.journal_plane = journal_plane
        self.jplane: JournalPlane | None = None
        # fan-out plane: N sender threads running the encode + AEAD-seal
        # half of every downlink send (its SendPool is item 8's)
        self.fanout_senders = max(int(fanout_senders), 0)
        self.sendpool = None
        self.ingest_window = ingest_window
        self.ingest_handoff_max = ingest_handoff_max
        self.ingest_plane = None
        self._handoff_wake = asyncio.Event()
        self._client_tasks: set = set()
        # arrays at/above this size are stored as lazy chunks
        # (server/lazy.py) instead of per-task records; 0 disables
        self.lazy_array_threshold = (
            lazy_array_threshold if lazy_array_threshold > 0 else 1 << 62
        )
        # chunked-submit streams: submit uid -> job id (exactly-once chunk
        # replay lands on the same job across client reconnects/restores)
        self._stream_jobs: dict[str, int] = {}
        # federation: this server owns shard `shard_id` of a
        # `shard_count`-way static job-id partition rooted at
        # `federation_root` (None = classic standalone server)
        if not (0 <= shard_id < max(shard_count, 1)):
            raise ValueError(
                f"shard id {shard_id} outside 0..{shard_count - 1}"
            )
        self.shard_id = shard_id
        self.shard_count = max(int(shard_count), 1)
        self.federation_root = (
            Path(federation_root) if federation_root else None
        )
        self.lease_timeout = float(lease_timeout)
        self.promoted = promoted
        self.lease = None
        self.fenced = False
        self.failover_watch = failover_watch
        self._watcher = None
        # graceful drains in flight: wid -> {deadline, started, source}
        self._draining: dict[int, dict] = {}
        # cross-shard worker lending: wid -> target shard
        self._lent_workers: dict[int, int] = {}
        self.workers_lent_total = 0
        # elastic resharding: jobs this shard exported live to a sibling.
        # migrating_out: job -> {"mig", "to"} while sealed here and the
        # protocol is in flight; migrated_out: job -> new owner once the
        # tombstone is journaled (requests answer wrong-shard from then on);
        # migrations_in: mig uid -> job for imports already applied.
        self.migrating_out: dict[int, dict] = {}
        self.migrated_out: dict[int, int] = {}
        self.migrations_in: dict[str, int] = {}
        self.jobs = JobManager()
        self.comm = CommSender()
        self.events = EventBridge(self)
        # the usage ledger folds the SAME records the journal persists
        # (live emit, replay, and migration import all call observe —
        # bit-equal by construction); the SLO engine that judges the
        # metrics registry is item 8's
        self.accounting = AccountingLedger()
        self.slo = None
        # lazy materialization needs the CURRENT job manager (restore may
        # swap it out on a snapshot fallback): bind a getter, not the object
        self.core.lazy.jobs_getter = lambda: self.jobs
        self.device = device
        if scheduler == "milp":
            base_model = MilpModel()
        elif scheduler == "multichip":
            base_model = MultichipModel(device=device)
        elif scheduler == "greedy-numpy":
            # pinned host/numpy solve: no adaptive host/device selection,
            # so the backend (and the decision records naming it) is
            # identical run-to-run
            base_model = GreedyCutScanModel(device=device, backend="numpy")
        elif scheduler == "greedy-fused":
            # fused constraint solve: multi-node gangs become all-or-
            # nothing rows INSIDE the batched solve (ops/assign.py gang
            # rows) instead of the host-side reservation drain;
            # deterministic like greedy-numpy
            base_model = GreedyCutScanModel(device=device, backend="numpy")
            self.core.fused_solve = True
        else:
            base_model = GreedyCutScanModel(device=device)
        # weighted scheduling objective (--policy-file, scheduler/policy.py):
        # heterogeneity affinity + fairness + runtime prediction on top of
        # the fused dense solve. Gated to greedy-fused — the policy's
        # affinity rows ride the dense snapshot's worker order.
        self.policy_file = policy_file
        if policy_file:
            if scheduler != "greedy-fused":
                raise ValueError(
                    "--policy-file requires --scheduler greedy-fused "
                    f"(got {scheduler!r})"
                )
            from hyperqueue_tpu_torch.scheduler.policy import build_policy

            def _job_label(job_id: int) -> str | None:
                job = self.jobs.jobs.get(job_id)
                return job.name if job is not None else None

            def _live_jobs() -> list[int]:
                return [
                    job_id for job_id, job in self.jobs.jobs.items()
                    if not job.all_tasks_done()
                ]

            self.core.policy = build_policy(
                str(policy_file), ledger=self.accounting,
                job_name=_job_label, live_jobs=_live_jobs,
            )
        # --paranoid-tick also arms the device-resident solve's own
        # bit-exactness guard: every N resident solves re-run from a fresh
        # full upload and assert identical counts (models/greedy.py)
        if paranoid_tick and hasattr(base_model, "paranoid_resident"):
            base_model.paranoid_resident = paranoid_tick
        # every solve runs behind the watchdog (scheduler/watchdog.py): a
        # solver exception or hang degrades that tick to the fallback
        # where the watchdog has one (a model off the card); a card model
        # raises instead
        self.model = SolverWatchdog(
            base_model,
            timeout_s=solver_watchdog_timeout,
            rearm_ticks=solver_rearm_ticks,
        )
        self.scheduler_kind = scheduler
        self.access = None
        self.autoalloc = None
        self.journal = None
        self.journal_path = journal_path
        self._stop_event = asyncio.Event()
        self._job_waiters: dict[int, list[asyncio.Event]] = {}
        self._event_listeners: list[asyncio.Queue] = []
        self._event_seq = 0
        self._overview_listeners = 0
        self._worker_conns: dict = {}
        self._tasks: list[asyncio.Task] = []
        self._servers: list = []
        self.started_at = clock.now()
        # Prometheus exposition endpoint (its server is item 8's)
        self.requested_metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.metrics_port: int | None = None
        self._metrics_server = None
        self._metrics_hook = None
        self._piggyback_names: set[str] = set()

    # ------------------------------------------------------------------
    async def start(self):
        """The listeners, the loops and the access record come with
        `hq server start`; until then a caller opens the journal with
        `_open_journal` and drives the reactor itself."""
        raise NotImplementedError(f"Server.start() comes with {_ITEM_8}")

    async def _open_journal(self, server_uid: str) -> None:
        """The journal block of the JAX `start()`: restore from the
        snapshot + journal pair when there is one (off the event loop),
        open the appender, start the commit thread (`journal_plane=
        "thread"`), and journal this boot's `server-uid` record (the JAX
        `start()` writes it once the access record names the uid; item 8's
        `start()` calls this at that point). Must run on the loop that will
        run the server: the journal plane releases its callbacks there."""
        if self.journal_path is None:
            return
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod
        from hyperqueue_tpu_torch.events.restore import restore_from_journal

        self.journal = Journal(
            self.journal_path, salvage=self.journal_salvage
        )
        # a snapshot alone is restorable (the journal may be freshly
        # rotated away or lost with the tail already folded in)
        if self.journal_path.exists() or snapshot_mod.have_snapshot(
            self.journal_path
        ):
            # off the event loop: a multi-second journal replay inline
            # would freeze the loop's other work
            await asyncio.get_running_loop().run_in_executor(
                None, restore_from_journal, self
            )
            # the promoted successor's failover annotation on open traces
            # comes with the federation plane (item 8)
        self.journal.open_for_append()
        if self.journal_plane == "thread":
            self.jplane = JournalPlane(
                self.journal,
                fsync_always=self.journal_fsync == "always",
                flush_each=not self.journal_flush_period,
                loop=asyncio.get_running_loop(),
                lag=self.lag,
                on_fatal=self.stop,
            )
            self.jplane.start()
        # record this instance's uid in the journal so a future restore
        # can verify that reattaching workers come from this lineage
        self.journal_uids.add(server_uid)
        self.n_boots += 1
        self.emit_event("server-uid", {"server_uid": server_uid})

    def _close_journal(self) -> None:
        """The journal block of the JAX `stop()` (its shutdown): drain +
        join the commit thread, then close the appender; a plane that
        failed to drain keeps the appender open rather than closing the
        file under a still-writing thread."""
        plane_drained = self.jplane.stop() if self.jplane is not None \
            else True
        if self.journal is not None and plane_drained:
            self.journal.close()

    def stop(self) -> None:
        self._stop_event.set()


    # control-plane event kinds mirrored into the flight recorder so a
    # dump shows what the cluster DID around each tick; per-task kinds are
    # deliberately excluded (a million-task job must not flush the ring)
    _FLIGHT_EVENT_KINDS = (
        "worker-", "job-submitted", "job-completed", "job-opened",
        "job-closed", "job-paused", "job-resumed", "alloc-", "server-uid",
    )

    # --- events out ----------------------------------------------------
    def _journal_group_commit(self):
        """Context manager: buffer journal writes inside the block and
        commit them as one append (+ one fsync under `--journal-fsync
        always`) at exit. The block MUST NOT await — group commit is
        correct only while no external effect can run before the commit."""
        journal = self.journal
        if journal is None or journal.in_batch or self.jplane is not None:
            # with the journal plane on, the commit thread owns batching
            # (emit_event enqueues; visibility rides the watermark)
            return _NOOP_BATCH
        return _journal_batch(
            journal,
            fsync=self.journal_fsync == "always",
            flush=not self.journal_flush_period,
        )

    def emit_event(self, kind: str, payload: dict) -> None:
        if (
            self.core.flight.enabled
            and kind.startswith(self._FLIGHT_EVENT_KINDS)
            and not kind.startswith("worker-overview")
        ):
            self.core.flight.record_event(
                kind,
                {k: v for k, v in payload.items() if k != "desc"},
            )
        if (
            self.journal is None
            and not self._event_listeners
            and not self._subscribers
        ):
            # nobody persists or streams events; the accounting fold
            # still consumes its kinds (journal-less sim/dev servers)
            if kind in ACCOUNTED_KINDS:
                self.accounting.observe(
                    kind,
                    {"time": clock.now(), "event": kind, **payload},
                )
            return
        record = {"time": clock.now(), "seq": self._event_seq,
                  "event": kind, **payload}
        self._event_seq += 1
        # fold BEFORE the append, on the exact record the journal gets:
        # snapshot capture runs synchronously between emits, so a captured
        # ledger corresponds exactly to `seq < watermark` — live fold and
        # kill -9 replay are bit-identical by construction
        self.accounting.observe(kind, record)
        if self.jplane is not None:
            # journal plane (server/journal_plane.py): the append is an
            # enqueue; the commit thread group-writes (+ flushes/fsyncs
            # per policy) off the loop, and deliveries to listeners/
            # subscribers are released only at the durability watermark
            self.jplane.append(record)
        elif self.journal is not None:
            self.journal.write(record)
            # default: flush to the OS on every event, so a crashed server
            # process restores everything (fsync-against-OS-crash happens on
            # close and `hq journal flush`). With --journal-flush-period the
            # periodic loop flushes instead (reference 30 s default).
            # --journal-fsync always additionally fsyncs per event. Inside
            # a group-commit block the batch commit does all of this once
            # at block exit instead.
            if not self.journal.in_batch:
                if self.journal_fsync == "always":
                    self.journal.flush(sync=True)
                elif not self.journal_flush_period:
                    self.journal.flush()
        # the chaos plane's kill-at-event-K injection site (after the
        # journal write + flush, behind a durability barrier) comes with
        # `hq server start` (ROADMAP Queue 1 item 8)
        if self.jplane is not None and (
            self._event_listeners or self._subscribers
        ):
            self.jplane.when_durable(
                lambda r=record, k=kind: self._deliver_event(k, r)
            )
        else:
            self._deliver_event(kind, record)

    def _deliver_event(self, kind: str, record: dict) -> None:
        """Fan one journaled record out to event listeners and
        subscribers. With the journal plane on this runs at the
        durability watermark — a completion a subscriber sees is already
        as durable as the fsync policy promises."""
        for q in self._event_listeners:
            q.put_nowait(record)
        for sub in self._subscribers:
            if sub.dead:
                _SUB_EVENTS_DROPPED.inc()
                continue
            if sub.prefixes and not kind.startswith(sub.prefixes):
                continue
            try:
                sub.queue.put_nowait(record)
            except asyncio.QueueFull:
                # slow consumer: drop IT, not the reactor's latency — its
                # streaming loop notices `dead` and closes the connection
                sub.dead = True
                sub.dropped += 1
                _SUBSCRIBERS_DROPPED.inc()
                _SUB_EVENTS_DROPPED.inc()

    # --- durability-before-visibility gating ---------------------------
    def reply_visible(self, channel, frame: dict) -> None:
        """Queue a client reply, released only once every event emitted
        so far is committed (journal plane) — the watermark gate that
        keeps an ack from outrunning the durability it implies. Without
        the plane the synchronous group-commit block already provides
        the ordering, so the reply goes straight out."""
        if self.jplane is not None:
            self.jplane.when_durable(lambda: channel.reply(frame))
        else:
            channel.reply(frame)

    async def _visibility_barrier(self) -> None:
        """Await the durability watermark (legacy in-loop client plane's
        equivalent of reply_visible)."""
        if self.jplane is None:
            return
        fut = asyncio.get_running_loop().create_future()
        self.jplane.when_durable(
            lambda: fut.done() or fut.set_result(None)
        )
        await fut

    def schedule_cancel(self, task_ids: list[int]) -> None:
        reactor.on_cancel_tasks(self.core, self.comm, self.events, task_ids)

    def _seal_job_streams(self, job) -> None:
        """Force-seal a job's chunk streams AND journal the seal (a
        forced seal has no `last` chunk event to replay from)."""
        sealed = job.seal_streams()
        if sealed:
            self.emit_event(
                "job-streams-sealed", {"job": job.job_id, "uids": sealed}
            )

    def check_job_completion(self, job_id: int) -> None:
        job = self.jobs.jobs.get(job_id)
        if job is None:
            return
        if job.is_terminated():
            self.emit_event(
                "job-completed",
                {"job": job_id, "status": job.status(),
                 "cancel_reason": job.cancel_reason},
            )
            # a terminated job's streams are dead: release their uid
            # mappings and applied-index sets (a long-lived server must
            # not grow per-stream state forever — retried chunks now get
            # a "sealed" error instead of a dup ack, which is fine: the
            # retrying client's stream already failed terminally)
            for uid, stream in job.streams.items():
                self._stream_jobs.pop(uid, None)
                stream["applied"] = set()
        # waiters are satisfied when every task submitted SO FAR is terminal —
        # for open jobs that is the useful "wait" semantics (the job itself
        # terminates only when closed)
        if job.all_tasks_done():
            for event in self._job_waiters.pop(job_id, []):
                event.set()

    # consecutive-crash budget per background loop before the server gives
    # up and stops (so clients fail fast instead of submitting into a
    # server that never schedules); a loop that then stays healthy for
    # LOOP_HEALTHY_SECS earns its budget back
    LOOP_CRASH_RESTARTS = 3
    LOOP_HEALTHY_SECS = 60.0


    def _owned_elsewhere(self, job_id, rid=None) -> dict | None:
        """wrong-shard / migrating guard: an error dict when this shard
        no longer (or not currently) serves the job, else None. `code`
        lets clients tell a redirect (wrong-shard, with the owner hint)
        from a transient seal (migrating — retry here shortly)."""
        if job_id is None:
            return None
        owner = self.migrated_out.get(job_id)
        if owner is not None:
            err = {"op": "error", "code": "wrong-shard", "owner": owner,
                   "message": f"job {job_id} migrated to shard {owner}"}
            if rid is not None:
                err["rid"] = rid
            return err
        if job_id in self.migrating_out:
            err = {"op": "error", "code": "migrating",
                   "message": f"job {job_id} is migrating; retry shortly"}
            if rid is not None:
                err["rid"] = rid
            return err
        return None


    async def compact_journal(self, reason: str = "manual") -> dict:
        """One snapshot + journal-GC cycle.

        Phases (each kill -9-survivable; the chaos site `server.compact` that
        tests it comes with item 8):

        1. **barrier** (sync on the reactor loop): commit + fsync any open
           group-commit batch so every acknowledged event is durable, then
           capture the live state and the event-seq watermark. Nothing can
           interleave — capture is one synchronous block.
        2. **snapshot** (executor thread): serialize + write temp → fsync →
           rotate `.snap` to `.snap.prev` → atomic rename → dir fsync.
           Only after this is the snapshot allowed to supersede anything.
        3. **GC** (executor thread): rewrite the pre-barrier journal region
           into a temp file, keeping live jobs' events (for `--history`),
           server-uid lineage records, and nothing else — completed and
           forgotten jobs' events are dropped. The journal keeps appending
           concurrently; only bytes below the barrier offset are touched.
        4. **swap** (sync on the loop): close the appender, carry over the
           frames appended during the rewrite, atomically publish the GC'd
           journal, fsync the directory, reopen for append.
        """
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod

        if self.journal is None:
            raise RuntimeError("server runs without a journal")
        if self._compacting:
            return {"skipped": "compaction already in progress"}
        self._compacting = True
        try:
            t0 = time.perf_counter()
            loop = asyncio.get_running_loop()
            # phase 1: barrier + capture (no awaits until stop_at is read)
            if self.jplane is not None:
                # blocks the loop until the commit thread has everything
                # on disk — the same stop-the-world barrier the inline
                # path gets from commit+fsync below
                self.jplane.barrier(sync=True)
            else:
                if self.journal.in_batch:
                    self.journal.commit_batch()
                self.journal.flush(sync=True)
            t_barrier = time.perf_counter()
            state = snapshot_mod.capture_state(self)
            t_capture = time.perf_counter()
            watermark = state["seq"]
            stop_at = self.journal_path.stat().st_size
            keep_jobs = {
                job_id
                for job_id, job in self.jobs.jobs.items()
                if not job.is_terminated()
            }
            bytes_before = stop_at

            # the current .snap becomes .snap.prev — the fallback source if
            # the NEW snapshot later proves corrupt. The GC floor must stay
            # at the fallback's watermark, or events of jobs that completed
            # between the two snapshots would be dropped and a fallback
            # restore would re-execute acknowledged-finished work. Retains
            # at most one compaction window of extra journal.
            def _retained_seq():
                try:
                    return snapshot_mod.read_snapshot(
                        snapshot_mod.snapshot_path(self.journal_path)
                    )["seq"]
                except Exception:
                    return None  # no/corrupt old snapshot: nothing retained

            old_seq = await loop.run_in_executor(None, _retained_seq)
            gc_floor = (
                watermark if old_seq is None else min(watermark, old_seq)
            )
            # phase 2: durable snapshot publish (off-loop)
            t_snap = time.perf_counter()
            snap = await loop.run_in_executor(
                None, snapshot_mod.write_snapshot, self.journal_path, state
            )
            t_gc = time.perf_counter()
            # phase 3: GC rewrite of the superseded prefix (off-loop)
            tmp = Path(str(self.journal_path) + ".gc")
            try:
                kept, dropped = await loop.run_in_executor(
                    None,
                    Journal.gc_rewrite,
                    self.journal_path,
                    tmp,
                    keep_jobs,
                    gc_floor,
                    stop_at,
                    self.journal_salvage,
                )
                # the "pre-swap" kill site (ROADMAP Queue 1 item 8)
                t_swap = time.perf_counter()
                # phase 4: synchronous swap — no awaits, so no event can
                # be appended between close and reopen; the journal
                # plane's commit thread is drained + parked around the
                # handle swap (it keeps appending to the SAME Journal
                # object, which reopens onto the published file)
                if self.jplane is not None:
                    self.jplane.suspend()
                self.journal.close()
                try:
                    Journal.gc_finalize(self.journal_path, tmp, stop_at)
                finally:
                    # whatever happened (ENOSPC mid-carry-over, either file
                    # published), the appender MUST come back or every
                    # subsequent emit_event would crash the handlers
                    self.journal.open_for_append()
                    if self.jplane is not None:
                        self.jplane.resume()
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            # the "post-swap" kill site (ROADMAP Queue 1 item 8)
            t_end = time.perf_counter()
            stats = {
                "reason": reason,
                "time": clock.now(),
                "duration_ms": round((time.perf_counter() - t0) * 1e3, 2),
                "watermark": watermark,
                "gc_floor": gc_floor,
                "kept_records": kept,
                "dropped_records": dropped,
                "journal_bytes_before": bytes_before,
                "journal_bytes_after": self.journal_path.stat().st_size,
                "snapshot_bytes": snap.stat().st_size,
                "live_jobs": len(keep_jobs),
                # the port's phase split of duration_ms (the barrier, the
                # capture, the snapshot write, the GC rewrite and the swap)
                "phases_ms": {
                    "barrier": (t_barrier - t0) * 1e3,
                    "capture": (t_capture - t_barrier) * 1e3,
                    "snapshot_write": (t_gc - t_snap) * 1e3,
                    "gc": (t_swap - t_gc) * 1e3,
                    "swap": (t_end - t_swap) * 1e3,
                },
            }
            self.last_compaction = stats
            REGISTRY.counter(
                "hq_journal_compactions_total",
                "journal snapshot+GC compaction cycles completed",
            ).inc()
            REGISTRY.counter(
                "hq_journal_gc_dropped_records_total",
                "journal records dropped by compaction GC",
            ).inc(dropped)
            logger.info(
                "journal compacted (%s): %d records kept, %d dropped, "
                "%d -> %d bytes (+%d snapshot) in %.1f ms",
                reason, kept, dropped, bytes_before,
                stats["journal_bytes_after"], stats["snapshot_bytes"],
                stats["duration_ms"],
            )
            return stats
        finally:
            self._compacting = False

    async def _client_submit(self, msg: dict) -> dict:
        recv_at = clock.now()
        job_desc = msg["job"]
        job_id = job_desc.get("job_id")
        if job_id is not None and job_id in self.jobs.jobs:
            job = self.jobs.jobs[job_id]
            if not job.is_open:
                return {"op": "error", "message": f"job {job_id} is not open"}
        else:
            job = self.jobs.create_job(
                name=job_desc.get("name", "job"),
                submit_dir=job_desc.get("submit_dir", os.getcwd()),
                max_fails=job_desc.get("max_fails"),
                is_open=job_desc.get("open", False),
                job_id=job_id,
            )
        # trace-context: the client stamped a trace id + its send
        # clock; every task of this submit joins that trace, and the ids
        # ride the journal event so restore rebuilds the SAME trace
        from hyperqueue_tpu_torch.transport.framing import read_trace
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        tctx = read_trace(msg) or {}
        trace_id = tctx.get("id") or new_trace_id()
        sent_at = float(tctx.get("sent_at") or 0.0)
        trace = {"id": trace_id, "sent_at": sent_at, "recv_at": recv_at,
                 "commit_at": clock.now()}
        array = job_desc.get("array")
        if array:
            n_new = self._ingest_array_desc(
                job, array, submitted_at=recv_at, trace=trace
            )
        else:
            new_tasks = self._build_tasks(job, job_desc)
            n_new = len(new_tasks)
        job.submits.append(submit_record(job_desc, n_new))
        self.emit_event(
            "job-submitted", {"job": job.job_id, "desc": job_desc,
                              "n_tasks": n_new,
                              "trace": {"id": trace_id, "sent_at": sent_at,
                                        "recv_at": recv_at}}
        )
        if not array:
            self._begin_submit_traces(new_tasks, trace)
            reactor.on_new_tasks(self.core, self.comm, new_tasks)
        return {"op": "submit_response", "job_id": job.job_id,
                "n_tasks": n_new}

    def _begin_submit_traces(self, new_tasks, trace: dict) -> None:
        """Open each task's distributed trace with the client/submit and
        server/submit spans (eager path; lazy chunks replay the same
        stamps at materialization — server/lazy.py)."""
        traces = self.core.traces
        if not traces.enabled:
            return
        sent_at = trace["sent_at"]
        recv_at = trace["recv_at"]
        commit_at = trace.get("commit_at") or recv_at
        for task in new_tasks:
            traces.begin(task.task_id, trace["id"])
            parent = None
            if sent_at:
                parent = traces.span(
                    task.task_id, "client/submit", sent_at, recv_at,
                    "client",
                )
            traces.span(
                task.task_id, "server/submit", recv_at, commit_at,
                "server", parent=parent,
            )

    @staticmethod
    def _wire_array_ids(array: dict):
        """(ids, id_range) from a wire array description. Chunked clients
        send contiguous runs as "id_range": [start, stop) — O(1) on the
        wire and in the lazy store; explicit id lists must be sorted."""
        id_range = array.get("id_range")
        if id_range is not None:
            lo, hi = int(id_range[0]), int(id_range[1])
            if hi <= lo:
                raise ValueError(f"empty or inverted id_range {id_range}")
            return None, (lo, hi)
        ids = list(array["ids"])
        if any(b <= a for a, b in zip(ids, ids[1:])):
            ids = sorted(set(ids))
        return ids, None

    def _check_array_ids(self, job, ids, id_range) -> None:
        """Duplicate-id guard in O(materialized + chunks), not O(array).

        Against lazy chunks the check is by chunk BOUNDS: an append whose
        id span overlaps an earlier chunk's span is rejected even if the
        earlier chunk had holes the new ids would fit — precise hole
        tracking would cost the O(tasks) scan laziness exists to avoid.
        """
        lo = id_range[0] if id_range else ids[0]
        hi = id_range[1] if id_range else ids[-1] + 1
        for seg in self.core.lazy.per_job.get(job.job_id, ()):
            chunk = seg.chunk
            if lo <= chunk.max_id() and chunk.min_id() < hi:
                raise ValueError(
                    f"task ids [{lo}, {hi}) overlap an earlier array "
                    f"chunk [{chunk.min_id()}, {chunk.max_id()}] of job "
                    f"{job.job_id}"
                )
        # iterate whichever side is SMALLER: a long stream of eager
        # chunks (--lazy-array-threshold 0) must stay O(chunk) per chunk,
        # not O(materialized-so-far) — quadratic over a 1M-line stdin
        n_new = (hi - lo) if id_range is not None else len(ids)
        if n_new < len(job.tasks):
            tasks = job.tasks
            for tid in (range(lo, hi) if id_range is not None else ids):
                if tid in tasks:
                    raise ValueError(f"duplicate task id {tid}")
        else:
            id_set = None if id_range is not None else set(ids)
            for tid in job.tasks:
                if lo <= tid < hi and (id_set is None or tid in id_set):
                    raise ValueError(f"duplicate task id {tid}")

    def _ingest_array_desc(self, job, array: dict, submitted_at: float,
                           trace: dict | None) -> int:
        """Ingest one wire array description — the JASDA atomization seam.

        Arrays at/above --lazy-array-threshold (single-node only) register
        ONE ArrayChunk: O(1) allocations here, per-task records deferred
        to dispatch (server/lazy.py). Smaller arrays keep the eager path.
        Reference: server/client/submit.rs build_tasks_array; the
        shared/separate wire split (messages/worker.rs:28-54) means a
        million-task array never ships a million bodies either way.
        """
        ids, id_range = self._wire_array_ids(array)
        n = (id_range[1] - id_range[0]) if id_range else len(ids)
        self._check_array_ids(job, ids, id_range)
        rqv = rqv_from_wire(
            array.get("request") or {}, self.core.resource_map
        )
        rq_id = self.core.intern_rqv(rqv)
        shared_body = array.get("body", {})
        entries = array.get("entries")
        priority = (int(array.get("priority", 0)),
                    encode_sched_priority(job.job_id))
        crash_limit = int(array.get("crash_limit", 5))
        if not rqv.is_multi_node and n >= self.lazy_array_threshold:
            chunk = ArrayChunk(
                job_id=job.job_id,
                rq_id=rq_id,
                priority=priority,
                body=shared_body,
                crash_limit=crash_limit,
                id_range=id_range,
                ids=ids,
                entries=list(entries) if entries is not None else None,
                submitted_at=submitted_at,
                ready_at=clock.now(),
                trace=dict(trace) if trace else None,
            )
            held = job.job_id in self.core.paused_jobs
            self.core.lazy.register(self.core, chunk, held=held)
            if not held:
                self.comm.ask_for_scheduling()
            return n
        # eager path: per-task records now, stamped with THIS submit's
        # clock (per-chunk submitted_at keeps `hq job timeline` exact for
        # open jobs appending chunks over time)
        new_tasks: list[Task] = []
        ids_iter = ids if ids is not None else range(*id_range)
        for i, job_task_id in enumerate(ids_iter):
            if job_task_id in job.tasks:
                raise ValueError(f"duplicate task id {job_task_id}")
            job.tasks[job_task_id] = JobTaskInfo(
                job_task_id=job_task_id, submitted_at=submitted_at
            )
            new_tasks.append(
                Task(
                    task_id=make_task_id(job.job_id, job_task_id),
                    rq_id=rq_id,
                    priority=priority,
                    body=shared_body,  # one dict for the whole array
                    entry=entries[i] if entries is not None else None,
                    crash_limit=crash_limit,
                )
            )
        if trace:
            self._begin_submit_traces(new_tasks, trace)
        reactor.on_new_tasks(self.core, self.comm, new_tasks)
        return len(new_tasks)

    def _build_tasks(self, job, job_desc: dict) -> list[Task]:
        """Convert a GRAPH submit description into core tasks (arrays go
        through _ingest_array_desc).

        Reference: server/client/submit.rs build_tasks_graph.
        """
        new_tasks: list[Task] = []
        used = set(job.tasks)
        for t in job_desc.get("tasks", []):
            job_task_id = t.get("id")
            if job_task_id is None:
                job_task_id = (max(used) + 1) if used else 0
                # write the assigned id back into the desc: the desc is
                # journaled verbatim by _client_submit, and restore replays
                # it through this same path — without the id every such task
                # would collapse to id 0 on replay
                t["id"] = job_task_id
            if job_task_id in used or self.core.lazy.owns(
                job.job_id, job_task_id
            ):
                raise ValueError(f"duplicate task id {job_task_id}")
            used.add(job_task_id)
            rqv = rqv_from_wire(t.get("request") or {}, self.core.resource_map)
            rq_id = self.core.intern_rqv(rqv)
            task_id = self.jobs.attach_task(job, job_task_id)
            deps = tuple(
                make_task_id(job.job_id, d) for d in t.get("deps", ())
            )
            new_tasks.append(
                Task(
                    task_id=task_id,
                    rq_id=rq_id,
                    priority=(int(t.get("priority", 0)),
                              encode_sched_priority(job.job_id)),
                    body=t.get("body", {}),
                    deps=deps,
                    crash_limit=int(t.get("crash_limit", 5)),
                )
            )
        return new_tasks
