"""Server process: bootstrap, RPC planes, scheduler loop, event bridge.

The port's copy of the JAX package's `server/bootstrap.py`: the listeners
(the worker plane on the loop, the client plane on the ingest thread or
in the loop), the fan-out sender pool, the loops (scheduler, ingest
drain, reapers, journal flush and compaction, SLO, loop lag), every
client RPC of a single server, the metrics endpoint, the SLO engine and
the sampling profiler. The journal's open and close are `_open_journal`
and `_close_journal`, which `start()` and `shutdown()` call.

The allocation service (`autoalloc/`) runs beside the loops, and the
chaos plane's server sites fire under `HQ_FAULT_PLAN`. A federated server
(`federation_root=`, `shard_count=`) holds its shard's lease from before
the journal opens to the end, is fenced (and stops without stopping its
workers) when a successor claims the lease, lends idle workers and
exports or imports jobs live (`server/federation.py` drives both); with
`failover_watch=True` it also promotes dead siblings in its own process.
With `memory_transport=True` the server opens no listener: the
deterministic simulator (`sim/`) injects its connections through
`accept_worker`/`accept_client`.

Reference: crates/hyperqueue/src/server/bootstrap.rs (init_hq_server),
crates/tako/src/internal/server/rpc.rs (connection handling) and
scheduler/main.rs (Notify-woken, min-delay-throttled scheduler loop). The
whole server is one asyncio event loop — the reference's deliberately
single-threaded design carried over: state is mutated only from reactor
handlers running on this loop, so the scheduler snapshot needs no locks.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import socket
import time
from pathlib import Path

from hyperqueue_tpu_torch import __version__
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
from hyperqueue_tpu_torch.server.ingest import (
    INGEST_CHUNKS,
    INGEST_TASKS,
    IngestPlane,
)
from hyperqueue_tpu_torch.server.fanout import SendPool
from hyperqueue_tpu_torch.server.jobs import JobManager, JobTaskInfo
from hyperqueue_tpu_torch.server.journal_plane import JournalPlane
from hyperqueue_tpu_torch.server.lazy import ArrayChunk
from hyperqueue_tpu_torch.server.protocol import rqv_from_wire, submit_record
from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.server.task import Task, TaskState
from hyperqueue_tpu_torch.server.worker import Worker, WorkerConfiguration
from hyperqueue_tpu_torch.transport.aead import WIRE_BACKEND
from hyperqueue_tpu_torch.utils import chaos, profiler
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils.slo import SloEngine
from hyperqueue_tpu_torch.utils.trace import TRACER
from hyperqueue_tpu_torch.transport.auth import (
    ROLE_CLIENT,
    ROLE_SERVER,
    ROLE_WORKER,
    AuthError,
    Connection,
    do_authentication,
)
from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.server")

SCHEDULE_MIN_DELAY = 0.01  # seconds; reference msd: 500ms prod / 20ms in benches
# forced worker overview cadence while a dashboard/stream listens
# (reference DEFAULT_WORKER_OVERVIEW_INTERVAL, server/worker.rs:63)
OVERVIEW_OVERRIDE_INTERVAL = 2.0

# module-level instrument: _process_worker_message is the server's hottest
# message path, so the get-or-create lookup must not run per message
_WORKER_MESSAGES_TOTAL = REGISTRY.counter(
    "hq_worker_messages_total",
    "uplink messages processed on the worker plane",
    labels=("op",),
)
_SUBSCRIBERS_DROPPED = REGISTRY.counter(
    "hq_subscribers_dropped_total",
    "subscribe-RPC consumers dropped because their bounded event queue "
    "overflowed (slow consumer)",
)
_SUB_EVENTS_DROPPED = REGISTRY.counter(
    "hq_sub_events_dropped_total",
    "events not delivered to subscribers whose queue had overflowed",
)
_REACTOR_STALLS = REGISTRY.counter(
    "hq_reactor_stalls_total",
    "reactor stall-watchdog captures: a work class held the event loop "
    "past --stall-budget (flight recorder + trace dumped)",
    labels=("plane",),
)
# graceful drain: counted under the autoalloc family because the
# elasticity controller is the main driver; `source` separates manual
# `hq worker stop --drain` from controller scale-down
_DRAINS_TOTAL = REGISTRY.counter(
    "hq_autoalloc_drains_total",
    "graceful worker drains initiated (masked from the solve, running "
    "tasks allowed to finish)",
    labels=("source",),
)
_DRAIN_ESCALATIONS_TOTAL = REGISTRY.counter(
    "hq_autoalloc_drain_escalations_total",
    "drains that hit --drain-timeout and escalated to a clean stop "
    "(running tasks requeue without a crash charge — zero task loss)",
)
_DRAIN_SECONDS = REGISTRY.histogram(
    "hq_autoalloc_drain_seconds",
    "drain latency: drain start to the worker being told to stop",
    buckets=(0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 300.0),
)
# queue-age distribution backing the queue-age SLO (utils/slo.py): how
# long each dispatched task sat READY before being assigned. Buckets
# stretch past the default latency decades — queue ages are minutes on
# a saturated cluster, not milliseconds.
_TASK_QUEUE_AGE = REGISTRY.histogram(
    "hq_task_queue_age_seconds",
    "ready -> assigned latency of dispatched tasks",
    buckets=(0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0,
             1800.0, 7200.0),
)

# default deadline for a drain nobody bounded explicitly
DRAIN_TIMEOUT_DEFAULT = 120.0

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



class _Subscriber:
    """One subscribe-RPC consumer: a BOUNDED event queue plus its filter.

    The reactor never blocks on a subscriber: events are put_nowait into
    the queue, and a full queue marks the subscriber dead (dropped with a
    counter) instead of growing without bound — the backpressure contract
    the autoscaler feed and `hq top` rely on.
    """

    __slots__ = ("queue", "prefixes", "sample_interval", "dropped", "dead")

    def __init__(self, prefixes: tuple, sample_interval: float,
                 buffer: int = 4096):
        self.queue: asyncio.Queue = asyncio.Queue(
            maxsize=min(max(int(buffer), 64), 65536)
        )
        self.prefixes = prefixes
        self.sample_interval = sample_interval
        self.dropped = 0
        self.dead = False


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
        # caller asks for the CPU, as everywhere in the port). A promoted
        # successor gets it from federation_server_kwargs, so it solves
        # where its predecessor did.
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
        # control-plane events (`--flight-recorder-ticks`, 0 = off),
        # dumped by `hq server flight-recorder dump` and joined by
        # `hq task explain` / `hq server trace export`
        from hyperqueue_tpu_torch.utils.flight import FlightRecorder
        from hyperqueue_tpu_torch.utils.trace import LagTracker, TaskTraceStore

        self.core.flight = FlightRecorder(flight_recorder_ticks)
        # per-task distributed traces (`hq task trace`): bounded store,
        # `--task-trace-capacity 0` disables the whole plane (no store, no
        # trace headers on compute messages, no worker stamps)
        self.core.traces = TaskTraceStore(task_trace_capacity)
        # reactor loop-lag tracking + stall watchdog: every work class
        # (rpc/journal/solve/fanout) and the loop's own sleep-overshoot
        # feed hq_reactor_lag_seconds; an observation over --stall-budget
        # seconds auto-captures a flight-recorder + trace dump
        # (`--stall-budget 0` keeps the histograms but never captures)
        self.lag = LagTracker()
        # continuous profiling plane: always-on sampling profiler at
        # --profile-hz (0 = off); the profiler itself refuses simulated
        # clocks
        self.profile_hz = float(profile_hz)
        self._profiler_started = False
        self.stall_budget = float(stall_budget)
        self.stall_dumps = max(int(stall_dumps), 1)
        self.stalls_captured = 0
        self.last_stall: dict | None = None
        self._last_stall_capture = 0.0
        # subscribe-RPC consumers: bounded per-subscriber queues; slow
        # consumers are dropped (counter), never allowed to grow the queue
        # without bound (the autoscaler/`hq top` feed)
        self._subscribers: list[_Subscriber] = []
        # client-connection plane (server/ingest.py): "thread" (default)
        # moves accept/auth/framing/decode off the reactor loop onto a
        # dedicated thread with a batched handoff; "reactor" keeps the
        # in-loop handling (operational escape hatch)
        if client_plane not in ("thread", "reactor"):
            raise ValueError(f"unknown client plane {client_plane!r}")
        self.client_plane = client_plane
        # in-memory transport (the deterministic simulator, sim/): no TCP
        # listeners at all — connections are injected via accept_worker /
        # accept_client over in-memory stream pairs. Requires the in-loop
        # client plane: the threaded ingest plane owns real sockets on its
        # own thread, which a single-threaded deterministic run must not
        # have.
        self.memory_transport = bool(memory_transport)
        if self.memory_transport and client_plane != "reactor":
            raise ValueError(
                "memory_transport requires client_plane='reactor' "
                "(the threaded ingest plane owns real sockets)"
            )
        # connection-handler tasks spawned by accept_worker/accept_client
        # (TCP handlers belong to asyncio.Server), tracked so a simulated
        # kill -9 can cancel them abruptly
        self._conn_tasks: set = set()
        # journal plane (server/journal_plane.py): "thread" (default)
        # moves group commit + fsync onto a commit thread with
        # watermark-gated visibility; "reactor" keeps the inline
        # group-commit block (escape hatch, mirrors --client-plane)
        if journal_plane not in ("thread", "reactor"):
            raise ValueError(f"unknown journal plane {journal_plane!r}")
        self.journal_plane = journal_plane
        self.jplane: JournalPlane | None = None
        # fan-out plane (server/fanout.py): N sender threads running the
        # msgpack-encode + AEAD-seal half of every downlink send; 0 keeps
        # encodes inline on the owning loop
        self.fanout_senders = max(int(fanout_senders), 0)
        self.sendpool = SendPool(self.fanout_senders)
        self.ingest_window = ingest_window
        self.ingest_handoff_max = ingest_handoff_max
        self.ingest_plane: IngestPlane | None = None
        self._handoff_wake = asyncio.Event()
        # streaming-op tasks spawned by the ingest drain loop, cancelled
        # at shutdown (the in-loop plane ties their lifetime to the conn
        # task)
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
        # `federation_root` (None = classic standalone server). The shard
        # dir holds an atomic lease renewed by _lease_renew_loop; losing
        # it to a successor FENCES this instance (it stops immediately).
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
        # --failover-watch: this shard also volunteers as a successor for
        # dead sibling shards (claims gated on being idle itself)
        self.failover_watch = failover_watch
        self._watcher = None
        # graceful drains in flight: wid -> {deadline, started, source};
        # the drain reaper stops each worker once it settles idle or the
        # deadline escalates the drain to a clean stop
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
        # production health plane: the usage ledger folds the SAME
        # records the journal persists (live emit, replay, and migration
        # import all call observe — bit-equal by construction); the SLO
        # engine judges the metrics registry on sliding windows from
        # _slo_loop and journals alert transitions
        self.accounting = AccountingLedger()
        self.slo = SloEngine()
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
        self.access: serverdir.AccessRecord | None = None
        # the allocation service (autoalloc/service.py), built in start()
        self.autoalloc = None
        self.journal = None
        self.journal_path = journal_path
        self._stop_event = asyncio.Event()
        self._job_waiters: dict[int, list[asyncio.Event]] = {}
        self._event_listeners: list[asyncio.Queue] = []
        self._event_seq = 0
        # dashboards/streams that asked for live hardware overviews; while
        # any is attached, workers are forced onto a 2 s overview interval
        # (reference SetOverviewIntervalOverride, control.rs:180-203,
        # DEFAULT_WORKER_OVERVIEW_INTERVAL server/worker.rs:63)
        self._overview_listeners = 0
        self._worker_conns: dict[int, Connection] = {}
        self._tasks: list[asyncio.Task] = []
        self._servers: list[asyncio.base_events.Server] = []
        self.started_at = clock.now()
        # Prometheus exposition endpoint (utils/metrics.py): None = off
        # (the default — recording still happens, it is just not served),
        # 0 = ephemeral port, resolved into self.metrics_port at start()
        # and surfaced through `hq server info`. The endpoint is
        # UNAUTHENTICATED (Prometheus convention) — metrics_host lets a
        # deployment bind 127.0.0.1 behind a scraping sidecar.
        self.requested_metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.metrics_port: int | None = None
        self._metrics_server = None
        self._metrics_hook = None
        # hq_worker_* metric names currently fanned out from piggybacked
        # worker samples (cleared + rebuilt on every scrape)
        self._piggyback_names: set[str] = set()

    # ------------------------------------------------------------------
    async def start(self) -> serverdir.AccessRecord:
        # GC tuning: a tick allocates tens of thousands of short-lived
        # objects (assignments, messages); default thresholds fire gen-0
        # collections mid-tick and add ~30 ms pauses (measured as 20 ms ->
        # 50 ms tick spikes at 1M x 1k). Raised thresholds collect cycles in
        # bigger, rarer batches; startup state (including a restored
        # journal's task graph) is frozen at the END of start().
        import gc

        if not self.memory_transport:
            # simulator runs boot many Server objects per process; the
            # permanent-generation freeze at the end of start() would pin
            # every dead incarnation's state (and its device buffers) in
            # memory, so sim servers skip the GC tuning entirely
            gc.set_threshold(100_000, 50, 25)

        if self.federation_root is not None:
            import secrets as _secrets

            from hyperqueue_tpu_torch.utils.lease import ShardLease

            existing_fed = serverdir.load_federation(self.federation_root)
            if (
                existing_fed is not None
                and self.shard_count > int(existing_fed["shard_count"])
            ):
                # online shard add: booting shard N of an N+1-way count
                # against an N-way root GROWS the federation in place —
                # descriptor rewritten, ownership log records the join,
                # sibling shards keep running untouched
                serverdir.grow_federation(
                    self.federation_root, self.shard_count
                )
            else:
                serverdir.write_federation(
                    self.federation_root, self.shard_count
                )
            # claim the shard BEFORE touching the journal: the lease is
            # what guarantees one journal appender per shard — a double
            # start (or a failover race) must fail here, not interleave
            # records. Raises LeaseHeldError while the holder is alive.
            self.lease = ShardLease(self.server_dir, self.lease_timeout)
            self.lease_owner = f"{socket.gethostname()}:{os.getpid()}:" + (
                _secrets.token_hex(4)
            )
            lease_rec = self.lease.acquire(self.lease_owner)
            logger.info(
                "shard %d/%d lease acquired (epoch %d%s)",
                self.shard_id, self.shard_count, lease_rec["epoch"],
                ", promoted successor" if self.promoted else "",
            )
            # renew from the moment the claim lands: a promotion whose
            # journal restore outlasts --lease-timeout must not look
            # stale to ANOTHER successor mid-restore (two claimants =
            # two journal appenders, the exact thing the lease forbids)
            self._tasks.append(self._spawn_loop(self._lease_renew_loop))

        # the journal block: restore, appender, commit thread (the uid
        # record is journaled below, once the access record names it)
        await self._open_journal()
        # after the restore (which may replace self.jobs): pin this
        # shard's job-id allocator to its congruence class
        self._apply_job_id_partition()

        # pre-shared deployment (reference generate-access + serverdir.rs):
        # an access file pins ports and both plane keys so workers/clients on
        # other sites can be configured before the server starts
        preshared: serverdir.AccessRecord | None = None
        if self.access_file is not None:
            import json as _json

            with open(self.access_file) as f:
                raw = _json.load(f)
            # the server needs BOTH planes: a split client-only/worker-only
            # file (generate-access --client-file/--worker-file) would
            # silently disable auth + bind an ephemeral port on the missing
            # plane — reject it loudly (reference: only FullAccessRecord is
            # accepted by server start)
            missing = [p for p in ("client", "worker") if p not in raw]
            if missing:
                raise ValueError(
                    f"access file {self.access_file} is a split "
                    f"{'/'.join(sorted(set(('client', 'worker')) - set(missing)))}"
                    f"-only record; `server start --access-file` needs the "
                    f"full record (missing plane: {', '.join(missing)})"
                )
            preshared = serverdir.AccessRecord.from_json(raw)
            self.client_port = preshared.client_port
            self.worker_port = preshared.worker_port

        if self.memory_transport:
            # no listeners: the simulator injects connections directly
            # (accept_worker/accept_client); port 0 marks "not reachable
            # over TCP" in the access record
            self._servers = []
        else:
            worker_srv = await asyncio.start_server(
                self._handle_worker_conn, "0.0.0.0", self.worker_port
            )
            self._servers = [worker_srv]
            self.worker_port = worker_srv.sockets[0].getsockname()[1]
        if self.memory_transport:
            pass
        elif self.client_plane == "thread":
            # decoupled connection plane (server/ingest.py): client
            # sockets live on their own thread; decoded messages cross
            # into this loop through the batched handoff drained by
            # _ingest_drain_loop
            self.ingest_plane = IngestPlane(
                lambda: (
                    self.access.client_key_bytes() if self.access else None
                ),
                window=self.ingest_window,
                handoff_max=self.ingest_handoff_max,
                sendpool=self.sendpool,
            )
            self.client_port = self.ingest_plane.start(
                "0.0.0.0", self.client_port,
                asyncio.get_running_loop(), self._handoff_wake.set,
            )
        else:
            client_srv = await asyncio.start_server(
                self._handle_client_conn, "0.0.0.0", self.client_port
            )
            self._servers.append(client_srv)
            self.client_port = client_srv.sockets[0].getsockname()[1]

        self._metrics_hook = self._collect_metrics
        REGISTRY.add_collect_hook(self._metrics_hook)
        if self.requested_metrics_port is not None:
            from hyperqueue_tpu_torch.utils.metrics import start_metrics_server

            self._metrics_server, self.metrics_port = (
                await start_metrics_server(
                    REGISTRY, self.requested_metrics_port,
                    host=self.metrics_host,
                    probes={"/healthz": self._probe_healthz,
                            "/readyz": self._probe_readyz},
                )
            )
            logger.info(
                "metrics endpoint on http://%s:%d/metrics "
                "(+ /healthz /readyz)",
                self.metrics_host, self.metrics_port,
            )

        # continuous profiling plane: the reactor thread labels itself,
        # then the sampler starts. Memory-transport (simulator) servers
        # never start it: the profiler is real-wall-clock telemetry and
        # must stay inert under a virtual clock (its own is_simulated()
        # guard backstops this).
        if not self.memory_transport and self.profile_hz > 0:
            profiler.register_plane("reactor")
            self._profiler_started = profiler.start_profiler(self.profile_hz)
            if self._profiler_started:
                logger.info(
                    "sampling profiler on at %.3g Hz (--profile-hz)",
                    self.profile_hz,
                )

        instance_dir = serverdir.create_instance_dir(self.server_dir)
        self._instance_dir = instance_dir
        if preshared is not None:
            self.access = preshared
        else:
            self.access = serverdir.generate_access(
                self.host,
                self.client_port,
                self.worker_port,
                disable_client_auth=self.disable_client_auth,
                disable_worker_auth=self.disable_worker_auth,
            )
        serverdir.store_access(instance_dir, self.access)
        self._journal_server_uid(self.access.server_uid)

        from hyperqueue_tpu_torch.autoalloc.service import AutoAllocService

        # restores the allocation table a journal restore left in
        # `restored_autoalloc`, then runs its loop every
        # HQ_AUTOALLOC_INTERVAL seconds
        self.autoalloc = AutoAllocService(self, instance_dir / "autoalloc")
        self.autoalloc.start()
        self._tasks.append(self._spawn_loop(self._scheduler_loop))
        self._tasks.append(self._spawn_loop(self._heartbeat_reaper))
        self._tasks.append(self._spawn_loop(self._drain_reaper))
        self._tasks.append(self._spawn_loop(self._loop_lag_monitor))
        self._tasks.append(self._spawn_loop(self._slo_loop))
        if self.federation_root is not None and self.failover_watch:
            # idle-peer successor mode: this shard claims dead siblings,
            # but only while its own ready backlog is empty (a drowning
            # shard leaves the claim to the standby or another peer)
            from hyperqueue_tpu_torch.server.federation import FailoverWatcher

            self._watcher = FailoverWatcher(
                self.federation_root,
                server_kwargs=self.federation_server_kwargs(),
                lease_timeout=self.lease_timeout,
                own_shard=self.shard_id,
                eligible=lambda: self.core.queues.total_ready() == 0,
            )
            self._tasks.append(self._spawn_loop(self._watcher.run))
        if self.ingest_plane is not None:
            self._tasks.append(self._spawn_loop(self._ingest_drain_loop))
        if self.journal is not None and (
            self.journal_flush_period > 0 or self.journal_fsync == "periodic"
        ):
            self._tasks.append(self._spawn_loop(self._journal_flush_loop))
        if self.journal is not None and (
            self.journal_compact_interval > 0
            or self.journal_compact_threshold > 0
        ):
            self._tasks.append(self._spawn_loop(self._journal_compact_loop))
        if self.reattach_pending:
            # journal restore held maybe-running tasks for their pre-crash
            # workers; requeue whatever is unclaimed when the window closes
            self._tasks.append(self._spawn_loop(self._reattach_reaper))
        logger.info(
            "server started uid=%s client=%s:%d worker=%s:%d",
            self.access.server_uid,
            self.host,
            self.client_port,
            self.host,
            self.worker_port,
        )
        # freeze everything allocated so far (including a restored journal's
        # task graph) out of the GC generations: old-gen collections then
        # never re-traverse startup state mid-tick
        if not self.memory_transport:
            gc.collect()
            gc.freeze()
        return self.access

    async def _open_journal(self, server_uid: str | None = None) -> None:
        """The journal block of `start()`: restore from the snapshot +
        journal pair when there is one (off the event loop), open the
        appender and start the commit thread (`journal_plane="thread"`).
        With `server_uid`, also journal this boot's `server-uid` record
        (`start()` does that later, once the access record names the uid).
        Must run on the loop that will run the server: the journal plane
        releases its callbacks there."""
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
            # off the event loop: nothing else references this Server
            # yet, and a peer shard promoting a dead sibling
            # (--failover-watch) runs THIS start() on its own live
            # reactor — a multi-second journal replay inline would
            # freeze its scheduler, heartbeats, and worker plane
            await asyncio.get_running_loop().run_in_executor(
                None, restore_from_journal, self
            )
            if self.promoted and self.core.traces.enabled:
                # fleet trace stitching: every trace still open at
                # promotion lived through the shard death — stamp the
                # failover (lease epoch) so `hq task trace` and the fleet
                # export show the seam
                stamped = self.core.traces.annotate_open({
                    "kind": "failover",
                    "shard": self.shard_id,
                    "lease_epoch": (
                        self.lease.epoch if self.lease else 0
                    ),
                    "time": clock.now(),
                })
                if stamped:
                    logger.info(
                        "stamped failover annotation on %d open "
                        "trace(s)", stamped,
                    )
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
        if server_uid is not None:
            self._journal_server_uid(server_uid)

    def _journal_server_uid(self, server_uid: str) -> None:
        """Record this instance's uid in the journal so a future restore
        can verify that reattaching workers come from this lineage."""
        if self.journal is None:
            return
        self.journal_uids.add(server_uid)
        self.n_boots += 1
        self.emit_event("server-uid", {"server_uid": server_uid})

    def _close_journal(self) -> None:
        """The journal block of `shutdown()`: drain + join the commit
        thread, then close the appender; a plane that failed to drain
        keeps the appender open rather than closing the file under a
        still-writing thread."""
        plane_drained = self.jplane.stop() if self.jplane is not None \
            else True
        if self.journal is not None and plane_drained:
            self.journal.close()

    # --- memory transport (deterministic simulator) ---------------------
    def accept_worker(self, reader, writer) -> "asyncio.Task":
        """Inject a worker connection over an in-memory stream pair —
        the memory-transport equivalent of a TCP accept on the worker
        port.  Runs the REAL connection handler (auth handshake,
        register/reattach, sender + recv loops)."""
        return self._track_conn(self._handle_worker_conn(reader, writer))

    def accept_client(self, reader, writer) -> "asyncio.Task":
        """Inject a client connection (memory-transport equivalent of a
        TCP accept on the client port; in-loop plane)."""
        return self._track_conn(self._handle_client_conn(reader, writer))

    def _track_conn(self, coro) -> "asyncio.Task":
        task = asyncio.get_running_loop().create_task(coro)
        self._conn_tasks.add(task)
        task.add_done_callback(self._conn_tasks.discard)
        return task

    async def run_until_stopped(self) -> None:
        await self._stop_event.wait()
        await self.shutdown()

    def stop(self) -> None:
        self._stop_event.set()

    async def shutdown(self) -> None:
        if getattr(self, "autoalloc", None) is not None:
            self.autoalloc.stop()
            # in-flight qdel/scancel calls finish before the process
            # exits (a lost cancel = a leaked cluster job the journal
            # already believes cancelled)
            await self.autoalloc.drain_background()
        if self._watcher is not None:
            # peer-successor mode: shards this process promoted into are
            # full Servers of their own — stop them with us
            await self._watcher.shutdown()
        if not self.fenced:
            for wid in list(self._worker_conns):
                self.comm.send_stop(wid)
            await asyncio.sleep(0.05)
        # a FENCED instance must NOT stop its workers: they are the
        # promoted successor's fleet now — closing the connections below
        # makes them reconnect (and reattach) to it, a `stop` op would
        # kill them unconditionally
        for t in self._tasks:
            t.cancel()
        for t in list(self._client_tasks):
            t.cancel()
        for t in list(self._conn_tasks):
            t.cancel()
        for srv in self._servers:
            srv.close()
        if self.ingest_plane is not None:
            self.ingest_plane.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if self._metrics_hook is not None:
            REGISTRY.remove_collect_hook(self._metrics_hook)
        if self._profiler_started:
            profiler.stop_profiler()
            self._profiler_started = False
        for conn in self._worker_conns.values():
            conn.close()
        self.sendpool.stop()
        # the solve thread ends with the server (the JAX package leaves it
        # parked as a daemon)
        self.model.close()
        # and so does the device-resident state: a successor promoted in a
        # standby or a peer shard (and one fenced there) stops while its
        # process lives on
        invalidate = getattr(self.model.model, "invalidate_resident", None)
        if invalidate is not None:
            invalidate()
        self._close_journal()
        if self.lease is not None:
            # clean stop: retire the lease so failover watchers never
            # promote a successor for a deliberately-stopped shard. A
            # FENCED instance skips this implicitly (release() refuses to
            # delete a lease it no longer owns).
            self.lease.release()
        # a clean stop retires the hq-current symlink so clients see "no
        # server" instead of a dead address (reference server stop removes
        # the symlink; test_server.py delete_symlink_after_server_stop).
        # Only if it still points at THIS instance — a newer server owns it
        # otherwise.
        link = self.server_dir / serverdir.CURRENT_LINK
        try:
            instance_dir = getattr(self, "_instance_dir", None)
            if (
                instance_dir is not None
                and link.is_symlink()
                and (self.server_dir / os.readlink(link)).resolve()
                == instance_dir.resolve()
            ):
                link.unlink()
        except OSError:
            pass  # cleanup is best-effort; a dead link is still harmless

    # --- federation ----------------------------------------------------
    def federation_server_kwargs(self) -> dict:
        """The config subset a promoted sibling Server clones from this
        one (FailoverWatcher in peer-successor mode). Ports and keys are
        NOT cloned — a successor publishes a fresh access record and the
        reconnect machinery re-reads it. `device` is cloned: a successor
        solves where its predecessor did (the card, or the CPU where the
        caller asked for it), never on a fallback. Keep in lockstep with
        the standby path's server_kwargs in cli._run_standby."""
        return dict(
            device=self.device,
            scheduler=self.scheduler_kind,
            schedule_min_delay=self.schedule_min_delay,
            journal_fsync=self.journal_fsync,
            journal_flush_period=self.journal_flush_period,
            journal_compact_interval=self.journal_compact_interval,
            journal_compact_threshold=self.journal_compact_threshold,
            journal_salvage=self.journal_salvage,
            heartbeat_timeout_factor=self.heartbeat_timeout_factor,
            reattach_timeout=self.reattach_timeout,
            idle_timeout=self.idle_timeout,
            client_plane=self.client_plane,
            journal_plane=self.journal_plane,
            fanout_senders=self.fanout_senders,
            policy_file=self.policy_file,
            lazy_array_threshold=(
                self.lazy_array_threshold
                if self.lazy_array_threshold < (1 << 62) else 0
            ),
        )

    def _apply_job_id_partition(self) -> None:
        """Pin the job-id allocator to this shard's congruence class:
        shard k of N allocates ids with (id - 1) % N == k, so shards
        never collide and a job id alone routes a client. Applied after
        the journal restore — the restored watermark is carried into the
        strided counter."""
        if self.shard_count <= 1:
            return
        counter = self.jobs.job_id_counter
        from hyperqueue_tpu_torch.ids import IdCounter

        base_count = self.shard_count
        if self.federation_root is not None:
            fed = serverdir.load_federation(self.federation_root)
            if fed:
                base_count = int(fed.get("base_shard_count",
                                         fed["shard_count"]))
        if self.shard_id >= base_count:
            # shard added online: the modulo classes are frozen
            # at base_shard_count, so this shard allocates from its
            # reserved high id block instead — the id alone still routes
            from hyperqueue_tpu_torch.utils.ownership import added_shard_block

            lo, _hi = added_shard_block(self.shard_id, base_count)
            blocked = IdCounter(start=lo + 1, stride=1)
            blocked.ensure_above(counter.peek() - 1)
            self.jobs.job_id_counter = blocked
            return
        strided = IdCounter(
            start=self.shard_id + 1, stride=base_count
        )
        strided.ensure_above(counter.peek() - 1)
        self.jobs.job_id_counter = strided

    async def _lease_renew_loop(self) -> None:
        """Renew this shard's lease on ~timeout/3; a renewal that finds a
        successor's claim means this instance was presumed dead and has
        been FENCED — stop immediately rather than keep a second
        scheduler + journal appender alive."""
        interval = max(self.lease.timeout / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                ok = self.lease.renew()
            except OSError as e:
                # a transient FS error must not fence a healthy shard;
                # the NEXT renewal either succeeds or the staleness clock
                # runs out honestly
                logger.warning("lease renew failed (%s); retrying", e)
                continue
            if not ok:
                claim = self.lease.read() or {}
                logger.critical(
                    "shard %d lease claimed by successor %r (epoch %s); "
                    "this instance is fenced — stopping",
                    self.shard_id, claim.get("owner"), claim.get("epoch"),
                )
                self.fenced = True
                self.stop()
                return

    def _federation_block(self) -> dict | None:
        """The federation section of `hq server info`/`stats` (None on a
        standalone server)."""
        if self.federation_root is None:
            return None
        lease = (self.lease.read() if self.lease else None) or {}
        borrowed = sum(
            1
            for w in self.core.workers.values()
            if getattr(w.configuration, "lent_from", -1) >= 0
        )
        age = self.lease.age_seconds() if self.lease else None
        return {
            "shard_id": self.shard_id,
            "shard_count": self.shard_count,
            "partition": (
                f"(job_id - 1) % {self.shard_count} == {self.shard_id}"
            ),
            "lease_owner": lease.get("owner"),
            "lease_epoch": lease.get("epoch"),
            "lease_age_seconds": (
                round(age, 3) if age is not None else None
            ),
            "promoted": self.promoted,
            "fenced": self.fenced,
            "workers_lent": self.workers_lent_total,
            "workers_borrowed": borrowed,
            "jobs_migrated_out": len(self.migrated_out),
            "jobs_migrating_out": len(self.migrating_out),
            "jobs_migrated_in": len(self.migrations_in),
        }

    # --- health plane ---------------------------------------------------
    async def _slo_loop(self) -> None:
        """Periodic SLO evaluation (utils/slo.py): judge the metrics
        registry on sliding windows and JOURNAL every alert transition —
        firing/resolved ride the subscribe plane and the FleetFeed like
        any other event, and a restored server re-derives alert state
        from fresh windows rather than trusting stale ones."""
        while True:
            await asyncio.sleep(self.slo.interval)
            for transition in self.slo.evaluate():
                self.emit_event("slo-alert", transition)

    def _probe_healthz(self) -> tuple[bool, dict]:
        """Liveness: the probe answering at all IS the signal (it runs
        on the reactor loop — a wedged loop cannot reply). Only a fatal
        journal-plane death marks a live process unhealthy: the process
        exists but has lost its durability guarantee."""
        if self.jplane is not None and self.jplane._thread is not None \
                and not self.jplane._thread.is_alive():
            return False, {"reason": "journal plane dead"}
        return True, {"uptime": round(clock.now() - self.started_at, 3)}

    def _probe_readyz(self) -> tuple[bool, dict]:
        """Readiness: should an orchestrator (or the standby/rebalancer)
        route work here? Every check is O(1) reads of live state."""
        checks: dict[str, str] = {}
        ok = True
        if self.jplane is not None:
            alive = (
                self.jplane._thread is not None
                and self.jplane._thread.is_alive()
            )
            checks["journal_plane"] = "ok" if alive else "dead"
            ok = ok and alive
        if self.lease is not None:
            age = self.lease.age_seconds()
            held = (
                not self.fenced
                and age is not None
                and age < self.lease_timeout
            )
            checks["lease"] = (
                "ok" if held else
                ("fenced" if self.fenced else "stale")
            )
            ok = ok and held
        armed = bool(self.model.stats().get("armed"))
        checks["solver"] = "ok" if armed else "degraded"
        ok = ok and armed
        if self.ingest_plane is not None:
            depth = len(self.ingest_plane.handoff)
            below = depth < self.ingest_handoff_max
            checks["ingest"] = (
                "ok" if below else f"backpressure ({depth})"
            )
            ok = ok and below
        paging = self.slo.paging_alerts()
        checks["slo"] = (
            "ok" if not paging else
            "paging: " + ",".join(a["alert"] for a in paging)
        )
        ok = ok and not paging
        return ok, {"checks": checks}

    async def _client_accounting(self, msg: dict) -> dict:
        """Usage ledger query (`hq job accounting` / `hq fleet
        accounting`): per-job rows for an explicit selection, or the
        per-label rollup when none is given."""
        job_ids = msg.get("job_ids")
        out: dict = {"op": "accounting", "shard": self.shard_id}
        if job_ids:
            report = self.accounting.job_report(
                [int(j) for j in job_ids]
            )
            # a LIST (each row carries its job id): the federated client
            # splits a selector across shards and merges responses by
            # list concatenation — a dict keyed by job id would silently
            # keep only the first shard's rows
            out["jobs"] = [
                {"job": j, **row} for j, row in sorted(report.items())
            ]
        else:
            out["rollup"] = self.accounting.rollup()
        return out

    async def _client_alerts(self, msg: dict) -> dict:
        """`hq alerts`: currently-firing SLO alerts + recent transitions
        (fan-out across shards happens client-side, like server_stats)."""
        return {"op": "alerts", "shard": self.shard_id,
                **self.slo.alerts()}

    def _alert_badge(self) -> dict:
        return self.slo.badge()

    async def _client_worker_lend(self, msg: dict) -> dict:
        """Lend an IDLE worker to another shard: order it to re-register
        there (federation coordinator RPC). No task state moves — that is
        the whole point: elasticity without migration."""
        wid = int(msg["worker_id"])
        target = int(msg["to_shard"])
        if self.federation_root is None:
            return {"op": "error", "message": "not a federated server"}
        if not (0 <= target < self.shard_count) or target == self.shard_id:
            return {"op": "error", "message": f"bad target shard {target}"}
        worker = self.core.workers.get(wid)
        if worker is None:
            return {"op": "error", "message": f"worker {wid} not found"}
        if worker.assigned_tasks or worker.prefilled_tasks:
            # never lend a busy worker: its running tasks belong to THIS
            # shard's journal and must finish (or reattach) here
            return {"op": "worker_lend", "lent": False, "reason": "busy"}
        if worker.configuration.on_server_lost != "reconnect":
            # a lent worker must survive the borrower dying (reattach to
            # its successor) — any other policy would make the lend a
            # one-way trip to a worker exit on the first hiccup
            return {"op": "worker_lend", "lent": False, "reason": "policy"}
        self._lent_workers[wid] = target
        self.workers_lent_total += 1
        self.comm.send_redirect(wid, target, self.shard_id)
        logger.info(
            "lending idle worker %d to shard %d", wid, target,
            extra={"worker": wid},
        )
        return {"op": "worker_lend", "lent": True, "to_shard": target}

    # --- live job migration --------------------------------------------
    def _migration_barrier(self) -> None:
        """Durability barrier for the migration protocol: the journaled
        migration record must be ON DISK before the RPC reply leaves —
        kill -9 right after the ack must replay to the same decision."""
        if self.journal is None:
            return
        if self.jplane is not None:
            self.jplane.barrier(sync=True)
        else:
            if self.journal.in_batch:
                self.journal.commit_batch()
            self.journal.flush(sync=True)

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

    def _guard_job_ids(self, job_ids) -> dict | None:
        """Job-op guard: redirect only when EVERY requested job moved
        (mixed batches fall through — absent jobs are simply omitted
        from the reply, exactly like unknown ids always were)."""
        guards = [self._owned_elsewhere(j) for j in job_ids]
        if guards and all(g is not None for g in guards):
            return guards[0]
        return None

    async def _client_migration_export(self, msg: dict) -> dict:
        """Phase 1 of a live migration (driver RPC): seal + drain the job
        and return a self-contained, versioned migration record.

        Sealing = pause (READY held, lazy chunks detached in chunk form,
        prefilled retracted) + RECALL of ASSIGNED/RUNNING tasks (resources
        released, worker's incarnation canceled, instance bumped — the
        fence). The `migration-out` journal record carries only {mig, to,
        fence}, NOT the record: a source crash after the barrier restores
        the job PAUSED, and a re-driven export rebuilds an equivalent
        record from that state — safe because the sealed job made no
        progress in between."""
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod

        mig = str(msg.get("mig") or "")
        job_id = int(msg.get("job", 0))
        to_shard = int(msg.get("to", -1))
        if not mig:
            return {"op": "error", "message": "migration_export needs mig"}
        guard = self._owned_elsewhere(job_id)
        if guard is not None and guard.get("code") == "wrong-shard":
            return guard
        out = self.migrating_out.get(job_id)
        if out is not None and out.get("mig") != mig:
            return {"op": "error",
                    "message": f"job {job_id} is sealed by migration "
                               f"{out.get('mig')!r}, not {mig!r}"}
        job = self.jobs.jobs.get(job_id)
        if job is None:
            return {"op": "error", "message": f"unknown job {job_id}"}
        if out is None:
            reactor.pause_jobs(self.core, self.comm, [job_id])
            recall_ids = [
                make_task_id(job_id, info.job_task_id)
                for info in job.tasks.values()
                if info.status in ("waiting", "running")
            ]
            reactor.recall_tasks(self.core, self.comm, recall_ids)
            self.migrating_out[job_id] = {"mig": mig, "to": to_shard}
            fence = self._job_fence(job_id, job)
            self.emit_event(
                "migration-out",
                {"job": job_id, "mig": mig, "to": to_shard, "fence": fence},
            )
            self._migration_barrier()
        bodies: list = []
        body_index: dict = {}
        requests: list = []
        request_index: dict = {}
        record = {
            "version": 1,
            "mig": mig,
            "job": job_id,
            "from": self.shard_id,
            "to": to_shard,
            "fence": self._job_fence(job_id, job),
            "bodies": bodies,
            "requests": requests,
            "job_state": snapshot_mod.capture_job(
                self, job, bodies, body_index, requests, request_index
            ),
            # accrued usage rides the record: the destination
            # seeds it from the journaled migration-in, the source drops
            # its row at the migration-out-done tombstone — the ledger
            # moves exactly once, with the job
            "accounting": self.accounting.export_job(job_id),
        }
        return {"op": "migration_export", "mig": mig, "record": record}

    def _job_fence(self, job_id: int, job) -> int:
        """Highest instance id this shard could have issued for the job:
        the destination floors every imported task AT it, so any late
        uplink from this (possibly SIGSTOP'd) shard's workers carries a
        strictly smaller instance id and is discarded over there."""
        fence = int(self.core.instance_fence_floor)
        for info in job.tasks.values():
            task = self.core.tasks.get(
                make_task_id(job_id, info.job_task_id)
            )
            if task is not None:
                fence = max(fence, task.instance_id)
        return fence

    async def _client_migration_import(self, msg: dict) -> dict:
        """Phase 2: durably adopt a migration record. The `migration-in`
        journal record embeds the WHOLE record before any in-memory state
        changes — kill -9 after the barrier replays the import; kill
        before it leaves nothing, and the driver re-sends. Duplicate
        imports (re-driven migrations) ack dup instead of double-seeding
        — same exactly-once discipline as SubmitStream chunk replay."""
        rec = msg.get("record") or {}
        mig = str(msg.get("mig") or rec.get("mig") or "")
        job_id = rec.get("job_state", {}).get("id")
        if not mig or job_id is None:
            return {"op": "error", "message": "malformed migration record"}
        if mig in self.migrations_in or job_id in self.jobs.jobs:
            return {"op": "migration_import", "mig": mig, "dup": True}
        self.emit_event(
            "migration-in", {"job": job_id, "mig": mig, "record": rec}
        )
        self._apply_migration_record(rec)
        self.migrations_in[mig] = job_id
        self._migration_barrier()
        return {"op": "migration_import", "mig": mig, "dup": False}

    async def _client_migration_finalize(self, msg: dict) -> dict:
        """Phase 3 (post-commit): drop the sealed source copy, leaving a
        journaled tombstone for wrong-shard redirects. Idempotent — the
        driver may re-send after a crash on either side."""
        mig = str(msg.get("mig") or "")
        job_id = int(msg.get("job", 0))
        to_shard = int(msg.get("to", -1))
        if job_id in self.migrated_out or job_id not in self.jobs.jobs:
            return {"op": "migration_finalize", "mig": mig, "dup": True}
        self.emit_event(
            "migration-out-done",
            {"job": job_id, "mig": mig, "to": to_shard},
        )
        job = self.jobs.jobs.pop(job_id)
        for job_task_id in job.tasks:
            self.core.tasks.pop(make_task_id(job_id, job_task_id), None)
        self.core.paused_jobs.discard(job_id)
        self.core.paused_held.pop(job_id, None)
        self.core.lazy.forget_job(job_id)
        for uid in job.streams:
            self._stream_jobs.pop(uid, None)
        # job_wait callers must not hang on a job that left: wake them —
        # their follow-up job_info gets the wrong-shard redirect
        for event in self._job_waiters.pop(job_id, ()):
            event.set()
        self.migrating_out.pop(job_id, None)
        self.migrated_out[job_id] = to_shard
        self._migration_barrier()
        return {"op": "migration_finalize", "mig": mig, "dup": False}

    def _apply_migration_record(self, rec: dict) -> None:
        """Install an exported job into the LIVE server (the in-memory
        twin of restore's migration-in replay — events/restore.py
        _seed_migration_record covers the post-crash path). Lazy chunks
        re-register in chunk form: importing a 1M-task lazy array is
        O(chunks), never O(tasks)."""
        jd = rec["job_state"]
        bodies = rec.get("bodies") or []
        requests = rec.get("requests") or []
        job_id = jd["id"]
        # a job can migrate BACK to a shard that once exported it: the
        # old wrong-shard tombstone must die with the import, or this
        # shard keeps redirecting requests for a job it owns again
        self.migrating_out.pop(job_id, None)
        self.migrated_out.pop(job_id, None)
        job = self.jobs.create_job(
            name=jd["name"],
            submit_dir=jd["submit_dir"],
            max_fails=jd["max_fails"],
            is_open=jd["open"],
            job_id=job_id,
        )
        job.submitted_at = jd["submitted_at"]
        job.cancel_reason = jd["cancel_reason"]
        job.submits = list(jd["submits"])
        status_of: dict[int, str] = {}
        for tid, status, error, finished_at, started_at, submitted_at in (
            jd["done"]
        ):
            self.jobs.attach_task(job, tid)
            info = job.tasks[tid]
            info.submitted_at = submitted_at
            info.status = status
            info.error = error
            info.finished_at = finished_at
            if started_at:
                info.started_at = started_at
            job.counters[status] += 1
            status_of[tid] = status
        for uid, s in (jd.get("streams") or {}).items():
            job.streams[uid] = {
                "applied": set(s["applied"]), "sealed": bool(s["sealed"]),
            }
            if not s["sealed"]:
                job.open_streams += 1
            self._stream_jobs[uid] = job_id
        fence = max(
            int(rec.get("fence", 0)), int(self.core.instance_fence_floor)
        )
        new_tasks = []
        for t in jd["pending"]:
            tid = t["id"]
            self.jobs.attach_task(job, tid)
            job.tasks[tid].submitted_at = t["submitted_at"]
            deps = tuple(
                make_task_id(job_id, d)
                for d in t.get("deps", ())
                if status_of.get(d) != "finished"
            )
            if any(
                status_of.get(d) in ("failed", "canceled")
                for d in t.get("deps", ())
            ):
                job.tasks[tid].status = "canceled"
                job.counters["canceled"] += 1
                continue
            task = Task(
                task_id=make_task_id(job_id, tid),
                rq_id=self.core.intern_rqv(rqv_from_wire(
                    requests[t["rq"]], self.core.resource_map
                )),
                priority=(int(t.get("priority", 0)),
                          encode_sched_priority(job_id)),
                body=bodies[t["b"]],
                entry=t.get("entry"),
                deps=deps,
                crash_limit=int(t.get("crash_limit", 5)),
            )
            task.crash_counter = int(t.get("crashes", 0))
            # monotonic across the move: floor at the source's fence,
            # then bump past it — the source's recalled incarnations
            # (and a SIGSTOP'd source's late uplinks) are all stale here
            task.instance_id = int(t.get("instance", 0))
            task.fence_instance(fence)
            new_tasks.append(task)
        if new_tasks:
            reactor.on_new_tasks(self.core, self.comm, new_tasks)
        for spec in jd.get("lazy") or ():
            rqv = rqv_from_wire(
                requests[spec["rq"]], self.core.resource_map
            )
            chunk = ArrayChunk(
                job_id=job_id,
                rq_id=self.core.intern_rqv(rqv),
                priority=(int(spec.get("priority", 0)),
                          encode_sched_priority(job_id)),
                body=bodies[spec["b"]],
                crash_limit=int(spec.get("crash_limit", 5)),
                id_range=(
                    tuple(spec["id_range"]) if "id_range" in spec else None
                ),
                ids=(
                    [int(i) for i in spec["ids"]]
                    if "ids" in spec else None
                ),
                entries=spec.get("entries"),
                submitted_at=float(spec.get("submitted_at") or 0.0),
                ready_at=float(spec.get("ready_at") or 0.0),
                trace=spec.get("trace"),
            )
            self.core.lazy.register(self.core, chunk)
            for dead in spec.get("dead") or ():
                self.core.lazy.drop_id(self.core, job_id, dead)
        self.check_job_completion(job_id)
        self.comm.ask_for_scheduling()

    # --- metrics --------------------------------------------------------
    def _collect_metrics(self) -> None:
        """Refresh cluster-state gauges at scrape time (utils/metrics.py
        collect hook): nothing here runs on a hot path, and everything is
        O(workers + queues), never O(tasks) — walking a million-task map
        per scrape would make the scrape itself a perturbation."""
        core = self.core
        REGISTRY.gauge(
            "hq_workers_connected", "workers currently registered"
        ).set(len(core.workers))
        REGISTRY.gauge(
            "hq_tasks_known", "tasks in the server core (all states)"
        ).set(len(core.tasks))
        REGISTRY.gauge(
            "hq_tasks_ready_queued", "single-node tasks in the ready queues"
        ).set(core.queues.total_ready())
        REGISTRY.gauge(
            "hq_tasks_mn_queued", "multi-node gang tasks awaiting workers"
        ).set(len(core.mn_queue))
        REGISTRY.gauge(
            "hq_jobs_known", "jobs known to the server"
        ).set(len(self.jobs.jobs))
        REGISTRY.gauge(
            "hq_reattach_pending_tasks",
            "restored maybe-running tasks held for worker reattach",
        ).set(len(self.reattach_pending))
        # event stream backpressure: listeners and the deepest unsent queue
        REGISTRY.gauge(
            "hq_event_listeners", "attached event-stream clients"
        ).set(len(self._event_listeners))
        # subscription plane (subscribe RPC) + per-task trace store health
        REGISTRY.gauge(
            "hq_event_subscribers", "attached subscribe-RPC consumers"
        ).set(len(self._subscribers))
        REGISTRY.gauge(
            "hq_sub_queue_depth",
            "deepest per-subscriber backlog of undelivered events",
        ).set(
            max((s.queue.qsize() for s in self._subscribers), default=0)
        )
        # ingest plane + lazy store: depth/client gauges are read here at
        # scrape time (single-writer rule: the counters are bumped by the
        # reactor/ingest threads, never from the scrape)
        lazy_stats = core.lazy.stats()
        REGISTRY.gauge(
            "hq_tasks_lazy",
            "unmaterialized lazy array tasks (registered as chunks, "
            "per-task records deferred to dispatch)",
        ).set(lazy_stats["unmaterialized"])
        if self.jplane is not None:
            REGISTRY.gauge(
                "hq_journal_plane_depth",
                "journal records enqueued to the commit thread, not yet "
                "committed (sustained growth = the disk is the bottleneck)",
            ).set(self.jplane.depth())
        REGISTRY.gauge(
            "hq_fanout_plane_senders",
            "sender-pool threads running the downlink encode+seal "
            "(--fanout-senders; 0 = inline on the owning loop)",
        ).set(self.fanout_senders)
        if self.ingest_plane is not None:
            REGISTRY.gauge(
                "hq_ingest_handoff_depth",
                "decoded client messages queued between the connection "
                "plane and the reactor",
            ).set(len(self.ingest_plane.handoff))
            REGISTRY.gauge(
                "hq_ingest_clients",
                "client connections held by the connection plane",
            ).set(len(self.ingest_plane.clients))
        if self.federation_root is not None:
            fed = self._federation_block() or {}
            REGISTRY.gauge(
                "hq_federation_lease_age_seconds",
                "seconds since this shard's lease was last renewed "
                "(staleness past the timeout makes the shard claimable)",
            ).set(fed.get("lease_age_seconds") or 0.0)
            REGISTRY.counter(
                "hq_federation_workers_lent_total",
                "idle workers this shard ordered to re-register with "
                "another shard (federation coordinator lending)",
            ).set_total(self.workers_lent_total)
            REGISTRY.gauge(
                "hq_federation_workers_borrowed",
                "currently-registered workers lent to this shard by a "
                "sibling (register carried lent_from)",
            ).set(fed.get("workers_borrowed") or 0)
            REGISTRY.counter(
                "hq_federation_jobs_moved_total",
                "jobs this shard finished migrating out (ownership "
                "tombstone journaled; live migration)",
            ).set_total(len(self.migrated_out))
            try:
                from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

                REGISTRY.gauge(
                    "hq_federation_ownership_epoch",
                    "last epoch in the federation ownership log (the "
                    "fencing token of the migration protocol)",
                ).set(OwnershipStore(self.federation_root).current_epoch())
            except OSError:
                pass
        # usage accounting rollup: per-label resource-time
        # totals from the ledger, rebuilt each scrape so labels whose jobs
        # all migrated away vanish instead of lingering at stale values
        rollup = self.accounting.rollup()
        acct_jobs = REGISTRY.gauge(
            "hq_accounting_jobs",
            "jobs with accrued usage in the ledger, by job label",
            labels=("label",), max_series=256,
        )
        acct_task = REGISTRY.counter(
            "hq_accounting_task_seconds_total",
            "wall-clock task execution seconds accrued, by job label",
            labels=("label",), max_series=256,
        )
        acct_cpu = REGISTRY.counter(
            "hq_accounting_cpu_seconds_total",
            "cpu-seconds accrued (amount x run seconds), by job label",
            labels=("label",), max_series=256,
        )
        acct_gpu = REGISTRY.counter(
            "hq_accounting_gpu_seconds_total",
            "gpu-seconds accrued (amount x run seconds), by job label",
            labels=("label",), max_series=256,
        )
        acct_wait = REGISTRY.counter(
            "hq_accounting_wait_seconds_total",
            "ready -> running wait seconds accrued, by job label",
            labels=("label",), max_series=256,
        )
        acct_crash = REGISTRY.counter(
            "hq_accounting_crash_retries_total",
            "crash-charged task retries, by job label",
            labels=("label",), max_series=256,
        )
        for metric in (acct_jobs, acct_task, acct_cpu, acct_gpu,
                       acct_wait, acct_crash):
            metric.clear()
        for label, agg in rollup["labels"].items():
            acct_jobs.labels(label).set(agg["jobs"])
            acct_task.labels(label).set_total(agg["task_seconds"])
            acct_cpu.labels(label).set_total(agg["cpu_seconds"])
            acct_gpu.labels(label).set_total(agg["gpu_seconds"])
            acct_wait.labels(label).set_total(agg["wait_seconds"])
            acct_crash.labels(label).set_total(agg["crash_retries"])
        trace_stats = core.traces.stats()
        REGISTRY.gauge(
            "hq_task_traces", "tasks with spans in the bounded trace store"
        ).set(trace_stats["tasks"])
        REGISTRY.counter(
            "hq_task_trace_evictions_total",
            "task traces evicted from the bounded store",
        ).set_total(trace_stats["evictions"])
        REGISTRY.gauge(
            "hq_event_stream_depth",
            "deepest per-listener backlog of undelivered events",
        ).set(
            max((q.qsize() for q in self._event_listeners), default=0)
        )
        REGISTRY.counter(
            "hq_events_emitted_total", "server events emitted (journal seq)"
        ).set_total(self._event_seq)
        # solver watchdog: adopt its externally-tracked monotonic counters
        wd = self.model.stats()
        REGISTRY.gauge(
            "hq_solver_armed",
            "1 while the primary solver is armed, 0 while degraded to the "
            "host-greedy fallback",
        ).set(1.0 if wd.get("armed") else 0.0)
        for key in ("failures", "timeouts", "degraded_ticks", "rearms",
                    "skipped_ticks"):
            REGISTRY.counter(
                f"hq_solver_{key}_total",
                f"solver watchdog {key.replace('_', ' ')} "
                "(scheduler/watchdog.py)",
            ).set_total(wd.get(key, 0))
        if self.journal_path is not None:
            # durability-plane gauges: both are one stat() each — the
            # scrape must never walk the journal
            try:
                journal_bytes = float(self.journal_path.stat().st_size)
            except OSError:
                journal_bytes = 0.0
            REGISTRY.gauge(
                "hq_journal_size_bytes",
                "event journal file size (compaction bounds this)",
            ).set(journal_bytes)
            from hyperqueue_tpu_torch.events import snapshot as snapshot_mod

            snap_stats = snapshot_mod.snapshot_stats(self.journal_path)
            REGISTRY.gauge(
                "hq_snapshot_age_seconds",
                "age of the newest journal snapshot (-1 = no snapshot yet)",
            ).set(
                snap_stats["age_seconds"]
                if snap_stats["age_seconds"] is not None
                else -1.0
            )
        cache = core.tick_cache.counters()
        for key in ("full_rebuilds", "incremental_syncs"):
            REGISTRY.counter(
                f"hq_tick_cache_{key}_total",
                f"tick snapshot cache {key.replace('_', ' ')}",
            ).set_total(cache.get(key, 0))
        # solve backend + device-resident state (parallel/resident.py):
        # which backend the last solve ran, how many bytes the device path
        # uploaded (full + delta), and how many rows were dirty last tick
        resident = {}
        get_resident = getattr(self.model, "resident_stats", None)
        if get_resident is not None:
            try:
                resident = get_resident()
            except Exception:  # noqa: BLE001 - metrics must never break
                resident = {}
        backend_gauge = REGISTRY.gauge(
            "hq_solve_backend",
            "1 for the backend the last solve ran on "
            "(host-native/host-numpy/device-cuda/device-sharded)",
            labels=("backend",), max_series=8,
        )
        backend_gauge.clear()
        if resident.get("backend"):
            backend_gauge.labels(resident["backend"]).set(1.0)
        if resident:
            REGISTRY.counter(
                "hq_device_upload_bytes_total",
                "bytes uploaded to the solve device (full uploads + "
                "dirty-row deltas + replicated-input placements)",
            ).set_total(resident.get("upload_bytes_total", 0))
            REGISTRY.gauge(
                "hq_tick_dirty_rows",
                "worker rows the device path uploaded last solve "
                "(delta size; W on a full upload)",
            ).set(resident.get("dirty_rows_last", 0))
            for key in ("full_uploads", "delta_uploads", "invalidations",
                        "rep_cache_hits"):
                REGISTRY.counter(
                    f"hq_resident_{key}_total",
                    f"device-resident tick state {key.replace('_', ' ')}",
                ).set_total(resident.get(key, 0))
        pipeline = core.tick_pipeline
        if pipeline is not None:
            ps = pipeline.stats()
            REGISTRY.gauge(
                "hq_tick_pipeline_depth",
                "solves currently in flight in the async tick pipeline "
                "(0 or 1)",
            ).set(ps["depth"])
            for key in ("dispatched", "mapped", "drains"):
                REGISTRY.counter(
                    f"hq_tick_pipeline_{key}_total",
                    f"async tick pipeline: solves {key}",
                ).set_total(ps[key])
        # per-worker gauges: the server's own accounting, plus whatever
        # gauges/counters the worker piggybacked on its last overview
        # message (cluster-wide re-export under a `worker` label)
        assigned = REGISTRY.gauge(
            "hq_worker_assigned_tasks",
            "tasks with accounted resources on each worker",
            labels=("worker",), max_series=4096,
        )
        prefilled = REGISTRY.gauge(
            "hq_worker_prefilled_tasks",
            "tasks queued on each worker beyond current capacity",
            labels=("worker",), max_series=4096,
        )
        assigned.clear()  # departed workers' series must not linger
        prefilled.clear()
        # piggybacked metric series are rebuilt from scratch each scrape so
        # a departed worker's samples vanish with it
        for name in self._piggyback_names:
            metric = REGISTRY.get(name)
            if metric is not None:
                metric.clear()
        self._piggyback_names = set()
        piggybacked = self._piggyback_names
        for w in core.workers.values():
            assigned.labels(w.worker_id).set(len(w.assigned_tasks))
            prefilled.labels(w.worker_id).set(len(w.prefilled_tasks))
            for sample in w.last_metrics:
                name = sample.get("name", "")
                if not name.startswith("hq_worker_"):
                    continue  # only the worker-runtime namespace fans out
                labels = sample.get("labels") or {}
                label_names = (*sorted(labels), "worker")
                make = (
                    REGISTRY.counter
                    if sample.get("type") == "counter"
                    else REGISTRY.gauge
                )
                try:
                    metric = make(
                        name, sample.get("help", ""),
                        labels=label_names, max_series=4096,
                    )
                except ValueError:
                    continue  # type conflict with an existing metric
                if metric.label_names != label_names:
                    continue  # conflicting shape from an older worker
                piggybacked.add(name)
                series = metric.labels(
                    *(labels[k] for k in sorted(labels)), w.worker_id
                )
                if sample.get("type") == "counter":
                    series.set_total(sample.get("value", 0.0))
                else:
                    series.set(sample.get("value", 0.0))


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
        if chaos.ACTIVE:
            # kill-at-event-K injection sits AFTER the journal write+flush:
            # a chaos test killing the server here proves exactly what the
            # configured flush/fsync policy persisted. A pending group
            # commit (or the journal plane's in-flight batch) gets a
            # durability barrier first so the guarantee holds at the
            # injection point too.
            if self.jplane is not None:
                self.jplane.barrier(sync=self.journal_fsync == "always")
            elif self.journal is not None and self.journal.in_batch:
                self.journal.flush(sync=self.journal_fsync == "always")
            chaos.fire(
                "server.event", event=kind, shard=self.shard_id, ctx=self
            )
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

    def _spawn_loop(self, factory, _restarts: int = 0) -> "asyncio.Task":
        """Background loops must never die silently: an unhandled exception
        in an asyncio task is held unreported while the server keeps a
        reference — the server would turn into a zombie that accepts
        submits but never schedules. Log the crash loudly, restart the loop
        up to LOOP_CRASH_RESTARTS consecutive times, then stop the
        server."""
        started = clock.now()
        task = asyncio.create_task(factory())
        name = getattr(factory, "__name__", repr(factory))

        def _report(t: "asyncio.Task") -> None:
            if t.cancelled():
                return
            exc = t.exception()
            if exc is None:
                return
            logger.critical(
                "server background loop %s crashed", name, exc_info=exc,
            )
            if self._stop_event.is_set():
                # shutting down: a respawn would run against resources
                # shutdown() is already closing
                return
            restarts = (
                0 if clock.now() - started >= self.LOOP_HEALTHY_SECS
                else _restarts
            )
            if restarts < self.LOOP_CRASH_RESTARTS:
                logger.critical(
                    "restarting %s (attempt %d/%d)",
                    name, restarts + 1, self.LOOP_CRASH_RESTARTS,
                )
                self._tasks.append(self._spawn_loop(factory, restarts + 1))
            else:
                logger.critical(
                    "%s exceeded its restart budget; stopping the server",
                    name,
                )
                self.stop()

        task.add_done_callback(_report)
        return task

    # --- scheduler loop ------------------------------------------------
    async def _scheduler_loop(self) -> None:
        while True:
            await self.comm.scheduling_event.wait()
            await asyncio.sleep(self.schedule_min_delay)
            self.comm.scheduling_event.clear()
            t0 = time.perf_counter()
            n = reactor.schedule(self.core, self.comm, self.events, self.model)
            # the tick runs synchronously on the loop: its duration IS the
            # solve plane's loop occupancy (stall watchdog included)
            self.note_plane("solve", time.perf_counter() - t0)
            if n:
                logger.debug(
                    "tick assigned %d tasks in %.2f ms",
                    n,
                    (time.perf_counter() - t0) * 1e3,
                    extra={"tick": self.core.tick_counter},
                )

    # --- ingest drain loop (client-connection plane handoff) ------------
    # max handoff items consumed per drain pass: bounds the reactor hold
    # (one pass is one `ingest` lag-plane observation) while still
    # amortizing journal group commits across a burst of submit chunks
    INGEST_DRAIN_BATCH = 256

    async def _ingest_drain_loop(self) -> None:
        """Consume batches of decoded client messages from the connection
        plane (server/ingest.py). Runs of consecutive `submit_chunk`
        messages — across ALL clients — are applied under ONE journal
        group commit, and their acks are queued only after that commit
        lands (durability-before-visibility across chunk boundaries)."""
        plane = self.ingest_plane
        # with the journal plane on, chunk acks (and every other reply)
        # ride the durability watermark instead of an inline group-commit
        # block: the commit thread batches whole runs of chunks on its
        # own, and reply_visible releases the acks in FIFO order once
        # the covering commit lands
        gated = self.jplane is not None
        while True:
            await self._handoff_wake.wait()
            self._handoff_wake.clear()
            while plane.handoff:
                items = plane.pop_batch(self.INGEST_DRAIN_BATCH)
                t0 = time.perf_counter()
                acks: list = []
                batch = None

                def flush_chunks() -> None:
                    nonlocal batch
                    if batch is not None:
                        batch.__exit__(None, None, None)
                        batch = None
                    for ch, resp in acks:
                        ch.reply(resp)
                    acks.clear()

                try:
                    for channel, msg in items:
                        if msg is None:
                            flush_chunks()
                            self._on_channel_gone(channel)
                            continue
                        if not isinstance(msg, dict):
                            # a malformed frame answers THAT client; it
                            # must never crash the drain loop every
                            # other client shares
                            channel.reply({
                                "op": "error",
                                "message": "malformed request frame",
                            })
                            continue
                        op = msg.get("op")
                        if op == "submit_chunk":
                            if batch is None and not gated:
                                batch = self._journal_group_commit()
                                batch.__enter__()
                            try:
                                resp = self._apply_submit_chunk(msg)
                            except Exception as e:  # noqa: BLE001
                                logger.exception("submit_chunk failed")
                                resp = {"op": "error", "message": str(e),
                                        "rid": msg.get("rid")}
                            if gated:
                                self.reply_visible(channel, resp)
                            else:
                                acks.append((channel, resp))
                            continue
                        # any non-chunk op is a durability barrier: commit
                        # the open chunk batch and release its acks first,
                        # preserving per-connection FIFO
                        flush_chunks()
                        if op in ("stream_events", "subscribe"):
                            self._spawn_client_stream(channel, op, msg)
                            continue
                        if op in self._RPC_LAG_EXEMPT:
                            # ops that await external progress (job_wait,
                            # compaction, manager dry-runs) must not stall
                            # the drain loop for every other client
                            self._spawn_client_request(channel, msg)
                            continue
                        response = await self._handle_client_message(msg)
                        if response is not None:
                            self.reply_visible(channel, response)
                finally:
                    flush_chunks()
                self.note_plane("ingest", time.perf_counter() - t0)
                plane.notify_drained()
                # yield between batches: a sustained multi-client flood
                # must round-robin with the scheduler tick and the worker
                # plane, not hold the loop until the handoff runs dry
                await asyncio.sleep(0)

    def _spawn_client_request(self, channel, msg: dict) -> None:
        async def run() -> None:
            response = await self._handle_client_message(msg)
            if response is not None:
                self.reply_visible(channel, response)

        task = asyncio.ensure_future(run())
        self._client_tasks.add(task)
        task.add_done_callback(self._client_tasks.discard)

    def _spawn_client_stream(self, channel, op: str, msg: dict) -> None:
        handler = (
            self._stream_events if op == "stream_events" else self._subscribe
        )
        gone = channel.reactor_gone_event()

        async def run() -> None:
            try:
                await handler(channel.stream_send, gone, msg)
            except (ConnectionError, OSError):
                pass  # consumer went away mid-send
            except Exception:  # noqa: BLE001 - never kill the drain plane
                logger.exception("client stream handler crashed")
            finally:
                # the stream is this connection's terminal op (the legacy
                # plane breaks out of its recv loop the same way)
                channel.close()

        task = asyncio.ensure_future(run())
        channel.stream_task = task
        self._client_tasks.add(task)
        task.add_done_callback(self._client_tasks.discard)

    def _on_channel_gone(self, channel) -> None:
        channel.is_gone = True
        if channel.gone is not None:
            channel.gone.set()

    async def _journal_flush_loop(self) -> None:
        """Flush the journal on --journal-flush-period instead of per event
        (reference bootstrap.rs journal_flush_period, default 30 s there);
        with --journal-fsync periodic/always the periodic flush also
        fsyncs, bounding the OS-crash loss window to one period."""
        period = self.journal_flush_period or 30.0
        while True:
            await asyncio.sleep(period)
            if self.jplane is not None:
                # non-blocking: the commit thread flushes when it drains
                self.jplane.request_flush(
                    sync=self.journal_fsync != "never"
                )
            else:
                self.journal.flush(sync=self.journal_fsync != "never")

    async def _journal_compact_loop(self) -> None:
        """Compact on --journal-compact-interval and/or whenever the
        journal grows past --journal-compact-threshold bytes. The size
        check is a cheap stat on a 5 s poll; compaction itself runs
        through compact_journal (snapshot + GC, heavy work off-loop)."""
        poll = 5.0
        if self.journal_compact_interval > 0:
            poll = min(poll, self.journal_compact_interval)
        last = clock.monotonic()
        while True:
            await asyncio.sleep(poll)
            due = (
                self.journal_compact_interval > 0
                and clock.monotonic() - last >= self.journal_compact_interval
            )
            if not due and self.journal_compact_threshold > 0:
                # a journal whose LIVE-work floor exceeds the threshold
                # must not be recompacted every poll: require the file to
                # have doubled past the last compaction's result before the
                # size trigger fires again (geometric backoff)
                floor = (
                    self.last_compaction["journal_bytes_after"]
                    if self.last_compaction
                    else 0
                )
                try:
                    size = self.journal_path.stat().st_size
                except OSError:
                    size = 0
                due = (
                    size >= self.journal_compact_threshold
                    and size >= 2 * floor
                )
            if not due:
                continue
            try:
                await self.compact_journal(reason="auto")
            except Exception:
                logger.exception("journal compaction failed")
            last = clock.monotonic()


    async def compact_journal(self, reason: str = "manual") -> dict:
        """One snapshot + journal-GC cycle.

        Phases (each kill -9-survivable, chaos site `server.compact`):

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
                if chaos.ACTIVE:
                    chaos.fire("server.compact", event="pre-swap")
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
            if chaos.ACTIVE:
                chaos.fire("server.compact", event="post-swap")
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

    async def _reattach_reaper(self) -> None:
        """Requeue restored maybe-running tasks whose pre-crash worker did
        not reconnect within --reattach-timeout: fence the dead incarnation
        (instance bump) and make the task schedulable again."""
        while True:
            await asyncio.sleep(0.5)
            if not self.reattach_pending:
                continue
            now = clock.monotonic()
            expired = [
                tid for tid, deadline in self.reattach_pending.items()
                if deadline <= now
            ]
            for task_id in expired:
                del self.reattach_pending[task_id]
                task = self.core.tasks.get(task_id)
                if (
                    task is None
                    or task.is_done
                    or task.state is not TaskState.WAITING
                ):
                    continue
                logger.warning(
                    "task %d: no worker reclaimed it within the %.0fs "
                    "reattach window; requeueing",
                    task_id, self.reattach_timeout,
                    extra={"job": task_id_job(task_id),
                           "task": task_id_task(task_id)},
                )
                reactor.requeue_reattach_expired(self.core, self.comm, task)

    # --- graceful drain --------------------------------------
    def start_drain(
        self, worker_ids, timeout: float | None = None, source: str = "cli"
    ) -> list[int]:
        """Begin a graceful drain of `worker_ids`: each worker is masked
        out of the solve/prefill/gang selection (Worker.draining — a
        membership mask like the gang reservation), its queued-but-not-
        started prefilled backlog is retracted, and the drain reaper stops
        it once its running tasks finish — or, past the deadline, stops it
        anyway with clean_stop so anything still running requeues without
        a crash charge (zero task loss either way)."""
        window = float(timeout) if timeout and timeout > 0 \
            else DRAIN_TIMEOUT_DEFAULT
        now = clock.monotonic()
        started: list[int] = []
        for wid in worker_ids:
            worker = self.core.workers.get(wid)
            if worker is None or worker.draining:
                continue
            worker.draining = True
            self.core.bump_membership()
            # retract the queued backlog so the drain is bounded by the
            # currently RUNNING tasks only (same move as the gang drain)
            refs = []
            for tid in sorted(worker.prefilled_tasks):
                task = self.core.tasks[tid]
                if task.retract_pending:
                    continue
                task.retract_pending = True
                refs.append((tid, task.instance_id))
            if refs:
                self.comm.send_retract(wid, refs)
            self._draining[wid] = {
                "deadline": now + window, "started": now, "source": source,
            }
            _DRAINS_TOTAL.labels(source).inc()
            self.emit_event(
                "worker-draining",
                {"id": wid, "timeout": window, "source": source,
                 "running": len(worker.assigned_tasks)},
            )
            started.append(wid)
        return started

    async def _drain_reaper(self) -> None:
        """Stop each draining worker once it settles idle; past the drain
        deadline, escalate to an immediate clean stop (running tasks take
        the normal worker-lost requeue path, no crash charge)."""
        while True:
            await asyncio.sleep(0.2)
            if not self._draining:
                continue
            now = clock.monotonic()
            for wid, rec in list(self._draining.items()):
                worker = self.core.workers.get(wid)
                if worker is None:
                    self._draining.pop(wid, None)
                    continue
                settled = (
                    not worker.assigned_tasks
                    and not worker.prefilled_tasks
                    and worker.mn_task == 0
                )
                escalated = not settled and now >= rec["deadline"]
                if not (settled or escalated):
                    continue
                self._draining.pop(wid, None)
                worker.clean_stop = True
                self.comm.send_stop(wid)
                drain_s = now - rec["started"]
                _DRAIN_SECONDS.observe(drain_s)
                if escalated:
                    _DRAIN_ESCALATIONS_TOTAL.inc()
                    logger.warning(
                        "drain of worker %d hit its %.0fs deadline with %d "
                        "task(s) still running; escalating to stop "
                        "(tasks requeue, no crash charge)",
                        wid, rec["deadline"] - rec["started"],
                        len(worker.assigned_tasks),
                        extra={"worker": wid},
                    )
                self.emit_event(
                    "worker-drained",
                    {"id": wid, "escalated": escalated,
                     "drain_s": round(drain_s, 3), "source": rec["source"]},
                )

    async def _heartbeat_reaper(self) -> None:
        """Drop workers whose heartbeats stopped (beyond TCP-close detection;
        reference server/rpc.rs per-connection heartbeat timeout). The
        timeout is heartbeat_secs x --heartbeat-timeout-factor (floored at
        2 s so one delayed frame never reaps a fast-heartbeat worker)."""
        while True:
            before = clock.monotonic()
            await asyncio.sleep(0.5)
            now = clock.monotonic()
            if now - before > 2.0:
                # the event loop itself stalled (e.g. a solve held at the
                # watchdog deadline): heartbeats are sitting unprocessed in
                # the recv buffers, not missing. Give the recv loops one
                # pass before judging anyone silent.
                continue
            for worker in list(self.core.workers.values()):
                limit = max(
                    worker.configuration.heartbeat_secs
                    * self.heartbeat_timeout_factor,
                    2.0,
                )
                if now - worker.last_heartbeat > limit:
                    logger.warning(
                        "worker %d heartbeat timeout (%.0fs)",
                        worker.worker_id,
                        now - worker.last_heartbeat,
                        extra={"worker": worker.worker_id},
                    )
                    conn = self._worker_conns.pop(worker.worker_id, None)
                    if conn is not None:
                        conn.close()
                    self.comm.unregister_worker(worker.worker_id)
                    self._record_past_worker(
                        worker.worker_id, "heartbeat timeout"
                    )
                    reactor.on_remove_worker(
                        self.core,
                        self.comm,
                        self.events,
                        worker.worker_id,
                        "heartbeat timeout",
                    )

    # --- worker plane ---------------------------------------------------
    async def _handle_worker_conn(self, reader, writer) -> None:
        worker_id = 0
        try:
            conn = await do_authentication(
                reader,
                writer,
                ROLE_SERVER,
                ROLE_WORKER,
                self.access.worker_key_bytes() if self.access else None,
            )
            register = await conn.recv()
            if register.get("op") != "register":
                raise AuthError("expected register message")
            config = WorkerConfiguration.from_wire(register["config"])
            worker = Worker.create(
                self.core.worker_id_counter.next(), config, self.core.resource_map
            )
            worker_id = worker.worker_id
            queue = self.comm.register_worker(worker_id)
            self._worker_conns[worker_id] = conn
            # a reconnecting worker reclaims the restored maybe-running
            # tasks it still executes; everything it reports that the
            # server cannot verify (instance mismatch, already terminal,
            # never held) is echoed back for the worker to kill — both
            # sides agree on exactly one live incarnation per task.
            # Processed BEFORE on_new_worker wakes the scheduler, so a held
            # task can never race onto another worker.
            reattached, discard = self._process_reattach(
                register.get("reattach"), worker
            )
            reactor.on_new_worker(self.core, self.comm, self.events, worker)
            await conn.send(
                {
                    "op": "registered",
                    "worker_id": worker_id,
                    "server_uid": self.access.server_uid if self.access else "",
                    "heartbeat_secs": config.heartbeat_secs,
                    # workers with no own idle timeout adopt the server's
                    # default (reference sync_worker_configuration)
                    "server_idle_timeout": self.idle_timeout,
                    "reattached": reattached,
                    "discard": discard,
                }
            )
            if self._overview_listeners > 0:
                # a dashboard is attached: the new worker starts under the
                # forced overview cadence too
                self.comm.send_overview_override(
                    worker_id, OVERVIEW_OVERRIDE_INTERVAL
                )
            if config.alloc_id and getattr(self, "autoalloc", None):
                self.autoalloc.on_worker_connected(worker_id, config.alloc_id)

            sender = asyncio.create_task(self._worker_sender(conn, queue))
            try:
                await self._worker_recv_loop(conn, worker)
            finally:
                sender.cancel()
        except (
            AuthError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ) as e:
            logger.info("worker connection ended: %s", e)
        finally:
            if worker_id:
                self._worker_conns.pop(worker_id, None)
                self.comm.unregister_worker(worker_id)
                worker = self.core.workers.get(worker_id)
                if worker is not None:
                    # a requested stop disconnects too — record the true
                    # reason, not a generic connection loss (reference
                    # LostWorkerReason::Stopped vs ConnectionLost); a
                    # redirect-ordered departure is a lend, not a loss
                    lent_to = self._lent_workers.pop(worker_id, None)
                    if worker.clean_stop:
                        reason = "stopped"
                        lent_to = None
                    elif lent_to is not None and not worker.assigned_tasks:
                        # only an IDLE departure is the lend completing; a
                        # worker that picked up work in the lend window
                        # aborts the redirect, so a busy disconnect here
                        # is a genuine loss (its tasks requeue/reattach).
                        # The human string stays for logs; `lent_to` is
                        # the structured field the fleet feed renders
                        # lending flows from
                        reason = f"lent to shard {lent_to}"
                    else:
                        reason = "connection lost"
                        lent_to = None
                    self._record_past_worker(worker_id, reason,
                                             lent_to=lent_to)
                    reactor.on_remove_worker(
                        self.core, self.comm, self.events, worker_id, reason
                    )
            writer.close()

    def _process_reattach(
        self, reattach: dict | None, worker: Worker
    ) -> tuple[list[int], list[int]]:
        """Reclaim a reconnecting worker's still-running tasks.

        A task is reattached iff the journal restore held it for exactly
        this incarnation (server.reattach_pending + matching instance id):
        it becomes RUNNING on the new worker record with resources
        accounted — NOT requeued, no crash-counter charge. Anything else
        the worker reports is stale (already terminal, requeued under a
        newer instance, or this server never knew it) and is returned in
        `discard` for the worker to kill; its messages would be fenced by
        the instance check anyway, but killing stops the side effects.
        """
        if not reattach:
            return [], []
        reattached: list[int] = []
        discard: list[int] = []
        # lineage fence: the claimed server_uid must have written this
        # journal, or the worker's task ids belong to a different server's
        # numbering (same server dir reused with another --journal) and
        # could collide at the common instance 0
        claimed_uid = reattach.get("server_uid") or ""
        uid_ok = claimed_uid in self.journal_uids
        if not uid_ok and reattach.get("running"):
            logger.warning(
                "reconnecting worker claims unknown server lineage %r; "
                "discarding its %d running task(s)",
                claimed_uid, len(reattach.get("running", ())),
            )
        for entry in reattach.get("running", ()):
            task_id = entry.get("id")
            instance = entry.get("instance", 0)
            task = self.core.tasks.get(task_id)
            claimable = (
                uid_ok
                and task is not None
                and not task.is_done
                and task.instance_id == instance
            )
            if claimable and self.reattach_pending.pop(task_id, None) is not None:
                reactor.on_task_reattached(self.core, self.events, task, worker)
                reattached.append(task_id)
            elif (
                claimable
                and task.state is TaskState.READY
                and not self.core.rq_map.get_variants(task.rq_id).is_multi_node
            ):
                # a ready task whose claimed instance matches EXACTLY what
                # the server would re-issue. Since restore fences re-issues
                # to the boot's generation base (core.instance_fence_floor)
                # a prior boot's incarnation can no longer collide here;
                # this branch stays as a safety net — if a matching claim
                # ever does arrive, adopting it out of the ready queue is
                # strictly safer than racing a second execution under the
                # same instance id, invisible to the fence. The journal
                # never saw this start, so the worker's reported variant is
                # the only truth about which resources it occupies.
                variant = int(entry.get("variant", 0))
                if variant < len(
                    self.core.rq_map.get_variants(task.rq_id).variants
                ):
                    task.assigned_variant = variant
                self.core.queues.remove(task.rq_id, task_id)
                reactor.on_task_reattached(self.core, self.events, task, worker)
                reattached.append(task_id)
            else:
                discard.append(task_id)
        # parked-but-never-started tasks are NEVER kept: the server
        # re-issues them (restore saw no task-started), so a silently kept
        # local copy would run alongside the re-issue under one instance id
        for entry in reattach.get("blocked", ()):
            discard.append(entry.get("id"))
        if reattached or discard:
            logger.info(
                "worker %d reconnected from old worker %s: reattached %d "
                "task(s), discarded %d stale",
                worker.worker_id, reattach.get("worker_id"),
                len(reattached), len(discard),
                extra={"worker": worker.worker_id},
            )
        return reattached, discard

    async def _worker_sender(self, conn: Connection, queue: asyncio.Queue):
        """Drain the per-worker queue into batch frames: a tick's burst
        (compute batches, retract fan-out, cancels) leaves as one
        encryption + one syscall instead of one per message — the downlink
        half of the pipelined assignment delivery. The encryption half
        runs on the fan-out sender pool (server/fanout.py) when enabled,
        so N workers' downlinks seal on N threads instead of serializing
        on this loop. Chaos actions apply per LOGICAL message so fault
        plans behave identically under batching."""
        loop = asyncio.get_running_loop()
        pool = self.sendpool
        while True:
            enq_ts, msg = await queue.get()
            batch = [msg]
            while len(batch) < 256:
                try:
                    batch.append(queue.get_nowait()[1])
                except asyncio.QueueEmpty:
                    break
            if chaos.ACTIVE:
                injected = []
                for m in batch:
                    action = await chaos.on_message(
                        "server.send", op=m.get("op")
                    )
                    if action == "drop":
                        continue
                    injected.append(m)
                    if action == "dup":
                        injected.append(m)
                batch = injected
                if not batch:
                    continue
            t0 = time.perf_counter()
            payload = (
                batch[0] if len(batch) == 1
                else {"op": "batch", "msgs": batch}
            )
            data = await pool.encode(loop, conn, payload)
            await conn.send_bytes(data)
            dt = time.perf_counter() - t0
            pool.note_send(len(batch), len(data), dt)
            # re-pointed `fanout` lag probe: handoff latency —
            # reactor enqueue to frame-on-the-wire — not loop hold time
            # (the encode no longer holds the loop at all)
            self.lag.observe("fanout", clock.monotonic() - enq_ts)
            if self.stall_budget > 0 and dt >= self.stall_budget:
                self._capture_stall("fanout", dt)

    async def _worker_recv_loop(self, conn: Connection, worker: Worker) -> None:
        while True:
            msg = await conn.recv()
            worker.last_heartbeat = clock.monotonic()
            subs = msg["msgs"] if msg.get("op") == "batch" else [msg]
            if chaos.ACTIVE:
                # conservative path: chaos actions await between messages,
                # so the group-commit block (which must stay synchronous)
                # is skipped and every event keeps its per-event flush
                for sub in subs:
                    action = await chaos.on_message(
                        "server.recv", op=sub.get("op")
                    )
                    if action == "drop":
                        continue
                    if action == "dup":
                        self._process_worker_message(worker, sub)
                    self._process_worker_message(worker, sub)
                continue
            # batched completion plane: the whole frame is processed
            # synchronously (no awaits). With the journal plane on, the
            # events it produced are enqueued to the commit thread and
            # every CLIENT-visible effect (acks, replies, listener/
            # subscriber deliveries) is watermark-gated. Worker-bound
            # messages (cancels/retracts this frame may trigger) are
            # deliberately NOT gated: dispatches were never journaled —
            # the tick already sends compute messages with no durability
            # coupling — and a pre-durable incarnation that dies with
            # the server is fenced + killed at reattach (instance
            # fencing), the same crash semantics as before. With
            # --journal-plane reactor the inline group commit covers the
            # frame as it always did (ONE write + fsync per batch).
            t0 = time.perf_counter()
            if self.jplane is not None:
                for sub in subs:
                    self._process_worker_message(worker, sub)
                # in-loop completion processing (sans journal I/O) is its
                # own lag plane now; `journal` measures handoff latency
                # on the commit thread (see JournalPlane)
                self.note_plane("completion", time.perf_counter() - t0)
            else:
                with self._journal_group_commit():
                    for sub in subs:
                        self._process_worker_message(worker, sub)
                # frame processing + group commit hold the loop
                # synchronously: the journal plane's loop occupancy
                self.note_plane("journal", time.perf_counter() - t0)

    def _process_worker_message(self, worker: Worker, msg: dict) -> None:
            op = msg.get("op")
            _WORKER_MESSAGES_TOTAL.labels(str(op)).inc()
            if op == "task_running":
                reactor.on_task_running(
                    self.core, self.events, msg["id"], msg["instance"],
                    wtrace=msg.get("trace"),
                )
            elif op == "task_finished":
                reactor.on_task_finished(
                    self.core, self.comm, self.events, msg["id"],
                    msg["instance"], wtrace=msg.get("trace"),
                )
            elif op == "task_failed":
                reactor.on_task_failed(
                    self.core,
                    self.comm,
                    self.events,
                    msg["id"],
                    msg["instance"],
                    msg.get("error", "task failed"),
                    wtrace=msg.get("trace"),
                )
            elif op == "retract_response":
                reactor.on_retract_response(
                    self.core, self.comm, msg["id"], msg.get("ok", False),
                    instance_id=msg.get("instance", -1),
                )
            elif op == "heartbeat":
                pass
            elif op == "goodbye":
                # deliberate worker exit (idle/time limit): its running
                # tasks requeue without a crash-counter charge
                worker.clean_stop = True
            elif op == "task_notify":
                task_id = msg.get("id", 0)
                self.emit_event(
                    "task-notify",
                    {
                        "job": task_id_job(task_id),
                        "task": task_id_task(task_id),
                        "payload": msg.get("payload", ""),
                    },
                )
            elif op == "overview":
                worker.last_overview = {
                    "hw": msg.get("hw", {}),
                    "n_running": msg.get("n_running", 0),
                }
                # piggybacked gauge/counter samples feed the cluster-wide
                # Prometheus view (collect hook) and the dashboard stream
                worker.last_metrics = msg.get("metrics") or []
                self.emit_event(
                    "worker-overview",
                    {"id": worker.worker_id, "hw": msg.get("hw", {}),
                     "n_running": msg.get("n_running", 0),
                     "metrics": worker.last_metrics},
                )
            else:
                logger.warning("unknown worker message %r", op)

    # --- client plane ---------------------------------------------------
    async def _handle_client_conn(self, reader, writer) -> None:
        try:
            conn = await do_authentication(
                reader,
                writer,
                ROLE_SERVER,
                ROLE_CLIENT,
                self.access.client_key_bytes() if self.access else None,
            )
            while True:
                msg = await conn.recv()
                if msg.get("op") in ("stream_events", "subscribe"):
                    # adapt the connection to the sink interface shared
                    # with the threaded plane: send = conn.send, and a
                    # watcher task turns the read side's EOF into `gone`
                    gone = asyncio.Event()

                    async def _watch_eof() -> None:
                        try:
                            await conn.recv()
                        except Exception:  # noqa: BLE001 - any end is EOF
                            pass
                        gone.set()

                    watcher = asyncio.ensure_future(_watch_eof())
                    handler = (
                        self._stream_events
                        if msg.get("op") == "stream_events"
                        else self._subscribe
                    )
                    try:
                        await handler(conn.send, gone, msg)
                    finally:
                        if not watcher.done():
                            watcher.cancel()
                            try:
                                await watcher
                            except (asyncio.CancelledError, Exception):
                                pass
                    break
                response = await self._handle_client_message(msg)
                if response is not None:
                    # durability gate (journal plane): the reply leaves
                    # only at/below the committed watermark
                    await self._visibility_barrier()
                    await conn.send(response)
        except (
            AuthError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ) as e:
            logger.debug("client connection ended: %s", e)
        finally:
            writer.close()

    # client ops that legitimately await external progress (job completion,
    # executor-offloaded compaction, manager dry-runs): their wall time is
    # waiting, not loop occupancy, so they stay out of the rpc lag plane
    _RPC_LAG_EXEMPT = frozenset({
        "job_wait", "journal_compact", "journal_prune", "alloc_add",
        "alloc_dry_run", "alloc_remove",
    })

    async def _handle_client_message(self, msg: dict) -> dict | None:
        if not isinstance(msg, dict):
            return {"op": "error", "message": "malformed request frame"}
        op = msg.get("op")
        if not isinstance(op, str):
            return {"op": "error", "message": f"malformed operation {op!r}"}
        handler = getattr(self, f"_client_{op.replace('-', '_')}", None)
        if handler is None:
            return {"op": "error", "message": f"unknown operation {op!r}"}
        t0 = time.perf_counter()
        try:
            return await handler(msg)
        except Exception as e:  # noqa: BLE001 - client errors must not kill the server
            logger.exception("error handling client %r", op)
            return {"op": "error", "message": str(e)}
        finally:
            if op not in self._RPC_LAG_EXEMPT:
                self.note_plane("rpc", time.perf_counter() - t0)

    async def _client_server_info(self, msg: dict) -> dict:
        return {
            "op": "server_info",
            "server_uid": self.access.server_uid if self.access else "",
            "version": __version__,
            "host": self.host,
            "server_dir": str(self.server_dir),
            "client_port": self.client_port,
            "worker_port": self.worker_port,
            "started_at": self.started_at,
            "n_workers": len(self.core.workers),
            "n_jobs": len(self.jobs.jobs),
            "scheduler": self.scheduler_kind,
            "metrics_port": self.metrics_port,
            "federation": self._federation_block(),
            # which AEAD implementation seals this server's
            # wire, and where the journal/fan-out work runs
            "wire_backend": WIRE_BACKEND,
            "journal_plane": (
                self.journal_plane if self.journal is not None else None
            ),
            "fanout_senders": self.fanout_senders,
        }

    async def _client_server_stats(self, msg: dict) -> dict:
        """Scheduler telemetry: per-phase tick latency breakdown plus the
        incremental snapshot-cache counters (`hq server stats`).  The
        phase split attributes a tick-latency regression to batches /
        assemble / solve-dispatch / device-sync / mapping instead of one
        opaque number."""
        return {
            "op": "server_stats",
            "tick": self.core.tick_stats.snapshot(),
            # phase -> fraction of tick time: the blame denominator bench
            # smokes store next to the profiler's plane shares
            "tick_shares": self.core.tick_stats.shares(),
            "tick_cache": self.core.tick_cache.counters(),
            "paranoid_tick": self.core.paranoid_tick,
            "scheduler": self.scheduler_kind,
            # active weighted-objective policy (None = flat
            # placement-count objective)
            "policy": (
                self.core.policy.stats()
                if self.core.policy is not None else None
            ),
            "solve_backend": getattr(self.model, "last_backend", None),
            "solve_backend_reason": getattr(
                self.model, "last_backend_reason", None
            ),
            "shape_allocations": getattr(
                self.model, "shape_allocations", None
            ),
            "resident": (
                self.model.resident_stats()
                if hasattr(self.model, "resident_stats") else None
            ),
            "pipeline": (
                self.core.tick_pipeline.stats()
                if self.core.tick_pipeline is not None else None
            ),
            "watchdog": self.model.stats(),
            "reattach_pending": len(self.reattach_pending),
            "journal": await self._journal_stats_brief(),
            "trace": TRACER.snapshot(recent=0),
            # loop-lag per plane, stall captures, trace store +
            # subscription plane health
            "lag": self.lag.snapshot(),
            "stalls": {
                "budget_s": self.stall_budget,
                "captured": self.stalls_captured,
                "last": self.last_stall,
            },
            "task_traces": self.core.traces.stats(),
            # per-plane CPU attribution from the sampling
            # profiler (the CPU twin of the lag block above)
            "profile": profiler.PROFILER.snapshot(),
            "subscribers": len(self._subscribers),
            # connection-plane + lazy-materialization health
            "ingest": self._ingest_stats(),
            # shard identity, lease health, lending counters
            "federation": self._federation_block(),
            # journal commit thread + fan-out sender pool
            "journal_plane": (
                self.jplane.stats() if self.jplane is not None
                else {"mode": self.journal_plane}
            ),
            "fanout": self._fanout_stats(),
        }

    def _fanout_stats(self) -> dict:
        from hyperqueue_tpu_torch.server.fanout import (
            FANOUT_BYTES,
            FANOUT_FRAMES,
            FANOUT_STALLS,
        )

        return {
            "senders": self.fanout_senders,
            "wire_backend": WIRE_BACKEND,
            "frames_total": int(FANOUT_FRAMES.labels().value),
            "bytes_total": int(FANOUT_BYTES.labels().value),
            "send_stalls": int(FANOUT_STALLS.labels().value),
        }

    def _ingest_stats(self) -> dict:
        plane = self.ingest_plane
        out = {
            "plane": self.client_plane,
            "lazy": self.core.lazy.stats(),
            "open_streams": sum(
                j.open_streams for j in self.jobs.jobs.values()
            ),
        }
        if plane is not None:
            out.update(
                clients=len(plane.clients),
                handoff_depth=len(plane.handoff),
                window=plane.window,
                chunks_total=int(INGEST_CHUNKS.labels().value),
                tasks_total=int(INGEST_TASKS.labels().value),
            )
        return out

    async def _journal_stats_brief(self) -> dict | None:
        """Compact journal/snapshot block for `hq server stats` (stat-only;
        `hq journal info` is the full view)."""
        if self.journal_path is None:
            return None
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod

        try:
            journal_bytes = self.journal_path.stat().st_size
        except OSError:
            journal_bytes = 0
        snap = snapshot_mod.snapshot_stats(self.journal_path)
        return {
            "journal_bytes": journal_bytes,
            "segments": int(journal_bytes > 0) + int(snap["bytes"] > 0)
            + int(snap["prev_bytes"] > 0),
            "snapshot_bytes": snap["bytes"],
            "snapshot_age_seconds": (
                round(snap["age_seconds"], 1)
                if snap["age_seconds"] is not None
                else None
            ),
            "last_compaction": self.last_compaction,
            "last_restore": self.last_restore,
        }

    async def _client_reset_metrics(self, msg: dict) -> dict:
        """Zero the metrics plane (registry values, tracer spans, tick-phase
        aggregates) so benchmarks can measure a steady-state window:
        reset, run, scrape. Registrations survive — only values clear.
        Externally-tracked telemetry the collect hook re-adopts (watchdog
        counters, tick-cache counters) is zeroed at its source too;
        hq_events_emitted_total is exempt — it mirrors the journal seq,
        which is functional state."""
        from hyperqueue_tpu_torch.scheduler.tick_cache import TickPhaseStats

        REGISTRY.reset()
        TRACER.reset()
        # the rolling per-plane lag SpanStats live OUTSIDE the registry
        # (they feed `hq server stats` + stall dumps) and must clear with
        # the rest of the window, like the hq_span_seconds SpanStats do —
        # a steady-state measurement must not inherit startup lag maxima
        self.lag.reset()
        self.core.tick_stats = TickPhaseStats()
        self.model.reset_stats()
        self.core.tick_cache.full_rebuilds = 0
        self.core.tick_cache.incremental_syncs = 0
        # SLO windows + alert state clear with the measurement window
        #: steady-state burn rates must not inherit a breach
        # that happened before the reset
        self.slo.reset()
        # profiler aggregates: folded trie, CPU-share window
        # and the stall sample ring all belong to the measurement window
        profiler.PROFILER.reset()
        return {"op": "ok"}

    async def _client_profile(self, msg: dict) -> dict:
        """Folded stacks + per-plane CPU shares from the sampling
        profiler (`hq server profile [--seconds N]`). With the
        continuous sampler on, `--seconds N` diffs the folded trie
        across the window (the cumulative view is seconds 0); on a
        `--profile-hz 0` server a throwaway burst sampler covers the
        window instead, so the command always answers."""
        seconds = min(max(float(msg.get("seconds") or 0.0), 0.0), 120.0)
        prof = profiler.PROFILER
        if prof.running:
            if seconds > 0:
                before = prof.folded_counts()
                passes0 = prof.passes
                await asyncio.sleep(seconds)
                counts = profiler.diff_counts(prof.folded_counts(), before)
                window_passes = prof.passes - passes0
            else:
                counts = prof.folded_counts()
                window_passes = prof.passes
            return {
                "op": "profile",
                "mode": "continuous",
                "shard": self.shard_id,
                "hz": prof.hz,
                "seconds": seconds,
                "passes": window_passes,
                "folded": profiler.render_folded(counts),
                "profile": prof.snapshot(),
            }
        if self.memory_transport or clock.is_simulated():
            return {"op": "error",
                    "message": "profiling is unavailable on a simulated "
                               "server (real wall-clock telemetry only)"}
        # --profile-hz 0: sample a temporary burst for the window
        seconds = seconds or 2.0
        burst = profiler.SamplingProfiler(hz=max(self.profile_hz, 0)
                                          or profiler.DEFAULT_HZ)
        if not burst.start():
            return {"op": "error", "message": "profiler failed to start"}
        try:
            await asyncio.sleep(seconds)
        finally:
            burst.stop()
        return {
            "op": "profile",
            "mode": "burst",
            "shard": self.shard_id,
            "hz": burst.hz,
            "seconds": seconds,
            "passes": burst.passes,
            "folded": burst.folded(),
            "profile": burst.snapshot(),
        }

    async def _client_metrics_render(self, msg: dict) -> dict:
        """The full Prometheus exposition over the client plane — the
        fleet metrics proxy scrapes shards through this RPC so
        one federated scrape needs no per-shard --metrics-port wiring."""
        return {"op": "metrics", "text": REGISTRY.render()}

    async def _client_job_timeline(self, msg: dict) -> dict:
        """Per-task lifecycle timeline of one job, aggregated server-side:
        submit -> queued -> assigned -> spawned -> finished timestamps
        folded into per-phase percentiles plus a slowest-task drill-down
        (`hq job timeline`). Phase chains are clamped monotonic, so the
        four phase durations of a finished task sum EXACTLY to its
        finished-submitted wall time."""
        job = self.jobs.jobs.get(msg["job_id"])
        if job is None:
            return {"op": "error", "message": f"job {msg['job_id']} not found"}
        rows = []
        for info in job.tasks.values():
            task = self.core.tasks.get(
                make_task_id(job.job_id, info.job_task_id)
            )
            pts = [
                info.submitted_at,
                task.t_ready if task else 0.0,
                task.t_assigned if task else 0.0,
                info.started_at,
                info.finished_at,
            ]
            # forward-clamp the chain: a missing middle stamp (e.g. a
            # restore dropped t_ready for a reattached task) collapses its
            # phase to zero instead of corrupting the neighbours
            for i in range(1, len(pts)):
                if pts[i] <= 0 or pts[i] < pts[i - 1]:
                    pts[i] = pts[i - 1]
            rows.append({
                "id": info.job_task_id,
                "status": info.status,
                "submitted": pts[0],
                "queued": pts[1],
                "assigned": pts[2],
                "started": pts[3],
                "finished": pts[4] if info.finished_at else 0.0,
                "phases": {
                    "pending": pts[1] - pts[0],
                    "queued": pts[2] - pts[1],
                    "dispatch": pts[3] - pts[2],
                    "run": pts[4] - pts[3],
                } if info.finished_at else None,
            })
        # unmaterialized lazy array tasks: pending since their CHUNK's
        # submit stamp (per-chunk clocks keep phase sums exact for open
        # jobs appending chunks over time)
        for seg in self.core.lazy.segments_of(job.job_id):
            chunk_submitted = seg.chunk.submitted_at
            for tid in seg.remaining_ids():
                rows.append({
                    "id": tid, "status": "waiting",
                    "submitted": chunk_submitted,
                    "queued": chunk_submitted, "assigned": 0.0,
                    "started": 0.0, "finished": 0.0, "phases": None,
                })
        finished = [r for r in rows if r["phases"] is not None]

        def pct(sorted_vals: list, q: float) -> float:
            if not sorted_vals:
                return 0.0
            idx = min(
                len(sorted_vals) - 1,
                int(q * (len(sorted_vals) - 1) + 0.5),
            )
            return sorted_vals[idx]

        phases_out = {}
        for name in ("pending", "queued", "dispatch", "run"):
            values = sorted(r["phases"][name] for r in finished)
            phases_out[name] = {
                "count": len(values),
                "total": round(sum(values), 6),
                "mean": round(sum(values) / len(values), 6) if values else 0.0,
                "p50": round(pct(values, 0.50), 6),
                "p95": round(pct(values, 0.95), 6),
                "max": round(values[-1], 6) if values else 0.0,
            }
        makespan = 0.0
        if finished:
            makespan = max(r["finished"] for r in finished) - min(
                r["submitted"] for r in finished
            )
        slowest = sorted(
            finished, key=lambda r: r["finished"] - r["submitted"],
            reverse=True,
        )[:5]
        out = {
            "op": "job_timeline",
            "job": job.job_id,
            "n_tasks": len(rows),
            "n_finished": len(finished),
            "makespan": round(makespan, 6),
            "phases": phases_out,
            "slowest": slowest,
        }
        if msg.get("detail"):
            out["tasks"] = rows
        return out

    async def _client_stop_server(self, msg: dict) -> dict:
        asyncio.get_running_loop().call_soon(self.stop)
        return {"op": "ok"}

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

    def _apply_submit_chunk(self, msg: dict) -> dict:
        """One streamed submit chunk (op=submit_chunk), applied
        synchronously so the ingest drain loop can group-commit a whole
        run of chunks as ONE journal append+fsync.

        Exactly-once across retries and restarts: every chunk is keyed
        (stream uid, chunk index); applied indexes are journaled with the
        chunk's job-submitted event and replayed into Job.streams, so a
        client re-sending an unacked chunk after a server crash gets an
        idempotent duplicate ack instead of duplicate tasks."""
        from hyperqueue_tpu_torch.transport.framing import read_trace
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        recv_at = clock.now()
        uid = msg.get("uid")
        rid = msg.get("rid")
        if not isinstance(uid, str) or not uid:
            return {"op": "error", "rid": rid,
                    "message": "submit_chunk requires a stream uid"}
        index = int(msg.get("i", 0))
        header = msg.get("job") or {}
        # elastic resharding: a stream whose job moved (or is
        # mid-move) answers a coded error — the client re-resolves the
        # owner and replays its unacked chunks there (the destination
        # imported the stream's applied-index set, so the replay dedups)
        probe_id = self._stream_jobs.get(uid)
        if probe_id is None:
            probe_id = header.get("job_id")
        guard = self._owned_elsewhere(probe_id, rid=rid)
        if guard is not None:
            return guard
        job_id = self._stream_jobs.get(uid)
        if job_id is not None:
            job = self.jobs.jobs.get(job_id)
            if job is None:
                return {"op": "error", "rid": rid,
                        "message": f"stream {uid}: job {job_id} vanished"}
        else:
            jid = header.get("job_id")
            if jid is not None and jid in self.jobs.jobs:
                job = self.jobs.jobs[jid]
                if not job.is_open and uid not in job.streams:
                    return {"op": "error", "rid": rid,
                            "message": f"job {jid} is not open"}
            else:
                job = self.jobs.create_job(
                    name=header.get("name", "job"),
                    submit_dir=header.get("submit_dir", os.getcwd()),
                    max_fails=header.get("max_fails"),
                    is_open=bool(header.get("open", False)),
                    job_id=jid,
                )
            self._stream_jobs[uid] = job.job_id
        stream = job.streams.get(uid)
        if stream is None:
            stream = job.streams[uid] = {"applied": set(), "sealed": False}
            job.open_streams += 1
        if index in stream["applied"]:
            # ack replay (client retry after a lost ack): idempotent
            return {"op": "chunk_ack", "rid": rid, "job_id": job.job_id,
                    "i": index, "n_tasks": 0, "dup": True}
        if stream["sealed"]:
            return {"op": "error", "rid": rid,
                    "message": f"stream {uid} is already sealed"}
        tctx = read_trace(msg) or {}
        trace = {
            "id": tctx.get("id") or new_trace_id(),
            "sent_at": float(tctx.get("sent_at") or 0.0),
            "recv_at": recv_at,
            "commit_at": clock.now(),
        }
        desc: dict = {
            "name": job.name, "submit_dir": job.submit_dir,
            "max_fails": job.max_fails, "open": job.is_open,
        }
        array = msg.get("array")
        graph_tasks = msg.get("tasks")
        n_new = 0
        try:
            if array:
                n_new = self._ingest_array_desc(
                    job, array, submitted_at=recv_at, trace=trace
                )
                desc["array"] = array
            elif graph_tasks:
                new_tasks = self._build_tasks(job, {"tasks": graph_tasks})
                n_new = len(new_tasks)
                desc["tasks"] = graph_tasks
                self._begin_submit_traces(new_tasks, trace)
                reactor.on_new_tasks(self.core, self.comm, new_tasks)
        except Exception as e:  # noqa: BLE001 - bad chunk answers the client
            # a rejected chunk BREAKS the stream: seal it (journaled, so
            # restore cannot resurrect it open) so the job can still
            # terminate — the client aborts on the error and must
            # restart with a fresh stream uid
            if not stream["sealed"]:
                stream["sealed"] = True
                job.open_streams = max(job.open_streams - 1, 0)
                self.emit_event(
                    "job-streams-sealed",
                    {"job": job.job_id, "uids": [uid]},
                )
                self.check_job_completion(job.job_id)
            return {"op": "error", "rid": rid,
                    "message": f"chunk {index} rejected: {e}"}
        stream["applied"].add(index)
        last = bool(msg.get("last"))
        if last:
            stream["sealed"] = True
            job.open_streams = max(job.open_streams - 1, 0)
        if n_new:
            job.submits.append(submit_record(desc, n_new))
        self.emit_event(
            "job-submitted",
            {"job": job.job_id, "desc": desc, "n_tasks": n_new,
             "chunk": {"uid": uid, "i": index, "last": last},
             "trace": {"id": trace["id"], "sent_at": trace["sent_at"],
                       "recv_at": recv_at}},
        )
        INGEST_CHUNKS.inc()
        if n_new:
            INGEST_TASKS.inc(n_new)
        if last:
            # the stream seal may be what lets the job terminate
            self.check_job_completion(job.job_id)
        return {"op": "chunk_ack", "rid": rid, "job_id": job.job_id,
                "i": index, "n_tasks": n_new, "dup": False}

    async def _client_submit_chunk(self, msg: dict) -> dict:
        """submit_chunk over the legacy in-loop client plane
        (--client-plane reactor): apply one chunk under its own group
        commit. The threaded plane batches chunk runs in the drain loop
        instead and never reaches this handler."""
        with self._journal_group_commit():
            return self._apply_submit_chunk(msg)

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

    def _job_pending_reasons(self, job_id: int) -> dict[str, int]:
        """Reason-code -> pending-task count for one job, joined from the
        latest DecisionRecord plus the pause ledger (`hq job info`
        "37 tasks waiting: 30 insufficient-capacity, 7 gang-incomplete")."""
        from hyperqueue_tpu_torch.scheduler import decision as decision_mod

        reasons: dict[str, int] = {}
        held = self.core.paused_held.get(job_id)
        if held:
            reasons[decision_mod.REASON_QUEUE_PAUSED] = len(held)
        if job_id in self.core.paused_jobs:
            # the pause supersedes whatever the last pre-pause tick said
            return reasons
        latest = self.core.flight.latest()
        if latest:
            for entry in latest.get("unplaced") or ():
                if (
                    entry.get("job") == job_id
                    and entry.get("reason")
                    != decision_mod.REASON_QUEUE_PAUSED
                ):
                    reasons[entry["reason"]] = (
                        reasons.get(entry["reason"], 0) + entry["count"]
                    )
        return reasons

    async def _client_job_list(self, msg: dict) -> dict:
        jobs = []
        for j in self.jobs.jobs.values():
            info = j.to_info()
            info["paused"] = j.job_id in self.core.paused_jobs
            jobs.append(info)
        return {"op": "job_list", "jobs": jobs}

    def _job_detail(self, job) -> dict:
        """job.to_detail() plus synthesized rows for unmaterialized lazy
        array tasks (status "waiting" — they have no per-task state yet,
        which is the point)."""
        detail = job.to_detail()
        if job.n_lazy:
            rows = detail["tasks"]
            for seg in self.core.lazy.segments_of(job.job_id):
                for tid in seg.remaining_ids():
                    rows.append({
                        "id": tid, "status": "waiting", "error": "",
                        "workers": [], "started_at": 0.0,
                        "finished_at": 0.0,
                    })
            rows.sort(key=lambda r: r["id"])
        return detail

    async def _client_job_info(self, msg: dict) -> dict:
        guard = self._guard_job_ids(msg["job_ids"])
        if guard is not None:
            return guard
        out = []
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is not None:
                detail = self._job_detail(job)
                detail["paused"] = job_id in self.core.paused_jobs
                if job.n_waiting() - job.counters["running"] > 0:
                    detail["pending_reasons"] = self._job_pending_reasons(
                        job_id
                    )
                out.append(detail)
        return {"op": "job_info", "jobs": out}

    async def _client_job_wait(self, msg: dict) -> dict:
        guard = self._guard_job_ids(msg["job_ids"])
        if guard is not None:
            return guard
        events = []
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is None or job.all_tasks_done():
                continue
            event = asyncio.Event()
            self._job_waiters.setdefault(job_id, []).append(event)
            events.append(event)
        if events:
            await asyncio.gather(*(e.wait() for e in events))
        return await self._client_job_info(msg)

    async def _client_job_cancel(self, msg: dict) -> dict:
        guard = self._guard_job_ids(msg["job_ids"])
        if guard is not None:
            return guard
        canceled = []
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is None:
                continue
            # lazy array tasks must exist to be canceled (per-task events,
            # counters); a cancel is O(tasks) with or without laziness
            if job.n_lazy:
                self.core.lazy.materialize_job(self.core, job_id)
            # cancel implies the client gave up on any in-flight chunk
            # stream: seal so the job can reach a terminal state — and
            # JOURNAL the forced seal, or a restore would resurrect the
            # stream as open and the job could never terminate
            self._seal_job_streams(job)
            task_ids = [
                make_task_id(job_id, t.job_task_id)
                for t in job.tasks.values()
                if t.status in ("waiting", "running")
            ]
            if task_ids:
                job.cancel_reason = "canceled by user"
            out = reactor.on_cancel_tasks(
                self.core, self.comm, self.events, task_ids
            )
            canceled.append({"job": job_id, "n_canceled": len(out)})
            self.check_job_completion(job_id)
        return {"op": "job_cancel", "result": canceled}

    async def _client_job_forget(self, msg: dict) -> dict:
        guard = self._guard_job_ids(msg["job_ids"])
        if guard is not None:
            return guard
        forgotten = 0
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is None or not job.is_terminated():
                continue
            del self.jobs.jobs[job_id]
            for job_task_id in job.tasks:
                self.core.tasks.pop(make_task_id(job_id, job_task_id), None)
            self.core.paused_jobs.discard(job_id)
            self.core.paused_held.pop(job_id, None)
            self.core.lazy.forget_job(job_id)
            for uid in job.streams:
                self._stream_jobs.pop(uid, None)
            forgotten += 1
        return {"op": "job_forget", "forgotten": forgotten}

    async def _client_open_job(self, msg: dict) -> dict:
        job = self.jobs.create_job(
            name=msg.get("name", "job"),
            submit_dir=msg.get("submit_dir", os.getcwd()),
            max_fails=msg.get("max_fails"),
            is_open=True,
        )
        self.emit_event("job-opened", {"job": job.job_id, "name": job.name})
        return {"op": "open_job", "job_id": job.job_id}

    async def _client_close_job(self, msg: dict) -> dict:
        closed = []
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is not None and (job.is_open or job.open_streams):
                job.is_open = False
                # a close also seals abandoned chunk streams (a client
                # that died mid-stream must not wedge the job forever);
                # the job-closed record seals them again on replay
                job.seal_streams()
                closed.append(job_id)
                self.emit_event("job-closed", {"job": job_id})
                self.check_job_completion(job_id)
        return {"op": "close_job", "closed": closed}

    # --- autoalloc ops ---------------------------------------------------
    async def _client_alloc_add(self, msg: dict) -> dict:
        from hyperqueue_tpu_torch.autoalloc.state import QueueParams

        params = QueueParams.from_wire(msg["params"])
        if params.manager not in ("pbs", "slurm", "local"):
            return {"op": "error",
                    "message": f"unknown manager {params.manager!r}"}
        # the local handler has no external manager to probe — a probe
        # would spawn (and instantly kill) a real worker for nothing
        if not msg.get("no_dry_run") and params.manager != "local":
            error = await self.autoalloc.probe_submit(params)
            if error is not None:
                return {"op": "error",
                        "message": f"allocation dry-run failed: {error} "
                                   "(use --no-dry-run to skip this check)"}
        queue = self.autoalloc.state.add_queue(params)
        self.emit_event(
            "alloc-queue-created",
            {"queue_id": queue.queue_id, "manager": params.manager,
             # full params ride the journal: restore rebuilds the queue
             # exactly (allocation-exact restore)
             "params": params.to_wire()},
        )
        return {"op": "alloc_add", "queue_id": queue.queue_id}

    async def _client_alloc_list(self, msg: dict) -> dict:
        return {
            "op": "alloc_list",
            "queues": [q.to_wire() for q in self.autoalloc.state.queues.values()],
        }

    async def _client_alloc_remove(self, msg: dict) -> dict:
        queue = self.autoalloc.state.queues.get(msg["queue_id"])
        if queue is None:
            return {"op": "error", "message": "allocation queue not found"}
        cancels = [
            # journals the cancellation + cancels the manager job
            self.autoalloc.cancel_allocation(
                queue, alloc, reason="queue-removed"
            )
            for alloc in queue.active_allocations()
        ]
        self.autoalloc.state.queues.pop(msg["queue_id"], None)
        self.autoalloc.forget_queue(msg["queue_id"])
        self.emit_event("alloc-queue-removed", {"queue_id": msg["queue_id"]})
        if cancels:
            # the reply must not outrun the manager cancels: a script
            # doing `alloc remove && server stop` would otherwise exit
            # with live batch jobs the journal believes cancelled
            await asyncio.gather(*cancels, return_exceptions=True)
        return {"op": "ok"}

    async def _client_alloc_pause(self, msg: dict) -> dict:
        queue = self.autoalloc.state.queues.get(msg["queue_id"])
        if queue is None:
            return {"op": "error", "message": "allocation queue not found"}
        queue.state = "paused" if msg.get("pause", True) else "running"
        if queue.state == "running":
            queue.consecutive_failures = 0
            queue.next_submit_at = 0.0
            # operator resume also lifts a quarantine and forgets its
            # backoff history
            queue.clear_quarantine()
        # journaled so a restore keeps the operator's pause/resume
        self.emit_event(
            "alloc-queue-paused" if queue.state == "paused"
            else "alloc-queue-resumed",
            {"queue_id": msg["queue_id"], "from": "operator"},
        )
        return {"op": "ok", "state": queue.state}

    async def _client_alloc_events(self, msg: dict) -> dict:
        """Scale decision records: why the controller did / did not act
        (`hq alloc events`)."""
        return {
            "op": "alloc_events",
            "decisions": self.autoalloc.controller.to_wire(),
        }

    async def _client_alloc_log(self, msg: dict) -> dict:
        """Locate an allocation so the client can read its manager-captured
        stdout/stderr (reference commands/autoalloc.rs print_allocation_output
        via AutoAllocRequest::GetAllocationInfo)."""
        _queue, alloc = self.autoalloc.state.find_allocation(msg["allocation_id"])
        if alloc is None:
            return {
                "op": "error",
                "message": f"allocation {msg['allocation_id']} not found",
            }
        return {"op": "alloc_log", "allocation": alloc.to_wire()}

    async def _client_alloc_dry_run(self, msg: dict) -> dict:
        from hyperqueue_tpu_torch.autoalloc.state import QueueParams

        params = QueueParams.from_wire(msg["params"])
        result = await self.autoalloc.dry_run(params)
        return {"op": "alloc_dry_run", **result}

    async def _client_task_explain(self, msg: dict) -> dict:
        """Why is this task (not) running? Reference server/explain.rs:11-98 —
        per worker x per variant, which constraints block — joined with the
        latest DecisionRecord (scheduler/decision.py) for the verdict:
        reason code, human detail, and how many consecutive ticks the
        task's class has been deferred (utils/flight.py)."""
        from hyperqueue_tpu_torch.scheduler import decision as decision_mod

        job_id = msg["job_id"]
        job = self.jobs.jobs.get(job_id)
        job_task_id = msg.get("task_id")
        if job_task_id is None:
            # `hq task explain <job>` without a task: pick the job's first
            # still-pending task (else its first task at all)
            if job is None:
                return {"op": "error", "message": f"job {job_id} not found"}
            pending = sorted(
                t.job_task_id for t in job.tasks.values()
                if t.status in ("waiting", "running")
            )
            if pending:
                job_task_id = pending[0]
            elif job.n_lazy:
                # first LIVE lazy id (the chunk min may already have
                # materialized — or finished — past the segment cursor)
                job_task_id = min(
                    next(iter(seg.remaining_ids()))
                    for seg in self.core.lazy.segments_of(job_id)
                )
            elif job.tasks:
                job_task_id = min(job.tasks)
            else:
                return {"op": "error",
                        "message": f"job {job_id} has no tasks"}
        task = self.core.tasks.get(make_task_id(job_id, job_task_id))
        if task is None and self.core.lazy.owns(job_id, job_task_id):
            # materialize the ONE asked-about lazy task so the explain
            # walk sees exactly what an eager submit would have produced
            # (it re-enters the queues at its priority level's tail)
            task = self.core.lazy.extract(self.core, job_id, job_task_id)
            if task is not None:
                if job_id in self.core.paused_jobs:
                    self.core.paused_held.setdefault(
                        job_id, set()
                    ).add(task.task_id)
                else:
                    self.core.queues.add(
                        task.rq_id, task.priority, task.task_id
                    )
        if task is None:
            if job is not None and job_task_id in job.tasks:
                info = job.tasks[job_task_id]
                return {
                    "op": "task_explain",
                    "job": job_id,
                    "task": job_task_id,
                    "state": info.status,
                    "workers": [],
                    "n_waiting_deps": 0,
                    "reason": None,
                    "reason_detail": f"task is {info.status}",
                    "deferred_ticks": 0,
                }
            return {"op": "error", "message": "task not found"}
        rqv = self.core.rq_map.get_variants(task.rq_id)
        workers = []
        for w in self.core.workers.values():
            variants = []
            for vi, variant in enumerate(rqv.variants):
                blocked = []
                if variant.is_multi_node:
                    group_size = sum(
                        1 for x in self.core.workers.values()
                        if x.group == w.group
                    )
                    if group_size < variant.n_nodes:
                        blocked.append(
                            f"group '{w.group}' has {group_size} < "
                            f"{variant.n_nodes} workers"
                        )
                else:
                    for entry in variant.entries:
                        name = self.core.resource_map.name_of(entry.resource_id)
                        have_total = w.resources.amount(entry.resource_id)
                        have_free = (
                            w.free[entry.resource_id]
                            if entry.resource_id < len(w.free)
                            else 0
                        )
                        if have_total < entry.amount:
                            blocked.append(
                                f"needs {entry.amount / 10_000:g} {name}, "
                                f"worker has {have_total / 10_000:g}"
                            )
                        elif have_free < entry.amount:
                            blocked.append(
                                f"waiting for {name} "
                                f"(free {have_free / 10_000:g} of "
                                f"{entry.amount / 10_000:g} needed)"
                            )
                if variant.min_time_secs and (
                    w.lifetime_secs() < variant.min_time_secs
                ):
                    blocked.append(
                        f"needs {variant.min_time_secs:g}s but worker has "
                        f"{w.lifetime_secs()}s left"
                    )
                variants.append({"variant": vi, "blocked": blocked})
            workers.append(
                {
                    "id": w.worker_id,
                    "hostname": w.configuration.hostname,
                    "variants": variants,
                    "runnable": any(not v["blocked"] for v in variants),
                }
            )

        # --- verdict: reason code + deferral from the flight recorder ---
        reason = None
        detail = ""
        deferred = 0
        decision_tick = None
        paused = job_id in self.core.paused_jobs
        if task.state is TaskState.WAITING:
            reason = decision_mod.REASON_WAITING_DEPS
            detail = (
                f"waiting for {task.unfinished_deps} unfinished "
                f"dependenc{'y' if task.unfinished_deps == 1 else 'ies'}"
            )
        elif task.state is TaskState.READY:
            held = self.core.paused_held.get(job_id)
            if paused and held and task.task_id in held:
                reason = decision_mod.REASON_QUEUE_PAUSED
                detail = (
                    f"job {job_id} is paused; "
                    f"`hq job resume {job_id}` to release it"
                )
            else:
                rec = self.core.flight.reason_for(task.rq_id, job_id)
                if rec is not None:
                    reason = rec["reason"]
                    detail = rec.get("detail") or ""
                    deferred = rec["deferred_ticks"]
                    decision_tick = rec["tick"]
                elif rqv.is_multi_node:
                    reason = decision_mod.REASON_GANG_INCOMPLETE
                else:
                    # no DecisionRecord covers it (no tick yet, or the
                    # recorder is off): classify live against the pool
                    reason = decision_mod.classify_class(
                        self.core, task.rq_id, rqv
                    )
            if not detail:
                n_capable = sum(
                    1 for w in self.core.workers.values()
                    if w.resources.is_capable_of_rqv(rqv)
                )
                detail = {
                    decision_mod.REASON_NO_MATCHING_WORKER: (
                        f"none of the {len(self.core.workers)} connected "
                        "worker(s) provides the requested resources"
                    ),
                    decision_mod.REASON_INSUFFICIENT_CAPACITY: (
                        f"{n_capable} capable worker(s), all currently "
                        "occupied"
                    ),
                    decision_mod.REASON_WORKER_LIFETIME: (
                        f"{n_capable} capable worker(s), but none has "
                        "enough remaining lifetime for the requested "
                        "--time-request"
                    ),
                    decision_mod.REASON_SOLVER_DEFERRED: (
                        "capacity was free but the solver deferred the "
                        "class this tick (priority interleaving or "
                        "reservation drain)"
                    ),
                    decision_mod.REASON_WATCHDOG_FALLBACK: (
                        "the tick ran on the watchdog's host-greedy "
                        "fallback after the primary solver failed "
                        "(see `hq server stats`)"
                    ),
                    decision_mod.REASON_GANG_INCOMPLETE: (
                        "waiting for enough idle same-group workers to "
                        "host the gang"
                    ),
                    decision_mod.REASON_FAIRNESS_DEFERRED: (
                        "a fairness/prediction-boosted job overtook this "
                        "class's priority this tick (--policy-file; "
                        "active policy under `hq server stats`)"
                    ),
                }.get(reason, "")
        # the latest tick's solver verdict: which backend solved (and WHY
        # that backend was chosen — the adaptive cost model's reason), so
        # "why did this tick solve on the host?" is answerable from here
        latest = self.core.flight.latest()
        solver = (latest or {}).get("solver") or {}
        return {
            "op": "task_explain",
            "job": job_id,
            "task": job_task_id,
            "state": task.state.value,
            "n_waiting_deps": task.unfinished_deps,
            "reason": reason,
            "reason_detail": detail,
            "deferred_ticks": deferred,
            "decision_tick": decision_tick,
            "paused": paused,
            "solver_backend": solver.get("backend"),
            "solver_backend_reason": solver.get("backend_reason"),
            "solver_pipelined": bool(solver.get("pipelined")),
            # active weighted objective (--policy-file): weight-matrix
            # source, predictor hit-rate, boost range — None when flat
            "policy": (
                self.core.policy.stats()
                if self.core.policy is not None else None
            ),
            "workers": workers,
        }

    async def _client_flight_recorder_dump(self, msg: dict) -> dict:
        """The flight recorder's rings: last N DecisionRecords + recent
        control-plane events (`hq server flight-recorder dump`)."""
        return {"op": "flight_recorder", **self.core.flight.dump()}

    async def _client_job_pause(self, msg: dict) -> dict:
        """Hold the selected jobs' READY tasks out of the scheduler queues
        (running/assigned tasks are not preempted)."""
        paused = []
        for job_id in msg["job_ids"]:
            job = self.jobs.jobs.get(job_id)
            if job is None or job.is_terminated():
                continue
            held, retracted = reactor.pause_jobs(
                self.core, self.comm, [job_id]
            )
            paused.append(
                {"job": job_id, "held": held, "retracted": retracted}
            )
            self.emit_event(
                "job-paused",
                {"job": job_id, "held": held, "retracted": retracted},
            )
        if paused:
            # wake the scheduler so the next DecisionRecord reflects the
            # pause (and freed prefill budgets can shift to other jobs)
            self.comm.ask_for_scheduling()
        return {"op": "job_pause", "paused": paused}

    async def _client_job_resume(self, msg: dict) -> dict:
        released = []
        for job_id in msg["job_ids"]:
            if job_id not in self.core.paused_jobs:
                continue
            n = reactor.resume_jobs(self.core, self.comm, [job_id])
            released.append({"job": job_id, "released": n})
            self.emit_event("job-resumed", {"job": job_id, "released": n})
        return {"op": "job_resume", "resumed": released}

    async def _client_trace_export(self, msg: dict) -> dict:
        """Chrome trace-event JSON of the run so far: one scheduler row
        built from the flight recorder's tick ring, one row per worker
        carrying its task spans (lifecycle stamps), loadable in Perfetto
        (`hq server trace export out.json`)."""
        events: list[dict] = []
        now = clock.now()
        events.append({
            "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
            "args": {"name": f"hq-server {self.host}"},
        })
        events.append({
            "ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
            "args": {"name": "scheduler"},
        })
        seen_workers: set[int] = set()

        def name_worker(wid: int, hostname: str = "") -> None:
            if wid in seen_workers or not wid:
                return
            seen_workers.add(wid)
            label = f"worker {wid}"
            if hostname:
                label += f" ({hostname})"
            events.append({
                "ph": "M", "pid": 0, "tid": wid, "name": "thread_name",
                "args": {"name": label},
            })

        for w in self.core.workers.values():
            name_worker(w.worker_id, w.configuration.hostname)
        for wid, past in self.past_workers.items():
            name_worker(wid, past.get("hostname", ""))

        # scheduler row: one slice per recorded tick + a ready-queue counter
        ticks = self.core.flight.ticks()
        for rec in ticks:
            ts = rec["time"] * 1e6
            events.append({
                "ph": "X", "pid": 0, "tid": 0, "ts": ts,
                "dur": max(rec.get("duration_ms", 0.0) * 1e3, 1.0),
                "cat": "tick", "name": f"tick {rec['tick']}",
                "args": {
                    "solver": rec.get("solver"),
                    "counts": rec.get("counts"),
                    "phases": rec.get("phases"),
                    "unplaced": rec.get("unplaced"),
                },
            })
            events.append({
                "ph": "C", "pid": 0, "tid": 0, "ts": ts,
                "name": "ready_tasks",
                "args": {
                    "ready": rec.get("counts", {}).get("ready_left", 0)
                },
            })

        # solver row (pid 1): one slice per solve, placed by its RECORDED
        # dispatch/readback wall stamps. Under --tick-pipeline, tick k+1
        # maps the solve DISPATCHED at tick k — charging its solve_ms to
        # the mapping tick's row misattributes the span (it shows the
        # readback wait at the wrong time and hides the overlapped device
        # execution).  The wall stamps render the true execution window;
        # sync solves draw inside their own tick with solve_ms.
        events.append({
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "hq-solver"},
        })
        events.append({
            "ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
            "args": {"name": "solve plane"},
        })
        for rec in ticks:
            solver = rec.get("solver") or {}
            solve_ms = solver.get("solve_ms") or 0.0
            if solver.get("pipelined"):
                disp = solver.get("dispatched_at_wall") or 0.0
                mapped = solver.get("mapped_at_wall") or 0.0
                if disp and mapped:
                    events.append({
                        "ph": "X", "pid": 1, "tid": 0, "ts": disp * 1e6,
                        "dur": max((mapped - disp) * 1e6, 1.0),
                        "cat": "solve",
                        "name": f"solve → tick {rec['tick']}",
                        "args": {
                            "pipelined": True,
                            "backend": solver.get("backend"),
                            # the tick-critical-path cost vs the full
                            # dispatch->map window (DecisionRecord
                            # solve_ms vs inflight_ms)
                            "readback_wait_ms": solve_ms,
                            "inflight_ms": solver.get("inflight_ms"),
                            "objective": solver.get("objective"),
                        },
                    })
            elif solve_ms:
                events.append({
                    "ph": "X", "pid": 1, "tid": 0, "ts": rec["time"] * 1e6,
                    "dur": max(solve_ms * 1e3, 1.0),
                    "cat": "solve", "name": f"solve tick {rec['tick']}",
                    "args": {
                        "pipelined": False,
                        "backend": solver.get("backend"),
                        "solve_ms": solve_ms,
                        "objective": solver.get("objective"),
                    },
                })

        # worker rows: one slice per task execution span, linked to the
        # scheduler row with flow events (the per-task causal trace made
        # visible: dispatch on the scheduler row flows into the execution
        # slice on the worker row)
        for job in self.jobs.jobs.values():
            for info in job.tasks.values():
                if not info.started_at:
                    continue
                wid = info.worker_ids[0] if info.worker_ids else 0
                name_worker(wid)
                end = info.finished_at or now
                task_id = make_task_id(job.job_id, info.job_task_id)
                core_task = self.core.tasks.get(task_id)
                trace_rec = self.core.traces.get(task_id)
                events.append({
                    "ph": "X", "pid": 0, "tid": wid,
                    "ts": info.started_at * 1e6,
                    "dur": max((end - info.started_at) * 1e6, 1.0),
                    "cat": "task",
                    "name": f"{job.job_id}.{info.job_task_id}",
                    "args": {
                        "status": info.status,
                        "submitted_at": info.submitted_at,
                        "queued_at": core_task.t_ready if core_task else 0.0,
                        "assigned_at": (
                            core_task.t_assigned if core_task else 0.0
                        ),
                        "workers": info.worker_ids,
                        "trace_id": (
                            trace_rec["trace_id"] if trace_rec else None
                        ),
                    },
                })
                assigned_at = core_task.t_assigned if core_task else 0.0
                if assigned_at and wid:
                    flow = {
                        "cat": "dispatch", "name": "dispatch",
                        "id": task_id,
                    }
                    events.append({
                        "ph": "s", "pid": 0, "tid": 0,
                        "ts": assigned_at * 1e6, **flow,
                    })
                    events.append({
                        "ph": "f", "bp": "e", "pid": 0, "tid": wid,
                        "ts": info.started_at * 1e6, **flow,
                    })

        # profiler counter tracks: one CPU-cores counter per
        # plane, bucketed from the sampling ring — the same Perfetto file
        # now answers "which plane was burning CPU" next to ticks, solves
        # and task spans
        prof = profiler.PROFILER
        if prof.running:
            events.append({
                "ph": "M", "pid": 2, "tid": 0, "name": "process_name",
                "args": {"name": "hq-profiler"},
            })
            for plane, series in sorted(prof.counter_track().items()):
                for t, cores in series:
                    events.append({
                        "ph": "C", "pid": 2, "tid": 0, "ts": t * 1e6,
                        "name": f"cpu {plane}", "args": {"cores": cores},
                    })
        return {"op": "trace_export", "traceEvents": events}

    def _record_past_worker(self, worker_id: int, reason: str,
                            lent_to: int | None = None) -> None:
        w = self.core.workers.get(worker_id)
        if w is None:
            return
        self.past_workers[worker_id] = {
            "id": worker_id,
            "hostname": w.configuration.hostname,
            "group": w.group,
            "status": "offline",
            "n_running": 0,
            "resources": {},
            "overview": None,
            "lost_at": clock.now(),
            "reason": reason,
            # structured lend target (None for a genuine loss): the fleet
            # feed and `hq top` render lending flows from this field, the
            # human `reason` string stays for logs
            "lent_to": lent_to,
            # age of the last heartbeat at loss time — for a heartbeat
            # timeout this is how long the worker was silent
            "heartbeat_age": round(clock.monotonic() - w.last_heartbeat, 3),
        }
        while len(self.past_workers) > 1000:  # bound server memory
            self.past_workers.pop(next(iter(self.past_workers)))

    async def _client_worker_list(self, msg: dict) -> dict:
        workers = [
            {
                "id": w.worker_id,
                "hostname": w.configuration.hostname,
                "group": w.group,
                "alloc_id": w.configuration.alloc_id,
                "status": "draining" if w.draining else "running",
                "n_running": len(w.assigned_tasks),
                "resources": {
                    self.core.resource_map.name_of(i): amount
                    for i, amount in enumerate(w.resources.amounts)
                    if amount
                },
                "overview": w.last_overview,
            }
            for w in self.core.workers.values()
        ]
        if msg.get("all"):
            workers.extend(self.past_workers.values())
        return {"op": "worker_list", "workers": workers}

    async def _client_worker_info(self, msg: dict) -> dict:
        w = self.core.workers.get(msg["worker_id"])
        if w is None:
            past = self.past_workers.get(msg["worker_id"])
            if past is not None:
                return {"op": "worker_info", "worker": past}
            return {"op": "error", "message": "worker not found"}
        return {
            "op": "worker_info",
            "worker": {
                "id": w.worker_id,
                "hostname": w.configuration.hostname,
                "group": w.group,
                "manager": w.configuration.manager,
                "manager_job_id": w.configuration.manager_job_id,
                "alloc_id": w.configuration.alloc_id,
                "draining": w.draining,
                "time_limit_secs": w.configuration.time_limit_secs,
                "lifetime_secs": w.lifetime_secs(),
                "descriptor": w.configuration.descriptor.to_dict(),
                "free": {
                    self.core.resource_map.name_of(i): amount
                    for i, amount in enumerate(w.free)
                },
                "running_tasks": sorted(
                    f"{task_id_job(t)}@{task_id_task(t)}"
                    for t in w.assigned_tasks
                ),
                "overview": w.last_overview,
            },
        }

    async def _client_server_debug_dump(self, msg: dict) -> dict:
        """Full server state dump (reference control.rs:207-210 /
        core.rs:472-481 ServerDebugDump)."""
        state_counts: dict[str, int] = {}
        for task in self.core.tasks.values():
            state_counts[task.state.value] = (
                state_counts.get(task.state.value, 0) + 1
            )
        return {
            "op": "server_debug_dump",
            "trace": TRACER.snapshot(),
            "tasks": {
                "total": len(self.core.tasks),
                "by_state": state_counts,
                "ready_queued": self.core.queues.total_ready(),
                "mn_queued": len(self.core.mn_queue),
            },
            "workers": [
                {
                    "id": w.worker_id,
                    "group": w.group,
                    "free": list(w.free),
                    "nt_free": w.nt_free,
                    "assigned": len(w.assigned_tasks),
                    "mn_task": w.mn_task,
                    "mn_reserved": w.mn_reserved,
                }
                for w in self.core.workers.values()
            ],
            "rq_classes": len(self.core.rq_map),
            "resources": self.core.resource_map.names(),
            "jobs": [j.to_info() for j in self.jobs.jobs.values()],
            "autoalloc": [
                q.to_wire() for q in self.autoalloc.state.queues.values()
            ] if self.autoalloc else [],
        }

    async def _client_worker_stop(self, msg: dict) -> dict:
        if msg.get("drain"):
            # graceful: mask + let running tasks finish under the deadline
            started = self.start_drain(
                msg["worker_ids"], timeout=msg.get("timeout"), source="cli"
            )
            return {"op": "worker_stop", "stopped": started, "drain": True}
        stopped = []
        for wid in msg["worker_ids"]:
            worker = self.core.workers.get(wid)
            if worker is not None:
                worker.clean_stop = True  # crash counters stay untouched
                self.comm.send_stop(wid)
                stopped.append(wid)
        return {"op": "worker_stop", "stopped": stopped}

    async def _client_task_list(self, msg: dict) -> dict:
        job = self.jobs.jobs.get(msg["job_id"])
        if job is None:
            return {"op": "error", "message": f"job {msg['job_id']} not found"}
        return {"op": "task_list", "job": self._job_detail(job)}

    async def _stream_events(self, send, gone: asyncio.Event,
                             msg: dict) -> None:
        """Stream events to this client until it disconnects.

        Reference: event/streamer.rs fan-out with EventFilterFlags
        (streamer.rs:36-44); `history=True` first replays the journal.
        `send` is the connection sink (conn.send on the legacy in-loop
        plane, ClientChannel.stream_send on the threaded plane — both
        apply backpressure to this handler); `gone` fires on disconnect.
        """
        prefixes = tuple(msg.get("filter") or ())
        queue: asyncio.Queue = asyncio.Queue()
        # register BEFORE the replay so no live event is missed, then use the
        # record seq to drop events that were appended to the journal while
        # the replay was await-ing sends (they arrive on both paths)
        self._event_listeners.append(queue)
        wants_overviews = bool(msg.get("overviews"))
        if wants_overviews:
            self._overview_listeners += 1
            if self._overview_listeners == 1:
                self.comm.broadcast_overview_override(
                    OVERVIEW_OVERRIDE_INTERVAL
                )
        replayed_seq = -1
        try:
            if msg.get("history") and self.journal_path is not None:
                from hyperqueue_tpu_torch.events.journal import Journal

                if self.jplane is not None:
                    # sync=True: the replay re-reads the FILE, so the
                    # commit thread's buffered tail must be on disk
                    # (sync=False only guarantees the appender saw it)
                    self.jplane.barrier(sync=True)
                else:
                    self.journal.flush()
                for record in Journal.read_all(self.journal_path):
                    seq = record.get("seq")
                    if isinstance(seq, int) and seq > replayed_seq:
                        replayed_seq = seq
                    if not prefixes or record.get("event", "").startswith(prefixes):
                        await send({"op": "event", "record": record})
            await send({"op": "stream_live"})
            # the stream is send-only from here: watch the disconnect
            # event so a client detach is noticed IMMEDIATELY (not at the
            # next failed send, which for an overview listener can lag two
            # cadences and leave workers sampling hw after the dashboard
            # is gone)
            eof = asyncio.ensure_future(gone.wait())
            try:
                while True:
                    getter = asyncio.ensure_future(queue.get())
                    done, _pending = await asyncio.wait(
                        (getter, eof), return_when=asyncio.FIRST_COMPLETED
                    )
                    if eof in done:
                        getter.cancel()
                        break
                    record = getter.result()
                    if record.get("seq", -1) <= replayed_seq:
                        continue  # already sent during the history replay
                    if not prefixes or record.get("event", "").startswith(
                        prefixes
                    ):
                        await send({"op": "event", "record": record})
            finally:
                if not eof.done():
                    eof.cancel()
                    # consume the cancellation so it never surfaces as an
                    # un-retrieved exception in the loop's log
                    try:
                        await eof
                    except (asyncio.CancelledError, Exception):
                        pass
        finally:
            self._event_listeners.remove(queue)
            if wants_overviews:
                self._overview_listeners -= 1
                if self._overview_listeners == 0:
                    self.comm.broadcast_overview_override(None)

    # --- live subscription plane ---------------------------
    def _build_sample(self) -> dict:
        """One metric sample pushed to subscribers: the cluster signals the
        autoscaler and `hq top` need without polling.
        O(workers + queues), never O(tasks)."""
        core = self.core
        workers = []
        running_total = 0
        borrowed = 0
        for w in core.workers.values():
            running_total += len(w.assigned_tasks)
            hw = (w.last_overview or {}).get("hw") or {}
            row = {
                "id": w.worker_id,
                "hostname": w.configuration.hostname,
                "running": len(w.assigned_tasks),
                "prefilled": len(w.prefilled_tasks),
                "draining": w.draining,
                "cpu": hw.get("cpu_usage_percent"),
            }
            lent_from = getattr(w.configuration, "lent_from", -1)
            if lent_from >= 0:
                row["lent_from"] = lent_from
                borrowed += 1
            # worker per-plane CPU attribution: the shares the
            # worker piggybacked on its last overview — `hq top` fleet
            # view renders them with no per-worker scrape
            planes = {
                s["labels"]["plane"]: s["value"]
                for s in (w.last_metrics or ())
                if s.get("name") == "hq_worker_profile_plane_cpu_share"
                and (s.get("labels") or {}).get("plane")
            }
            if planes:
                row["planes"] = planes
            workers.append(row)
        latest = core.flight.latest() or {}
        pending_reasons: dict[str, int] = {}
        for entry in latest.get("unplaced") or ():
            reason = entry.get("reason")
            if reason:
                pending_reasons[reason] = (
                    pending_reasons.get(reason, 0) + entry.get("count", 0)
                )
        jobs = self.jobs.jobs
        job_counts: dict[str, int] = {}
        for job in jobs.values():
            status = job.status()
            job_counts[status] = job_counts.get(status, 0) + 1
        sample = {
            "op": "sample",
            "time": clock.now(),
            "uptime": round(clock.now() - self.started_at, 1),
            "event_seq": self._event_seq,
            "workers": workers,
            "n_workers": len(core.workers),
            "n_jobs": len(jobs),
            "job_counts": job_counts,
            "tasks_known": len(core.tasks),
            "ready": core.queues.total_ready(),
            "mn_queued": len(core.mn_queue),
            "running": running_total,
            "pending_reasons": pending_reasons,
            "tick": core.tick_counter,
            "tick_last_ms": (core.tick_stats.snapshot().get("phases") or {})
            .get("total", {}).get("last_ms"),
            "lag": self.lag.snapshot(),
            "stalls": self.stalls_captured,
            "subscribers": len(self._subscribers),
            # health plane: usage totals + alert badge ride
            # every sample so `hq top` / the FleetFeed render both
            # without extra RPCs
            "accounting": self.accounting.brief(),
            "alerts": self._alert_badge(),
        }
        if profiler.PROFILER.running:
            # per-plane CPU shares ride every sample so
            # `hq top` renders the CPU block push-fed, like the lag block
            sample["profile"] = {
                plane: agg["cpu"]
                for plane, agg in profiler.PROFILER.plane_shares().items()
            }
        if self.federation_root is not None:
            # fleet view context — all in-memory reads, no lease-file I/O
            # on the sample path (self.lease.epoch is the holder's
            # authoritative copy)
            sample["federation"] = {
                "shard_id": self.shard_id,
                "shard_count": self.shard_count,
                "lease_epoch": self.lease.epoch if self.lease else 0,
                "promoted": self.promoted,
                "workers_lent": self.workers_lent_total,
                "workers_borrowed": borrowed,
            }
        autoalloc = getattr(self, "autoalloc", None)
        if autoalloc is not None and autoalloc.state.queues:
            sample["alloc_quarantined"] = sum(
                1 for q in autoalloc.state.queues.values()
                if q.state == "quarantined"
            )
        return sample

    async def _subscribe(self, send, gone: asyncio.Event,
                         msg: dict) -> None:
        """Stream lifecycle events + periodic metric samples to one client
        over the existing framing until it disconnects or falls behind.

        Backpressure contract: the per-subscriber queue is bounded; a
        consumer that cannot keep up is DROPPED (final `sub_dropped`
        frame, counted in hq_subscribers_dropped_total) rather than
        allowed to hold server memory or reactor latency hostage."""
        # validate the filter: emit_event runs kind.startswith(prefixes)
        # on the reactor's hottest paths, where a non-str element would
        # raise out of the WORKER recv loop — one malformed subscriber
        # must not tear down worker connections. A bare string is treated
        # as one prefix, not a tuple of characters.
        raw_filter = msg.get("filter") or ()
        if isinstance(raw_filter, str):
            raw_filter = (raw_filter,)
        sub = _Subscriber(
            prefixes=tuple(p for p in raw_filter if isinstance(p, str)),
            sample_interval=max(float(msg.get("sample_interval") or 0.0), 0.0),
            buffer=msg.get("buffer") or 4096,
        )
        self._subscribers.append(sub)
        wants_overviews = bool(msg.get("overviews"))
        if wants_overviews:
            self._overview_listeners += 1
            if self._overview_listeners == 1:
                self.comm.broadcast_overview_override(
                    OVERVIEW_OVERRIDE_INTERVAL
                )
        try:
            await send({"op": "sub_live", "seq": self._event_seq})
            if sub.sample_interval:
                await send(self._build_sample())
            next_sample = (
                clock.monotonic() + sub.sample_interval
                if sub.sample_interval else None
            )
            eof = asyncio.ensure_future(gone.wait())
            try:
                while not sub.dead:
                    timeout = (
                        max(next_sample - clock.monotonic(), 0.0)
                        if next_sample is not None else None
                    )
                    getter = asyncio.ensure_future(sub.queue.get())
                    done, _pending = await asyncio.wait(
                        (getter, eof),
                        timeout=timeout,
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                    if eof in done:
                        getter.cancel()
                        return
                    if getter in done:
                        # coalesce a burst into one frame (one encryption +
                        # one syscall, like the downlink batcher)
                        records = [getter.result()]
                        while len(records) < 128:
                            try:
                                records.append(sub.queue.get_nowait())
                            except asyncio.QueueEmpty:
                                break
                        await send(
                            {"op": "events", "records": records}
                        )
                    else:
                        getter.cancel()
                    if (
                        next_sample is not None
                        and clock.monotonic() >= next_sample
                    ):
                        await send(self._build_sample())
                        next_sample = clock.monotonic() + sub.sample_interval
                # fell behind: say so, then hang up
                await send(
                    {"op": "sub_dropped", "dropped": sub.dropped}
                )
            finally:
                if not eof.done():
                    eof.cancel()
                    try:
                        await eof
                    except (asyncio.CancelledError, Exception):
                        pass
        except (ConnectionError, OSError):
            pass  # consumer went away mid-send
        finally:
            self._subscribers.remove(sub)
            if wants_overviews:
                self._overview_listeners -= 1
                if self._overview_listeners == 0:
                    self.comm.broadcast_overview_override(None)

    # --- task traces ---------------------------------------
    async def _client_task_trace(self, msg: dict) -> dict:
        """The assembled causal trace of one task: every recorded span
        from client submit through worker spawn to completion commit
        (`hq task trace <job>.<task>`)."""
        job_id = msg["job_id"]
        job_task_id = msg.get("task_id") or 0
        task_id = make_task_id(job_id, job_task_id)
        rec = self.core.traces.get(task_id)
        if rec is None:
            if not self.core.traces.enabled:
                return {"op": "error",
                        "message": "task tracing is disabled "
                                   "(--task-trace-capacity 0)"}
            return {"op": "error",
                    "message": f"no trace recorded for task "
                               f"{job_id}.{job_task_id} (evicted, or the "
                               "task predates this server's trace store)"}
        from hyperqueue_tpu_torch.utils.trace import REQUIRED_HOPS, SPAN_ORDER

        order = {name: i for i, name in enumerate(SPAN_ORDER)}
        spans = sorted(
            rec["spans"],
            key=lambda s: (s["instance"], s["t0"], order.get(s["name"], 99)),
        )
        t0 = min((s["t0"] for s in spans), default=0.0)
        t1 = max((s["t1"] for s in spans), default=0.0)
        names = {s["name"] for s in spans}
        return {
            "op": "task_trace",
            "job": job_id,
            "task": job_task_id,
            "trace_id": rec["trace_id"],
            "closed": bool(rec.get("done")),
            "complete": rec.get("done") and REQUIRED_HOPS <= names,
            "missing_hops": sorted(REQUIRED_HOPS - names),
            "wall_s": round(max(t1 - t0, 0.0), 6),
            "span_sum_s": round(
                sum(s["t1"] - s["t0"] for s in spans), 6
            ),
            "spans": spans,
            # fleet annotations: lend / failover stamps
            "annotations": list(rec.get("notes") or ()),
        }

    # --- reactor lag + stall watchdog ----------------------
    STALL_CAPTURE_MIN_INTERVAL = 5.0

    def note_plane(self, plane: str, dt: float) -> None:
        """Record how long one work class held the event loop; past the
        stall budget, auto-capture a diagnosis dump."""
        self.lag.observe(plane, dt)
        if self.stall_budget > 0 and dt >= self.stall_budget:
            self._capture_stall(plane, dt)

    def _capture_stall(self, plane: str, duration_s: float) -> None:
        now = clock.monotonic()
        _REACTOR_STALLS.labels(plane).inc()
        self.core.flight.record_event(
            "reactor-stall",
            {"plane": plane, "duration_s": round(duration_s, 4),
             "budget_s": self.stall_budget},
        )
        if now - self._last_stall_capture < self.STALL_CAPTURE_MIN_INTERVAL:
            self.stalls_captured += 1
            return  # rate-limit the (file-writing) capture, keep counting
        self._last_stall_capture = now
        self.stalls_captured += 1
        dump = {
            "time": clock.now(),
            "plane": plane,
            "duration_s": round(duration_s, 4),
            "budget_s": self.stall_budget,
            "tick": self.core.tick_counter,
            "lag": self.lag.snapshot(),
            "trace": TRACER.snapshot(),
            # profile-on-stall: the aggregated stack burst the
            # sampler captured during the stall window itself — what every
            # plane was executing while the budget was being blown (the
            # stall is detected only after the blocking work returns, so
            # the ring is the only honest source of this)
            "profile": profiler.PROFILER.stall_burst(
                duration_s + 1.0
            ) if profiler.PROFILER.running else [],
            "queues": {
                "ready": self.core.queues.total_ready(),
                "mn_queued": len(self.core.mn_queue),
                "workers": len(self.core.workers),
                "event_listeners": len(self._event_listeners),
                "subscribers": len(self._subscribers),
            },
            "flight": self.core.flight.dump(),
        }
        self.last_stall = {
            k: dump[k] for k in ("time", "plane", "duration_s", "tick")
        }
        instance_dir = getattr(self, "_instance_dir", None)
        if instance_dir is None:
            return  # stalled before start() finished; counted, not dumped
        stall_dir = Path(instance_dir) / "stalls"
        try:
            import json as _json

            stall_dir.mkdir(exist_ok=True)
            out = stall_dir / f"stall-{self.stalls_captured:04d}.json"
            out.write_text(_json.dumps(dump, default=str))
            self.last_stall["dump"] = str(out)

            def seq_of(p: Path) -> int:
                # numeric, not lexicographic: past capture 9999 the name
                # outgrows the padding and a string sort would prune the
                # NEWEST dumps
                try:
                    return int(p.stem.rpartition("-")[2])
                except ValueError:
                    return -1

            dumps = sorted(stall_dir.glob("stall-*.json"), key=seq_of)
            for old in dumps[: max(len(dumps) - self.stall_dumps, 0)]:
                old.unlink(missing_ok=True)
        except OSError:
            logger.exception("stall dump write failed")
        logger.critical(
            "reactor stall: %s plane held the loop %.3fs (budget %.3fs); "
            "diagnosis dumped to %s",
            plane, duration_s, self.stall_budget,
            self.last_stall.get("dump", "<memory only>"),
        )

    async def _loop_lag_monitor(self) -> None:
        """Measure the event loop's own scheduling lag: the overshoot of a
        short sleep is exactly how long other work held the loop. Feeds
        the `loop` plane of hq_reactor_lag_seconds and the stall
        watchdog (a long stall shows up here even when the blocking work
        class was never instrumented)."""
        interval = 0.1
        while True:
            before = clock.monotonic()
            await asyncio.sleep(interval)
            overshoot = clock.monotonic() - before - interval
            self.note_plane("loop", max(overshoot, 0.0))

    async def _client_journal_flush(self, msg: dict) -> dict:
        if self.journal is None:
            return {"op": "error", "message": "server runs without a journal"}
        if self.jplane is not None:
            self.jplane.barrier(sync=True)
        else:
            self.journal.flush(sync=True)
        return {"op": "ok"}

    async def _client_journal_prune(self, msg: dict) -> dict:
        """Drop completed jobs from the journal (reference journal/prune.rs)."""
        if self.journal is None:
            return {"op": "error", "message": "server runs without a journal"}
        if self._compacting:
            return {"op": "error",
                    "message": "journal compaction in progress; retry"}
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod
        from hyperqueue_tpu_torch.events.journal import Journal

        live = {
            job_id
            for job_id, job in self.jobs.jobs.items()
            if not job.is_terminated()
        }
        if snapshot_mod.have_snapshot(self.journal_path):
            # a snapshot supersedes the journal prefix: a bare prune would
            # drop post-watermark terminal events of completed jobs while
            # leaving the stale snapshot in place — the next restore would
            # resurrect and re-execute them. Compaction IS the
            # snapshot-aware prune, so delegate.
            stats = await self.compact_journal(reason="prune")
            if stats.get("skipped"):
                return {"op": "error", "message": stats["skipped"]}
            return {"op": "ok", "kept_records": stats["kept_records"],
                    "live_jobs": sorted(live)}
        # quiesce the commit thread around the close/rewrite/reopen (no
        # awaits in between — see JournalPlane.suspend)
        if self.jplane is not None:
            self.jplane.suspend()
        try:
            self.journal.close()
            kept = Journal.prune(self.journal_path, live,
                                 salvage=self.journal_salvage)
            self.journal.open_for_append()
        finally:
            if self.jplane is not None:
                self.jplane.resume()
        # live jobs' submit events survived the prune; re-log nothing
        return {"op": "ok", "kept_records": kept, "live_jobs": sorted(live)}

    async def _client_journal_compact(self, msg: dict) -> dict:
        """Snapshot + GC now (`hq journal compact`)."""
        if self.journal is None:
            return {"op": "error", "message": "server runs without a journal"}
        stats = await self.compact_journal(reason="cli")
        return {"op": "journal_compact", **stats}

    async def _client_journal_info(self, msg: dict) -> dict:
        """Journal/snapshot sizes, lineage, restore + compaction stats
        (`hq journal info`)."""
        if self.journal_path is None:
            return {"op": "error", "message": "server runs without a journal"}
        from hyperqueue_tpu_torch.events import snapshot as snapshot_mod

        if self.jplane is not None:
            # sync=True so the size/segment stats below see the full tail
            self.jplane.barrier(sync=True)
        else:
            self.journal.flush()
        journal_bytes = (
            self.journal_path.stat().st_size
            if self.journal_path.exists()
            else 0
        )
        snap = snapshot_mod.snapshot_stats(self.journal_path)
        segments = int(journal_bytes > 0) + int(snap["bytes"] > 0) + int(
            snap["prev_bytes"] > 0
        )
        return {
            "op": "journal_info",
            "path": str(self.journal_path),
            "journal_bytes": journal_bytes,
            "segments": segments,
            "event_seq": self._event_seq,
            "n_boots": self.n_boots,
            "snapshot": snap,
            "fsync_policy": self.journal_fsync,
            "compact_interval": self.journal_compact_interval,
            "compact_threshold": self.journal_compact_threshold,
            "salvage": self.journal_salvage,
            "last_restore": self.last_restore,
            "last_compaction": self.last_compaction,
        }


async def run_server(**kwargs) -> None:
    server = Server(**kwargs)
    await server.start()
    await server.run_until_stopped()

