"""Event-sourced dashboard state with time-travel.

Reference: crates/hyperqueue/src/dashboard/data/ — DashboardData holds
per-worker / per-job / per-allocation timelines built purely from the event
stream (live or journal replay), so the dashboard can replay a finished
journal offline and scrub through time (data/timelines/*.rs).

This mirror keeps every consumed record and rebuilds state `at(t)` by
replaying the prefix — events are cheap dict updates, and a rebuild only
happens on seek, so scrubbing a journal of tens of thousands of records is
instant in practice.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from hyperqueue_tpu_torch.utils import clock

OVERVIEW_HISTORY = 512  # per-worker (t, cpu%) samples kept for the chart


@dataclass
class TaskSpan:
    """One task's stay on a worker (timeline chart fodder)."""

    job_id: int
    task_id: int
    started_at: float
    ended_at: float = 0.0  # 0 = still running
    status: str = "running"


@dataclass
class WorkerState:
    worker_id: int
    hostname: str = ""
    group: str = "default"
    resources: dict = field(default_factory=dict)  # name -> units
    alloc_id: str = ""  # autoalloc allocation this worker belongs to
    connected_at: float = 0.0
    lost_at: float = 0.0
    lost_reason: str = ""
    last_hw: dict = field(default_factory=dict)
    cpu_history: deque = field(default_factory=lambda: deque(maxlen=OVERVIEW_HISTORY))
    running: set = field(default_factory=set)  # (job, task)
    tasks_done: int = 0
    # recent task spans on this worker, newest last (worker-detail timeline)
    task_history: deque = field(
        default_factory=lambda: deque(maxlen=OVERVIEW_HISTORY)
    )

    def running_series(self) -> list[tuple[float, float]]:
        """(t, concurrent running tasks) step series from the span history."""
        return fold_spans(self.task_history)

    @property
    def is_connected(self) -> bool:
        return self.lost_at == 0.0


def fold_spans(spans) -> list[tuple[float, float]]:
    """TaskSpans -> (t, concurrent count) step series. Starts sort before
    ends at equal timestamps (-d) so a zero-duration span never dips the
    count negative."""
    deltas: list[tuple[float, int]] = []
    for span in spans:
        deltas.append((span.started_at, +1))
        if span.ended_at:
            deltas.append((span.ended_at, -1))
    series, n = [], 0
    for t, d in sorted(deltas, key=lambda td: (td[0], -td[1])):
        n += d
        series.append((t, float(n)))
    return series


@dataclass
class TaskView:
    status: str = "waiting"
    started_at: float = 0.0
    finished_at: float = 0.0
    workers: tuple = ()
    error: str = ""


@dataclass
class JobState:
    job_id: int
    name: str = "job"
    n_tasks: int = 0
    submitted_at: float = 0.0
    completed_at: float = 0.0
    final_status: str = ""
    is_open: bool = False
    paused: bool = False
    # reason-code -> pending-task count from the server's latest
    # DecisionRecord (job_info `pending_reasons`).  Snapshot semantics: the
    # event stream does not carry reason updates, so this reflects the
    # last seed/refresh (seed_from_server) and is cleared when the job
    # completes; replay-mode dashboards never have it.
    pending_reasons: dict = field(default_factory=dict)
    tasks: dict = field(default_factory=dict)  # task_id -> TaskView

    def pending_summary(self) -> str:
        """"30 insufficient-capacity, 7 gang-incomplete" or ""."""
        if not self.pending_reasons:
            return ""
        from hyperqueue_tpu_torch.scheduler.decision import format_reason_counts

        return format_reason_counts(self.pending_reasons)

    def counters(self) -> dict:
        out = {"waiting": 0, "running": 0, "finished": 0, "failed": 0,
               "canceled": 0}
        seen = 0
        for t in self.tasks.values():
            out[t.status] = out.get(t.status, 0) + 1
            seen += 1
        out["waiting"] += max(self.n_tasks - seen, 0)
        return out

    def status(self) -> str:
        if self.final_status:
            return self.final_status
        c = self.counters()
        if c["running"]:
            return "running"
        return "waiting"

    def progress(self) -> float:
        if not self.n_tasks:
            return 0.0
        c = self.counters()
        return (c["finished"] + c["failed"] + c["canceled"]) / self.n_tasks


@dataclass
class AllocationView:
    allocation_id: str
    status: str = "queued"
    queued_at: float = 0.0
    started_at: float = 0.0
    ended_at: float = 0.0
    worker_count: int = 1


@dataclass
class QueueState:
    queue_id: int
    manager: str = ""
    state: str = "active"
    allocations: dict = field(default_factory=dict)


class DashboardData:
    """State reducer over the server event stream.

    retain_events=False (live mode) keeps only the reduced state: the raw
    record log exists for replay/time-travel and would grow without bound on
    a long-lived live dashboard."""

    def __init__(self, retain_events: bool = True):
        self.retain_events = retain_events
        self.workers: dict[int, WorkerState] = {}
        self.jobs: dict[int, JobState] = {}
        self.queues: dict[int, QueueState] = {}
        self.events: list[dict] = []      # consumed records (replay mode)
        # (t, n_connected); bounded — feeds a fixed-width sparkline
        self.worker_series: deque = deque(maxlen=4096)
        self.last_time: float = 0.0

    # ------------------------------------------------------------------
    def add_event(self, record: dict) -> None:
        if self.retain_events:
            self.events.append(record)
        self._apply(record)

    def _apply(self, record: dict) -> None:
        kind = record.get("event", "")
        t = float(record.get("time", 0.0))
        if t > self.last_time:
            self.last_time = t

        if kind == "worker-connected":
            wid = record.get("id", 0)
            self.workers[wid] = WorkerState(
                worker_id=wid,
                hostname=record.get("hostname", ""),
                group=record.get("group", "default"),
                resources=record.get("resources") or {},
                alloc_id=record.get("alloc_id", ""),
                connected_at=t,
            )
            self._mark_worker_count(t)
        elif kind == "worker-lost":
            w = self.workers.get(record.get("id", 0))
            if w is not None:
                w.lost_at = t
                w.lost_reason = record.get("reason", "")
                w.running.clear()
                # drop the utilization snapshot: a lost worker's last sample
                # must not render as live load while (and after) its
                # replacement reconnects under a new id
                w.last_hw = {}
            self._mark_worker_count(t)
        elif kind == "worker-overview":
            wid = record.get("id", 0)
            w = self.workers.get(wid)
            if w is None:
                # a reconnected worker re-registers under a NEW id and its
                # first overview can outrun the worker-connected record in
                # the stream; create the state so fresh utilization is
                # never attributed to the stale pre-reconnect entry
                w = self.workers[wid] = WorkerState(
                    worker_id=wid, connected_at=t
                )
                self._mark_worker_count(t)
            # prefer the structured gauge samples piggybacked by the worker
            # runtime (the metrics plane); fall back to the raw hw dict for
            # journals written before the metrics plane existed
            gauges = {
                s.get("name"): s.get("value")
                for s in record.get("metrics") or []
                if not s.get("labels")
            }
            w.last_hw = record.get("hw", {}) or {}
            cpu = gauges.get(
                "hq_worker_cpu_percent", w.last_hw.get("cpu_usage_percent")
            )
            if cpu is not None:
                w.cpu_history.append((t, float(cpu)))
        elif kind == "job-submitted":
            job_id = record.get("job", 0)
            desc = record.get("desc", {}) or {}
            job = self.jobs.get(job_id)
            if job is None:
                job = self.jobs[job_id] = JobState(job_id=job_id)
                job.submitted_at = t
                job.name = desc.get("name", "job")
            job.n_tasks += record.get("n_tasks", 0)
            job.is_open = bool(desc.get("open", job.is_open))
        elif kind == "job-opened":
            job_id = record.get("job", 0)
            job = self.jobs.setdefault(job_id, JobState(job_id=job_id))
            job.name = record.get("name", job.name)
            job.is_open = True
            if not job.submitted_at:
                job.submitted_at = t
        elif kind == "job-closed":
            job = self.jobs.get(record.get("job", 0))
            if job is not None:
                job.is_open = False
        elif kind == "job-paused":
            job = self.jobs.get(record.get("job", 0))
            if job is not None:
                job.paused = True
        elif kind == "job-resumed":
            job = self.jobs.get(record.get("job", 0))
            if job is not None:
                job.paused = False
                job.pending_reasons.pop("queue-paused", None)
        elif kind == "job-completed":
            job = self.jobs.get(record.get("job", 0))
            if job is not None:
                job.completed_at = t
                job.final_status = record.get("status", "finished")
                job.pending_reasons = {}  # nothing pending anymore
        elif kind == "task-started":
            job = self.jobs.setdefault(
                record.get("job", 0), JobState(job_id=record.get("job", 0))
            )
            task = job.tasks.setdefault(record.get("task", 0), TaskView())
            task.status = "running"
            task.started_at = t
            task.workers = tuple(record.get("workers") or ())
            for wid in task.workers:
                w = self.workers.get(wid)
                if w is not None:
                    w.running.add((job.job_id, record.get("task", 0)))
                    w.task_history.append(TaskSpan(
                        job_id=job.job_id,
                        task_id=record.get("task", 0),
                        started_at=t,
                    ))
        elif kind == "task-restarted":
            job = self.jobs.get(record.get("job", 0))
            if job is not None:
                task = job.tasks.setdefault(record.get("task", 0), TaskView())
                self._release_task(job.job_id, record.get("task", 0), task,
                                   at=t, status="restarted")
                task.status = "waiting"
        elif kind in ("task-finished", "task-failed", "task-canceled"):
            job = self.jobs.setdefault(
                record.get("job", 0), JobState(job_id=record.get("job", 0))
            )
            task = job.tasks.setdefault(record.get("task", 0), TaskView())
            self._release_task(job.job_id, record.get("task", 0), task,
                               count_done=kind == "task-finished",
                               at=t, status=kind.removeprefix("task-"))
            task.status = kind.removeprefix("task-")
            task.finished_at = t
            task.error = record.get("error", "")
        elif kind == "alloc-queue-created":
            qid = record.get("queue_id", 0)
            self.queues[qid] = QueueState(
                queue_id=qid, manager=record.get("manager", "")
            )
        elif kind == "alloc-queue-removed":
            self.queues.pop(record.get("queue_id", 0), None)
        elif kind == "alloc-queue-paused":
            q = self.queues.get(record.get("queue_id", 0))
            if q is not None:
                q.state = "paused"
        elif kind == "alloc-queued":
            q = self.queues.setdefault(
                record.get("queue_id", 0),
                QueueState(queue_id=record.get("queue_id", 0)),
            )
            aid = record.get("alloc", "")
            q.allocations[aid] = AllocationView(
                allocation_id=aid, queued_at=t,
                worker_count=int(record.get("worker_count", 1)),
            )
        elif kind in ("alloc-started", "alloc-finished", "alloc-failed"):
            q = self.queues.get(record.get("queue_id", 0))
            if q is not None:
                a = q.allocations.setdefault(
                    record.get("alloc", ""),
                    AllocationView(allocation_id=record.get("alloc", "")),
                )
                status = kind.removeprefix("alloc-")
                a.status = "running" if status == "started" else status
                if status == "started":
                    a.started_at = t
                else:
                    a.ended_at = t

    def _release_task(self, job_id, task_id, task: TaskView,
                      count_done: bool = False, at: float = 0.0,
                      status: str = "finished") -> None:
        for wid in task.workers:
            w = self.workers.get(wid)
            if w is not None:
                w.running.discard((job_id, task_id))
                if count_done:
                    w.tasks_done += 1
                for span in reversed(w.task_history):
                    if (span.job_id, span.task_id) == (job_id, task_id) \
                            and not span.ended_at:
                        span.ended_at = at or self.last_time
                        span.status = status
                        break

    def _mark_worker_count(self, t: float) -> None:
        n = sum(1 for w in self.workers.values() if w.is_connected)
        self.worker_series.append((t, n))

    def job_running_series(self, job_id: int) -> list[tuple[float, float]]:
        """(t, running tasks) series for ONE job, from the per-worker span
        history — restart-aware (every instance's span counts), so the
        jobs screen agrees with the worker-detail timelines."""
        return fold_spans(
            span
            for w in self.workers.values()
            for span in w.task_history
            if span.job_id == job_id
        )

    # ------------------------------------------------------------------
    def at(self, t: float) -> "DashboardData":
        """State as of time t (inclusive) — rebuilt by prefix replay, the
        time-travel primitive of replay mode."""
        out = DashboardData()
        for record in self.events:
            if float(record.get("time", 0.0)) <= t:
                out.add_event(record)
        return out

    def time_span(self) -> tuple[float, float]:
        if not self.events:
            return (0.0, 0.0)
        return (
            float(self.events[0].get("time", 0.0)),
            float(self.events[-1].get("time", 0.0)),
        )


def seed_from_server(data: DashboardData, session) -> None:
    """Seed live-mode state from a snapshot of the running server.

    A server without a journal has no event history, so a dashboard that
    connects late would render an empty cluster; the snapshot (worker list,
    job details, allocation queues) establishes current state and the live
    stream keeps it moving (the reference seeds the same way through its
    initial overview fetch, dashboard/data/fetch.rs)."""
    now = clock.now()
    for w in session.request({"op": "worker_list"})["workers"]:
        ws = WorkerState(
            worker_id=w["id"],
            hostname=w.get("hostname", ""),
            group=w.get("group", "default"),
            # worker_list carries raw fraction amounts; the
            # worker-connected event carries whole units — normalize so
            # config grouping agrees across both paths
            resources={
                k: v / 10_000 for k, v in (w.get("resources") or {}).items()
            },
            alloc_id=w.get("alloc_id", ""),
            connected_at=now,
        )
        overview = w.get("overview") or {}
        ws.last_hw = overview.get("hw", {}) or {}
        data.workers[w["id"]] = ws
    data.worker_series.append((now, len(data.workers)))

    jobs = session.request({"op": "job_list"})["jobs"]
    recent = sorted(jobs, key=lambda j: -j["id"])[:100]
    if recent:
        details = session.request(
            {"op": "job_info", "job_ids": [j["id"] for j in recent]}
        )["jobs"]
        for detail in details:
            job = JobState(
                job_id=detail["id"],
                name=detail.get("name", "job"),
                n_tasks=detail.get("n_tasks", 0),
                submitted_at=detail.get("submitted_at", 0.0),
                is_open=detail.get("is_open", False),
                paused=detail.get("paused", False),
                pending_reasons=dict(detail.get("pending_reasons") or {}),
            )
            status = detail.get("status", "")
            if status in ("finished", "failed", "canceled"):
                job.final_status = status
            for t in detail.get("tasks", []):
                tv = TaskView(
                    status=t.get("status", "waiting"),
                    started_at=t.get("started_at") or 0.0,
                    finished_at=t.get("finished_at") or 0.0,
                    workers=tuple(t.get("workers") or ()),
                    error=t.get("error", "") or "",
                )
                job.tasks[t["id"]] = tv
                if tv.status == "running":
                    for wid in tv.workers:
                        ws = data.workers.get(wid)
                        if ws is not None:
                            ws.running.add((job.job_id, t["id"]))
            data.jobs[job.job_id] = job

    try:
        alloc = session.request({"op": "alloc_list"})
    except Exception:  # noqa: BLE001 - autoalloc may be disabled
        alloc = {}
    for q in alloc.get("queues", []):
        qs = QueueState(
            queue_id=q.get("id", 0),
            manager=(q.get("params") or {}).get("manager", ""),
            state=q.get("state", "active"),
        )
        for a in q.get("allocations", []):
            qs.allocations[a["id"]] = AllocationView(
                allocation_id=a["id"],
                status=a.get("status", "queued"),
                queued_at=a.get("queued_at", 0.0),
                started_at=a.get("started_at", 0.0),
                ended_at=a.get("ended_at", 0.0),
                worker_count=int(a.get("worker_count", 1)),
            )
        data.queues[qs.queue_id] = qs
    data.last_time = now


def load_journal(path) -> DashboardData:
    """Build DashboardData from a journal file (offline replay mode)."""
    from hyperqueue_tpu_torch.events.journal import Journal

    data = DashboardData()
    for record in Journal.read_all(path):
        data.add_event(record)
    return data
