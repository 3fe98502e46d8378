"""Jobs layer: user-facing grouping of tasks.

Reference: crates/hyperqueue/src/server/{state.rs,job.rs} — a Job owns a set
of tasks (array or graph), per-task states with counters, a `max_fails` abort
policy, and open jobs that accept more tasks after submission. Job ids are the
upper half of each packed task id (ids.py), mirroring how the reference leaks
job ids into tako task ids (reference internal/common/ids.rs:5-60).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperqueue_tpu_torch.ids import IdCounter, make_task_id, task_id_task
from hyperqueue_tpu_torch.server.task import TaskState
from hyperqueue_tpu_torch.utils import clock

# client-visible task status strings
_STATUS = {
    TaskState.WAITING: "waiting",
    TaskState.READY: "waiting",
    TaskState.ASSIGNED: "waiting",
    TaskState.RUNNING: "running",
    TaskState.FINISHED: "finished",
    TaskState.FAILED: "failed",
    TaskState.CANCELED: "canceled",
}


@dataclass
class JobTaskInfo:
    job_task_id: int
    status: str = "waiting"
    error: str = ""
    worker_ids: list[int] = field(default_factory=list)
    # lifecycle timeline endpoints (submitted_at defaults to creation time;
    # restore overwrites it with the journal's job-submitted time so a
    # restored timeline keeps the original clock)
    submitted_at: float = field(default_factory=clock.now)
    started_at: float = 0.0
    finished_at: float = 0.0


@dataclass
class Job:
    job_id: int
    name: str
    submit_dir: str
    max_fails: int | None = None
    is_open: bool = False
    cancel_reason: str = ""  # why tasks were canceled (user / max_fails)
    submitted_at: float = field(default_factory=clock.now)
    # one record per submit: {"n_tasks": N, "request": wire request dict}
    # echoed in job detail (reference JobDetail.submit_descs)
    submits: list = field(default_factory=list)
    tasks: dict[int, JobTaskInfo] = field(default_factory=dict)  # job_task_id ->
    # unmaterialized lazy array tasks owned by this job (server/lazy.py
    # maintains the count; the task records themselves live in the core's
    # LazyStore until the scheduler materializes them)
    n_lazy: int = 0
    # chunked-submit streams (ingest plane): uid -> {"applied": set of
    # chunk indexes already ingested (exactly-once ack replay), "sealed"}.
    # While any stream is unsealed the job cannot terminate — a fast
    # worker finishing chunk k must not fire job-completed while chunk
    # k+1 is still on the wire.
    streams: dict = field(default_factory=dict)
    open_streams: int = 0
    counters: dict[str, int] = field(
        default_factory=lambda: {
            "running": 0,
            "finished": 0,
            "failed": 0,
            "canceled": 0,
        }
    )

    def n_tasks(self) -> int:
        return len(self.tasks) + self.n_lazy

    def n_waiting(self) -> int:
        return self.n_tasks() - sum(self.counters.values()) + self.counters["running"]

    def all_tasks_done(self) -> bool:
        """Every task submitted so far is terminal (used by `job wait`; an
        open job can be waited on without being closed)."""
        done = (
            self.counters["finished"]
            + self.counters["failed"]
            + self.counters["canceled"]
        )
        return done == self.n_tasks()

    def seal_streams(self) -> list:
        """Force-seal every chunk stream (job close / explicit cancel):
        a client that died mid-stream must not leave the job unable to
        terminate forever. Returns the uids that were still open, so the
        caller can journal the forced seal (restore must not resurrect
        the stream as open)."""
        sealed = [
            uid for uid, s in self.streams.items() if not s["sealed"]
        ]
        for stream in self.streams.values():
            stream["sealed"] = True
        self.open_streams = 0
        return sealed

    def is_terminated(self) -> bool:
        if self.is_open or self.open_streams > 0:
            return False
        done = (
            self.counters["finished"]
            + self.counters["failed"]
            + self.counters["canceled"]
        )
        return done == self.n_tasks()

    def status(self) -> str:
        # reference client/status.rs:18 job_status precedence: running >
        # waiting > failed > canceled > opened/finished (failures dominate
        # once nothing is left to run: a max-fails abort cancels the
        # remainder but the job's outcome is "failed")
        c = self.counters
        waiting = (self.n_tasks() - c["finished"] - c["failed"]
                   - c["canceled"] - c["running"])
        if c["running"]:
            return "running"
        if waiting > 0:
            return "waiting"
        if c["failed"]:
            return "failed"
        if c["canceled"]:
            return "canceled"
        return "opened" if self.is_open else "finished"

    def to_info(self) -> dict:
        return {
            "id": self.job_id,
            "name": self.name,
            "status": self.status(),
            "n_tasks": self.n_tasks(),
            "counters": dict(self.counters),
            "is_open": self.is_open,
            "submit_dir": self.submit_dir,
            "submitted_at": self.submitted_at,
            "cancel_reason": self.cancel_reason,
        }

    def to_detail(self) -> dict:
        info = self.to_info()
        info["submits"] = self.submits
        info["tasks"] = [
            {
                "id": t.job_task_id,
                "status": t.status,
                "error": t.error,
                "workers": t.worker_ids,
                "started_at": t.started_at,
                "finished_at": t.finished_at,
            }
            for t in sorted(self.tasks.values(), key=lambda t: t.job_task_id)
        ]
        return info


class JobManager:
    """Owns all jobs; receives task events from the tako-equivalent core via
    the EventSink bridge (server/bootstrap.py wires it)."""

    def __init__(self):
        self.jobs: dict[int, Job] = {}
        self.job_id_counter = IdCounter()

    def create_job(
        self,
        name: str,
        submit_dir: str,
        max_fails: int | None = None,
        is_open: bool = False,
        job_id: int | None = None,
    ) -> Job:
        if job_id is None:
            job_id = self.job_id_counter.next()
        else:
            self.job_id_counter.ensure_above(job_id)
        job = Job(
            job_id=job_id,
            name=name,
            submit_dir=submit_dir,
            max_fails=max_fails,
            is_open=is_open,
        )
        self.jobs[job_id] = job
        return job

    def attach_task(self, job: Job, job_task_id: int) -> int:
        job.tasks[job_task_id] = JobTaskInfo(job_task_id=job_task_id)
        return make_task_id(job.job_id, job_task_id)

    # --- event handlers (called from the EventSink bridge) ---------------
    def _task(self, job_id: int, task_id: int) -> tuple[Job, JobTaskInfo] | None:
        job = self.jobs.get(job_id)
        if job is None:
            return None
        info = job.tasks.get(task_id_task(task_id))
        if info is None:
            return None
        return job, info

    def on_task_started(self, job_id: int, task_id: int,
                        worker_ids: list[int],
                        started_at: float | None = None):
        found = self._task(job_id, task_id)
        if not found:
            return
        job, info = found
        if info.status != "running":
            job.counters["running"] += 1
        info.status = "running"
        info.worker_ids = worker_ids
        # started_at comes from the core task's t_started when available: a
        # reattach after a server restart re-announces a task that never
        # stopped running, and the timeline must keep the ORIGINAL start
        # instead of restarting the clock (no duplicate spawn phase)
        info.started_at = started_at or clock.now()

    def on_task_restarted(self, job_id: int, task_id: int):
        found = self._task(job_id, task_id)
        if not found:
            return
        job, info = found
        if info.status == "running":
            job.counters["running"] -= 1
        info.status = "waiting"
        info.worker_ids = []

    def _finish(self, job_id: int, task_id: int, status: str, error: str = ""):
        found = self._task(job_id, task_id)
        if not found:
            return None
        job, info = found
        if info.status == "running":
            job.counters["running"] -= 1
        if info.status in ("finished", "failed", "canceled"):
            return None  # already terminal
        info.status = status
        info.error = error
        info.finished_at = clock.now()
        job.counters[status] += 1
        return job

    def on_task_finished(self, job_id: int, task_id: int):
        return self._finish(job_id, task_id, "finished")

    def on_task_failed(self, job_id: int, task_id: int, message: str):
        """Returns task ids to cancel if max_fails is exceeded."""
        job = self._finish(job_id, task_id, "failed", message)
        if job is None:
            return []
        if job.max_fails is not None and job.counters["failed"] > job.max_fails:
            job.cancel_reason = (
                f"max_fails={job.max_fails} exceeded "
                f"({job.counters['failed']} tasks failed)"
            )
            return [
                make_task_id(job.job_id, t.job_task_id)
                for t in job.tasks.values()
                if t.status in ("waiting", "running")
            ]
        return []

    def on_task_canceled(self, job_id: int, task_id: int):
        self._finish(job_id, task_id, "canceled")
