"""Lazy array-task materialization (JASDA-style job atomization).

An array submit arriving through the chunked ingest plane is stored as ONE
`ArrayChunk` record — shared body + a compact id range — instead of a Task
object and a JobTaskInfo per element, so a 1M-task submit costs O(chunks)
allocations at ingest (arxiv 2510.14599 motivates exactly this seam:
split huge arrays into scheduler-sized chunks at ingest, materialize at
dispatch). Per-task records are created only when the scheduler actually
pops ids out of the ready queues (assignment/prefill) or when a per-task
operation (cancel, explain, pause) forces them into existence.

Invariants:

- A lazy task is logically READY from the moment its chunk is registered:
  `t_ready` of the materialized Task is the chunk's registration clock,
  and `JobTaskInfo.submitted_at` is the chunk's OWN submit stamp (not the
  materialization time), so `hq job timeline` phase sums stay exact for
  open jobs that append chunks over time.
- Job-level counters (`Job.n_tasks`) always include unmaterialized ids via
  `Job.n_lazy`, maintained here; terminal-state accounting is untouched
  because a task must materialize before it can start, finish, or cancel.
- Ordering at equal priority is approximate FIFO: materialized tasks
  (requeues, retract returns) drain before lazy segments of the same
  priority level.

Only single-node array chunks without dependencies are registered lazily;
graph submits and multi-node requests keep the eager path.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import deque
from dataclasses import dataclass

from hyperqueue_tpu_torch.ids import TASK_ID_BITS, make_task_id
from hyperqueue_tpu_torch.server.jobs import JobTaskInfo
from hyperqueue_tpu_torch.server.task import Task, TaskState


@dataclass(slots=True)
class ArrayChunk:
    """One ingested array chunk: shared body + compact ids."""

    job_id: int
    rq_id: int
    priority: tuple[int, int]
    body: dict
    crash_limit: int
    # exactly one of id_range (contiguous [start, stop)) or ids (sorted)
    id_range: tuple[int, int] | None = None
    ids: list[int] | None = None
    entries: list | None = None
    submitted_at: float = 0.0  # per-chunk submit stamp (timeline)
    ready_at: float = 0.0      # when the chunk entered the queues
    # submit trace stamps shared by every task of the chunk:
    # {"id", "sent_at", "recv_at", "commit_at"} — replayed into the trace
    # store at materialization so chunked submits still open each task's
    # trace with the client/submit + server/submit spans
    trace: dict | None = None

    @property
    def n(self) -> int:
        if self.id_range is not None:
            return self.id_range[1] - self.id_range[0]
        return len(self.ids)

    def id_at(self, index: int) -> int:
        if self.id_range is not None:
            return self.id_range[0] + index
        return self.ids[index]

    def index_of(self, job_task_id: int) -> int | None:
        if self.id_range is not None:
            lo, hi = self.id_range
            if lo <= job_task_id < hi:
                return job_task_id - lo
            return None
        i = bisect_left(self.ids, job_task_id)
        if i < len(self.ids) and self.ids[i] == job_task_id:
            return i
        return None

    def entry_at(self, index: int):
        if self.entries is None:
            return None
        return self.entries[index]

    def min_id(self) -> int:
        return self.id_range[0] if self.id_range is not None else self.ids[0]

    def max_id(self) -> int:
        if self.id_range is not None:
            return self.id_range[1] - 1
        return self.ids[-1]


class LazySegment:
    """Queue-side view of one chunk: a take cursor plus tombstones for ids
    extracted individually (cancel/explain/single-task materialization)."""

    __slots__ = ("chunk", "pos", "dead", "dead_ahead", "in_queue")

    def __init__(self, chunk: ArrayChunk):
        self.chunk = chunk
        self.pos = 0
        self.dead: set[int] = set()   # tombstoned indexes
        self.dead_ahead = 0           # tombstones at/after pos
        self.in_queue = False

    @property
    def remaining(self) -> int:
        return self.chunk.n - self.pos - self.dead_ahead

    def take_indexes(self, count: int):
        """Advance the cursor past up to `count` live indexes: one range
        where no tombstone lies ahead of it."""
        if not self.dead_ahead:
            start = self.pos
            self.pos = min(start + count, self.chunk.n)
            return range(start, self.pos)
        out = []
        n = self.chunk.n
        while self.pos < n and len(out) < count:
            i = self.pos
            self.pos += 1
            if i in self.dead:
                self.dead.discard(i)
                self.dead_ahead -= 1
                continue
            out.append(i)
        return out

    def tombstone(self, index: int) -> bool:
        if index < self.pos or index in self.dead:
            return False
        self.dead.add(index)
        self.dead_ahead += 1
        return True

    def remaining_ids(self):
        """Iterate the not-yet-materialized ids (detail/timeline synth)."""
        chunk = self.chunk
        for i in range(self.pos, chunk.n):
            if i not in self.dead:
                yield chunk.id_at(i)


class LazyStore:
    """All unmaterialized array tasks, indexed for both the scheduler
    queues ((rq_id, priority) FIFO levels) and job-level operations."""

    def __init__(self):
        # (rq_id, priority) -> FIFO of in-queue segments
        self.levels: dict[tuple[int, tuple], deque[LazySegment]] = {}
        # rq_id -> live in-queue task count (cheap hybrid-view predicate)
        self.rq_ready: dict[int, int] = {}
        # rq_id -> {priority: in-queue task count}: batch sizing must be
        # O(levels), never O(segments) — at thousands of streamed chunks
        # a per-tick segment walk was measurable in the tick p95
        self.level_ready: dict[int, dict[tuple, int]] = {}
        self.per_job: dict[int, list[LazySegment]] = {}
        self.ready = 0           # unmaterialized ids currently in queues
        self.held = 0            # unmaterialized ids held by job pause
        self.materialized_total = 0
        self.chunks_total = 0
        # bound by Server/bootstrap: () -> JobManager (job-side accounting)
        self.jobs_getter = None

    # --- registration ---------------------------------------------------
    def register(self, core, chunk: ArrayChunk, held: bool = False) -> None:
        seg = LazySegment(chunk)
        self.per_job.setdefault(chunk.job_id, []).append(seg)
        self.chunks_total += 1
        job = self._job(chunk.job_id)
        if job is not None:
            job.n_lazy += chunk.n
        if held:
            self.held += chunk.n
        else:
            self._enqueue(core, seg)

    def _adjust(self, rq_id: int, priority: tuple, delta: int) -> None:
        """Single point of truth for the three in-queue count indexes."""
        self.ready += delta
        self.rq_ready[rq_id] = self.rq_ready.get(rq_id, 0) + delta
        by_p = self.level_ready.setdefault(rq_id, {})
        n = by_p.get(priority, 0) + delta
        if n > 0:
            by_p[priority] = n
        else:
            by_p.pop(priority, None)

    def _enqueue(self, core, seg: LazySegment) -> None:
        key = (seg.chunk.rq_id, seg.chunk.priority)
        self.levels.setdefault(key, deque()).append(seg)
        seg.in_queue = True
        self._adjust(seg.chunk.rq_id, seg.chunk.priority, seg.remaining)
        core.queues.version += 1

    def _job(self, job_id: int):
        if self.jobs_getter is None:
            return None
        return self.jobs_getter().jobs.get(job_id)

    def _retire(self, seg: LazySegment) -> None:
        """Drop a fully-drained segment from every index. Without this,
        per_job would retain every chunk's body + entries list for the
        server's lifetime (and _check_array_ids would keep rejecting
        appends overlapping long-finished chunks)."""
        job_list = self.per_job.get(seg.chunk.job_id)
        if job_list is not None:
            try:
                job_list.remove(seg)
            except ValueError:
                pass
            if not job_list:
                del self.per_job[seg.chunk.job_id]
        if seg.in_queue:
            key = (seg.chunk.rq_id, seg.chunk.priority)
            segs = self.levels.get(key)
            if segs is not None:
                try:
                    segs.remove(seg)
                except ValueError:
                    pass
                if not segs:
                    self.levels.pop(key, None)
            seg.in_queue = False

    def forget_job(self, job_id: int) -> None:
        """Drop every segment of a forgotten job. Terminated jobs have
        none live, but a MIGRATED-OUT job leaves its sealed segments here
        in chunk form — release their in-queue/held counts too, or the
        unmaterialized gauge stays inflated for the server's lifetime."""
        for seg in self.per_job.get(job_id, ()):
            if not seg.remaining:
                continue
            if seg.in_queue:
                self._adjust(seg.chunk.rq_id, seg.chunk.priority,
                             -seg.remaining)
                key = (seg.chunk.rq_id, seg.chunk.priority)
                segs = self.levels.get(key)
                if segs is not None:
                    try:
                        segs.remove(seg)
                    except ValueError:
                        pass
                    if not segs:
                        self.levels.pop(key, None)
                seg.in_queue = False
            else:
                self.held -= seg.remaining
        self.per_job.pop(job_id, None)

    # --- queue-side interface (consumed by scheduler/queues.py) ---------
    def ready_count_rq(self, rq_id: int) -> int:
        return self.rq_ready.get(rq_id, 0)

    def ready_rqs(self):
        return [rq for rq, n in self.rq_ready.items() if n > 0]

    def level_sizes(self, rq_id: int) -> dict[tuple, int]:
        return dict(self.level_ready.get(rq_id) or ())

    def take(self, core, rq_id: int, priority: tuple, count: int) -> list[int]:
        """Pop up to `count` ids at this level, MATERIALIZING each into a
        core Task + JobTaskInfo. This is the scheduler's dispatch-time
        entry point — the one place lazy tasks become real in bulk, a
        segment at a time."""
        segs = self.levels.get((rq_id, priority))
        if not segs:
            return []
        jobs_mgr = self.jobs_getter() if self.jobs_getter else None
        out: list[int] = []
        while segs and len(out) < count:
            seg = segs[0]
            taken = seg.take_indexes(count - len(out))
            out.extend(self._make(core, jobs_mgr, seg.chunk, taken))
            if seg.remaining == 0:
                segs.popleft()
                seg.in_queue = False
                self._retire(seg)
            if not taken and segs and segs[0] is seg:
                break  # defensive: no progress
        if not segs:
            self.levels.pop((rq_id, priority), None)
        if out:
            self._adjust(rq_id, priority, -len(out))
        return out

    # --- materialization -------------------------------------------------
    def _materialize(self, core, jobs_mgr, chunk: ArrayChunk,
                     index: int) -> int:
        return self._make(core, jobs_mgr, chunk, (index,))[0]

    def _make(self, core, jobs_mgr, chunk: ArrayChunk, indexes) -> list[int]:
        """Materialize the tasks at `indexes` (ascending) of one chunk: a
        READY Task and a JobTaskInfo each. The job, the id base and the
        chunk's fields are read once, and the id range checked at both
        ends; a chunk with trace stamps then replays its submit spans."""
        if not indexes:
            return []
        job_id = chunk.job_id
        run = isinstance(indexes, range)
        if chunk.ids is not None:
            jids = (chunk.ids[indexes.start:indexes.stop] if run
                    else [chunk.ids[i] for i in indexes])
        else:
            lo = chunk.id_range[0]
            jids = (range(lo + indexes.start, lo + indexes.stop) if run
                    else [lo + i for i in indexes])
        make_task_id(job_id, jids[0])   # the range check, at both ends of
        make_task_id(job_id, jids[-1])  # the sorted ids
        base = job_id << TASK_ID_BITS
        rq_id, priority, body = chunk.rq_id, chunk.priority, chunk.body
        entries, crash_limit = chunk.entries, chunk.crash_limit
        ready, ready_at = TaskState.READY, chunk.ready_at
        submitted_at = chunk.submitted_at
        job = jobs_mgr.jobs.get(job_id) if jobs_mgr is not None else None
        job_tasks = job.tasks if job is not None else None
        tasks = core.tasks
        out: list[int] = []
        for index, jid in zip(indexes, jids):
            task_id = base | jid
            # Task's fields in order, up to t_ready: task_id, rq_id,
            # priority, body, entry, deps, crash_limit, state,
            # unfinished_deps, consumers, instance_id, crash_counter,
            # assigned_worker, assigned_variant, prefilled,
            # retract_pending, mn_workers, t_ready
            tasks[task_id] = Task(
                task_id, rq_id, priority, body,
                None if entries is None else entries[index], (),
                crash_limit, ready, 0, set(), 0, 0, 0, 0, False, False,
                (), ready_at,
            )
            if job_tasks is not None:
                job_tasks[jid] = JobTaskInfo(
                    jid, "waiting", "", [], submitted_at
                )
            out.append(task_id)
        if job is not None:
            job.n_lazy -= len(out)
        traces = core.traces
        if traces.enabled and chunk.trace and chunk.trace.get("id"):
            for task_id in out:
                _replay_submit(traces, chunk.trace, task_id)
        self.materialized_total += len(out)
        return out

    # --- job-level operations --------------------------------------------
    def segments_of(self, job_id: int):
        return [
            s for s in self.per_job.get(job_id, ()) if s.remaining > 0
        ]

    def job_unmaterialized(self, job_id: int) -> int:
        return sum(s.remaining for s in self.per_job.get(job_id, ()))

    def owns(self, job_id: int, job_task_id: int) -> bool:
        for seg in self.per_job.get(job_id, ()):
            index = seg.chunk.index_of(job_task_id)
            if index is None:
                continue
            if index >= seg.pos and index not in seg.dead:
                return True
        return False

    def drop_id(self, core, job_id: int, job_task_id: int) -> bool:
        """Tombstone one lazy id WITHOUT materializing it (restore uses
        this to carve journal-tail-touched ids out of a snapshot chunk
        before handing them to the per-task restore path)."""
        for seg in self.per_job.get(job_id, ()):
            index = seg.chunk.index_of(job_task_id)
            if index is None:
                continue
            if not seg.tombstone(index):
                continue
            if seg.in_queue:
                self._adjust(seg.chunk.rq_id, seg.chunk.priority, -1)
                core.queues.version += 1
            else:
                self.held -= 1
            job = self._job(job_id)
            if job is not None:
                job.n_lazy -= 1
            if seg.remaining == 0:
                self._retire(seg)
            return True
        return False

    def extract(self, core, job_id: int, job_task_id: int):
        """Materialize ONE lazy task out of its segment (per-task ops:
        cancel of a single id, `hq task explain`). Returns the Task (state
        READY, NOT enqueued — the caller decides queue membership) or None
        when the id is not lazily held."""
        for seg in self.per_job.get(job_id, ()):
            index = seg.chunk.index_of(job_task_id)
            if index is None:
                continue
            if not seg.tombstone(index):
                continue
            if seg.in_queue:
                self._adjust(seg.chunk.rq_id, seg.chunk.priority, -1)
                core.queues.version += 1
            else:
                self.held -= 1
            jobs_mgr = self.jobs_getter() if self.jobs_getter else None
            task_id = self._materialize(core, jobs_mgr, seg.chunk, index)
            if seg.remaining == 0:
                self._retire(seg)
            return core.tasks[task_id]
        return None

    def materialize_job(self, core, job_id: int) -> list:
        """Force every remaining lazy task of a job into existence (rare
        whole-job ops: cancel, forced drain). In-queue segments turn into
        READY tasks in the base queues — exactly what an eager submit
        would have produced; held segments (job paused) land in the pause
        ledger (core.paused_held) like any other held READY task."""
        segs = self.per_job.pop(job_id, [])
        jobs_mgr = self.jobs_getter() if self.jobs_getter else None
        out: list = []
        for seg in segs:
            was_queued = seg.in_queue
            n = seg.remaining
            if n == 0:
                continue
            if was_queued:
                self._dequeue(core, seg)
            else:
                self.held -= n
            for index in seg.take_indexes(n):
                task_id = self._materialize(
                    core, jobs_mgr, seg.chunk, index
                )
                task = core.tasks[task_id]
                if was_queued:
                    core.queues.add(task.rq_id, task.priority, task_id)
                else:
                    core.paused_held.setdefault(job_id, set()).add(task_id)
                out.append(task)
        return out

    def _dequeue(self, core, seg: LazySegment) -> None:
        key = (seg.chunk.rq_id, seg.chunk.priority)
        segs = self.levels.get(key)
        if segs is not None:
            try:
                segs.remove(seg)
            except ValueError:
                pass
            if not segs:
                self.levels.pop(key, None)
        seg.in_queue = False
        self._adjust(seg.chunk.rq_id, seg.chunk.priority, -seg.remaining)
        core.queues.version += 1

    def detach_job(self, core, job_id: int) -> int:
        """Pull a job's in-queue segments out of the scheduler levels
        (job pause); they stay owned by per_job, flagged held."""
        moved = 0
        for seg in self.per_job.get(job_id, ()):
            if seg.in_queue and seg.remaining:
                n = seg.remaining
                self._dequeue(core, seg)
                self.held += n
                moved += n
        return moved

    def requeue_job(self, core, job_id: int) -> int:
        """Re-enqueue a job's held segments (job resume)."""
        moved = 0
        for seg in self.per_job.get(job_id, ()):
            if not seg.in_queue and seg.remaining:
                n = seg.remaining
                self.held -= n
                self._enqueue(core, seg)
                moved += n
        return moved

    def stats(self) -> dict:
        return {
            "unmaterialized": self.ready + self.held,
            "ready": self.ready,
            "held": self.held,
            "chunks": self.chunks_total,
            "materialized_total": self.materialized_total,
        }


def _replay_submit(traces, trace: dict, task_id: int) -> None:
    """Open a lazy task's trace with the submit spans its chunk stamped."""
    traces.begin(task_id, trace["id"])
    parent = None
    sent = float(trace.get("sent_at") or 0.0)
    recv = float(trace.get("recv_at") or 0.0)
    commit = float(trace.get("commit_at") or 0.0) or recv
    if sent and recv:
        parent = traces.span(task_id, "client/submit", sent, recv, "client")
    if recv:
        traces.span(task_id, "server/submit", recv, commit, "server",
                    parent=parent)
