"""Per-request-class ready-task queues.

Reference: crates/tako/src/internal/scheduler/taskqueue.rs — one priority-
ordered queue per interned rq-id. Tasks enter when all dependencies finish and
leave when assigned to a worker. Priorities are (user_priority, scheduler
priority) pairs compared lexicographically, higher first.

Implementation: per queue, a dict priority -> deque plus a descending-sorted
key list maintained with bisect (distinct priorities are few). Cancelled tasks
are removed lazily via a tombstone set. TaskQueues takes its queues from
utils/native.make_task_queue: the C++ queue (native/hqcore.cpp) where the
native library builds, else this Python one, with the same interface and
semantics.

A class that holds unmaterialized lazy array tasks (server/lazy.py) is
served through LazyQueueView, which merges them into the counts and
materializes them at take time.
"""

from __future__ import annotations

from bisect import insort
from collections import deque

Priority = tuple[int, int]  # (user_priority, scheduler_priority), higher first

# --- scheduler-priority encoding -------------------------------------------
#
# The scheduler component packs (job_id, b-level) into one int so the
# lexicographic (user, sched) comparison yields: older job first (reference
# -job_id FIFO), and WITHIN a job deeper critical path first (b-level
# lookahead). Encoding: sched = -(job_id * BLEVEL_STRIDE + BLEVEL_MAX -
# blevel), so any blevel of job J beats every blevel of job J+1 while higher
# blevel yields a higher (less negative) value within the job. Values with
# magnitude < BLEVEL_STRIDE are raw literals (-job_id) and decode as
# (job=-sched, blevel=0).

BLEVEL_STRIDE = 1 << 20
BLEVEL_MAX = 1 << 16


def encode_sched_priority(job_id: int, blevel: int = 0) -> int:
    if blevel > BLEVEL_MAX:
        blevel = BLEVEL_MAX
    elif blevel < 0:
        blevel = 0
    return -(job_id * BLEVEL_STRIDE + BLEVEL_MAX - blevel)


def decode_sched_job(sched: int) -> int:
    p = -sched
    if p < BLEVEL_STRIDE:
        return p  # raw -job_id literal
    return p // BLEVEL_STRIDE


def decode_sched_blevel(sched: int) -> int:
    p = -sched
    if p < BLEVEL_STRIDE:
        return 0
    return BLEVEL_MAX - (p % BLEVEL_STRIDE)


class TaskQueue:
    __slots__ = ("_levels", "_keys", "_tombstones", "_len")

    def __init__(self):
        self._levels: dict[Priority, deque[int]] = {}
        # _keys holds negated priorities so the list is ascending and
        # iteration order (descending priority) is a simple walk.
        self._keys: list[tuple[int, int]] = []
        self._tombstones: set[int] = set()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def add(self, priority: Priority, task_id: int) -> None:
        level = self._levels.get(priority)
        if level is None:
            level = deque()
            self._levels[priority] = level
            insort(self._keys, (-priority[0], -priority[1]))
        level.append(task_id)
        self._len += 1

    def remove(self, task_id: int) -> None:
        """Lazy removal (cancel / assignment elsewhere)."""
        self._tombstones.add(task_id)
        self._len -= 1

    def _compact_level(self, priority: Priority) -> deque[int]:
        level = self._levels[priority]
        if self._tombstones:
            kept = deque(t for t in level if t not in self._tombstones)
            self._tombstones.difference_update(set(level) - set(kept))
            self._levels[priority] = kept
            level = kept
        return level

    def priority_sizes(self) -> list[tuple[Priority, int]]:
        """Descending-priority [(priority, n_ready)], skipping empty levels."""
        out = []
        for nk in list(self._keys):
            priority = (-nk[0], -nk[1])
            level = self._compact_level(priority)
            if level:
                out.append((priority, len(level)))
            else:
                del self._levels[priority]
                self._keys.remove(nk)
        return out

    def take(self, priority: Priority, count: int) -> list[int]:
        """Pop up to `count` tasks at the given priority level (FIFO)."""
        if priority not in self._levels:
            return []
        level = self._compact_level(priority)
        taken = []
        while level and len(taken) < count:
            taken.append(level.popleft())
        self._len -= len(taken)
        if not level:
            del self._levels[priority]
            self._keys.remove((-priority[0], -priority[1]))
        return taken

    def all_tasks(self) -> list[int]:
        out = []
        for priority in list(self._levels):
            out.extend(self._compact_level(priority))
        return out


class LazyQueueView:
    """One rq class's queue with its lazy array segments merged in.

    Returned by TaskQueues.queue()/items() only while the class has
    unmaterialized lazy tasks (server/lazy.py): counts include them, and
    `take` materializes ids on demand AFTER draining the base queue (so
    requeued/materialized tasks keep approximate FIFO precedence at equal
    priority). The view deliberately does NOT subclass the native queue —
    tick mapping falls back to its per-cell Python take path whenever a
    batch queue is a view, which is where materialization hooks in.

    `all_tasks`/`remove` cover the BASE queue only: whole-job operations
    on lazy tasks go through LazyStore.detach_job/materialize_job first.
    """

    __slots__ = ("_base", "_store", "_core", "_rq_id")

    def __init__(self, base, store, core, rq_id: int):
        self._base = base
        self._store = store
        self._core = core
        self._rq_id = rq_id

    def __len__(self) -> int:
        return len(self._base) + self._store.ready_count_rq(self._rq_id)

    def priority_sizes(self) -> list[tuple[Priority, int]]:
        lazy = self._store.level_sizes(self._rq_id)
        merged: dict[Priority, int] = dict(self._base.priority_sizes())
        for priority, n in lazy.items():
            merged[priority] = merged.get(priority, 0) + n
        return sorted(merged.items(), key=lambda kv: kv[0], reverse=True)

    def take(self, priority: Priority, count: int) -> list[int]:
        got = self._base.take(priority, count)
        if len(got) < count:
            got.extend(
                self._store.take(
                    self._core, self._rq_id, priority, count - len(got)
                )
            )
        return got

    def add(self, priority: Priority, task_id: int) -> None:
        self._base.add(priority, task_id)

    def remove(self, task_id: int) -> None:
        self._base.remove(task_id)

    def all_tasks(self) -> list[int]:
        return self._base.all_tasks()


class TaskQueues:
    """rq-id -> TaskQueue, plus bookkeeping of total ready tasks.

    Queues come from utils.native.make_task_queue: the C++ queue where the
    native library builds (the tick then pops every cell's ids in one
    native call, scheduler/tick._native_map_take), else the Python
    TaskQueue above.

    When a lazy-array store is bound (Core.__post_init__ links
    server/lazy.LazyStore), classes holding unmaterialized array tasks are
    served through LazyQueueView so batch sizing and takes include them;
    classes without lazy tasks keep the bare (native) queue and its
    one-call map-take.
    """

    def __init__(self):
        self._queues: dict[int, TaskQueue] = {}
        # monotone mutation counter over add/remove (takes during mapping
        # show up in total_ready instead): a cheap "could a re-solve see
        # different inputs?" signature with the membership and total_ready
        self.version = 0
        # bound by Core.__post_init__; None for standalone queue users
        self.lazy = None
        self._core = None

    def bind_lazy(self, store, core) -> None:
        self.lazy = store
        self._core = core

    def _base(self, rq_id: int) -> TaskQueue:
        q = self._queues.get(rq_id)
        if q is None:
            # imported here: the client reads this module's priority
            # codecs (scheduler/decision) and must not load numpy, which
            # utils/native needs
            from hyperqueue_tpu_torch.utils.native import make_task_queue

            q = make_task_queue()
            self._queues[rq_id] = q
        return q

    def queue(self, rq_id: int):
        q = self._base(rq_id)
        if self.lazy is not None and self.lazy.ready_count_rq(rq_id) > 0:
            return LazyQueueView(q, self.lazy, self._core, rq_id)
        return q

    def add(self, rq_id: int, priority: Priority, task_id: int) -> None:
        self.version += 1
        self._base(rq_id).add(priority, task_id)

    def remove(self, rq_id: int, task_id: int) -> None:
        q = self._queues.get(rq_id)
        if q is not None:
            self.version += 1
            q.remove(task_id)

    def items(self):
        lazy_rqs = (
            set(self.lazy.ready_rqs()) if self.lazy is not None else set()
        )
        out = [
            (rq_id, self.queue(rq_id) if rq_id in lazy_rqs else q)
            for rq_id, q in self._queues.items()
            if len(q) or rq_id in lazy_rqs
        ]
        for rq_id in lazy_rqs:
            if rq_id not in self._queues:
                out.append((rq_id, self.queue(rq_id)))
        return out

    def total_ready(self) -> int:
        n = sum(len(q) for q in self._queues.values())
        if self.lazy is not None:
            n += self.lazy.ready
        return n

    def sanity_check(self) -> None:
        for q in self._queues.values():
            n = sum(count for _, count in q.priority_sizes())
            if n != len(q):
                raise AssertionError("queue length bookkeeping broken")
