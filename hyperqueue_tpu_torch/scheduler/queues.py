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

The lazy array store's view (LazyQueueView) comes with the server's data
model.
"""

from __future__ import annotations

from bisect import insort
from collections import deque

from hyperqueue_tpu_torch.utils.native import make_task_queue

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


class TaskQueues:
    """rq-id -> TaskQueue, plus bookkeeping of total ready tasks.

    Queues come from utils.native.make_task_queue: the C++ queue where the
    native library builds (the tick then pops every cell's ids in one
    native call, scheduler/tick._native_map_take), else the Python
    TaskQueue above."""

    def __init__(self):
        self._queues: dict[int, TaskQueue] = {}
        # monotone mutation counter over add/remove (takes during mapping
        # show up in total_ready instead): a cheap "could a re-solve see
        # different inputs?" signature with the membership and total_ready
        self.version = 0

    def queue(self, rq_id: int) -> TaskQueue:
        q = self._queues.get(rq_id)
        if q is None:
            q = make_task_queue()
            self._queues[rq_id] = q
        return q

    def add(self, rq_id: int, priority: Priority, task_id: int) -> None:
        self.version += 1
        self.queue(rq_id).add(priority, task_id)

    def remove(self, rq_id: int, task_id: int) -> None:
        q = self._queues.get(rq_id)
        if q is not None:
            self.version += 1
            q.remove(task_id)

    def items(self) -> list[tuple[int, TaskQueue]]:
        return [(rq_id, q) for rq_id, q in self._queues.items() if len(q)]

    def total_ready(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def sanity_check(self) -> None:
        for q in self._queues.values():
            n = sum(count for _, count in q.priority_sizes())
            if n != len(q):
                raise AssertionError("queue length bookkeeping broken")
