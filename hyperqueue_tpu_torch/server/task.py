"""Server-side task state machine.

Reference: crates/tako/src/internal/server/task.rs:22-43 —
Waiting{unfinished_deps} -> Assigned -> Running -> Finished, with instance ids
(restart counter, task.rs) so stale messages from a previous incarnation are
discarded, and crash counters driving the CrashLimit policy
(reference gateway.rs:96-106).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TaskState(enum.Enum):
    WAITING = "waiting"     # has unfinished dependencies
    READY = "ready"         # in a scheduler queue
    ASSIGNED = "assigned"   # compute message sent to a worker
    RUNNING = "running"     # worker reported start
    FINISHED = "finished"
    FAILED = "failed"
    CANCELED = "canceled"


TERMINAL_STATES = (TaskState.FINISHED, TaskState.FAILED, TaskState.CANCELED)

DEFAULT_CRASH_LIMIT = 5  # reference gateway.rs: MaxCrashes(5)

# Restart fencing: boot g (g = prior server-uid records in the journal)
# re-issues every restored non-terminal task at instance >= g * STRIDE.
# A crashed boot can have issued SEVERAL instances of one task whose
# lifecycle events all died in its unflushed journal tail (start,
# worker-lost requeue, restart — each bumps by 1), so fencing by "+1 past
# what the journal saw" can collide with a lost incarnation that still
# runs on a reconnecting worker. The stride clears everything a prior
# boot could have issued as long as no single boot bumps one task more
# than STRIDE times — requeues are bounded by the crash limit, orders of
# magnitude below 2^20.
INSTANCE_GENERATION_STRIDE = 1 << 20


@dataclass(slots=True)
class Task:
    task_id: int
    rq_id: int
    priority: tuple[int, int] = (0, 0)
    body: dict = field(default_factory=dict)
    # array-entry payload (HQ_ENTRY), kept OUT of body so every task of an
    # entries array shares one body object — the wire layer dedups shared
    # bodies per compute message (reference messages/worker.rs:28-54
    # shared/separate data split)
    entry: str | None = None
    deps: tuple[int, ...] = ()
    crash_limit: int = DEFAULT_CRASH_LIMIT

    state: TaskState = TaskState.WAITING
    unfinished_deps: int = 0
    consumers: set[int] = field(default_factory=set)
    instance_id: int = 0
    crash_counter: int = 0
    assigned_worker: int = 0  # 0 = none
    assigned_variant: int = 0
    # assigned beyond current capacity: queued on the worker, resources not
    # yet accounted (reference mapping.rs proactive prefilling)
    prefilled: bool = False
    # a retract request is in flight; don't re-send every tick while the
    # worker's answer travels back
    retract_pending: bool = False
    # multi-node gangs: workers allocated to this task (root first)
    mn_workers: tuple[int, ...] = ()

    # lifecycle timeline (wall-clock, 0 = not reached for the CURRENT
    # incarnation): became ready / assigned to a worker / worker reported
    # running. Feed `hq job timeline` + the task-started event payload;
    # cleared by increment_instance so every restart starts a fresh chain.
    t_ready: float = 0.0
    t_assigned: float = 0.0
    t_started: float = 0.0

    @property
    def is_done(self) -> bool:
        return self.state in TERMINAL_STATES

    def increment_instance(self) -> int:
        self.instance_id += 1
        # a new incarnation gets a fresh lifecycle chain; the timeline of
        # the dead one already lives in the journal/job records
        self.t_ready = 0.0
        self.t_assigned = 0.0
        self.t_started = 0.0
        return self.instance_id

    def fence_instance(self, floor: int) -> int:
        """Advance the instance past every incarnation a crashed boot
        could have issued: always by at least 1, and at least to `floor`
        (the restoring boot's generation base, Core.instance_fence_floor).
        Used wherever a restored task is re-issued instead of reattached —
        a bump-by-one there could collide with an incarnation whose
        lifecycle events died in the crashed boot's unflushed tail."""
        self.instance_id = max(self.instance_id + 1, floor)
        self.t_ready = 0.0
        self.t_assigned = 0.0
        self.t_started = 0.0
        return self.instance_id

    @property
    def never_restart(self) -> bool:
        """crash_limit encodes CRASH_LIMIT_NEVER_RESTART (utils/parsing.py):
        fail whenever the worker is lost while the task runs, even on clean
        stops (reference CrashLimit::NeverRestart, reactor.rs:166 — outside
        the reason.is_failure() gate)."""
        return self.crash_limit < 0

    def crashed(self) -> bool:
        """Register a crash (worker lost while running); True if over limit."""
        self.crash_counter += 1
        return self.crash_limit > 0 and self.crash_counter >= self.crash_limit
