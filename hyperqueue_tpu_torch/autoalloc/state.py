"""Autoalloc state: queues and allocations.

Reference: crates/hyperqueue/src/server/autoalloc/state.rs:22-399 —
AllocationQueue descriptors and the Allocation lifecycle
Queued -> Running -> Finished/Failed, plus the rate limiter with exponential
backoff that pauses repeatedly-failing queues (process.rs:881,1209).

Beyond the reference: a crash-loop quarantine (a queue whose workers keep
dying right after registration is benched with geometric backoff — the
containment sibling of the submit-failure pause), an explicit `cancelled`
terminal status (drain scale-down, zombie reap, queue removal), and full
wire round-trips (`from_wire`) so the allocation table can ride the journal
and snapshots like every other durable table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from hyperqueue_tpu_torch.ids import IdCounter
from hyperqueue_tpu_torch.utils import clock

MAX_SUBMIT_FAILS_BEFORE_PAUSE = 3
BACKOFF_BASE_SECS = 2.0
BACKOFF_MAX_SECS = 300.0

# crash-loop quarantine policy (env-overridable so chaos tests can run the
# whole loop in seconds): a worker death within WINDOW seconds of its
# registration is a "fast" death; K consecutive fast deaths quarantine the
# queue for BASE * 2^(n_quarantines-1) seconds, capped at MAX.
CRASH_LOOP_K = int(os.environ.get("HQ_AUTOALLOC_CRASH_LOOP_K", "3"))
CRASH_LOOP_WINDOW_SECS = float(
    os.environ.get("HQ_AUTOALLOC_CRASH_LOOP_WINDOW", "10.0")
)
QUARANTINE_BASE_SECS = float(
    os.environ.get("HQ_AUTOALLOC_QUARANTINE_BASE", "30.0")
)
QUARANTINE_MAX_SECS = float(
    os.environ.get("HQ_AUTOALLOC_QUARANTINE_MAX", "3600.0")
)


@dataclass
class QueueParams:
    manager: str  # "pbs" | "slurm" | "local"
    backlog: int = 1              # allocations kept in the batch queue
    workers_per_alloc: int = 1
    max_worker_count: int = 0     # 0 = unlimited
    time_limit_secs: float = 3600.0
    name: str = ""
    worker_args: list[str] = field(default_factory=list)  # extra hq args
    additional_args: list[str] = field(default_factory=list)  # qsub/sbatch args
    idle_timeout_secs: float = 300.0
    # reference SharedQueueOpts (commands/autoalloc.rs:96-180)
    worker_start_cmd: str = ""    # shell line run before each worker starts
    worker_stop_cmd: str = ""     # shell line run after the worker terminates
    worker_wrap_cmd: str = ""     # prefix for the `hq worker start` command
    worker_time_limit_secs: float = 0.0  # 0 = allocation time limit
    on_server_lost: str = "finish-running"

    def to_wire(self) -> dict:
        return self.__dict__.copy()

    @classmethod
    def from_wire(cls, data: dict) -> "QueueParams":
        return cls(**{k: v for k, v in data.items() if k in cls.__dataclass_fields__})


@dataclass
class Allocation:
    allocation_id: str          # manager job id (qsub/sbatch output)
    queue_id: int
    worker_count: int
    status: str = "queued"      # queued | running | finished | failed | cancelled
    queued_at: float = field(default_factory=clock.now)
    started_at: float = 0.0
    ended_at: float = 0.0
    connected_workers: set[int] = field(default_factory=set)
    workdir: str = ""           # holds hq-submit.sh + manager stdout/stderr
    # did ANY worker ever register from this allocation?  The zombie
    # reaper only cancels running allocations that never produced one —
    # survives restore so a restart never resets the zombie clock's basis
    ever_bound: bool = False
    # why a cancelled/failed allocation ended ("scale-down", "zombie",
    # "queue-removed", ...)
    reason: str = ""

    @property
    def is_active(self) -> bool:
        return self.status in ("queued", "running")

    def to_wire(self) -> dict:
        return {
            "id": self.allocation_id,
            "queue": self.queue_id,
            "worker_count": self.worker_count,
            "status": self.status,
            "queued_at": self.queued_at,
            "started_at": self.started_at,
            "ended_at": self.ended_at,
            "workers": sorted(self.connected_workers),
            "workdir": self.workdir,
            "ever_bound": self.ever_bound,
            "reason": self.reason,
        }

    @classmethod
    def from_wire(cls, data: dict) -> "Allocation":
        return cls(
            allocation_id=data["id"],
            queue_id=data.get("queue", 0),
            worker_count=data.get("worker_count", 1),
            status=data.get("status", "queued"),
            queued_at=data.get("queued_at", 0.0),
            started_at=data.get("started_at", 0.0),
            ended_at=data.get("ended_at", 0.0),
            connected_workers=set(data.get("workers") or ()),
            workdir=data.get("workdir", ""),
            ever_bound=bool(
                data.get("ever_bound") or data.get("workers")
            ),
            reason=data.get("reason", ""),
        )


@dataclass
class AllocationQueue:
    queue_id: int
    params: QueueParams
    state: str = "running"  # running | paused | quarantined
    allocations: dict[str, Allocation] = field(default_factory=dict)
    consecutive_failures: int = 0
    next_submit_at: float = 0.0
    # crash-loop quarantine
    crash_streak: int = 0       # consecutive fast worker deaths
    quarantines: int = 0        # times quarantined (geometric backoff base)
    quarantine_until: float = 0.0  # wall clock; 0 = not quarantined

    def active_allocations(self) -> list[Allocation]:
        return [a for a in self.allocations.values() if a.is_active]

    def queued_allocations(self) -> list[Allocation]:
        return [a for a in self.allocations.values() if a.status == "queued"]

    def active_worker_count(self) -> int:
        return sum(a.worker_count for a in self.active_allocations())

    def on_submit_ok(self) -> None:
        self.consecutive_failures = 0
        self.next_submit_at = 0.0

    def on_submit_fail(self) -> bool:
        """Returns True if the queue should be paused."""
        self.consecutive_failures += 1
        backoff = min(
            BACKOFF_BASE_SECS * (2 ** (self.consecutive_failures - 1)),
            BACKOFF_MAX_SECS,
        )
        self.next_submit_at = clock.now() + backoff
        return self.consecutive_failures >= MAX_SUBMIT_FAILS_BEFORE_PAUSE

    # --- crash-loop quarantine ------------------------------------------
    def on_worker_death(self, fast: bool) -> bool:
        """Record one allocation-worker death. `fast` = the worker died
        (uncleanly) within CRASH_LOOP_WINDOW_SECS of registering. Returns
        True when this death tips the queue into quarantine."""
        if not fast:
            self.crash_streak = 0
            return False
        self.crash_streak += 1
        if self.crash_streak < CRASH_LOOP_K or self.state == "quarantined":
            return False
        self.quarantine()
        return True

    def quarantine(self) -> float:
        """Bench the queue with geometric backoff; returns the backoff."""
        self.quarantines += 1
        backoff = min(
            QUARANTINE_BASE_SECS * (2 ** (self.quarantines - 1)),
            QUARANTINE_MAX_SECS,
        )
        self.quarantine_until = clock.now() + backoff
        self.state = "quarantined"
        self.crash_streak = 0
        return backoff

    def maybe_release_quarantine(self) -> bool:
        """Release an expired quarantine (keeps `quarantines` so a repeat
        offender backs off twice as long next time)."""
        if self.state == "quarantined" and clock.now() >= self.quarantine_until:
            self.state = "running"
            self.quarantine_until = 0.0
            return True
        return False

    def clear_quarantine(self) -> None:
        """Operator override (`hq alloc resume`): forget the history."""
        self.quarantines = 0
        self.quarantine_until = 0.0
        self.crash_streak = 0

    def can_submit_now(self) -> bool:
        return self.state == "running" and clock.now() >= self.next_submit_at

    def to_wire(self) -> dict:
        return {
            "id": self.queue_id,
            "state": self.state,
            "params": self.params.to_wire(),
            "allocations": [a.to_wire() for a in self.allocations.values()],
            "consecutive_failures": self.consecutive_failures,
            "quarantines": self.quarantines,
            "quarantine_until": self.quarantine_until,
        }

    @classmethod
    def from_wire(cls, data: dict) -> "AllocationQueue":
        queue = cls(
            queue_id=data["id"],
            params=QueueParams.from_wire(data.get("params") or {}),
            state=data.get("state", "running"),
            consecutive_failures=data.get("consecutive_failures", 0),
            quarantines=data.get("quarantines", 0),
            quarantine_until=data.get("quarantine_until", 0.0),
        )
        for a in data.get("allocations") or ():
            alloc = Allocation.from_wire(a)
            queue.allocations[alloc.allocation_id] = alloc
        return queue


class AutoAllocState:
    def __init__(self):
        self.queues: dict[int, AllocationQueue] = {}
        self.queue_id_counter = IdCounter()

    def add_queue(self, params: QueueParams) -> AllocationQueue:
        queue = AllocationQueue(self.queue_id_counter.next(), params)
        self.queues[queue.queue_id] = queue
        return queue

    def find_allocation(self, allocation_id: str):
        for queue in self.queues.values():
            alloc = queue.allocations.get(allocation_id)
            if alloc is not None:
                return queue, alloc
        return None, None

    # --- durability -----------------------------------------------------
    def capture(self) -> dict:
        """Snapshot-table form: everything `restore` needs to rebuild the
        allocation table exactly (events/snapshot.py carries this)."""
        return {
            "queues": [q.to_wire() for q in self.queues.values()],
            "next_queue_id": self.queue_id_counter.peek(),
        }

    def restore(self, data: dict) -> None:
        for qd in data.get("queues") or ():
            queue = AllocationQueue.from_wire(qd)
            self.queues[queue.queue_id] = queue
        self.queue_id_counter.ensure_above(
            data.get("next_queue_id", 1) - 1
        )
