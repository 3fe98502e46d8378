"""Server-side view of a connected worker.

Reference: crates/tako/src/internal/server/worker.rs:30-63 — tracks assigned
tasks, free resources (dense, mirrors the solver's columns), time-limit and
heartbeat state. The free/nt_free fields are exactly the WorkerRow the tick
snapshot copies out (scheduler/tick.py, scheduler/tick_cache.py).

The configuration's wire conversion comes with the worker runtime and
transport.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from hyperqueue_tpu_torch.utils.constants import INF_TIME
from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor
from hyperqueue_tpu_torch.resources.map import ResourceIdMap
from hyperqueue_tpu_torch.resources.worker_resources import WorkerResources
from hyperqueue_tpu_torch.utils import clock


@dataclass
class WorkerConfiguration:
    descriptor: ResourceDescriptor
    hostname: str = "localhost"
    group: str = "default"
    heartbeat_secs: float = 8.0
    time_limit_secs: float = 0.0  # 0 = unlimited
    idle_timeout_secs: float = 0.0
    on_server_lost: str = "stop"  # stop | finish-running | reconnect
    # with on_server_lost=reconnect: give up after this many seconds of
    # failed reconnect attempts (0 = keep retrying forever)
    reconnect_timeout_secs: float = 60.0
    overview_interval_secs: float = 0.0
    # Scheduler only plans tasks here while at least min_utilization x cpus
    # would be busy afterwards — all-or-nothing per tick (reference worker
    # configuration.rs:52, enforced in solver.rs:479-518 add_min_utilization;
    # used by autoalloc so allocation-spawned workers pack-or-idle).
    min_utilization: float = 0.0
    listen_address: str = ""
    # autoalloc linkage: batch manager + allocation id (HQ_ALLOC_ID env)
    manager: str = "none"
    manager_job_id: str = ""
    alloc_id: str = ""
    # warm runner pool width: -1 = auto-size to CPU capacity, 0 = disable
    # (every task spawns through the in-loop asyncio path)
    runner_pool: int = -1
    # bounded coalescing delay of the uplink send drainer: completions
    # within the window share one frame (0 = send-as-ready)
    uplink_flush_secs: float = 0.002
    # federation: home shard this worker was lent FROM after a coordinator
    # redirect (-1 = not a borrowed worker); lets the borrowing shard
    # count its borrowed pool in `hq server stats`
    lent_from: int = -1


def cpu_floor(min_utilization: float, all_cpus: int, free_cpus: int) -> int:
    """floor = ceil(mu x all_cpus) - used_cpus = mu x all - (all - free);
    0 for normal workers or once enough is already running (reference
    solver.rs:493-498)."""
    if min_utilization <= 0.001 or all_cpus <= 0:
        return 0
    floor = math.ceil(min_utilization * all_cpus) - (all_cpus - free_cpus)
    return max(floor, 0)


@dataclass
class Worker:
    worker_id: int
    configuration: WorkerConfiguration
    resources: WorkerResources
    started_at: float = field(default_factory=clock.monotonic)

    # dense scheduling state (the tick snapshot reads these directly)
    free: list[int] = field(default_factory=list)
    nt_free: int = 0
    assigned_tasks: set[int] = field(default_factory=set)
    # tasks pushed beyond current capacity (queue on the worker; no resource
    # accounting until they report running)
    prefilled_tasks: set[int] = field(default_factory=set)
    # multi-node: task id this worker is running a gang for (0 = none)
    mn_task: int = 0
    # multi-node: pending gang task this worker is DRAINING for (0 = none).
    # A reserved worker takes no new sn work (excluded from the dense solve
    # and prefill) so it converges to idle and the gang can eventually claim
    # it even under a continuous stream of small tasks (anti-starvation; the
    # reference achieves this inside one MILP via per-group count variables
    # plus blocking variables, solver.rs:177-209,479-518).
    mn_reserved: int = 0
    last_heartbeat: float = field(default_factory=clock.monotonic)
    last_overview: dict = field(default_factory=dict)
    # gauge/counter samples piggybacked on the worker's last overview
    # message; fanned out (with a `worker` label) by the server's metrics
    # collect hook for the cluster-wide Prometheus view
    last_metrics: list = field(default_factory=list)
    # the worker is going away deliberately (`hq worker stop`, idle/time
    # limit): its tasks requeue WITHOUT a crash-counter increment
    # (reference gateway.rs CrashLimit doc: stops don't count)
    clean_stop: bool = False
    # graceful drain: the worker is masked out of the solve,
    # prefill and gang selection (a membership mask like mn_reserved) so it
    # converges to idle; running tasks finish normally, then the server
    # stops it. Set by `hq worker stop --drain` and the elasticity
    # controller's scale-down path; every flip MUST bump core membership.
    draining: bool = False
    # dirty-tracking epoch for the persistent tick snapshot
    # (scheduler/tick_cache.TickStateCache): every mutation of the dense
    # scheduling state (free/nt_free) MUST bump this, or the cache serves
    # a stale row.  assign/unassign are the only such mutation funnel.
    epoch: int = 0

    @classmethod
    def create(
        cls,
        worker_id: int,
        configuration: WorkerConfiguration,
        resource_map: ResourceIdMap,
    ) -> "Worker":
        resources = WorkerResources.from_descriptor(
            configuration.descriptor, resource_map
        )
        worker = cls(
            worker_id=worker_id,
            configuration=configuration,
            resources=resources,
        )
        worker.free = list(resources.amounts)
        worker.nt_free = resources.task_max_count()
        return worker

    @property
    def group(self) -> str:
        return self.configuration.group

    def lifetime_secs(self) -> int:
        limit = self.configuration.time_limit_secs
        if limit <= 0:
            return int(INF_TIME)
        remaining = limit - (clock.monotonic() - self.started_at)
        return max(int(remaining), 0)

    def cpu_floor(self) -> int:
        """Cpu fractions this tick must still fill for min_utilization
        (the module-level cpu_floor). Resource id 0 is the cpus column by
        convention (reference CPU_RESOURCE_ID)."""
        if not self.free:
            return 0
        return cpu_floor(self.configuration.min_utilization,
                         self.resources.amount(0), self.free[0])

    def assign(self, task_id: int, amounts: list[tuple[int, int]]) -> None:
        """amounts: [(resource_id, fraction_amount)] of the chosen variant."""
        self.assigned_tasks.add(task_id)
        for rid, amount in amounts:
            if rid < len(self.free):
                self.free[rid] -= amount
        self.nt_free -= 1
        self.epoch += 1

    def unassign(self, task_id: int, amounts: list[tuple[int, int]]) -> None:
        self.assigned_tasks.discard(task_id)
        for rid, amount in amounts:
            if rid < len(self.free):
                self.free[rid] += amount
        self.nt_free += 1
        self.epoch += 1

    def is_idle(self) -> bool:
        return (
            not self.assigned_tasks
            and not self.prefilled_tasks
            and self.mn_task == 0
        )
