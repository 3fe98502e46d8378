"""Carry scheduler state into the port from plain data.

The scheduler has no weights: its state is the tick state — the resource
and request-class interning maps, the ready-task queues and the worker rows.
`tick_state_from_plain` builds the port's objects from plain Python and
numpy data, so that any producer (another implementation of the scheduler,
a snapshot, a generator) can hand its state over and both sides compute from
identical state. The fused tick's extra state crosses the same way: a group
name per worker (`group_ids` turns the rows' groups into the tick's group
index map) and the scheduling policy's tables (`policy_table_from_plain`).
`core_from_plain` builds the server's view of the same state instead: a
`server/core.Core` with `Worker`s, which the incremental tick cache reads.
`lazy_core_from_plain` builds that Core as the server holds an array
submit: the ready tasks as lazy array chunks (server/lazy.py) of their jobs
in a `server/jobs.JobManager`, materialized only when the reactor takes
them.
"""

from __future__ import annotations

import numpy as np

from hyperqueue_tpu_torch.ids import IdCounter, task_id_job, task_id_task
from hyperqueue_tpu_torch.resources.descriptor import (
    ResourceDescriptor,
    ResourceDescriptorItem,
)
from hyperqueue_tpu_torch.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu_torch.resources.request import (
    AllocationPolicy,
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu_torch.scheduler.policy import PolicyTable
from hyperqueue_tpu_torch.scheduler.queues import TaskQueues
from hyperqueue_tpu_torch.scheduler.tick import WorkerRow
from hyperqueue_tpu_torch.server.worker import (
    Worker,
    WorkerConfiguration,
    cpu_floor,
)
from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils.constants import INF_TIME


def tick_state_from_plain(resources, classes, tasks, workers):
    """Build (resource_map, rq_map, queues, worker_rows) from plain data.

    resources: resource names in resource-id order ("cpus" first).
    classes: per request class in rq-id order, a list of variants, each a
      dict {"entries": [(resource_name, amount, policy_name), ...],
      "n_nodes": int, "min_time_secs": float, "weight": float} (the last
      three optional).
    tasks: (task_id, class_index, (user_priority, scheduler_priority))
      rows in queue (FIFO) order.
    workers: (worker_id, free, nt_free, lifetime_secs, total[, group[,
      min_utilization]]) rows; free and total are per-resource amounts in
      resource-id order, total may be None; group is the worker group's
      name ("default" when absent); min_utilization (0 when absent) gives
      the row's cpu_floor, as server/worker.Worker.cpu_floor computes it
      from the worker's cpus (resource 0) and its free cpus.

    Raises ValueError where the data does not give the ids it promises
    (a resource name out of place, two classes that intern to one rq-id).
    """
    resource_map = ResourceIdMap()
    for rid, name in enumerate(resources):
        if resource_map.get_or_create(name) != rid:
            raise ValueError(f"resource {name!r} is not at id {rid}")

    rq_map = ResourceRqMap()
    for index, variants in enumerate(classes):
        requests = []
        for variant in variants:
            entries = []
            for name, amount, policy in variant["entries"]:
                rid = resource_map.get(name)
                if rid is None:
                    raise ValueError(f"class {index} names unknown {name!r}")
                entries.append(ResourceRequestEntry(
                    resource_id=rid, amount=int(amount),
                    policy=AllocationPolicy.parse(policy),
                ))
            requests.append(ResourceRequest(
                entries=tuple(entries),
                n_nodes=int(variant.get("n_nodes", 0)),
                min_time_secs=float(variant.get("min_time_secs", 0.0)),
                weight=float(variant.get("weight", 1.0)),
            ))
        rqv = ResourceRequestVariants(variants=tuple(requests))
        if rq_map.get_or_create(rqv) != index:
            raise ValueError(f"class {index} duplicates an earlier class")

    queues = TaskQueues()
    for task_id, class_index, (user, sched) in tasks:
        queues.add(int(class_index), (int(user), int(sched)), int(task_id))

    rows = []
    for worker_id, free, nt_free, lifetime, total, *rest in workers:
        mu = float(rest[1]) if len(rest) > 1 else 0.0
        all_cpus = (total if total is not None else free)[0] if free else 0
        rows.append(WorkerRow(
            worker_id=int(worker_id),
            free=[int(a) for a in free],
            nt_free=int(nt_free),
            lifetime_secs=int(lifetime),
            total=None if total is None else [int(a) for a in total],
            cpu_floor=cpu_floor(mu, int(all_cpus),
                                int(free[0]) if free else 0),
            group=str(rest[0]) if rest else "default",
        ))
    return resource_map, rq_map, queues, rows


def core_from_plain(resources, classes, tasks, workers):
    """A server Core from the same plain data as tick_state_from_plain.

    Each worker row becomes a `Worker` (created through Worker.create from
    a descriptor of one fungible pool per resource the row's total holds,
    the total defaulting to free), with its free amounts and task slots
    set from the row and its group from the row's sixth field. A finite
    lifetime becomes the worker's time limit, counted from now, so its
    lifetime_secs() reads one less as soon as a fraction of a second has
    passed. Its min_utilization comes from the row's seventh field. The
    core's id counter continues after the largest worker id.
    """
    from hyperqueue_tpu_torch.server.core import Core

    resource_map, rq_map, queues, rows = tick_state_from_plain(
        resources, classes, tasks, workers
    )
    core = Core(resource_map=resource_map, rq_map=rq_map, queues=queues)
    for row, plain in zip(rows, workers):
        total = row.total if row.total is not None else row.free
        items = tuple(
            ResourceDescriptorItem.sum(resources[rid], int(amount))
            for rid, amount in enumerate(total) if amount > 0
        )
        config = WorkerConfiguration(
            descriptor=ResourceDescriptor(items=items),
            group=row.group,
            time_limit_secs=(0.0 if row.lifetime_secs >= INF_TIME
                             else float(row.lifetime_secs)),
            min_utilization=float(plain[6]) if len(plain) > 6 else 0.0,
        )
        worker = Worker.create(row.worker_id, config, resource_map)
        worker.free = list(row.free)
        worker.nt_free = row.nt_free
        core.workers[row.worker_id] = worker
    if core.workers:
        core.worker_id_counter = IdCounter(start=max(core.workers) + 1)
    core.bump_membership()
    return core


def lazy_core_from_plain(resources, classes, tasks, workers,
                         chunk_size=16384):
    """A server Core whose ready tasks are lazy array chunks, and its jobs.

    Takes the plain data of core_from_plain. The tasks are grouped by
    (job, class, priority), in order of first appearance; each group's
    job-local ids, sorted, are cut into `ids=` chunks of at most
    `chunk_size` and registered with the core's lazy store, as the server
    registers a chunked array submit. Each job is created in a JobManager
    (name f"job{id}"), which the store reaches through `jobs_getter`, so
    that a task taken from a chunk gets its JobTaskInfo. Returns
    (core, jobs).
    """
    from hyperqueue_tpu_torch.server.jobs import JobManager
    from hyperqueue_tpu_torch.server.lazy import ArrayChunk

    core = core_from_plain(resources, classes, [], workers)
    jobs = JobManager()
    core.lazy.jobs_getter = lambda: jobs
    groups: dict[tuple, list[int]] = {}
    for task_id, class_index, (user, sched) in tasks:
        key = (task_id_job(int(task_id)), int(class_index),
               (int(user), int(sched)))
        groups.setdefault(key, []).append(task_id_task(int(task_id)))
    now = clock.now()
    for (job_id, rq_id, priority), ids in groups.items():
        if job_id not in jobs.jobs:
            jobs.create_job(name=f"job{job_id}", submit_dir="",
                            job_id=job_id)
        ids.sort()
        for start in range(0, len(ids), chunk_size):
            core.lazy.register(core, ArrayChunk(
                job_id=job_id, rq_id=rq_id, priority=priority, body={},
                crash_limit=5, ids=ids[start:start + chunk_size],
                submitted_at=now, ready_at=now,
            ))
    return core, jobs


def group_ids(rows) -> np.ndarray:
    """(W,) int32 group index of each worker row, groups numbered in order
    of first appearance (the fused tick's `group_ids=`)."""
    index: dict[str, int] = {}
    return np.fromiter(
        (index.setdefault(row.group, len(index)) for row in rows),
        dtype=np.int32, count=len(rows),
    )


def policy_table_from_plain(data: dict) -> PolicyTable:
    """A PolicyTable from the policy file's tables given as a dict
    ({"affinity": {task_class: {worker_class: weight}}, "fairness": {...},
    "prediction": {...}}), validated as a policy file is."""
    return PolicyTable.from_plain(data)
