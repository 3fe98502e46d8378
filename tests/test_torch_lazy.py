"""The port's lazy array store, its queue view and the jobs layer against
the JAX package's, on the same chunks.

Each scenario runs once per package (`PKGS`) and returns what it observed;
the two observation lists must be equal (tolerance 0). The scenarios of
tests/test_ingest.py's lazy-store units are among them, with their own
assertions on both sides. `lazy_core_from_plain` is held against a JAX core
built from the same plain data the way the JAX server registers a chunked
array submit (bootstrap's migration import), through reactor ticks of both
packages.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources import descriptor as jax_descriptor
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.server import core as jax_core_mod
from hyperqueue_tpu.server import jobs as jax_jobs
from hyperqueue_tpu.server import lazy as jax_lazy
from hyperqueue_tpu.server import protocol as jax_protocol
from hyperqueue_tpu.server import reactor as jax_reactor
from hyperqueue_tpu.server import worker as jax_worker
from hyperqueue_tpu_torch.convert import lazy_core_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.server import core as port_core_mod
from hyperqueue_tpu_torch.server import jobs as port_jobs
from hyperqueue_tpu_torch.server import lazy as port_lazy
from hyperqueue_tpu_torch.server import protocol as port_protocol
from hyperqueue_tpu_torch.server import reactor as port_reactor
from hyperqueue_tpu_torch.server import worker as port_worker
from test_torch_reactor import flight_view

torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1


def _pkg(core, jobs, lazy, protocol, tick, worker, descriptor, reactor,
         model):
    return types.SimpleNamespace(
        Core=core.Core, JobManager=jobs.JobManager,
        ArrayChunk=lazy.ArrayChunk, rqv_from_wire=protocol.rqv_from_wire,
        create_batches=tick.create_batches, run_tick=tick.run_tick,
        Worker=worker.Worker, WorkerConfiguration=worker.WorkerConfiguration,
        ResourceDescriptor=descriptor.ResourceDescriptor,
        ResourceDescriptorItem=descriptor.ResourceDescriptorItem,
        reactor=reactor, model=model)


PKGS = {
    "jax": _pkg(jax_core_mod, jax_jobs, jax_lazy, jax_protocol, jax_tick,
                jax_worker, jax_descriptor, jax_reactor,
                lambda: JaxModel(backend="numpy")),
    "port": _pkg(port_core_mod, port_jobs, port_lazy, port_protocol,
                 port_tick, port_worker, port_descriptor, port_reactor,
                 lambda: GreedyCutScanModel(device="cpu")),
}


def both(scenario):
    """Run a scenario on each package; their observations must agree."""
    out = {name: scenario(pkg) for name, pkg in PKGS.items()}
    assert out["jax"] == out["port"]
    return out["port"]


def _core_and_job(pkg):
    core = pkg.Core()
    jobs = pkg.JobManager()
    core.lazy.jobs_getter = lambda: jobs
    job = jobs.create_job(name="j", submit_dir="/tmp")
    rq_id = core.intern_rqv(pkg.rqv_from_wire({}, core.resource_map))
    return core, jobs, job, rq_id


def test_lazy_take_materializes_with_chunk_stamps():
    """tests/test_ingest.py:46 on both packages."""

    def scenario(pkg):
        core, _jobs, job, rq_id = _core_and_job(pkg)
        chunk = pkg.ArrayChunk(
            job_id=job.job_id, rq_id=rq_id, priority=(0, -job.job_id),
            body={"cmd": ["true"]}, crash_limit=5, id_range=(10, 110),
            submitted_at=123.0, ready_at=124.0,
        )
        core.lazy.register(core, chunk)
        assert job.n_tasks() == 100 and job.n_lazy == 100
        assert core.queues.total_ready() == 100
        assert not core.tasks
        q = core.queues.queue(rq_id)
        sizes = dict(q.priority_sizes())
        assert sizes[(0, -job.job_id)] == 100
        taken = q.take((0, -job.job_id), 7)
        assert len(taken) == 7 and len(core.tasks) == 7
        task = core.tasks[taken[0]]
        assert task.t_ready == 124.0
        assert job.tasks[10].submitted_at == 123.0
        assert job.n_lazy == 93 and core.queues.total_ready() == 93
        t = core.lazy.extract(core, job.job_id, 50)
        assert t is not None and t.task_id in core.tasks
        assert job.n_lazy == 92
        rest = q.take((0, -job.job_id), 200)
        assert len(rest) == 92 and t.task_id not in rest
        assert job.n_lazy == 0 and core.lazy.stats()["unmaterialized"] == 0
        assert not core.lazy.per_job and not core.lazy.levels
        return [taken, t.task_id, rest, core.lazy.stats(),
                sorted(job.tasks), [core.tasks[i].body for i in taken]]

    both(scenario)


def test_lazy_ids_list_and_drop():
    """tests/test_ingest.py:92 on both packages."""

    def scenario(pkg):
        core, _jobs, job, rq_id = _core_and_job(pkg)
        ids = [1, 3, 5, 9, 11]
        core.lazy.register(core, pkg.ArrayChunk(
            job_id=job.job_id, rq_id=rq_id, priority=(0, -job.job_id),
            body={}, crash_limit=5, ids=ids,
            entries=[f"e{i}" for i in ids], submitted_at=1.0, ready_at=1.0,
        ))
        assert core.lazy.drop_id(core, job.job_id, 5)
        assert not core.lazy.drop_id(core, job.job_id, 5)
        assert job.n_lazy == 4
        taken = core.queues.queue(rq_id).take((0, -job.job_id), 10)
        got = sorted(core.tasks[t].entry for t in taken)
        assert got == ["e1", "e11", "e3", "e9"]
        return [taken, got, core.lazy.stats()]

    both(scenario)


def _chunks(pkg, core, job, rq_id, spec):
    """Register chunks (first id, n, priority, held) of one job."""
    for start, n, prio, held in spec:
        core.lazy.register(core, pkg.ArrayChunk(
            job_id=job.job_id, rq_id=rq_id, priority=prio, body={},
            crash_limit=5, id_range=(start, start + n), submitted_at=2.0,
            ready_at=3.0,
        ), held=held)


def test_queue_view_batch_sizes_and_takes():
    """A class with lazy chunks is served through LazyQueueView: its sizes
    merge the base queue's, its takes drain the base queue first, and a
    class without lazy tasks keeps its bare queue."""

    def scenario(pkg):
        core, _jobs, job, rq = _core_and_job(pkg)
        other = core.intern_rqv(pkg.rqv_from_wire(
            {"variants": [{"entries": [
                {"name": "cpus", "amount": 2 * U}]}]}, core.resource_map))
        _chunks(pkg, core, job, rq, [(0, 40, (1, -1), False),
                                     (40, 30, (0, -1), False),
                                     (70, 20, (1, -1), False)])
        for tid in (1000, 1001, 1002):
            core.queues.add(rq, (1, -1), (1 << 32) + tid)
        core.queues.add(other, (2, -1), (1 << 32) + 2000)
        view = core.queues.queue(rq)
        bare = core.queues.queue(other)
        out = [type(view).__name__, type(bare).__name__ == "LazyQueueView",
               len(view), view.priority_sizes(), core.queues.total_ready(),
               sorted((r, type(q).__name__ == "LazyQueueView")
                      for r, q in core.queues.items())]
        out.append(view.take((1, -1), 5))
        out.append(view.take((1, -1), 60))
        out.append(view.take((0, -1), 100))
        out += [len(view), core.queues.total_ready(), core.lazy.stats(),
                type(core.queues.queue(rq)).__name__]
        return out

    out = both(scenario)
    assert out[0] == "LazyQueueView" and out[1] is False
    assert out[3] == [((1, -1), 63), ((0, -1), 30)]


def _workers(pkg, core, cpus):
    for wid, n in enumerate(cpus, start=1):
        config = pkg.WorkerConfiguration(descriptor=pkg.ResourceDescriptor(
            items=(pkg.ResourceDescriptorItem.range("cpus", 0, n - 1),)))
        w = pkg.Worker.create(wid, config, core.resource_map)
        core.workers[wid] = w
        core.worker_id_counter.next()
    core.bump_membership()


def test_create_batches_and_run_tick_over_lazy_and_eager():
    """Batches and three solves over a class that holds lazy chunks and
    eager tasks at the same priorities, beside an eager-only class."""

    def scenario(pkg):
        core, _jobs, job, rq = _core_and_job(pkg)
        two = core.intern_rqv(pkg.rqv_from_wire(
            {"variants": [{"entries": [
                {"name": "cpus", "amount": 2 * U}]}]}, core.resource_map))
        _workers(pkg, core, [4, 8, 2, 16])
        _chunks(pkg, core, job, rq, [(0, 30, (1, -1), False),
                                     (30, 25, (0, -1), False)])
        for i in range(12):
            core.queues.add(rq if i % 2 else two, (i % 3, -1),
                            (1 << 32) + 500 + i)
        model = pkg.model()
        out = []
        for _ in range(3):
            batches = pkg.create_batches(core.queues)
            out.append([(b.rq_id, tuple(b.priority), b.size)
                        for b in batches])
            rows = core.worker_rows()
            assignments = pkg.run_tick(core.queues, rows, core.rq_map,
                                       core.resource_map, model)
            out.append(list(assignments))
            for tid, wid, rq_id, variant in assignments:
                w = core.workers[wid]
                w.assign(tid, core.variant_amounts(rq_id, variant, w))
            # the first worker finishes what it runs
            w = core.workers[1]
            for tid in list(w.assigned_tasks):
                t = core.tasks.get(tid)
                rq_id = t.rq_id if t is not None else two
                w.unassign(tid, core.variant_amounts(rq_id, 0, w))
            out.append([core.queues.total_ready(), core.lazy.stats()])
        return out

    out = both(scenario)
    assert any(out[1]) and out[-1][1]["materialized_total"] > 0


def test_pause_resume_through_detach_and_requeue():
    def scenario(pkg):
        core, jobs, job, rq = _core_and_job(pkg)
        job2 = jobs.create_job(name="k", submit_dir="/tmp")
        _chunks(pkg, core, job, rq, [(0, 10, (0, -1), False),
                                     (10, 5, (0, -1), True)])
        _chunks(pkg, core, job2, rq, [(0, 7, (0, -2), False)])
        out = [core.lazy.stats(), core.queues.total_ready(),
               core.queues.version]
        out.append(core.lazy.detach_job(core, job.job_id))
        out += [core.lazy.stats(), core.queues.total_ready(),
                core.queues.queue(rq).priority_sizes()]
        out.append(core.lazy.detach_job(core, job.job_id))
        out.append(core.lazy.requeue_job(core, job.job_id))
        out += [core.lazy.stats(), core.queues.total_ready(),
                core.queues.version, job.n_lazy, job2.n_lazy]
        return out

    out = both(scenario)
    assert out[3] == 10 and out[8] == 15


def test_drop_extract_and_materialize_job():
    def scenario(pkg):
        core, _jobs, job, rq = _core_and_job(pkg)
        _chunks(pkg, core, job, rq, [(0, 10, (0, -1), False),
                                     (10, 6, (0, -1), True)])
        out = [core.lazy.owns(job.job_id, 3), core.lazy.owns(job.job_id, 99)]
        out.append(core.lazy.drop_id(core, job.job_id, 3))
        out.append(core.lazy.drop_id(core, job.job_id, 12))  # a held one
        held_task = core.lazy.extract(core, job.job_id, 13)
        out.append((held_task.task_id, held_task.state.value))
        out.append(core.lazy.extract(core, job.job_id, 3))  # dropped
        out.append(core.lazy.job_unmaterialized(job.job_id))
        tasks = core.lazy.materialize_job(core, job.job_id)
        out.append([(t.task_id, t.state.value) for t in tasks])
        out += [{j: sorted(h) for j, h in core.paused_held.items()},
                core.queues.total_ready(), core.lazy.stats(), job.n_lazy,
                sorted(job.tasks), core.lazy.owns(job.job_id, 5)]
        return out

    out = both(scenario)
    assert out[7] and out[-4]["unmaterialized"] == 0


def test_job_manager_counters():
    def scenario(pkg):
        jobs = pkg.JobManager()
        job = jobs.create_job(name="j", submit_dir="/d", max_fails=1)
        other = jobs.create_job(name="k", submit_dir="/d", job_id=7)
        later = jobs.create_job(name="l", submit_dir="/d")
        ids = [jobs.attach_task(job, i) for i in range(5)]
        out = [job.job_id, other.job_id, later.job_id, ids]
        jobs.on_task_started(job.job_id, ids[0], [1], started_at=5.0)
        jobs.on_task_started(job.job_id, ids[1], [2], started_at=5.0)
        out.append(dict(job.counters))
        jobs.on_task_restarted(job.job_id, ids[1])
        jobs.on_task_finished(job.job_id, ids[0])
        out.append(jobs.on_task_failed(job.job_id, ids[2], "boom"))
        out.append(sorted(jobs.on_task_failed(job.job_id, ids[3], "boom")))
        jobs.on_task_canceled(job.job_id, ids[4])
        jobs.on_task_canceled(job.job_id, ids[4])  # already terminal
        out += [dict(job.counters), job.status(), job.n_tasks(),
                job.n_waiting(), job.all_tasks_done(), job.is_terminated(),
                job.cancel_reason]
        info = job.to_info()
        info.pop("submitted_at")
        detail = [{k: v for k, v in t.items() if not k.endswith("_at")}
                  for t in job.to_detail()["tasks"]]
        out += [info, detail]
        job.n_lazy = 3
        out += [job.n_tasks(), job.status(), job.all_tasks_done()]
        return out

    out = both(scenario)
    assert out[5] == [] and len(out[6]) == 2


# --- lazy_core_from_plain against the JAX core ------------------------------

def _plain(seed=5, n_workers=24, n_tasks=6000, n_jobs=3):
    from hyperqueue_tpu.ids import make_task_id
    from hyperqueue_tpu.scheduler.queues import encode_sched_priority

    rng = np.random.default_rng(seed)
    classes = [
        [{"entries": [("cpus", U, "compact")]}],
        [{"entries": [("cpus", 2 * U, "compact"), ("gpus", U, "compact")]},
         {"entries": [("cpus", 4 * U, "compact")]}],
        [{"entries": [("cpus", 4 * U, "compact")]}],
    ]
    tasks = []
    for t in range(n_tasks):
        job = int(rng.integers(1, n_jobs + 1))
        tasks.append((make_task_id(job, t), int(rng.integers(0, 3)),
                      (int(rng.integers(0, 3)), encode_sched_priority(job))))
    workers = []
    for wid in range(1, n_workers + 1):
        free = [int(rng.choice([4, 8, 16])) * U,
                int(rng.choice([0, 2])) * U]
        workers.append((wid, free, 16, INF, list(free)))
    return ["cpus", "gpus"], classes, tasks, workers


def jax_lazy_core(resources, classes, tasks, workers, chunk_size):
    """The JAX core of the same plain data, registered as the JAX server
    imports a chunked array (rqv_from_wire per class, an ArrayChunk per
    (job, class, priority) run of sorted ids, a JobManager behind the
    store's jobs_getter)."""
    from hyperqueue_tpu.ids import task_id_job, task_id_task

    core = jax_core_mod.Core()
    for name in resources:
        core.resource_map.get_or_create(name)
    for variants in classes:
        wire = {"variants": [
            {"entries": [{"name": n, "amount": a, "policy": p}
                         for n, a, p in v["entries"]]} for v in variants]}
        core.intern_rqv(jax_protocol.rqv_from_wire(wire, core.resource_map))
    for wid, free, nt_free, _life, total in workers:
        items = tuple(
            jax_descriptor.ResourceDescriptorItem.sum(resources[r], a)
            for r, a in enumerate(total) if a > 0)
        w = jax_worker.Worker.create(
            wid, jax_worker.WorkerConfiguration(
                descriptor=jax_descriptor.ResourceDescriptor(items=items)),
            core.resource_map)
        w.free, w.nt_free = list(free), nt_free
        core.workers[wid] = w
    core.worker_id_counter = type(core.worker_id_counter)(
        start=max(core.workers) + 1)
    core.bump_membership()
    jobs = jax_jobs.JobManager()
    core.lazy.jobs_getter = lambda: jobs
    groups: dict = {}
    for tid, c, prio in tasks:
        groups.setdefault((task_id_job(tid), c, tuple(prio)), []).append(
            task_id_task(tid))
    for (job_id, rq, prio), ids in groups.items():
        if job_id not in jobs.jobs:
            jobs.create_job(name=f"job{job_id}", submit_dir="",
                            job_id=job_id)
        ids.sort()
        for s in range(0, len(ids), chunk_size):
            core.lazy.register(core, jax_lazy.ArrayChunk(
                job_id=job_id, rq_id=rq, priority=prio, body={},
                crash_limit=5, ids=ids[s:s + chunk_size]))
    return core, jobs


class _Comm:
    def __init__(self):
        self.compute, self.retracts = [], []

    def send_compute(self, worker_id, tasks):
        self.compute.append(
            (worker_id, [{k: v for k, v in m.items() if k != "trace"}
                         for m in tasks]))

    def send_cancel(self, worker_id, task_ids):
        raise AssertionError("no cancel expected")

    def send_retract(self, worker_id, refs):
        self.retracts.append((worker_id, list(refs)))

    def ask_for_scheduling(self):
        pass


class _Events:
    def __init__(self):
        self.started = []

    def on_task_started(self, task_id, *_args, **_kwargs):
        self.started.append(task_id)

    def __getattr__(self, name):
        return lambda *a, **k: None


@pytest.mark.parametrize("chunk_size", [16384, 700])
def test_lazy_core_from_plain_matches_jax_core(chunk_size):
    """The same plain data as a lazy port core and a lazy JAX core: the
    same chunks, batches and jobs, then four reactor ticks with prefill
    (the workers start what they receive beyond their prefill backlog,
    the first third of them finish what runs) that send the same compute messages and flight records."""
    plain = _plain()
    port, port_jobs_ = lazy_core_from_plain(*plain, chunk_size=chunk_size)
    jax, jax_jobs_ = jax_lazy_core(*plain, chunk_size=chunk_size)
    assert port.lazy.stats() == jax.lazy.stats()
    assert {j: (job.name, job.n_lazy) for j, job in port_jobs_.jobs.items()} \
        == {j: (job.name, job.n_lazy) for j, job in jax_jobs_.jobs.items()}
    assert [[(s.chunk.rq_id, s.chunk.priority, s.chunk.ids)
             for s in segs] for segs in port.lazy.per_job.values()] == \
        [[(s.chunk.rq_id, s.chunk.priority, s.chunk.ids)
          for s in segs] for segs in jax.lazy.per_job.values()]
    sides = []
    for core, reactor, model in (
        (jax, jax_reactor, JaxModel(backend="numpy")),
        (port, port_reactor, GreedyCutScanModel(device="cpu")),
    ):
        comm, events = _Comm(), _Events()
        seen = []
        for _tick in range(4):
            reactor.schedule(core, comm, events, model)
            core.sanity_check()
            for wid, msgs in comm.compute[len(seen):]:
                for m in msgs:
                    if not core.tasks[m["id"]].prefilled:
                        reactor.on_task_running(core, events, m["id"],
                                                m["instance"])
            seen = list(comm.compute)
            for wid in sorted(core.workers)[:len(core.workers) // 3]:
                for tid in sorted(core.workers[wid].assigned_tasks):
                    reactor.on_task_finished(
                        core, comm, events, tid, core.tasks[tid].instance_id)
        jobs_ = port_jobs_ if core is port else jax_jobs_
        sides.append(dict(
            compute=comm.compute, retracts=comm.retracts,
            started=events.started,
            flight=[flight_view(r) for r in core.flight.ticks()],
            lazy=core.lazy.stats(), ready=core.queues.total_ready(),
            jobs={j: (job.n_lazy, len(job.tasks), dict(job.counters))
                  for j, job in jobs_.jobs.items()}))
    assert sides[0] == sides[1]
    assert sides[1]["lazy"]["materialized_total"] > 0
    assert sum(n + m for n, m, _c in sides[1]["jobs"].values()) == 6000
