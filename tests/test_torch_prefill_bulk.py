"""Prefill's take of lazy array tasks, a segment at a time, against the
JAX package and against taking one id at a time.

The port's lazy store makes the tasks that a take pops out of array
chunks in bulk, a segment at a time (`LazyStore.take`), and prefill
makes one take and one batch of messages per worker. Each case runs the
same chunks, workers and answers through three reactors: the JAX
package's, the port's, and the port's with every lazy take cut into
takes of one id. The three must agree on everything a tick leaves
behind: the compute messages with their trace headers, every Task
field, every `job.tasks` record, `n_lazy`, `lazy.stats()`, the queues,
the retracts and the flight records (tolerance 0). A fixed clock a tick
makes the assignment stamps comparable.
"""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources import descriptor as jax_descriptor
from hyperqueue_tpu.server import core as jax_core_mod
from hyperqueue_tpu.server import jobs as jax_jobs
from hyperqueue_tpu.server import lazy as jax_lazy
from hyperqueue_tpu.server import protocol as jax_protocol
from hyperqueue_tpu.server import reactor as jax_reactor
from hyperqueue_tpu.server import worker as jax_worker
from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
from hyperqueue_tpu_torch.server import core as port_core_mod
from hyperqueue_tpu_torch.server import jobs as port_jobs
from hyperqueue_tpu_torch.server import lazy as port_lazy
from hyperqueue_tpu_torch.server import protocol as port_protocol
from hyperqueue_tpu_torch.server import reactor as port_reactor
from hyperqueue_tpu_torch.server import worker as port_worker
from hyperqueue_tpu_torch.utils import clock as port_clock
from test_torch_reactor import flight_view

torch.set_num_threads(1)

TICKS = 4


def _pkg(core, jobs, lazy, protocol, worker, descriptor, reactor, clock,
         model):
    return types.SimpleNamespace(
        Core=core.Core, JobManager=jobs.JobManager,
        ArrayChunk=lazy.ArrayChunk, rqv_from_wire=protocol.rqv_from_wire,
        Worker=worker.Worker, WorkerConfiguration=worker.WorkerConfiguration,
        ResourceDescriptor=descriptor.ResourceDescriptor,
        ResourceDescriptorItem=descriptor.ResourceDescriptorItem,
        reactor=reactor, clock=clock, model=model)


JAX = _pkg(jax_core_mod, jax_jobs, jax_lazy, jax_protocol, jax_worker,
           jax_descriptor, jax_reactor, jax_clock,
           lambda: JaxModel(backend="numpy"))
PORT = _pkg(port_core_mod, port_jobs, port_lazy, port_protocol, port_worker,
            port_descriptor, port_reactor, port_clock,
            lambda: GreedyCutScanModel(device="cpu"))


class FixedClock:
    """One wall-clock stamp a tick."""

    def __init__(self):
        self.at = 1000.0

    def time(self):
        return self.at

    def monotonic(self):
        return self.at


class Comm:
    def __init__(self):
        self.compute, self.retracts = [], []

    def send_compute(self, worker_id, tasks):
        self.compute.append((worker_id, [dict(m) for m in tasks]))

    def send_cancel(self, worker_id, task_ids):
        raise AssertionError("no cancel expected")

    def send_retract(self, worker_id, refs):
        self.retracts.append((worker_id, [tuple(r) for r in refs]))

    def ask_for_scheduling(self):
        pass


class Events:
    def __getattr__(self, name):
        return lambda *a, **k: None


TRACE = {"id": "t-0123", "sent_at": 1.5, "recv_at": 2.5, "commit_at": 3.0}


def _chunk(pkg, job, rq, prio, ids=None, id_range=None, **kw):
    return pkg.ArrayChunk(
        job_id=job.job_id, rq_id=rq, priority=prio, body={"cmd": ["true"]},
        crash_limit=5, id_range=id_range, ids=ids, submitted_at=2.0,
        ready_at=3.0, **kw)


def _chunks(pkg, job, rq, prio, case):
    """The chunks of each case, in their queue order at one level."""
    c = lambda **kw: _chunk(pkg, job, rq, prio, **kw)  # noqa: E731
    if case == "id_range":
        return [c(id_range=(0, 2400))]
    if case == "ids":
        return [c(ids=list(range(5, 7200, 3)))]
    if case == "entries":
        return [c(id_range=(100, 2100),
                  entries=[f"e{i}" for i in range(2000)])]
    if case == "tombstones":
        return [c(id_range=(0, 2400))]
    if case == "boundary":
        # takes of up to 512 cross these at every other chunk
        return [c(id_range=(0, 300)), c(ids=list(range(300, 1000, 2))),
                c(id_range=(1000, 1001)), c(id_range=(1001, 1650),
                                            entries=["x"] * 649),
                c(id_range=(2000, 3400))]
    if case == "budget":
        return [c(id_range=(0, 10_000))]
    if case == "requeued":
        return [c(id_range=(0, 3000))]
    if case == "traced":
        return [c(id_range=(0, 700), trace=dict(TRACE)),
                c(id_range=(700, 2400))]
    raise AssertionError(case)


def _worker(pkg, core, wid, cpus):
    config = pkg.WorkerConfiguration(descriptor=pkg.ResourceDescriptor(
        items=(pkg.ResourceDescriptorItem.range("cpus", 0, cpus - 1),)))
    core.workers[wid] = pkg.Worker.create(wid, config, core.resource_map)
    core.worker_id_counter.next()


def _task_view(task) -> dict:
    out = {}
    for f in dataclasses.fields(task):
        v = getattr(task, f.name)
        if f.name == "state":
            v = v.value
        elif f.name == "consumers":
            v = sorted(v)
        out[f.name] = v
    return out


def _observe(core, jobs, comm) -> dict:
    return dict(
        compute=list(comm.compute), retracts=list(comm.retracts),
        tasks={tid: _task_view(t) for tid, t in core.tasks.items()},
        job_tasks={j: {i: dataclasses.asdict(r) for i, r in job.tasks.items()}
                   for j, job in jobs.jobs.items()},
        n_lazy={j: job.n_lazy for j, job in jobs.jobs.items()},
        lazy=core.lazy.stats(), ready=core.queues.total_ready(),
        levels=sorted((rq, q.priority_sizes())
                      for rq, q in core.queues.items()),
        version=core.queues.version,
        prefilled={w: sorted(x.prefilled_tasks)
                   for w, x in core.workers.items()},
        flight=[flight_view(r) for r in core.flight.ticks()],
    )


def scenario(pkg, case, phases=None):
    """Four ticks with prefill over the case's chunks; returns what each
    tick left behind. `phases` collects each tick's phases (the port)."""
    clock = FixedClock()
    previous = pkg.clock.install(clock)
    try:
        core = pkg.Core()
        jobs = pkg.JobManager()
        core.lazy.jobs_getter = lambda: jobs
        job = jobs.create_job(name="j", submit_dir="/tmp")
        rq = core.intern_rqv(pkg.rqv_from_wire({}, core.resource_map))
        for wid, cpus in enumerate((2, 3, 1, 4), start=1):
            _worker(pkg, core, wid, cpus)
        core.bump_membership()
        prio = (0, -job.job_id)
        for chunk in _chunks(pkg, job, rq, prio, case):
            core.lazy.register(core, chunk)
        if case == "tombstones":
            # mid-chunk ids taken out one by one (`hq task explain`, a
            # single cancel): one queued again, one dropped
            task = core.lazy.extract(core, job.job_id, 700)
            core.queues.add(task.rq_id, task.priority, task.task_id)
            assert core.lazy.drop_id(core, job.job_id, 1501)
            core.lazy.extract(core, job.job_id, 1500).state = \
                type(task.state).CANCELED
        if phases is not None:
            record = core.tick_stats.record

            def capture(p):
                phases.append(p)
                record(p)

            core.tick_stats.record = capture
        comm, events = Comm(), Events()
        reactor = pkg.reactor
        model = pkg.model()
        out = []
        for tick in range(TICKS):
            clock.at = 1000.0 + tick
            seen = len(comm.compute)
            reactor.schedule(core, comm, events, model)
            core.sanity_check()
            for _wid, msgs in comm.compute[seen:]:
                for m in msgs:
                    if not core.tasks[m["id"]].prefilled:
                        reactor.on_task_running(core, events, m["id"],
                                                m["instance"])
            out.append(_observe(core, jobs, comm))
            if case == "requeued" and tick == 0:
                # prefilled tasks retracted back: READY again in the base
                # queue at their level, ahead of the lazy ids, so that the
                # next take onto worker 2 crosses from them into a chunk
                for tid in sorted(core.workers[2].prefilled_tasks)[7:27]:
                    task = core.tasks[tid]
                    task.retract_pending = True
                    reactor.on_retract_response(core, comm, tid, True,
                                                task.instance_id)
            clock.at = 1000.5 + tick
            # two workers finish what runs, then start prefilled backlog
            for wid in (1, 4):
                w = core.workers[wid]
                for tid in sorted(w.assigned_tasks):
                    reactor.on_task_finished(core, comm, events, tid,
                                             core.tasks[tid].instance_id)
                for tid in sorted(w.prefilled_tasks)[:2]:
                    reactor.on_task_running(core, events, tid,
                                            core.tasks[tid].instance_id)
        return out
    finally:
        pkg.clock.install(previous)


CASES = ["id_range", "ids", "entries", "tombstones", "boundary", "budget",
         "requeued", "traced"]


def _one_id_a_take(take):
    def each(self, core, rq_id, priority, count):
        out = []
        while len(out) < count:
            got = take(self, core, rq_id, priority, 1)
            if not got:
                break
            out += got
        return out

    return each


def _by_path(phases):
    return [(p["since_n"]["prefill_bulk"], p["since_n"]["prefill_each"])
            for p in phases]


@pytest.mark.parametrize("case", CASES)
def test_bulk_prefill_matches_the_per_id_path(case, monkeypatch):
    bulk_phases: list = []
    port = scenario(PORT, case, bulk_phases)
    jax = scenario(JAX, case)
    with monkeypatch.context() as m:
        m.setattr(port_lazy.LazyStore, "take",
                  _one_id_a_take(port_lazy.LazyStore.take))
        each_phases: list = []
        each = scenario(PORT, case, each_phases)
    for tick, (j, p, e) in enumerate(zip(jax, port, each)):
        for key in p:
            assert p[key] == e[key], (tick, key, "port bulk vs per id")
            assert p[key] == j[key], (tick, key, "port vs jax")
    assert _by_path(bulk_phases) == _by_path(each_phases)
    assert sum(n for n, _ in _by_path(bulk_phases)) > 1000
    assert port[-1]["lazy"]["materialized_total"] > 1000


def _prefilled_in_flight(record) -> int:
    return record["counts"]["prefilled"]


@pytest.mark.parametrize("case", ["id_range", "requeued", "traced"])
def test_prefill_counts_by_path_sum_to_the_tick_s_prefilled(case):
    phases: list = []
    out = scenario(PORT, case, phases)
    flight = out[-1]["flight"]
    assert len(phases) == len(flight) == TICKS
    bulk = 0
    for p, record in zip(phases, flight):
        n = p["since_n"]
        assert n["prefill_bulk"] + n["prefill_each"] == \
            _prefilled_in_flight(record)
        bulk += n["prefill_bulk"]
    assert bulk > 1000
    each = sum(p["since_n"]["prefill_each"] for p in phases)
    if case == "requeued":
        # the retracted tasks, taken again from the base queue
        assert 0 < each <= 20
    else:
        # one array, with or without trace stamps: all of it the lazy
        # store's
        assert each == 0
