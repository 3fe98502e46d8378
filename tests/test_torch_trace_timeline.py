"""The port's detailed timeline: the switch that follows a torch profiler,
prefill's two sub-phases, the workers' answers folded into the next tick's
record, the collector's passes by where they fell, and the tick's
existing readers (`TickPhaseStats`, `hq_tick_phase_seconds`, the flight
record) unchanged by the new entries."""

from __future__ import annotations

import gc

import pytest
import torch
import utils_env

from hyperqueue_tpu_torch.ids import make_task_id
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT
from hyperqueue_tpu_torch.resources.descriptor import (
    ResourceDescriptor,
    ResourceDescriptorItem,
)
from hyperqueue_tpu_torch.resources.request import (
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu_torch.scheduler.tick_cache import (
    PHASES_APART,
    TickPhaseStats,
)
from hyperqueue_tpu_torch.server import reactor
from hyperqueue_tpu_torch.server.core import Core
from hyperqueue_tpu_torch.server.task import Task, TaskState
from hyperqueue_tpu_torch.server.worker import Worker, WorkerConfiguration
from hyperqueue_tpu_torch.utils import trace

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]


class Events(utils_env.TestEvents):
    on_started = None  # a hook the gc test sets

    def on_task_started(self, *args, **kwargs):
        super().on_task_started(*args, **kwargs)
        if self.on_started is not None:
            self.on_started()


class Env:
    """A port core with 1-cpu workers and a record of every tick's
    `phases`, as `core.tick_stats.record` receives them."""

    def __init__(self, model=None):
        self.core = Core()
        self.comm = utils_env.TestComm()
        self.events = Events()
        self.model = model or GreedyCutScanModel(device="cpu")
        self.records: list = []
        self.seq = 0
        record = self.core.tick_stats.record

        def capture(phases):
            self.records.append(phases)
            record(phases)

        self.core.tick_stats.record = capture

    def worker(self, cpus=1) -> Worker:
        config = WorkerConfiguration(descriptor=ResourceDescriptor(
            items=(ResourceDescriptorItem.range("cpus", 0, cpus - 1),)))
        w = Worker.create(self.core.worker_id_counter.next(), config,
                          self.core.resource_map)
        reactor.on_new_worker(self.core, self.comm, self.events, w)
        return w

    def submit(self, n, priority=(0, 0), job=1) -> list:
        rq = ResourceRequest(entries=(ResourceRequestEntry(
            self.core.resource_map.get_or_create("cpus"),
            FRACTIONS_PER_UNIT),))
        rq_id = self.core.intern_rqv(ResourceRequestVariants.single(rq))
        tasks = []
        for _ in range(n):
            self.seq += 1
            tasks.append(Task(task_id=make_task_id(job, self.seq),
                              rq_id=rq_id, priority=priority))
        reactor.on_new_tasks(self.core, self.comm, tasks)
        return [t.task_id for t in tasks]

    def schedule(self) -> dict:
        reactor.schedule(self.core, self.comm, self.events, self.model)
        self.core.sanity_check()
        return self.records[-1]

    def start_assigned(self, include_prefilled=False) -> int:
        n = 0
        for task in list(self.core.tasks.values()):
            if task.state is TaskState.ASSIGNED and (
                include_prefilled or not task.prefilled
            ):
                reactor.on_task_running(self.core, self.events, task.task_id,
                                        task.instance_id)
                n += 1
        return n

    def finish_running(self) -> int:
        running = [t for t in self.core.tasks.values()
                   if t.state is TaskState.RUNNING]
        for task in running:
            reactor.on_task_finished(self.core, self.comm, self.events,
                                     task.task_id, task.instance_id)
        return len(running)


@pytest.fixture
def no_auto_gc():
    """Only the test's own collections: automatic passes would add to the
    counts."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def test_the_switch_follows_a_cpu_profiler():
    env = Env()
    env.worker()
    env.submit(2)
    assert not trace.timeline_on()
    env.schedule()
    assert env.core.timeline_on is False
    with torch.profiler.profile(activities=CPU):
        assert trace.timeline_on()
        env.schedule()
        assert env.core.timeline_on is True
    assert not trace.timeline_on()
    env.schedule()
    assert env.core.timeline_on is False


def _displacing_tick(env: Env) -> dict:
    """A worker's prefill budget full of priority-0 backlog, then a
    priority-10 task: its tick prefills nothing and retracts backlog."""
    w = env.worker()
    env.submit(reactor.PREFILL_MAX + 1)
    first = env.schedule()
    assert first["prefill"] > 0
    assert len(w.prefilled_tasks) == reactor.PREFILL_MAX
    env.submit(1, priority=(10, 0), job=2)
    before = len(env.comm.retracts)
    phases = env.schedule()
    assert len(env.comm.retracts) > before  # the displacement ran
    return phases


def test_prefill_sub_phases_tile_prefill():
    env = Env()
    w = env.worker()
    env.worker()
    env.submit(3 * reactor.PREFILL_MAX)
    phases = env.schedule()  # a prefill backlog on both workers
    assert len(w.prefilled_tasks) == reactor.PREFILL_MAX
    assert phases["prefill_fill"] > 0 and phases["prefill_retract"] > 0
    assert (phases["prefill_fill"] + phases["prefill_retract"]
            == pytest.approx(phases["prefill"], rel=1e-9, abs=1e-12))
    phases = _displacing_tick(Env())
    assert (phases["prefill_fill"] + phases["prefill_retract"]
            == pytest.approx(phases["prefill"], rel=1e-9, abs=1e-12))


def test_the_phases_are_profiler_ranges_while_it_records():
    env = Env()
    with torch.profiler.profile(activities=CPU) as prof:
        _displacing_tick(env)
    names = {e.name for e in prof.events()}
    assert {"total", "batches", "prefill", "prefill_fill",
            "prefill_retract", "decide", "assemble", "mapping"} <= names
    # the solve's ranges open on the thread that solves: here the tick's
    assert "solve_dispatch" in names


def test_answers_fold_into_the_next_record():
    env = Env()
    env.worker(cpus=2)
    env.worker(cpus=2)
    env.submit(8)
    with torch.profiler.profile(activities=CPU):
        env.schedule()  # the switch is read here: on
        n = env.start_assigned() + env.finish_running()
        assert n == 8  # 4 started and 4 finished
        assert env.core.answers_n == n and env.core.answers_s > 0
        answers_s = env.core.answers_s
        spans = trace.TRACER.stats.get("answers")
        before = spans.count if spans is not None else 0
        phases = env.schedule()
    assert phases["since_n"]["answers"] == n
    assert phases["since_ms"]["answers"] == pytest.approx(answers_s * 1e3)
    assert env.core.answers_n == 0 and env.core.answers_s == 0.0
    assert trace.TRACER.stats["answers"].count == before + 1
    # off: the next tick reads the switch off, and answers sum nothing
    env.schedule()
    assert env.start_assigned(include_prefilled=True) > 0
    assert env.finish_running() > 0
    assert env.core.answers_n == 0
    phases = env.schedule()
    assert "answers" not in phases["since_ms"]
    assert "answers" not in phases["since_n"]


@pytest.mark.parametrize("place", ["tick", "answers", "other"])
def test_a_forced_full_collection_is_one_gen2_pass(place, no_auto_gc):
    class CollectingModel(GreedyCutScanModel):
        collect = False

        def solve(self, **kwargs):
            if self.collect:
                self.collect = False
                gc.collect(2)
            return super().solve(**kwargs)

    def collect_once():
        env.events.on_started = None
        gc.collect(2)

    env = Env(CollectingModel(device="cpu"))
    env.worker(cpus=2)
    env.submit(4)
    with torch.profiler.profile(activities=CPU) as prof:
        env.schedule()
        env.start_assigned()
        env.finish_running()
        env.schedule()  # the previous passes settle into this record
        gen2 = trace.TRACER.stats.get("gc/gen2")
        before = gen2.count if gen2 is not None else 0
        env.submit(2)
        if place == "tick":
            env.model.collect = True
        elif place == "answers":
            env.events.on_started = collect_once
            assert env.start_assigned(include_prefilled=True) > 0
        else:
            gc.collect(2)
        phases = env.schedule()
    since_ms, since_n = phases["since_ms"], phases["since_n"]
    assert (since_n["gc_gen0"], since_n["gc_gen1"], since_n["gc_gen2"]) \
        == (0, 0, 1)
    assert since_ms["gc_gen2"] > 0
    assert since_ms["gc_gen0"] == since_ms["gc_gen1"] == 0
    where = {"tick": since_ms["gc_tick"], "answers": since_ms["gc_answers"],
             "other": since_ms["gc_other"]}
    assert where[place] == pytest.approx(since_ms["gc_gen2"])
    assert all(ms == 0 for p, ms in where.items() if p != place)
    assert trace.TRACER.stats["gc/gen2"].count == before + 1
    assert "gc/gen2" in {e.name for e in prof.events()}


def test_shares_metrics_and_flight_read_the_same_with_the_new_entries():
    flat = {"batches": 1.0, "assemble": 2.0, "mapping": 1.0, "prefill": 4.0,
            "total": 8.0}
    full = dict(flat, prefill_fill=3.0, prefill_retract=1.0,
                since_ms={"answers": 50.0, "gc_tick": 0.5, "gc_answers": 1.0,
                          "gc_other": 2.0, "gc_gen0": 3.5, "gc_gen1": 0.0,
                          "gc_gen2": 0.0},
                since_n={"answers": 7, "gc_gen0": 2, "gc_gen1": 0,
                         "gc_gen2": 0})
    plain, new = TickPhaseStats(), TickPhaseStats()
    plain.record(flat)
    new.record(full)
    assert new.shares() == plain.shares()
    assert set(new.snapshot()["phases"]) == set(flat) | {"prefill_fill",
                                                          "prefill_retract"}
    assert not set(PHASES_APART) & set(new.last_ms)

    env = Env()
    with torch.profiler.profile(activities=CPU):
        env.schedule()
        _displacing_tick(env)
        env.start_assigned()
        phases = env.schedule()
    assert set(PHASES_APART) <= set(phases)
    record = env.core.flight.ticks()[-1]
    assert set(record["phases"]) == set(phases) - set(PHASES_APART)
    assert all(isinstance(v, float) for v in record["phases"].values())
    series = reactor._TICK_PHASE_SECONDS.series
    labels = {values[0] for values in series}
    assert {"prefill", "prefill_fill", "prefill_retract"} <= labels
    assert not set(PHASES_APART) & labels
    assert "solve_dispatch" in phases  # a solving tick still says so
