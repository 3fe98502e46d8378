"""The port's reactor against the JAX package's, call for call.

`TwinEnv` has the API of `utils_env.TestEnv`. It drives a JAX core (the JAX
GreedyCutScanModel on the CPU, as TestEnv does) and a port core
(GreedyCutScanModel(device="cpu"), the kernel's plain version) with the same
calls, and after every call compares the two: task states, assigned workers
and variants, instance ids and crash counters, worker free/nt_free and task
sets, the queues, the compute, cancel and retract messages per worker, the
event lists and the flight records. Everything is compared exactly, except
the fields that cannot match: wall-clock stamps (`time`, `duration_ms`,
`phases`, the solver's `solve_ms`, `inflight_ms`, `dispatched_at_wall` and
`mapped_at_wall`), trace ids (drawn from `secrets`) and the
solver's `backend`/`backend_reason`, which name the platform the solve ran
on.

Every scenario of tests/test_reactor.py and tests/test_prefill.py runs
through it: the module's `TestEnv` (and `_TestEnv`) name is patched to
TwinEnv, and its `reactor` name (module-level, or imported inside a test
from `hyperqueue_tpu.server`) to a shim that applies each call to both
cores. The scenarios read the JAX side (`env.core` is the JAX core), so
their own assertions still hold the JAX package to its behaviour.

Then fused and pipelined ticks of both reactors over a 64-worker dense
snapshot with gangs, a policy and a paused job.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import hyperqueue_tpu.server as jax_server_pkg
import test_prefill
import test_reactor
import utils_env
from hyperqueue_tpu.ids import task_id_job
from hyperqueue_tpu.scheduler import policy as jax_policy
from hyperqueue_tpu.scheduler.pipeline import TickPipeline as JaxPipeline
from hyperqueue_tpu.scheduler.predict import (
    RuntimePredictor as JaxPredictor,
)
from hyperqueue_tpu.scheduler.queues import encode_sched_priority
from hyperqueue_tpu.server import reactor as jax_reactor
from hyperqueue_tpu.server.protocol import rqv_to_wire
from hyperqueue_tpu.server.task import Task as JaxTask
from hyperqueue_tpu.server.worker import Worker as JaxWorker
from hyperqueue_tpu_torch.convert import policy_table_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.scheduler import policy as port_policy
from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor
from hyperqueue_tpu_torch.server import reactor as port_reactor
from hyperqueue_tpu_torch.server.core import Core as PortCore
from hyperqueue_tpu_torch.server.protocol import rqv_from_wire
from hyperqueue_tpu_torch.server.task import Task as PortTask
from hyperqueue_tpu_torch.server.worker import (
    Worker as PortWorker,
    WorkerConfiguration as PortConfiguration,
)

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

DECISION_LOG = "decision-record assembly failed"


# --- the two sides' state, as comparable plain values ------------------------

def _tasks(core) -> dict:
    return {
        tid: (t.state.value, t.rq_id, tuple(t.priority), t.assigned_worker,
              t.assigned_variant, t.instance_id, t.crash_counter, t.prefilled,
              t.retract_pending, tuple(t.mn_workers), t.unfinished_deps,
              sorted(t.consumers), t.entry)
        for tid, t in core.tasks.items()
    }


def _workers(core) -> dict:
    return {
        wid: (list(w.free), w.nt_free, sorted(w.assigned_tasks),
              sorted(w.prefilled_tasks), w.mn_task, w.mn_reserved,
              w.draining, w.clean_stop)
        for wid, w in core.workers.items()
    }


def _queues(core) -> tuple:
    levels = sorted(
        (rq_id, [(tuple(p), n) for p, n in q.priority_sizes()])
        for rq_id, q in core.queues.items()
    )
    return (core.queues.total_ready(), levels, list(core.mn_queue),
            sorted(core.paused_jobs),
            {j: sorted(h) for j, h in core.paused_held.items()},
            core.lazy.stats())


def _messages(comm) -> tuple:
    compute = [
        (wid, [{k: v for k, v in m.items() if k != "trace"} for m in msgs])
        for wid, msgs in comm.compute
    ]
    return (compute, [(w, list(t)) for w, t in comm.cancels],
            [(w, [tuple(r) for r in refs]) for w, refs in comm.retracts],
            comm.scheduling_asked)


def _events(events) -> dict:
    return {f.name: list(getattr(events, f.name))
            for f in dataclasses.fields(events)}


def flight_view(record: dict) -> dict:
    """A DecisionRecord without its wall-clock fields and the solver's
    platform name."""
    out = {k: v for k, v in record.items()
           if k not in ("time", "duration_ms", "phases")}
    solver = dict(out.get("solver") or {})
    for key in ("solve_ms", "inflight_ms", "dispatched_at_wall",
                "mapped_at_wall", "backend", "backend_reason"):
        solver.pop(key, None)
    out["solver"] = solver
    return out


def _flight(core) -> list:
    return [flight_view(r) for r in core.flight.ticks()]


def compare_cores(jax_core, port_core, jax_comm=None, port_comm=None,
                  jax_events=None, port_events=None, where="") -> None:
    views = [("tasks", _tasks), ("workers", _workers), ("queues", _queues),
             ("flight", _flight)]
    for label, view in views:
        j, p = view(jax_core), view(port_core)
        if j != p:
            diff = j if not isinstance(j, dict) else {
                k: (j.get(k), p.get(k)) for k in set(j) | set(p)
                if j.get(k) != p.get(k)}
            raise AssertionError(f"{where}: {label} differ: {diff}"
                                 if isinstance(j, dict) else
                                 f"{where}: {label} differ:\n{j}\n{p}")
    if jax_comm is not None:
        assert _messages(jax_comm) == _messages(port_comm), where
    if jax_events is not None:
        assert _events(jax_events) == _events(port_events), where
    assert jax_core.tick_counter == port_core.tick_counter, where


# --- the twin environment ------------------------------------------------------

class TwinEnv:
    """utils_env.TestEnv over both packages. `core`, `comm`, `events` and
    the returned workers are the JAX side's."""

    __test__ = False
    created: list = []
    by_core: dict = {}

    def __init__(self, model=None):
        self.jax = utils_env.TestEnv(model)
        self.port_core = PortCore()
        self.port_comm = utils_env.TestComm()
        self.port_events = utils_env.TestEvents()
        self.port_model = GreedyCutScanModel(device="cpu")
        self.calls = 0
        TwinEnv.created.append(self)
        TwinEnv.by_core[id(self.jax.core)] = self

    core = property(lambda self: self.jax.core)
    comm = property(lambda self: self.jax.comm)
    events = property(lambda self: self.jax.events)
    model = property(lambda self: self.jax.model)

    def compare(self, where="") -> None:
        self.calls += 1
        compare_cores(self.jax.core, self.port_core, self.jax.comm,
                      self.port_comm, self.jax.events, self.port_events,
                      where=f"call {self.calls} {where}")

    def _sync_names(self) -> None:
        # resource ids follow the JAX map's order, so the dense columns
        # line up
        for name in self.jax.core.resource_map.names():
            self.port_core.resource_map.get_or_create(name)

    def port_rqv(self, jax_rq_id: int):
        self._sync_names()
        wire = rqv_to_wire(self.jax.core.rq_map.get_variants(jax_rq_id),
                           self.jax.core.resource_map)
        return rqv_from_wire(wire, self.port_core.resource_map)

    def to_port(self, value):
        if value is self.jax.core:
            return self.port_core
        if value is self.jax.comm:
            return self.port_comm
        if value is self.jax.events:
            return self.port_events
        if value is self.jax.model:
            return self.port_model
        if isinstance(value, JaxTask):
            return self.port_core.tasks[value.task_id]
        if isinstance(value, JaxWorker):
            return self.port_core.workers[value.worker_id]
        return value

    # --- builders -------------------------------------------------------
    def worker(self, cpus=4, gpus=0, group="default", time_limit=0.0):
        w = self.jax.worker(cpus=cpus, gpus=gpus, group=group,
                            time_limit=time_limit)
        self._sync_names()
        config = PortConfiguration.from_wire(w.configuration.to_wire())
        pw = PortWorker.create(w.worker_id, config,
                               self.port_core.resource_map)
        # one clock for both lifetimes
        pw.started_at = w.started_at
        assert self.port_core.worker_id_counter.next() == w.worker_id
        port_reactor.on_new_worker(self.port_core, self.port_comm,
                                   self.port_events, pw)
        self.compare("worker")
        return w

    def rqv(self, *args, **kwargs):
        return self.jax.rqv(*args, **kwargs)

    def rq(self, *args, **kwargs):
        return self.jax.rq(*args, **kwargs)

    def submit(self, n=1, rqv=None, deps=(), priority=(0, 0), job=1,
               body=None, crash_limit=None):
        ids = self.jax.submit(n=n, rqv=rqv, deps=deps, priority=priority,
                              job=job, body=body, crash_limit=crash_limit)
        jax_rq = self.jax.core.tasks[ids[0]].rq_id
        rq_id = self.port_core.intern_rqv(self.port_rqv(jax_rq))
        assert rq_id == jax_rq
        extra = {} if crash_limit is None else {"crash_limit": crash_limit}
        tasks = [PortTask(task_id=tid, rq_id=rq_id, priority=priority,
                          deps=tuple(deps), body=body or {}, **extra)
                 for tid in ids]
        port_reactor.on_new_tasks(self.port_core, self.port_comm, tasks)
        self.compare("submit")
        return ids

    # --- actions --------------------------------------------------------
    def schedule(self, prefill: bool = False) -> int:
        n = self.jax.schedule(prefill=prefill)
        m = port_reactor.schedule(self.port_core, self.port_comm,
                                  self.port_events, self.port_model,
                                  prefill=prefill)
        self.port_core.sanity_check()
        assert n == m
        self.compare("schedule")
        return n

    def start_all_assigned(self, include_prefilled: bool = False):
        self.jax.start_all_assigned(include_prefilled=include_prefilled)
        from hyperqueue_tpu_torch.server.task import TaskState

        for task in list(self.port_core.tasks.values()):
            if task.state is TaskState.ASSIGNED and (
                include_prefilled or not task.prefilled
            ):
                port_reactor.on_task_running(
                    self.port_core, self.port_events, task.task_id,
                    task.instance_id)
        self.compare("start_all_assigned")

    def finish(self, task_id):
        self.jax.finish(task_id)
        port_reactor.on_task_finished(
            self.port_core, self.port_comm, self.port_events, task_id,
            self.port_core.tasks[task_id].instance_id)
        self.port_core.sanity_check()
        self.compare("finish")

    def fail(self, task_id, message="boom"):
        self.jax.fail(task_id, message)
        port_reactor.on_task_failed(
            self.port_core, self.port_comm, self.port_events, task_id,
            self.port_core.tasks[task_id].instance_id, message)
        self.port_core.sanity_check()
        self.compare("fail")

    def lose_worker(self, worker_id, clean=False):
        if clean:
            self.port_core.workers[worker_id].clean_stop = True
        self.jax.lose_worker(worker_id, clean=clean)
        port_reactor.on_remove_worker(
            self.port_core, self.port_comm, self.port_events, worker_id,
            "stopped" if clean else "connection lost")
        self.port_core.sanity_check()
        self.compare("lose_worker")

    def cancel(self, task_ids):
        out = self.jax.cancel(task_ids)
        assert port_reactor.on_cancel_tasks(
            self.port_core, self.port_comm, self.port_events,
            list(task_ids)) == out
        self.port_core.sanity_check()
        self.compare("cancel")
        return out

    def state(self, task_id):
        return self.jax.state(task_id)


class ReactorShim:
    """Stands in for the JAX reactor module inside a scenario: a function
    call runs on the JAX core, then on its twin's port core with every
    JAX-side argument swapped for its port counterpart, and the two are
    compared. Constants must be equal in both packages."""

    def __getattr__(self, name):
        jax_value = getattr(jax_reactor, name)
        port_value = getattr(port_reactor, name)
        if not callable(jax_value):
            assert jax_value == port_value, name
            return jax_value

        def call(core, *args, **kwargs):
            twin = TwinEnv.by_core[id(core)]
            out = jax_value(core, *args, **kwargs)
            port_out = port_value(
                twin.port_core, *(twin.to_port(a) for a in args),
                **{k: twin.to_port(v) for k, v in kwargs.items()})
            assert out == port_out, name
            twin.compare(name)
            return out

        return call


SHIM = ReactorShim()

# Scenarios that cannot run twinned, by name, each with its reason. None
# today: test_prefill.py's test_retract_response_not_ok_keeps_task writes
# `retract_pending` on the JAX task alone, and the next call (the ok=False
# answer) clears the flag on both sides, so the twins agree again.
EXCLUDED: dict[str, str] = {}


def _scenarios(module) -> list[str]:
    return sorted(name for name, fn in vars(module).items()
                  if name.startswith("test_") and callable(fn)
                  and name not in EXCLUDED)


def _run_twinned(module, name, monkeypatch, caplog) -> None:
    monkeypatch.setattr(module, "TestEnv", TwinEnv)
    if hasattr(module, "_TestEnv"):
        monkeypatch.setattr(module, "_TestEnv", TwinEnv)
    if hasattr(module, "reactor"):
        monkeypatch.setattr(module, "reactor", SHIM)
    monkeypatch.setattr(jax_server_pkg, "reactor", SHIM)
    TwinEnv.created, TwinEnv.by_core = [], {}
    try:
        getattr(module, name)()
        assert TwinEnv.created, f"{name} built no TestEnv"
        for twin in TwinEnv.created:
            twin.compare("end")
    finally:
        TwinEnv.created, TwinEnv.by_core = [], {}
    assert DECISION_LOG not in caplog.text


@pytest.mark.parametrize("name", _scenarios(test_reactor))
def test_reactor_scenario_twinned(name, monkeypatch, caplog):
    _run_twinned(test_reactor, name, monkeypatch, caplog)


@pytest.mark.parametrize("name", _scenarios(test_prefill))
def test_prefill_scenario_twinned(name, monkeypatch, caplog):
    _run_twinned(test_prefill, name, monkeypatch, caplog)


def test_every_scenario_is_twinned():
    # 39 + 25 scenarios when this was written; a new one joins by itself
    assert len(_scenarios(test_reactor)) + len(EXCLUDED) >= 39
    assert len(_scenarios(test_prefill)) >= 25


def test_shim_passes_constants():
    assert SHIM.PREFILL_MAX == port_reactor.PREFILL_MAX == 512
    assert SHIM.MAX_FUSED_GANG_ROWS == port_reactor.MAX_FUSED_GANG_ROWS


# --- fused and pipelined ticks over a dense snapshot -------------------------

POLICY_TABLE = dict(
    affinity={"cpus": {"*": 1.0, "fast": 2.0, "slow": 0.0},
              "nodes": {"*": 1.0, "slow": 0.0}},
    fairness_enabled=True, fairness_max_boost=2,
    prediction_enabled=True, prediction_max_boost=3,
)
GROUPS = ("fast", "slow", "mid", "mid")


def _policy_states():
    table = POLICY_TABLE
    out = []
    for pkg, predictor_cls, tbl in (
        (jax_policy, JaxPredictor, jax_policy.PolicyTable(**table)),
        (port_policy, RuntimePredictor, policy_table_from_plain(
            {"affinity": table["affinity"],
             "fairness": {"enabled": True, "max_boost": 2},
             "prediction": {"enabled": True, "max_boost": 3}})),
    ):
        predictor = predictor_cls()
        for job, runtime in ((1, 30.0), (2, 300.0), (3, 5.0)):
            predictor.observe(f"job{job}", runtime)
        out.append(pkg.PolicyState(tbl, predictor=predictor,
                                   job_name=lambda j: f"job{j}"))
    return out


def _fused_twin(seed, pipelined):
    """64 workers in 4 groups, 3 jobs of single-node tasks (one class with
    a gpu) and two gangs of 2-5 nodes each, above every single-node task,
    with fused_solve and the policy on both cores."""
    env = TwinEnv()
    rng = np.random.default_rng(seed)
    for i in range(64):
        env.worker(cpus=int(rng.choice([2, 4, 8])),
                   gpus=int(rng.choice([0, 0, 2])),
                   group=GROUPS[i * len(GROUPS) // 64])
    jax_state, port_state = _policy_states()
    env.jax.core.policy, env.port_core.policy = jax_state, port_state
    env.jax.core.fused_solve = env.port_core.fused_solve = True
    if pipelined:
        env.jax.core.tick_pipeline = JaxPipeline()
        env.port_core.tick_pipeline = TickPipeline()
        env.jax.core.paranoid_tick = env.port_core.paranoid_tick = 3
    env.jax.model = utils_env.GreedyCutScanModel(backend="numpy")
    env.compare("setup")
    for job in (1, 2, 3):
        for cpus, gpus in ((1, 0), (2, 0), (1, 1)):
            env.submit(n=int(rng.integers(20, 80)),
                       rqv=env.rqv(cpus=cpus, gpus=gpus),
                       priority=(int(rng.integers(0, 3)),
                                 encode_sched_priority(job)), job=job)
        for _ in range(2):
            env.submit(rqv=env.rqv(n_nodes=int(rng.integers(2, 6))),
                       priority=(3, encode_sched_priority(job)), job=job)
    return env, rng


def _step(env, rng) -> None:
    """The workers start their assigned tasks and a third of the running
    tasks finish."""
    env.start_all_assigned()
    running = sorted(t.task_id for t in env.jax.core.tasks.values()
                     if t.state.value == "running")
    for tid in running:
        if rng.random() < 1 / 3:
            env.finish(tid)


def shim_call(env, name, *args):
    """One reactor call (core, comm, *args) on both cores through the
    shim."""
    TwinEnv.by_core[id(env.jax.core)] = env
    return getattr(SHIM, name)(env.jax.core, env.jax.comm, *args)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("seed", range(2))
def test_fused_ticks_twinned(seed, pipelined, caplog):
    """Fused ticks (gang rows in the solve, the policy's boosts and
    exclusions) of both reactors, synchronous or pipelined with a paranoid
    tick every third; job 2 is paused before tick 3 and resumed before
    tick 5. Prefill stays off (as in TestEnv), so the queues keep a
    backlog for the pause to hold."""
    env, rng = _fused_twin(seed, pipelined)
    paused_entries = 0
    for tick in range(8):
        if tick == 3:
            held, _retracts = shim_call(env, "pause_jobs", [2])
            assert held > 0
        if tick == 5:
            assert shim_call(env, "resume_jobs", [2]) > 0
        sent = len(env.comm.compute)
        env.schedule()
        if tick in (3, 4):
            # the paused job places nothing and its held tasks are on the
            # tick's record
            assert not any(task_id_job(m["id"]) == 2
                           for _w, msgs in env.comm.compute[sent:]
                           for m in msgs)
            latest = env.jax.core.flight.latest()
            paused_entries += sum(
                1 for e in latest["unplaced"]
                if e["reason"] == "queue-paused" and e["job"] == 2)
        _step(env, rng)
    assert paused_entries == 2
    assert not env.jax.core.paused_held
    assert any("node_ids" in m for _w, msgs in env.comm.compute
               for m in msgs)
    env.compare("end")
    assert DECISION_LOG not in caplog.text
