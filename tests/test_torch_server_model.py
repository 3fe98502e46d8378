"""The port's server data model against the JAX package's: resource
descriptors in wire form, the worker configuration's wire form across the
packages both ways, the flight recorder, the per-task trace store (the
cases of tests/test_trace.py's store units, on both packages), the metrics
registry, the watchdog's reset_stats, Core.sanity_check, and the reactor's
import where msgpack is absent. All comparisons are exact.
"""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from hyperqueue_tpu.resources import descriptor as jax_descriptor
from hyperqueue_tpu.server import worker as jax_worker
from hyperqueue_tpu.transport import framing as jax_framing
from hyperqueue_tpu.utils import flight as jax_flight
from hyperqueue_tpu.utils import metrics as jax_metrics
from hyperqueue_tpu.utils import trace as jax_trace
from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
from hyperqueue_tpu_torch.server import worker as port_worker
from hyperqueue_tpu_torch.transport import framing as port_framing
from hyperqueue_tpu_torch.utils import flight as port_flight
from hyperqueue_tpu_torch.utils import metrics as port_metrics
from hyperqueue_tpu_torch.utils import trace as port_trace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKGS = {
    "jax": types.SimpleNamespace(
        d=jax_descriptor, w=jax_worker, flight=jax_flight, trace=jax_trace,
        metrics=jax_metrics, framing=jax_framing),
    "port": types.SimpleNamespace(
        d=port_descriptor, w=port_worker, flight=port_flight,
        trace=port_trace, metrics=port_metrics, framing=port_framing),
}


def both(scenario):
    out = {name: scenario(pkg) for name, pkg in PKGS.items()}
    assert out["jax"] == out["port"]
    return out["port"]


# --- resource descriptors ----------------------------------------------------

def _descriptor_dicts():
    return [
        {"items": [{"name": "cpus", "kind": "range", "range_start": 0,
                    "range_end": 15}]},
        {"items": [
            {"name": "cpus", "kind": "groups",
             "groups": [["0", "1"], ["2", "3"]]},
            {"name": "gpus", "kind": "groups", "groups": [["a"], ["b"]]},
            {"name": "mem", "kind": "sum", "sum_size": 4096},
            {"name": "disk", "kind": "list", "groups": [["x", "y", "z"]]}],
         "coupling": {"names": ["cpus", "gpus"], "weights": []}},
        {"items": [
            {"name": "cpus", "kind": "groups",
             "groups": [["0", "1"], ["2", "3"]]},
            {"name": "gpus", "kind": "groups", "groups": [["a"], ["b"]]}],
         "coupling": {"names": [],
                      "weights": [["gpus", 1, "cpus", 0, 128],
                                  ["cpus", 1, "gpus", 1, 256]]}},
        # the legacy plain name list
        {"items": [{"name": "cpus", "kind": "range", "range_start": 0,
                    "range_end": 3}], "coupling": ["cpus"]},
    ]


@pytest.mark.parametrize("index", range(4))
def test_descriptor_wire_round_trip_matches_jax(index):
    data = _descriptor_dicts()[index]

    def scenario(pkg):
        d = pkg.d.ResourceDescriptor.from_dict(data)
        d.validate()
        n_groups = {it.name: it.n_groups() for it in d.items}
        weights = ([
            (w.resource1, w.group1, w.resource2, w.group2, w.weight)
            for w in d.coupling.expand_weights(n_groups)]
            if d.coupling else None)
        return [d.to_dict(), weights,
                [(it.name, it.total_amount(), it.index_groups())
                 for it in d.items],
                pkg.d.ResourceDescriptor.from_dict(d.to_dict()) == d]

    out = both(scenario)
    assert out[3] is True
    # across the packages: the JAX descriptor's wire form builds the port's
    jax = jax_descriptor.ResourceDescriptor.from_dict(data)
    assert port_descriptor.ResourceDescriptor.from_dict(
        jax.to_dict()).to_dict() == jax.to_dict()


@pytest.mark.parametrize("data, message", [
    ({"items": [{"name": "cpus", "kind": "range", "range_start": 0,
                 "range_end": 1},
                {"name": "cpus", "kind": "sum", "sum_size": 1}]},
     "duplicate resource name"),
    ({"items": [{"name": "g", "kind": "groups", "groups": [["0"], ["0"]]}]},
     "duplicate index"),
    ({"items": [{"name": "g", "kind": "list", "groups": [[]]}]},
     "has no indices"),
    ({"items": [{"name": "r", "kind": "range", "range_start": 5,
                 "range_end": 2}]}, "empty range"),
    ({"items": [{"name": "m", "kind": "sum", "sum_size": 0}]},
     "zero size"),
    ({"items": [{"name": "cpus", "kind": "range", "range_start": 0,
                 "range_end": 1}], "coupling": ["gpus"]},
     "unknown resource"),
    ({"items": [{"name": "cpus", "kind": "groups", "groups": [["0"]]}],
      "coupling": {"weights": [["cpus", 3, "cpus", 0, 1]]}},
     "which has 1 groups"),
])
def test_descriptor_validate_matches_jax(data, message):
    def scenario(pkg):
        with pytest.raises(ValueError, match=message) as err:
            pkg.d.ResourceDescriptor.from_dict(data).validate()
        return str(err.value)

    both(scenario)


def test_descriptor_builders_match_jax():
    def scenario(pkg):
        item = pkg.d.ResourceDescriptorItem
        d = pkg.d.ResourceDescriptor(items=(
            item.group_list("gpus", [["0", "1"], ["2"]]),
            item.list("nics", ["eth0"]), item.sum("mem", 64),
        ))
        return [pkg.d.ResourceDescriptor.simple_cpus(8).to_dict(),
                d.to_dict(), d.item("mem").sum_size, d.item("none")]

    both(scenario)


# --- the worker configuration in wire form ---------------------------------

def _configuration(pkg):
    return pkg.w.WorkerConfiguration(
        descriptor=pkg.d.ResourceDescriptor.from_dict(
            _descriptor_dicts()[1]),
        hostname="node7", group="g2", heartbeat_secs=3.0,
        time_limit_secs=600.0, idle_timeout_secs=30.0,
        on_server_lost="reconnect", reconnect_timeout_secs=5.0,
        overview_interval_secs=1.5, min_utilization=0.5,
        listen_address="10.0.0.7:1234", manager="slurm",
        manager_job_id="42", alloc_id="a1", runner_pool=4,
        uplink_flush_secs=0.01, lent_from=3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_worker_configuration_wire_across_packages(direction):
    src, dst = ((PKGS["jax"], PKGS["port"]) if direction == "jax_to_port"
                else (PKGS["port"], PKGS["jax"]))
    wire = _configuration(src).to_wire()
    back = dst.w.WorkerConfiguration.from_wire(wire)
    assert back.to_wire() == wire
    assert back == _configuration(dst)
    # absent keys take the defaults on both sides
    minimal = {"descriptor": wire["descriptor"]}
    assert dst.w.WorkerConfiguration.from_wire(minimal).to_wire() == \
        src.w.WorkerConfiguration.from_wire(minimal).to_wire()


# --- the flight recorder and the trace store --------------------------------

def test_flight_recorder_matches_jax():
    def scenario(pkg):
        rec = pkg.flight.FlightRecorder(capacity_ticks=3, capacity_events=2)
        rec.record_tick({"tick": 1, "counts": {}})  # idle: dropped
        for tick in range(2, 7):
            rec.record_tick({"tick": tick, "counts": {"unplaced": 1},
                             "unplaced": [{"job": 1, "rq_id": 0,
                                           "reason": "insufficient-capacity",
                                           "count": 2}]})
        for i in range(3):
            rec.record_event("worker-new", {"worker": i})
        off = pkg.flight.FlightRecorder(capacity_ticks=0)
        off.record_tick({"tick": 1, "counts": {"assigned": 1}})
        events = [{k: v for k, v in e.items() if k != "time"}
                  for e in rec.events()]
        dump = rec.dump()
        dump.pop("events")
        return [rec.ticks(), events, rec.latest(), rec.reason_for(0, 1),
                rec.reason_for(None, 1), rec.reason_for(0, 2), dump,
                off.enabled, off.ticks()]

    out = both(scenario)
    assert out[3]["deferred_ticks"] == 3 and out[3]["deferred_capped"]


def test_trace_store_dedup_and_order():
    """tests/test_trace.py:31 on both packages."""

    def scenario(pkg):
        store = pkg.trace.TaskTraceStore(capacity=8)
        store.begin(1, "t1")
        a = store.span(1, "server/submit", 10.0, 11.0, "server")
        b = store.span(1, "server/queue", 11.0, 12.0, "server", parent=a)
        assert store.span(1, "server/queue", 99.0, 100.0, "server") == b
        rec = store.get(1)
        assert rec["trace_id"] == "t1"
        assert [s["name"] for s in rec["spans"]] == [
            "server/submit", "server/queue"]
        assert rec["spans"][1]["parent"] == a
        assert store.span(1, "server/queue", 20.0, 21.0, "server",
                          instance=1)
        assert len(store.get(1)["spans"]) == 3
        return [store.get(1), store.wire_ctx(1), store.stats()]

    both(scenario)


def test_trace_store_clock_skew_clamped():
    def scenario(pkg):
        store = pkg.trace.TaskTraceStore(capacity=4)
        store.begin(5, "t5")
        store.span(5, "server/dispatch", 100.0, 99.5, "server")
        s = store.get(5)["spans"][0]
        assert s["t1"] >= s["t0"]
        return store.get(5)

    both(scenario)


def test_trace_store_bounded_eviction_prefers_closed():
    def scenario(pkg):
        store = pkg.trace.TaskTraceStore(capacity=4)
        for tid in range(4):
            store.begin(tid, f"t{tid}")
        store.close(2)
        store.begin(100, "t100")
        assert store.get(2) is None and store.get(0) is not None
        assert store.evictions == 1
        store.begin(101, "t101")
        assert len(store) == 4
        return [store.stats(), [store.trace_id(t) for t in (0, 1, 3, 100)]]

    both(scenario)


def test_trace_store_seed_round_trip():
    def scenario(pkg):
        store = pkg.trace.TaskTraceStore(capacity=8)
        store.begin(7, "t7")
        store.span(7, "server/submit", 1.0, 2.0, "server")
        store.close(7)
        other = pkg.trace.TaskTraceStore(capacity=8)
        other.seed(7, store.get(7))
        assert other.get(7)["trace_id"] == "t7" and other.get(7)["done"]
        other.span(7, "server/submit", 1.0, 2.0, "server")
        assert len(other.get(7)["spans"]) == 1
        return other.get(7)

    both(scenario)


def test_trace_store_disabled_is_noop():
    def scenario(pkg):
        store = pkg.trace.TaskTraceStore(capacity=0)
        assert store.begin(1, "t") is None
        assert store.span(1, "x", 1.0, 2.0, "server") is None
        return [store.enabled, store.get(1), len(store)]

    both(scenario)


def test_trace_header_helpers_match_jax():
    def scenario(pkg):
        f = pkg.framing
        a = f.attach_trace({"op": "x"}, "t1", parent="s2", sent_at=1.5)
        b = f.attach_trace_wire({"id": 3}, "t9", None)
        return [a, b, f.read_trace(a), f.read_trace(b),
                f.read_trace({"trace": []}), f.read_trace({})]

    both(scenario)


def test_tracer_spans_and_metrics_registry_match_jax():
    """A private Tracer and registry on each side: the same spans and
    instruments render the same exposition text."""

    def scenario(pkg):
        reg = pkg.metrics.MetricsRegistry()
        c = reg.counter("hq_x_total", "x", labels=("kind",))
        g = reg.gauge("hq_y", "y")
        h = reg.histogram("hq_z_seconds", "z", labels=("phase",))
        c.labels("a").inc(3)
        c.labels(kind="b").inc()
        g.set(2.5)
        for v in (0.0002, 0.003, 0.2, 7.0, 30.0):
            h.labels("solve").observe(v)
        tracer = pkg.trace.Tracer()
        tracer.record("scheduler/solve", 0.002)
        tracer.record("scheduler/solve", 0.004)
        snap = reg.snapshot()
        text = reg.render()
        samples = reg.export_samples()
        reg.reset()
        return [text, snap, samples, reg.render(),
                tracer.snapshot(recent=2)]

    both(scenario)


# --- the watchdog, the core ------------------------------------------------

def test_watchdog_reset_stats_keeps_the_state_machine():
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    class Failing:
        device = torch.device("cpu")

        def solve(self, **kwargs):
            raise RuntimeError("boom")

    wd = SolverWatchdog(Failing(),
                        fallback=GreedyCutScanModel(device="cpu",
                                                    backend="numpy"),
                        rearm_ticks=3)
    wd.failures, wd.timeouts, wd.degraded_ticks = 2, 1, 4
    wd.rearms, wd.skipped_ticks = 1, 5
    wd._bench_remaining = 2
    wd.reset_stats()
    stats = wd.stats()
    assert (stats["failures"], stats["timeouts"], stats["degraded_ticks"],
            stats["rearms"], stats["skipped_ticks"]) == (0, 0, 0, 0, 0)
    assert stats["bench_remaining"] == 2 and not stats["armed"]


def test_core_sanity_check_catches_broken_invariants():
    from hyperqueue_tpu_torch.server.core import Core
    from hyperqueue_tpu_torch.server.protocol import rqv_from_wire
    from hyperqueue_tpu_torch.server.task import Task, TaskState
    from hyperqueue_tpu_torch.server.worker import (
        Worker,
        WorkerConfiguration,
    )

    core = Core()
    config = WorkerConfiguration(
        descriptor=port_descriptor.ResourceDescriptor.simple_cpus(2))
    w = Worker.create(1, config, core.resource_map)
    core.workers[1] = w
    rq = core.intern_rqv(rqv_from_wire({}, core.resource_map))
    task = Task(task_id=(1 << 32) + 1, rq_id=rq)
    core.tasks[task.task_id] = task
    task.state = TaskState.WAITING
    with pytest.raises(AssertionError, match="waiting without deps"):
        core.sanity_check()
    task.unfinished_deps = 1
    core.sanity_check()
    task.state = TaskState.ASSIGNED
    task.assigned_worker = 9
    with pytest.raises(AssertionError, match="assigned to no worker"):
        core.sanity_check()
    task.assigned_worker = 1
    w.prefilled_tasks.add(task.task_id)
    with pytest.raises(AssertionError, match="is not prefilled there"):
        core.sanity_check()
    task.prefilled = True
    core.sanity_check()
    w.free[0] = -1
    with pytest.raises(AssertionError, match=r"free\[0\] = -1"):
        core.sanity_check()
    w.free[0] = 0
    w.assigned_tasks.add(12345)
    with pytest.raises(AssertionError, match="assigned elsewhere"):
        core.sanity_check()
    w.assigned_tasks.discard(12345)
    core.sanity_check()


def test_core_binds_the_lazy_store_to_its_queues():
    from hyperqueue_tpu_torch.server.core import Core

    core = Core()
    assert core.queues.lazy is core.lazy
    assert core.queues._core is core


def test_reactor_imports_without_msgpack():
    """The port's reactor (and its framing helpers) import where msgpack is
    not installed: a fresh interpreter with msgpack blocked imports it and
    runs a tick."""
    code = """
import sys
sys.modules["msgpack"] = None
from hyperqueue_tpu_torch.server import reactor
from hyperqueue_tpu_torch.server.core import Core
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

class Comm:
    def send_compute(self, w, t): pass
    def ask_for_scheduling(self): pass
assert reactor.schedule(Core(), Comm(), None,
                        GreedyCutScanModel(device="cpu")) == 0
assert "msgpack" not in {m.split(".")[0] for m in sys.modules
                         if sys.modules[m] is not None}
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
