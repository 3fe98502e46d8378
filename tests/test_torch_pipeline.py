"""The port's pipelined tick (scheduler/pipeline.py) and the watchdog's
async handles, against the synchronous tick and the JAX package.

Contracts pinned here, tolerance 0:

- a dispatched solve maps to exactly the assignments the synchronous tick
  produces from the same snapshot (and the JAX synchronous tick);
- over many ticks in the server's order (take_result, then the tick
  cache's sync, then dispatch) the pipelined run maps, one tick late, the
  synchronous run's assignment lists, and the device residency uploads
  only dirty rows and is never invalidated;
- the watchdog resolves a failing pending handle through its fallback, and
  a benched watchdog hands back a ready handle.
"""

import numpy as np
import pytest

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.scheduler import pipeline as jax_pipeline
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu_torch.convert import core_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
from hyperqueue_tpu_torch.scheduler.tick import create_batches, run_tick
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.utils.constants import INF_TIME

from test_torch_tick_cache import Twin

U = 10_000


def _plain(seed, n_workers=6, n_tasks=60):
    rng = np.random.default_rng(seed)
    classes = [
        [{"entries": [("cpus", U, "compact")]}],
        [{"entries": [("cpus", 2 * U, "compact"), ("gpus", U, "compact")]},
         {"entries": [("cpus", 4 * U, "compact")]}],
        [{"entries": [("cpus", U, "compact"), ("mem", 4 * U, "compact")]}],
    ]
    tasks = [(t, int(rng.integers(0, 3)), (int(rng.integers(0, 3)), 0))
             for t in range(1, n_tasks + 1)]
    workers = []
    for wid in range(1, n_workers + 1):
        free = [int(rng.choice([2, 4, 8])) * U, int(rng.choice([0, 2])) * U,
                16 * U]
        workers.append((wid, free, int(free[0] // U), INF_TIME, None))
    return ["cpus", "gpus", "mem"], classes, tasks, workers


def _start(core, assignments, running, solve_tick):
    for task, wid, rq_id, variant in assignments:
        w = core.workers[wid]
        w.assign(task, core.variant_amounts(rq_id, variant, w))
        running[task] = (wid, rq_id, variant, solve_tick)


def _finish_some(core, running, rng, before_tick):
    """A seeded third of the tasks that solves before `before_tick`
    started finish (the same tasks on two cores in lock-step)."""
    done = sorted(t for t, r in running.items() if r[3] < before_tick)
    for i in rng.choice(len(done), size=len(done) // 3, replace=False):
        wid, rq_id, variant, _tick = running.pop(done[i])
        w = core.workers[wid]
        w.unassign(done[i], core.variant_amounts(rq_id, variant, w))


def test_pipelined_dispatch_then_map_equals_sync_and_jax():
    twin = Twin()
    for cpus in (4, 4, 8):
        twin.join(cpus=cpus)
    twin.submit(n=20, cpus=1, gpus=0, priority=(0, 0))
    twin.submit(n=6, cpus=2, gpus=0, priority=(1, 0))
    jax_snap = twin.jax.tick_cache.sync(twin.jax)
    want = jax_tick.run_tick(
        twin.jax.queues, None, twin.jax.rq_map, twin.jax.resource_map,
        JaxModel(backend="numpy"), dense=jax_snap)
    assert want
    core = twin.port
    snap = core.tick_cache.sync(core)
    model = GreedyCutScanModel(device="cpu", backend="device")
    pipeline = TickPipeline()
    out = run_tick(core.queues, None, core.rq_map, core.resource_map, model,
                   batches=create_batches(core.queues), dense=snap,
                   pipeline=pipeline)
    assert out == [] and pipeline.depth == 1
    with pytest.raises(AssertionError, match="depth is 1"):
        pipeline.put(pipeline.pending)
    mapped = pipeline.take_result(model=model)
    assert pipeline.depth == 0
    assert mapped == [tuple(a) for a in want]
    assert pipeline.stats() == {"depth": 0, "dispatched": 1, "mapped": 1,
                                "drains": 0,
                                "last_wait_ms": pipeline.stats()[
                                    "last_wait_ms"]}
    assert set(pipeline.stats()) == set(jax_pipeline.TickPipeline().stats())


@pytest.mark.parametrize("seed", range(3))
def test_pipelined_run_maps_the_sync_run_one_tick_late(seed):
    """Two cores from one seed: one ticks synchronously, the other in the
    server's pipelined order. Between ticks the same tasks finish on both
    (tasks of solves before the last one, which the pipelined core has not
    mapped yet). The pipelined core maps at tick k what the synchronous
    core assigned at tick k-1; its residency takes dirty-row uploads
    only."""
    sync_core = core_from_plain(*_plain(seed))
    pipe_core = core_from_plain(*_plain(seed))
    sync_model = GreedyCutScanModel(device="cpu", backend="device")
    pipe_model = GreedyCutScanModel(device="cpu", backend="device")
    pipeline = TickPipeline()
    pipe_core.tick_pipeline = pipeline
    rng_s, rng_p = (np.random.default_rng(seed + 50) for _ in range(2))
    run_s, run_p = {}, {}
    sync_lists = []
    for tick in range(8):
        phases = {}
        # the server's order: map the pending solve, then sync, dispatch
        mapped = pipeline.take_result(model=pipe_model, phases=phases)
        _start(pipe_core, mapped, run_p, tick - 1)
        if tick:
            assert mapped == sync_lists[-1], f"tick {tick}"
            assert "pipeline_wait" in phases
        snap = pipe_core.tick_cache.sync(pipe_core)
        assert run_tick(pipe_core.queues, None, pipe_core.rq_map,
                        pipe_core.resource_map, pipe_model, dense=snap,
                        key_cache=pipe_core.tick_cache, pipeline=pipeline,
                        phases=phases) == []
        s_snap = sync_core.tick_cache.sync(sync_core)
        got = run_tick(sync_core.queues, None, sync_core.rq_map,
                       sync_core.resource_map, sync_model, dense=s_snap,
                       key_cache=sync_core.tick_cache)
        sync_lists.append(got)
        _start(sync_core, got, run_s, tick)
        _finish_some(sync_core, run_s, rng_s, tick)
        _finish_some(pipe_core, run_p, rng_p, tick)
    assert sum(map(len, sync_lists)) > 20
    stats = pipe_model.resident_stats()
    assert stats["invalidations"] == 0
    # a tick that dirties more than half the rows uploads in full
    assert stats["delta_uploads"] >= 1
    assert pipe_core.tick_cache.full_rebuilds == 1


def test_decision_records_match_jax_keys():
    twin = Twin()
    twin.join(cpus=4)
    twin.submit(n=3, cpus=1, gpus=0, priority=(0, 0))
    jax_decision, port_decision = {}, {}
    jax_tick.run_tick(
        twin.jax.queues, None, twin.jax.rq_map, twin.jax.resource_map,
        JaxModel(backend="numpy"), dense=twin.jax.tick_cache.sync(twin.jax),
        decision=jax_decision)
    model = GreedyCutScanModel(device="cpu", backend="numpy")
    run_tick(twin.port.queues, None, twin.port.rq_map,
             twin.port.resource_map, model,
             dense=twin.port.tick_cache.sync(twin.port),
             decision=port_decision)
    assert set(port_decision["solver"]) == set(jax_decision["solver"])
    assert port_decision["solver"]["status"] == "ok"
    assert port_decision["solver"]["objective"] == \
        jax_decision["solver"]["objective"] == 3
    assert port_decision["solver"]["backend_reason"] == "forced-numpy"
    # pipelined: the dispatch records "pipelined", the map the verdict
    twin.submit(n=2, cpus=1, gpus=0, priority=(0, 0))
    for core in (twin.jax, twin.port):
        w = core.workers[1]
        w.unassign(0, [(0, 3 * U)])
    pipeline, dispatch, mapped = TickPipeline(), {}, {}
    run_tick(twin.port.queues, None, twin.port.rq_map,
             twin.port.resource_map, model,
             dense=twin.port.tick_cache.sync(twin.port), pipeline=pipeline,
             decision=dispatch)
    assert dispatch["solver"]["status"] == "pipelined"
    pipeline.take_result(model=model, decision=mapped)
    assert mapped["solver"]["pipelined"] and mapped["solver"]["status"] == "ok"
    assert mapped["solver"]["objective"] == 2


class _ExplodingHandle:
    def result(self):
        raise RuntimeError("device readback exploded")


def test_watchdog_resolves_failing_pending_handle_via_fallback():
    core = core_from_plain(*_plain(3))
    primary = GreedyCutScanModel(device="cpu", backend="device")
    invalidated = []
    primary.invalidate_resident = lambda: invalidated.append(True)
    primary.solve_async = lambda **kw: _ExplodingHandle()
    watchdog = SolverWatchdog(primary, timeout_s=5.0, rearm_ticks=2)
    reference = core_from_plain(*_plain(3))
    want = run_tick(reference.queues, None, reference.rq_map,
                    reference.resource_map,
                    GreedyCutScanModel(device="cpu", backend="numpy"),
                    dense=reference.tick_cache.sync(reference))
    pipeline = TickPipeline()
    run_tick(core.queues, None, core.rq_map, core.resource_map, watchdog,
             dense=core.tick_cache.sync(core), pipeline=pipeline)
    got = pipeline.take_result(model=watchdog)
    assert got == want and got
    assert watchdog.failures == 1 and not watchdog.armed
    assert invalidated
    assert watchdog.last_solve_degraded


def test_benched_watchdog_returns_ready_fallback_handle():
    core = core_from_plain(*_plain(4))
    watchdog = SolverWatchdog(
        GreedyCutScanModel(device="cpu", backend="device"),
        timeout_s=0.0, rearm_ticks=3)
    watchdog._bench_remaining = 3
    pipeline = TickPipeline()
    run_tick(core.queues, None, core.rq_map, core.resource_map, watchdog,
             dense=core.tick_cache.sync(core), pipeline=pipeline)
    assert type(pipeline.pending.handle).__name__ == "_ReadyHandle"
    assert pipeline.take_result(model=watchdog)
    assert watchdog.degraded_ticks == 1 and watchdog._bench_remaining == 2


def test_canceled_task_pops_short_harmlessly():
    core = core_from_plain(["cpus"], [[{"entries": [("cpus", U, "compact")]}]],
                           [(t, 0, (0, 0)) for t in range(1, 5)],
                           [(1, [8 * U], 8, INF_TIME, None)])
    model = GreedyCutScanModel(device="cpu", backend="device")
    pipeline = TickPipeline()
    run_tick(core.queues, None, core.rq_map, core.resource_map, model,
             dense=core.tick_cache.sync(core), pipeline=pipeline)
    core.queues.remove(0, 2)  # canceled while its solve is in flight
    mapped = pipeline.drain(model=model)
    assert [a[0] for a in mapped] == [1, 3, 4]
    assert pipeline.drains == 1
