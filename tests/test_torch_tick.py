"""The slice as a whole: the port's scheduling tick against the JAX
package's, from identical state.

The JAX package's objects (interning maps, queues, worker rows) are exported
to plain data here, the port's state is built from that data with
`tick_state_from_plain`, and consecutive ticks run through both packages'
`run_tick`, the assignments applied to both sides' worker rows in between.
The assignment lists must be identical (tolerance 0).
"""

import types

import numpy as np
import pytest

import bench
from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu.resources.request import (
    AllocationPolicy,
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu.scheduler import policy as jax_policy
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler.predict import (
    RuntimePredictor as JaxPredictor,
)
from hyperqueue_tpu.scheduler.queues import TaskQueues, encode_sched_priority
from hyperqueue_tpu.scheduler.tick_cache import DenseSnapshot
from hyperqueue_tpu_torch.convert import (
    core_from_plain,
    group_ids,
    policy_table_from_plain,
    tick_state_from_plain,
)
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.scheduler import policy as port_policy
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor

U = 10_000
INF = 2**31 - 1


def export_plain(resource_map, rq_map, queues, workers,
                 min_utilization=None):
    """The JAX package's tick state as plain data (tick_state_from_plain's
    input). Queue order is read with take() and restored with add(), which
    keeps every level's FIFO order. `min_utilization` (worker id -> the
    JAX worker's configured min_utilization) adds the group ("default")
    and min_utilization fields to every row."""
    resources = resource_map.names()
    classes = [
        [
            {
                "entries": [
                    (resources[e.resource_id], e.amount, e.policy.value)
                    for e in variant.entries
                ],
                "n_nodes": variant.n_nodes,
                "min_time_secs": variant.min_time_secs,
                "weight": variant.weight,
            }
            for variant in rqv.variants
        ]
        for rqv in rq_map.all()
    ]
    tasks = []
    for rq_id, queue in queues.items():
        for priority, n in queue.priority_sizes():
            ids = queue.take(priority, n)
            for task_id in ids:
                queue.add(priority, task_id)
            tasks.extend((task_id, rq_id, priority) for task_id in ids)
    rows = [
        (w.worker_id, list(w.free), w.nt_free, w.lifetime_secs,
         None if w.total is None else list(w.total))
        for w in workers
    ]
    if min_utilization is not None:
        rows = [row + ("default", min_utilization.get(row[0], 0.0))
                for row in rows]
    return resources, classes, tasks, rows


def _apply(assignments, rows, rq_map):
    """Start the assigned tasks on the worker rows (either package's)."""
    by_id = {row.worker_id: row for row in rows}
    for _task, worker_id, rq_id, variant in assignments:
        row = by_id[worker_id]
        for e in rq_map.get_variants(rq_id).variants[variant].entries:
            if e.policy.value == "all":
                row.free[e.resource_id] = 0
            else:
                row.free[e.resource_id] -= e.amount
        row.nt_free -= 1


def _release(rows, totals, nt0, tick):
    """Completions: every third worker (rotating) is idle again."""
    for i, row in enumerate(rows):
        if i % 3 == tick % 3:
            row.free[:] = totals[i]
            row.nt_free = nt0[i]


def _run_both(jax_state, n_ticks, release=True):
    """Run `n_ticks` consecutive ticks through both packages; returns the
    per-tick assignment lists (asserted identical)."""
    resource_map, rq_map, queues, rows = jax_state
    plain = export_plain(resource_map, rq_map, queues, rows)
    p_resource_map, p_rq_map, p_queues, p_rows = tick_state_from_plain(*plain)
    assert p_resource_map.names() == resource_map.names()
    assert p_queues.total_ready() == queues.total_ready()
    totals = [list(row.total or row.free) for row in rows]
    nt0 = [row.nt_free for row in rows]
    jax_model = JaxModel(backend="numpy")
    port_model = GreedyCutScanModel(device="cpu", backend="device")
    out = []
    for t in range(n_ticks):
        phases = {}
        want = jax_tick.run_tick(queues, rows, rq_map, resource_map,
                                 jax_model)
        got = port_tick.run_tick(p_queues, p_rows, p_rq_map, p_resource_map,
                                 port_model, phases=phases)
        assert got == want, f"tick {t}"
        if got:
            assert set(phases) >= {"assemble", "solve_dispatch",
                                   "device_sync", "mapping"}
        _apply(want, rows, rq_map)
        _apply(got, p_rows, p_rq_map)
        if release:
            _release(rows, totals, nt0, t)
            _release(p_rows, totals, nt0, t)
        out.append(got)
    assert p_queues.total_ready() == queues.total_ready()
    return out


def test_build_tick_state_instance_three_ticks():
    queues, worker_rows, rq_map, resource_map, _prio = bench.build_tick_state(
        n_workers=64, n_tasks=20_000, n_classes=16
    )
    rows = [
        jax_tick.WorkerRow(worker_id=r.worker_id, free=list(r.free),
                           nt_free=r.nt_free, lifetime_secs=r.lifetime_secs,
                           total=list(r.free))
        for r in worker_rows()
    ]
    ticks = _run_both((resource_map, rq_map, queues, rows), n_ticks=3)
    assert all(len(t) > 0 for t in ticks)


def _golden_state(workers, classes, lifetimes=None, used=None, nt_free=64,
                  weights=None):
    """JAX-package objects for a golden case, in the notation of
    tests/test_scheduler_golden.py schedule_case: workers [cpus] or
    [(cpus, other...)]; classes [(priority, n_tasks, needs[, min_time])]
    with needs a cpu count, a per-resource tuple ("all" = ALL policy) or a
    list of such tuples (resource variants)."""
    def variants_of(needs):
        return needs if isinstance(needs, list) else [needs]

    def as_tuple(needs):
        return needs if isinstance(needs, tuple) else (needs,)

    n_r = max(
        [len(w) if isinstance(w, tuple) else 1 for w in workers]
        + [len(as_tuple(v)) for c in classes for v in variants_of(c[2])]
    )
    resource_map = ResourceIdMap()
    for r in range(n_r):
        resource_map.get_or_create(f"r{r}")
    rq_map = ResourceRqMap()
    queues = TaskQueues()
    next_id = 1
    for ci, cls in enumerate(classes):
        requests = []
        for needs in variants_of(cls[2]):
            entries = tuple(
                ResourceRequestEntry(r, 0, policy=AllocationPolicy.ALL)
                if a == "all" else ResourceRequestEntry(r, int(a * U))
                for r, a in enumerate(as_tuple(needs)) if a
            )
            requests.append(ResourceRequest(
                entries=entries,
                min_time_secs=float(cls[3]) if len(cls) > 3 else 0.0,
                weight=weights[ci] if weights else 1.0,
            ))
        rq_id = rq_map.get_or_create(
            ResourceRequestVariants(variants=tuple(requests))
        )
        for _ in range(cls[1]):
            queues.add(rq_id, (cls[0], 0), next_id)
            next_id += 1
    rows = []
    for i, w in enumerate(workers):
        amounts = w if isinstance(w, tuple) else (w,)
        total = [0] * n_r
        for r, a in enumerate(amounts):
            total[r] = a * U
        free = list(total)
        if used is not None:
            free[0] -= used[i] * U
        rows.append(jax_tick.WorkerRow(
            worker_id=i + 1, free=free, nt_free=nt_free,
            lifetime_secs=lifetimes[i] if lifetimes else INF, total=total,
        ))
    return resource_map, rq_map, queues, rows


# a handful of tests/test_scheduler_golden.py cases, with the per-class
# counts that file pins for the first tick
GOLDEN = {
    "priorities_higher_class_first": (
        dict(workers=[4, 4], classes=[(0, 2, 4), (1, 1, 2), (2, 1, 3)]),
        [0, 1, 1],
    ),
    "gap_filling_low_prio_fills_remainder": (
        dict(workers=[12], classes=[(1, 2, 8), (0, 1, 4)]), [1, 1],
    ),
    "multiple_resources_disjoint_classes": (
        dict(workers=[(4, 2), (4, 0)],
             classes=[(0, 2, (2, 1)), (0, 2, (4, 0))]),
        [2, 1],
    ),
    "time_request_selects_long_lived_worker": (
        dict(workers=[4, 4], classes=[(0, 2, 1, 600)],
             lifetimes=[100, INF]),
        [2],
    ),
    "all_policy_requires_idle_pool": (
        dict(workers=[8, 8], classes=[(0, 2, "all")], used=[3, 0]), [1],
    ),
    "resource_weights_joint_vs_all_policy": (
        dict(workers=[12], classes=[(0, 5, 3), (0, 1, "all")],
             weights=[1.1, 1.0]),
        [4, 0],
    ),
    "some_tasks_running": (
        dict(workers=[3, 3, 3], classes=[(0, 1, 2), (0, 1, 1), (0, 1, 3)],
             used=[1, 2, 3]),
        [1, 1, 0],
    ),
    "variants_fall_back_when_gpus_run_out": (
        dict(workers=[(14, 4)],
             classes=[(10, 10, [(8, 0), (4, 2)]), (0, 10, 1)]),
        None,
    ),
    "many_cuts_tail_merge": (
        dict(workers=[16, 16],
             classes=[(p, 1, 1 + p % 3) for p in range(50)]),
        None,
    ),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_cases_match(name):
    spec, pinned = GOLDEN[name]
    state = _golden_state(**spec)
    rq_map = state[1]
    first, *_ = _run_both(state, n_ticks=2)
    if pinned is not None:
        per_class = [0] * len(rq_map)
        for _t, _w, rq_id, _v in first:
            per_class[rq_id] += 1
        assert per_class == pinned


SMALL_PLAIN = (
    ["cpus"],
    [[{"entries": [("cpus", U, "compact")]}]],
    [(i, 0, (0, 0)) for i in range(4)],
    [(1, [4 * U], 4, INF, None)],
)


def _small_state():
    return tick_state_from_plain(*SMALL_PLAIN)


def _jax_small_state(min_utilization=0.0):
    """SMALL_PLAIN as the JAX package's objects, the worker's cpu_floor
    as the JAX Worker.cpu_floor gives it for `min_utilization`."""
    from hyperqueue_tpu.resources.descriptor import (
        ResourceDescriptor,
        ResourceDescriptorItem,
    )
    from hyperqueue_tpu.server.worker import Worker, WorkerConfiguration

    resource_map = ResourceIdMap()
    cpus = resource_map.get_or_create("cpus")
    rq_map = ResourceRqMap()
    rq = rq_map.get_or_create(ResourceRequestVariants.single(
        ResourceRequest(entries=(ResourceRequestEntry(cpus, U),))))
    queues = TaskQueues()
    for i in range(4):
        queues.add(rq, (0, 0), i)
    worker = Worker.create(1, WorkerConfiguration(
        descriptor=ResourceDescriptor(
            items=(ResourceDescriptorItem.sum("cpus", 4 * U),)),
        min_utilization=min_utilization), resource_map)
    rows = [jax_tick.WorkerRow(worker_id=1, free=[4 * U], nt_free=4,
                               lifetime_secs=INF,
                               cpu_floor=worker.cpu_floor())]
    return resource_map, rq_map, queues, rows


@pytest.mark.parametrize("option", ["dense", "pipeline"])
def test_unported_tick_options_raise(option):
    """A core with a min-utilization worker: its tick cache declines the
    snapshot, as the server's does, and the worker-rows tick it falls back
    to (with the pipeline passed too, which that path does not use, as in
    the JAX package) gives the JAX package's assignments: the floored
    worker's exact host search."""
    core = core_from_plain(*SMALL_PLAIN)
    for worker in core.workers.values():
        worker.configuration.min_utilization = 0.5
    core.bump_membership()
    snap = core.tick_cache.sync(core)
    assert snap is None
    j_resource_map, j_rq_map, j_queues, j_rows = _jax_small_state(0.5)
    assert [r.cpu_floor for r in core.worker_rows()] == \
        [r.cpu_floor for r in j_rows] == [2 * U]
    pipeline = TickPipeline()
    kwargs = {"dense": snap} if option == "dense" else {"pipeline": pipeline}
    got = port_tick.run_tick(core.queues, core.worker_rows(), core.rq_map,
                             core.resource_map,
                             GreedyCutScanModel(device="cpu"), **kwargs)
    want = jax_tick.run_tick(j_queues, j_rows, j_rq_map, j_resource_map,
                             JaxModel(backend="numpy"), **kwargs)
    assert got == want
    assert len(got) == 4
    assert pipeline.depth == 0
    assert core.queues.total_ready() == j_queues.total_ready() == 0


@pytest.mark.parametrize("option", ["dense", "pipeline"])
def test_dense_and_pipeline_options_match_worker_rows(option):
    """The tick over the core's dense snapshot (pipelined: dispatched, then
    mapped by take_result) gives the worker-rows tick's assignments."""
    resource_map, rq_map, queues, rows = _small_state()
    want = port_tick.run_tick(queues, rows, rq_map, resource_map,
                              GreedyCutScanModel(device="cpu",
                                                 backend="device"))
    assert len(want) == 4
    core = core_from_plain(*SMALL_PLAIN)
    snap = core.tick_cache.sync(core)
    model = GreedyCutScanModel(device="cpu", backend="device")
    args = (core.queues, None, core.rq_map, core.resource_map, model)
    if option == "dense":
        got = port_tick.run_tick(*args, dense=snap,
                                 key_cache=core.tick_cache)
    else:
        pipeline = TickPipeline()
        assert port_tick.run_tick(*args, dense=snap,
                                  pipeline=pipeline) == []
        assert pipeline.depth == 1
        got = pipeline.take_result(model=model)
    assert got == want


def test_min_utilization_workers_raise():
    """A floored worker beside the solve (its floor met or not, with and
    without a policy, whose rows the carve-out strips) gives the JAX
    package's assignments."""
    for floor in (U, 8 * U):
        for with_policy in (False, True):
            resource_map, rq_map, queues, rows = _small_state()
            j_resource_map, j_rq_map, j_queues, j_rows = _jax_small_state()
            rows[0].cpu_floor = j_rows[0].cpu_floor = floor
            kwargs, j_kwargs = {}, {}
            if with_policy:
                row = np.ones(1, np.float32)
                kwargs["policy"] = port_policy.TickPolicyContext({0: row},
                                                                 {})
                j_kwargs["policy"] = jax_policy.TickPolicyContext({0: row},
                                                                  {})
            got = port_tick.run_tick(
                queues, rows, rq_map, resource_map,
                GreedyCutScanModel(device="cpu", backend="device"), **kwargs)
            want = jax_tick.run_tick(j_queues, j_rows, j_rq_map,
                                     j_resource_map,
                                     JaxModel(backend="numpy"), **j_kwargs)
            assert got == want
            assert len(got) == (4 if floor <= 4 * U else 0)
            assert queues.total_ready() == j_queues.total_ready()


# -- the fused tick: gang batches, worker groups and a policy ---------------

def _dense(rows, n_r):
    """The JAX package's dense snapshot of worker rows over n_r resources
    (a row may lag the resource map): its run_tick hands gang_ok and
    group_ids to the solve on that path."""
    free = np.zeros((len(rows), n_r), np.int64)
    total = np.zeros((len(rows), n_r), np.int64)
    for i, r in enumerate(rows):
        free[i, :len(r.free)] = r.free
        src = r.total if r.total is not None else r.free
        total[i, :len(src)] = src
    return DenseSnapshot(
        worker_ids=[r.worker_id for r in rows], free=free, total=total,
        nt_free=np.array([max(r.nt_free, 0) for r in rows], np.int32),
        lifetime=np.array([r.lifetime_secs for r in rows], np.int32),
    )


def _apply_fused(assignments, rows, rq_map):
    """Start the assignments; a gang sentinel takes its worker whole."""
    by_id = {row.worker_id: row for row in rows}
    for _task, worker_id, rq_id, variant in assignments:
        row = by_id[worker_id]
        if variant < 0:
            row.free[:] = [0] * len(row.free)
            row.nt_free = 0
            continue
        for e in rq_map.get_variants(rq_id).variants[variant].entries:
            row.free[e.resource_id] -= e.amount
        row.nt_free -= 1


def _run_fused(jax_state, groups, n_ticks, gangs=(), table=None,
               predictor_feed=(), ledger=None, job_names=None,
               jax_policy_ctx=None, port_policy_ctx=None):
    """Run `n_ticks` fused ticks through both packages: the JAX run_tick on
    a dense snapshot, the port's on its worker rows, with the same gang
    batches (gangs: (gang_task, rq_id, priority, n_nodes)), idleness,
    groups and policy. Returns the per-tick assignment lists (asserted
    identical)."""
    resource_map, rq_map, queues, rows = jax_state
    resources, classes, tasks, plain_rows = export_plain(*jax_state)
    plain_rows = [r + (g,) for r, g in zip(plain_rows, groups)]
    p_resource_map, p_rq_map, p_queues, p_rows = tick_state_from_plain(
        resources, classes, tasks, plain_rows)
    totals = [list(row.total or row.free) for row in rows]
    nt0 = [row.nt_free for row in rows]
    gids = group_ids(p_rows)
    jax_model = JaxModel(backend="numpy")
    port_model = GreedyCutScanModel(device="cpu", backend="device")
    states = None
    if table is not None:
        states = []
        for pkg, predictor_cls, tbl in (
            (jax_policy, JaxPredictor,
             jax_policy.PolicyTable(**table)),
            (port_policy, RuntimePredictor, policy_table_from_plain(
                {"affinity": table.get("affinity", {}),
                 "fairness": {
                     "enabled": table.get("fairness_enabled", False),
                     "max_boost": table.get("fairness_max_boost", 4)},
                 "prediction": {
                     "enabled": table.get("prediction_enabled", False),
                     "max_boost": table.get("prediction_max_boost", 4)}})),
        ):
            predictor = predictor_cls()
            for label, runtime in predictor_feed:
                predictor.observe(label, runtime)
            states.append(pkg.PolicyState(
                tbl, predictor=predictor, ledger=ledger,
                job_name=(job_names or {}).get))
    pending = list(gangs)
    out = []
    for t in range(n_ticks):
        idle = np.array([
            row.free == totals[i] and row.nt_free == nt0[i]
            for i, row in enumerate(rows)
        ], np.int32)
        j_batches = jax_tick.create_batches(queues) + [
            jax_tick.Batch(rq_id=rq, priority=prio, size=1, gang_task=task,
                           gang_nodes=n) for task, rq, prio, n in pending]
        p_batches = port_tick.create_batches(p_queues) + [
            port_tick.Batch(rq_id=rq, priority=prio, size=1, gang_task=task,
                            gang_nodes=n) for task, rq, prio, n in pending]
        j_ctx, p_ctx = jax_policy_ctx, port_policy_ctx
        if states is not None:
            wids = [r.worker_id for r in rows]
            j_ctx = states[0].tick_context(
                {r.worker_id: types.SimpleNamespace(group=r.group)
                 for r in p_rows},
                rq_map, resource_map, wids, j_batches)
            p_ctx = states[1].tick_context(
                {r.worker_id: r for r in p_rows}, p_rq_map, p_resource_map,
                wids, p_batches)
            assert (j_ctx is None) == (p_ctx is None)
            if j_ctx is not None:
                assert p_ctx.boosts == j_ctx.boosts
                assert sorted(p_ctx.rows) == sorted(j_ctx.rows)
                for rq in j_ctx.rows:
                    np.testing.assert_array_equal(p_ctx.rows[rq],
                                                  j_ctx.rows[rq])
        fused = dict(gang_ok=idle, group_ids=gids) if pending else {}
        want = jax_tick.run_tick(
            queues, None, rq_map, resource_map, jax_model, batches=j_batches,
            dense=_dense(rows, len(resource_map)), policy=j_ctx, **fused)
        got = port_tick.run_tick(
            p_queues, p_rows, p_rq_map, p_resource_map, port_model,
            batches=p_batches, policy=p_ctx, **fused)
        assert got == want, f"tick {t}"
        placed = {task for task, _w, _rq, v in got if v < 0}
        pending = [g for g in pending if g[0] not in placed]
        _apply_fused(want, rows, rq_map)
        _apply_fused(got, p_rows, p_rq_map)
        _release(rows, totals, nt0, t)
        _release(p_rows, totals, nt0, t)
        out.append(got)
    assert p_queues.total_ready() == queues.total_ready()
    return out


def _jobs_state(seed, n_workers=12):
    """Three jobs over 1-cpu, 2-cpu+gpu and 4-cpu (with a 2-cpu fallback)
    classes, plus two gang classes, on workers of 4 or 8 cpus, some with
    gpus; returns the JAX state, the gang classes' rq ids and the jobs'
    scheduler priorities."""
    rng = np.random.default_rng(seed)
    resource_map = ResourceIdMap()
    cpus = resource_map.get_or_create("cpus")
    gpus = resource_map.get_or_create("gpus")
    rq_map = ResourceRqMap()

    def rq(*variants, n_nodes=0):
        return rq_map.get_or_create(ResourceRequestVariants(variants=tuple(
            ResourceRequest(entries=tuple(
                ResourceRequestEntry(r, a) for r, a in v), n_nodes=n_nodes)
            for v in variants)))

    plain = [rq([(cpus, U)]), rq([(cpus, 2 * U), (gpus, U)]),
             rq([(cpus, 4 * U)], [(cpus, 2 * U)])]
    gang_rqs = [rq([], n_nodes=2), rq([], n_nodes=3)]
    queues = TaskQueues()
    sched = {job: encode_sched_priority(job) for job in (1, 2, 3)}
    task_id = 1
    for job in (1, 2, 3):
        for cls in plain:
            for _ in range(int(rng.integers(2, 12))):
                queues.add(cls, (int(rng.integers(0, 2)), sched[job]),
                           task_id)
                task_id += 1
    rows = []
    for i in range(n_workers):
        total = [int(rng.choice([4, 8])) * U,
                 int(rng.choice([0, 0, 2])) * U]
        rows.append(jax_tick.WorkerRow(
            worker_id=i + 1, free=list(total), nt_free=8,
            lifetime_secs=INF, total=total))
    return (resource_map, rq_map, queues, rows), gang_rqs, sched


POLICY_TABLE = dict(
    affinity={"cpus": {"*": 1.0, "fast": 2.0, "slow": 0.0},
              "cpus+gpus": {"fast": 0.5},
              "nodes": {"*": 1.0, "slow": 0.0}},
    fairness_enabled=True, fairness_max_boost=2,
    prediction_enabled=True, prediction_max_boost=3,
)


@pytest.mark.parametrize("seed", range(3))
def test_fused_ticks_match_jax(seed):
    state, gang_rqs, sched = _jobs_state(seed)
    groups = ["fast", "slow", "mid"] * 4
    gangs = [(9001, gang_rqs[0], (1, sched[1]), 2),
             (9002, gang_rqs[1], (0, sched[2]), 3),
             (9003, gang_rqs[0], (0, sched[3]), 2),
             (9004, gang_rqs[1], (1, sched[3]), 3)]
    ledger = types.SimpleNamespace(
        rows={1: {"label": "a", "resource_seconds": {"cpus": 50.0}},
              2: {"label": "b", "resource_seconds": {"cpus": 5.0}},
              3: {"label": "c", "resource_seconds": {}}},
        open_runs={})
    ticks = _run_fused(state, groups, 4, gangs=gangs, table=POLICY_TABLE,
                       predictor_feed=[("a", 5.0), ("b", 30.0), ("c", 12.0)],
                       ledger=ledger, job_names={1: "a", 2: "b", 3: "c"})
    sentinels = [a for tick in ticks for a in tick if a[3] < 0]
    assert sentinels, "no gang was placed"
    by_task: dict = {}
    for task, worker, _rq, _v in sentinels:
        by_task.setdefault(task, []).append(worker)
    for task, workers in by_task.items():
        # all-or-nothing on one group, never on the excluded "slow" group
        assert len(workers) == {9001: 2, 9002: 3, 9003: 2, 9004: 3}[task]
        assert len({groups[w - 1] for w in workers}) == 1
        assert all(groups[w - 1] != "slow" for w in workers)
    one_cpu = 0  # rq id of the "cpus" class, which excludes "slow"
    for tick in ticks:
        for _task, worker, rq_id, variant in tick:
            if variant >= 0 and rq_id == one_cpu:
                assert groups[worker - 1] != "slow"


def _two_jobs_state(n_workers=1):
    """tests/test_scheduler_golden.py _policy_tick_case: two 4-task jobs at
    the same user priority over n 4-cpu workers."""
    resource_map = ResourceIdMap()
    cpus = resource_map.get_or_create("cpus")
    rq_map = ResourceRqMap()
    rq = rq_map.get_or_create(ResourceRequestVariants.single(
        ResourceRequest(entries=(ResourceRequestEntry(cpus, U),))))
    queues = TaskQueues()
    for t in range(1, 5):
        queues.add(rq, (0, encode_sched_priority(1)), t)
    for t in range(101, 105):
        queues.add(rq, (0, encode_sched_priority(2)), t)
    rows = [jax_tick.WorkerRow(worker_id=i + 1, free=[4 * U], nt_free=8,
                               lifetime_secs=INF)
            for i in range(n_workers)]
    return resource_map, rq_map, queues, rows


def test_policy_boost_reorders_jobs_in_tick():
    flat, = _run_fused(_two_jobs_state(), ["default"], 1)
    assert sorted(t for t, *_ in flat) == [1, 2, 3, 4]
    boosted, = _run_fused(
        _two_jobs_state(), ["default"], 1,
        jax_policy_ctx=jax_policy.TickPolicyContext({}, {2: 2}),
        port_policy_ctx=port_policy.TickPolicyContext({}, {2: 2}))
    assert sorted(t for t, *_ in boosted) == [101, 102, 103, 104]


def _spread_state(n_workers, n_tasks):
    """tests/test_solver.py's affinity cases: equal 4-cpu workers, 1-cpu
    tasks of one class."""
    spec = dict(workers=[4] * n_workers, classes=[(0, n_tasks, 1)],
                nt_free=8)
    return _golden_state(**spec)


def test_zero_weight_excludes_in_tick():
    row = np.asarray([0.0, 1.0], np.float32)
    got, = _run_fused(
        _spread_state(2, 8), ["default"] * 2, 1,
        jax_policy_ctx=jax_policy.TickPolicyContext({0: row}, {}),
        port_policy_ctx=port_policy.TickPolicyContext({0: row}, {}))
    assert [w for _t, w, *_ in got] == [2] * 4


def test_affinity_reorders_water_fill_in_tick():
    row = np.asarray([1.0, 3.0, 2.0], np.float32)
    got, = _run_fused(
        _spread_state(3, 6), ["default"] * 3, 1,
        jax_policy_ctx=jax_policy.TickPolicyContext({0: row}, {}),
        port_policy_ctx=port_policy.TickPolicyContext({0: row}, {}))
    per_worker = [sum(1 for _t, w, *_ in got if w == i) for i in (1, 2, 3)]
    assert per_worker == [0, 4, 2]


def test_gang_batches_emit_sentinels_and_leave_queues():
    state, gang_rqs, sched = _jobs_state(5, n_workers=6)
    groups = ["a", "a", "b", "b", "b", "c"]
    ready = state[2].total_ready()
    ticks = _run_fused(
        state, groups, 2,
        gangs=[(7001, gang_rqs[1], (2, sched[1]), 3),
               (7002, gang_rqs[0], (2, sched[2]), 2)])
    sentinels = [a for a in ticks[0] if a[3] < 0]
    # both gangs outrank every queue (user priority 2): the 3-node gang
    # takes group b whole, the 2-node gang group a
    assert sorted((t, w) for t, w, _rq, _v in sentinels) == [
        (7001, 3), (7001, 4), (7001, 5), (7002, 1), (7002, 2)]
    assert all(rq in gang_rqs for _t, _w, rq, _v in sentinels)
    # placed gangs are not offered again, and only ordinary cells pop tasks
    assert not [a for a in ticks[1] if a[3] < 0]
    popped = sum(1 for tick in ticks for a in tick if a[3] >= 0)
    assert state[2].total_ready() == ready - popped


def test_tick_state_from_plain_rejects_inconsistent_ids():
    with pytest.raises(ValueError, match="not at id"):
        tick_state_from_plain(["gpus", "cpus"], [], [], [])
    cls = [{"entries": [("cpus", U, "compact")]}]
    with pytest.raises(ValueError, match="duplicates"):
        tick_state_from_plain(["cpus"], [cls, cls], [], [])


def test_create_batches_and_compression_match_jax():
    queues_j = TaskQueues()
    for p in range(50):
        queues_j.add(1, (p % 7, -p), 1000 + p)
        queues_j.add(2, (p % 3, 0), 2000 + p)
    plain = export_plain(ResourceIdMap(), ResourceRqMap(), queues_j, [])
    _rm, _qm, queues_p, _rows = tick_state_from_plain(*plain)
    want = [(b.rq_id, b.priority, b.size)
            for b in jax_tick.create_batches(queues_j)]
    got = [(b.rq_id, b.priority, b.size)
           for b in port_tick.create_batches(queues_p)]
    assert got == want
    rng = np.random.default_rng(3)
    needs = rng.integers(0, 2**26, size=(4, 2, 3))
    free = rng.integers(-5, 2**27, size=(6, 3))
    total = free + rng.integers(0, 2, size=(6, 3))
    arrays = [(needs.copy(), free.copy(), total.copy()) for _ in range(2)]
    assert (jax_tick._range_compress(*arrays[0])
            == port_tick._range_compress(*arrays[1]))
    for a, b in zip(*arrays):
        np.testing.assert_array_equal(a, b)
