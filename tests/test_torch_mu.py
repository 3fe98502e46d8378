"""Min-utilization workers: the port's run_tick against the JAX package's,
from identical state (exact). Under the greedy models the floored workers
are carved out of the main solve and each gets the exact host search
(_solve_mu_workers); the assignments, their order included, must be the
JAX package's."""

import logging

import numpy as np
import pytest
import torch

import bench
from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources.descriptor import (
    ResourceDescriptor as JaxDescriptor,
    ResourceDescriptorItem as JaxItem,
)
from hyperqueue_tpu.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu.resources.request import (
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu.scheduler import policy as jax_policy
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler.queues import TaskQueues, encode_sched_priority
from hyperqueue_tpu.server.worker import (
    Worker as JaxWorker,
    WorkerConfiguration as JaxConfiguration,
)
from hyperqueue_tpu_torch.convert import group_ids, tick_state_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.models.multichip import MultichipModel
from hyperqueue_tpu_torch.scheduler import policy as port_policy
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.server.worker import cpu_floor
from test_torch_tick import (
    _apply,
    _apply_fused,
    _dense,
    _jobs_state,
    _release,
    export_plain,
)

# one intra-op thread per process (see tests/test_torch_imports.py)
torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1


def jax_floor(total, free, mu):
    """The JAX package's Worker.cpu_floor for a worker of `total` with
    `free` left and min_utilization `mu`."""
    names = ["cpus", "gpus", "mem"][:len(total)]
    rmap = ResourceIdMap()
    for name in names:
        rmap.get_or_create(name)
    items = tuple(JaxItem.sum(n, int(a)) for n, a in zip(names, total) if a)
    worker = JaxWorker.create(
        1, JaxConfiguration(descriptor=JaxDescriptor(items=items),
                            min_utilization=mu), rmap)
    worker.free = list(free)
    return worker.cpu_floor()


def mu_state(seed, n_workers=10, n_floored=3, weighted=False, n_jobs=3):
    """JAX-package objects: cpu/gpu/mem classes (some with a fallback
    variant, some weighted), tasks of `n_jobs` jobs at three user
    priorities, and workers of 4-16 cpus, some busy or short-lived, the
    first `n_floored` with min_utilization 0.5, 0.75 or 1.0. Returns the
    state and the workers' min_utilization by id."""
    rng = np.random.default_rng(seed)
    resource_map = ResourceIdMap()
    for name in ("cpus", "gpus", "mem"):
        resource_map.get_or_create(name)
    rq_map = ResourceRqMap()
    rq_ids = []
    for _ in range(6):
        cpus = int(rng.choice([1, 2, 3, 4]))
        entries = [ResourceRequestEntry(0, cpus * U)]
        if rng.random() < 0.3:
            entries.append(ResourceRequestEntry(1, U))
        if rng.random() < 0.5:
            entries.append(ResourceRequestEntry(2, int(rng.integers(1, 4))
                                                * U))
        weight = float(rng.choice([1.0, 2.5])) if weighted else 1.0
        variants = [ResourceRequest(entries=tuple(entries), weight=weight,
                                    min_time_secs=float(rng.choice(
                                        [0, 0, 0, 300])))]
        if rng.random() < 0.4:
            variants.append(ResourceRequest(
                entries=(ResourceRequestEntry(0, 2 * cpus * U),),
                weight=weight))
        rq_ids.append(rq_map.get_or_create(
            ResourceRequestVariants(variants=tuple(variants))))
    queues = TaskQueues()
    sched = [encode_sched_priority(j) for j in range(1, n_jobs + 1)]
    for tid in range(1, int(rng.integers(60, 160))):
        queues.add(rq_ids[int(rng.integers(0, len(rq_ids)))],
                   (int(rng.integers(0, 3)),
                    sched[int(rng.integers(0, n_jobs))]), tid)
    rows, mus = [], {}
    for i in range(n_workers):
        total = [int(rng.choice([4, 8, 16])) * U,
                 int(rng.choice([0, 0, 2])) * U,
                 int(rng.choice([4, 8])) * U]
        free = list(total)
        if rng.random() < 0.3:
            free[0] -= int(rng.integers(1, 4)) * U
        mu = float(rng.choice([0.5, 0.75, 1.0])) if i < n_floored else 0.0
        mus[i + 1] = mu
        rows.append(jax_tick.WorkerRow(
            worker_id=i + 1, free=free, nt_free=int(rng.integers(2, 12)),
            lifetime_secs=int(rng.choice([INF, INF, 120])), total=total,
            cpu_floor=jax_floor(total, free, mu)))
    return (resource_map, rq_map, queues, rows), mus


def port_state(jax_state, mus):
    plain = export_plain(*jax_state, min_utilization=mus)
    state = tick_state_from_plain(*plain)
    assert ([r.cpu_floor for r in state[3]]
            == [r.cpu_floor for r in jax_state[3]])
    return state


def refresh_floors(j_rows, p_rows, mus):
    """Each tick reads the floors anew from the rows' free cpus, as
    Core.worker_rows does."""
    for j, p in zip(j_rows, p_rows):
        j.cpu_floor = jax_floor(j.total, j.free, mus[j.worker_id])
        p.cpu_floor = cpu_floor(mus[p.worker_id], p.total[0], p.free[0])
        assert j.cpu_floor == p.cpu_floor


def run_both(jax_state, mus, n_ticks, port_model, jax_model=None,
             policies=None):
    """`n_ticks` ticks through both packages' run_tick, floors refreshed
    and completions applied between ticks; returns the per-tick
    assignment lists (asserted identical)."""
    resource_map, rq_map, queues, rows = jax_state
    p_resource_map, p_rq_map, p_queues, p_rows = port_state(jax_state, mus)
    totals = [list(r.total) for r in rows]
    nt0 = [r.nt_free for r in rows]
    jax_model = jax_model or JaxModel(backend="numpy")
    j_kw, p_kw = policies or ({}, {})
    out = []
    for t in range(n_ticks):
        refresh_floors(rows, p_rows, mus)
        want = jax_tick.run_tick(queues, rows, rq_map, resource_map,
                                 jax_model, **j_kw)
        got = port_tick.run_tick(p_queues, p_rows, p_rq_map, p_resource_map,
                                 port_model, **p_kw)
        assert got == want, f"tick {t}"
        check_floors(got, p_rows, p_rq_map)
        _apply(want, rows, rq_map)
        _apply(got, p_rows, p_rq_map)
        _release(rows, totals, nt0, t)
        _release(p_rows, totals, nt0, t)
        out.append(got)
    assert p_queues.total_ready() == queues.total_ready()
    return out


def check_floors(assignments, rows, rq_map):
    """Every floored worker receives cpu work of 0 or at least its floor."""
    cpu = {}
    for _t, w, rq, v in assignments:
        for e in rq_map.get_variants(rq).variants[v].entries:
            if e.resource_id == 0:
                cpu[w] = cpu.get(w, 0) + e.amount
    for row in rows:
        if row.cpu_floor > 0:
            got = cpu.get(row.worker_id, 0)
            assert got == 0 or got >= row.cpu_floor, (row.worker_id, got)


def greedy():
    return GreedyCutScanModel(device="cpu", backend="device")


@pytest.mark.parametrize("with_policy", [False, True],
                         ids=["plain", "policy"])
@pytest.mark.parametrize("seed", range(6))
def test_mu_ticks_match_jax(seed, with_policy):
    state, mus = mu_state(seed, weighted=seed % 2 == 1)
    policies = None
    if with_policy:
        n_w = len(state[3])
        row = np.linspace(0.5, 2.0, n_w).astype(np.float32)
        policies = tuple(
            {"policy": pkg.TickPolicyContext({0: row}, {2: 1})}
            for pkg in (jax_policy, port_policy))
    ticks = run_both(state, mus, 3, greedy(), policies=policies)
    floored = {w for w, mu in mus.items() if mu > 0}
    assert any(a for a in ticks)
    if seed == 0:
        assert any(w in floored for tick in ticks for _t, w, *_ in tick)


def test_mu_search_at_the_node_budget(caplog):
    """A floored worker whose search stops at MU_DFS_NODE_BUDGET ships the
    same best-so-far fill as the JAX package's, and says so."""
    assert port_tick.MU_DFS_NODE_BUDGET == jax_tick.MU_DFS_NODE_BUDGET
    queues, worker_rows, rq_map, resource_map, _ = bench.build_tick_state(
        n_workers=16, n_tasks=2000, n_classes=8)
    rows = [jax_tick.WorkerRow(worker_id=r.worker_id, free=list(r.free),
                               nt_free=r.nt_free,
                               lifetime_secs=r.lifetime_secs,
                               total=list(r.free))
            for r in worker_rows()]
    mus = {r.worker_id: 0.0 for r in rows}
    mus[1] = 0.5
    rows[0].cpu_floor = jax_floor(rows[0].total, rows[0].free, 0.5)
    p_state = port_state((resource_map, rq_map, queues, rows), mus)
    floored = [r for r in rows if r.cpu_floor > 0]
    p_floored = [r for r in p_state[3] if r.cpu_floor > 0]
    with caplog.at_level(logging.WARNING):
        want = jax_tick._solve_mu_workers(queues, floored, rq_map,
                                          resource_map)
        got = port_tick._solve_mu_workers(p_state[2], p_floored,
                                          p_state[1], p_state[0])
    assert got == want and got
    hits = [r for r in caplog.records
            if "node budget" in r.getMessage()
            or "-node budget" in r.getMessage()]
    assert {r.name for r in hits} == {"hyperqueue_tpu.scheduler.tick",
                                      "hyperqueue_tpu_torch.scheduler.tick"}


@pytest.mark.parametrize("seed", range(3))
def test_all_floored_workers(seed):
    """Every worker floored: no main solve, only the host search (one tick:
    a worker whose floor is met takes part in the next tick's solve)."""
    state, mus = mu_state(seed + 10, n_workers=5, n_floored=5)
    assert all(r.cpu_floor > 0 for r in state[3])

    class NoSolve:
        def solve(self, **kwargs):
            raise AssertionError("the all-floored tick solved")

    tick, = run_both(state, mus, 1, NoSolve(), jax_model=NoSolve())
    assert tick


@pytest.mark.parametrize("seed", range(3))
def test_fused_tick_with_floored_workers(seed):
    """Gang batches, worker groups and a policy beside floored workers: the
    port's worker-rows tick filters gang_ok and group_ids with the rows it
    keeps and strips the policy's affinity rows; it equals the JAX dense
    path over the unfloored workers (the JAX rows path drops the gang
    inputs) followed by the JAX host search over the floored ones."""
    state, gang_rqs, sched = _jobs_state(seed)
    resource_map, rq_map, queues, rows = state
    groups = ["fast", "slow", "mid"] * 4
    mus = {r.worker_id: (0.5 if r.worker_id in (2, 6, 7) else 0.0)
           for r in rows}
    for r in rows:
        r.cpu_floor = jax_floor(r.total, r.free, mus[r.worker_id])
    plain = list(export_plain(*state, min_utilization=mus))
    plain[3] = [r[:5] + (g, r[6]) for r, g in zip(plain[3], groups)]
    p_resource_map, p_rq_map, p_queues, p_rows = tick_state_from_plain(
        *plain)
    totals = [list(r.total) for r in rows]
    nt0 = [r.nt_free for r in rows]
    gids = group_ids(p_rows)
    pending = [(9001, gang_rqs[0], (1, sched[1]), 2),
               (9002, gang_rqs[1], (0, sched[2]), 3)]
    aff = np.linspace(2.0, 0.5, len(rows)).astype(np.float32)
    for t in range(3):
        refresh_floors(rows, p_rows, mus)
        keep = np.array([r.cpu_floor <= 0 for r in rows])
        idle = np.array([r.free == totals[i] and r.nt_free == nt0[i]
                         for i, r in enumerate(rows)], np.int32)
        j_batches = jax_tick.create_batches(queues) + [
            jax_tick.Batch(rq_id=rq, priority=p, size=1, gang_task=task,
                           gang_nodes=n) for task, rq, p, n in pending]
        p_batches = port_tick.create_batches(p_queues) + [
            port_tick.Batch(rq_id=rq, priority=p, size=1, gang_task=task,
                            gang_nodes=n) for task, rq, p, n in pending]
        unfloored = [r for r, k in zip(rows, keep) if k]
        want = jax_tick.run_tick(
            queues, None, rq_map, resource_map, JaxModel(backend="numpy"),
            batches=j_batches, dense=_dense(unfloored, len(resource_map)),
            gang_ok=idle[keep], group_ids=gids[keep],
            policy=jax_policy.TickPolicyContext({}, {3: 1}))
        want += jax_tick._solve_mu_workers(
            queues, [r for r, k in zip(rows, keep) if not k], rq_map,
            resource_map)
        got = port_tick.run_tick(
            p_queues, p_rows, p_rq_map, p_resource_map, greedy(),
            batches=p_batches, gang_ok=idle, group_ids=gids,
            policy=port_policy.TickPolicyContext({0: aff}, {3: 1}))
        assert got == want, f"tick {t}"
        sentinels = [(task, w) for task, w, _rq, v in got if v < 0]
        floored_ids = {r.worker_id for r, k in zip(rows, keep) if not k}
        assert not {w for _t, w in sentinels} & floored_ids
        placed = {task for task, _w in sentinels}
        pending = [g for g in pending if g[0] not in placed]
        _apply_fused(want, rows, rq_map)
        _apply_fused(got, p_rows, p_rq_map)
        _release(rows, totals, nt0, t)
        _release(p_rows, totals, nt0, t)
    assert p_queues.total_ready() == queues.total_ready()


def test_multichip_model_takes_the_carve_out():
    """MultichipModel has no supports_cpu_floor: its tick carves the floored
    workers out like the greedy model's, over its shards on the CPU."""
    assert not getattr(MultichipModel, "supports_cpu_floor", False)
    state, mus = mu_state(3, n_workers=12, n_floored=4)
    run_both(state, mus, 3, MultichipModel(devices=["cpu"] * 4))


def test_mu_carveout_deviation_matches_jax():
    """tests/test_makespan.py's pinned deviation: six 1-cpu tasks, a normal
    4-cpu worker and a 4-cpu worker with mu = 1.0. The carve-out gives the
    normal worker four and leaves the floored one idle (two leftovers are
    below its floor), in both packages."""
    resource_map = ResourceIdMap()
    resource_map.get_or_create("cpus")
    rq_map = ResourceRqMap()
    rq = rq_map.get_or_create(ResourceRequestVariants.single(
        ResourceRequest(entries=(ResourceRequestEntry(0, U),))))
    queues = TaskQueues()
    for t in range(1, 7):
        queues.add(rq, (0, 0), t)
    rows = [jax_tick.WorkerRow(worker_id=1, free=[4 * U], nt_free=64,
                               lifetime_secs=INF, total=[4 * U]),
            jax_tick.WorkerRow(worker_id=2, free=[4 * U], nt_free=64,
                               lifetime_secs=INF, total=[4 * U],
                               cpu_floor=jax_floor([4 * U], [4 * U], 1.0))]
    got, = run_both((resource_map, rq_map, queues, rows), {1: 0.0, 2: 1.0},
                    1, greedy())
    assert len(got) == 4
    assert all(w == 1 for _t, w, _rq, _v in got)


def test_cpu_floor_ceil_shift_under_range_compression():
    """assemble_solve_inputs(cpu_floor=) with a cpu column past
    MAX_SAFE_AMOUNT: the floors are ceil-shifted with the column, key for
    key and value for value as in the JAX package."""
    state, mus = mu_state(4, n_workers=6, n_floored=3)
    resource_map, rq_map, queues, rows = state
    scale = 2**12  # cpus past 2^23 fractions
    for r in rows:
        r.free[0] *= scale
        r.total[0] *= scale
        r.cpu_floor = r.cpu_floor * scale + (r.cpu_floor > 0)
    p_resource_map, p_rq_map, p_queues, p_rows = tick_state_from_plain(
        *export_plain(resource_map, rq_map, queues, rows))
    floors = np.array([r.cpu_floor for r in rows], np.int64)
    want = jax_tick.assemble_solve_inputs(
        rows, jax_tick.create_batches(queues), rq_map, resource_map,
        cpu_floor=floors)
    got = port_tick.assemble_solve_inputs(
        p_rows, port_tick.create_batches(p_queues), p_rq_map,
        p_resource_map, cpu_floor=floors)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "priorities":
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["cpu_floor"] < floors).any()
    assert (got["cpu_floor"] > 0).sum() == 3
