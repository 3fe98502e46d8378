"""The port's incremental tick state (server Core, Worker, TickStateCache)
against its own from-scratch assembly and against the JAX package's.

A randomized mutation golden applies the same steps — submits, ticks,
finishes, worker joins and leaves, gang reservations and resource-map
widening — to a JAX `Core` and a port `Core`. After every step the port's
incremental assemble must equal its from-scratch assemble and the JAX
package's incremental assemble, array for array, and every tick's
assignments must be the JAX tick's. Both packages read a frozen fake
clock, so time-limited workers' lifetimes are exact. Tolerance 0.
"""

import random

import numpy as np
import pytest

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources import descriptor as jax_desc
from hyperqueue_tpu.resources import request as jax_req
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler import tick_cache as jax_cache
from hyperqueue_tpu.server import core as jax_core
from hyperqueue_tpu.server import worker as jax_worker
from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu_torch.convert import core_from_plain, tick_state_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.resources import descriptor as port_desc
from hyperqueue_tpu_torch.resources import request as port_req
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.scheduler import tick_cache as port_cache
from hyperqueue_tpu_torch.server import core as port_core
from hyperqueue_tpu_torch.server import worker as port_worker
from hyperqueue_tpu_torch.utils import clock as port_clock
from hyperqueue_tpu_torch.utils.constants import INF_TIME

U = 10_000


class _FrozenClock:
    def __init__(self):
        self.t = 5000.0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


@pytest.fixture
def frozen_clock():
    fake = _FrozenClock()
    prev = (jax_clock.install(fake), port_clock.install(fake))
    yield fake
    jax_clock.install(prev[0])
    port_clock.install(prev[1])


class Twin:
    """The same server state in both packages, mutated step by step."""

    def __init__(self):
        self.jax = jax_core.Core()
        self.port = port_core.Core()
        self.next_task = 1
        self.priority_of: dict[int, tuple] = {}
        # task -> (rq_id, priority, worker_id, variant) while running
        self.running: dict[int, tuple] = {}
        self.jax_model = JaxModel(backend="numpy")
        self.port_model = GreedyCutScanModel(device="cpu", backend="device")

    # -- mutations ---------------------------------------------------------
    def join(self, cpus, gpus=0, time_limit=0.0, group="default"):
        ids = []
        for pkg_desc, pkg_worker, core in (
            (jax_desc, jax_worker, self.jax),
            (port_desc, port_worker, self.port),
        ):
            items = [pkg_desc.ResourceDescriptorItem.range("cpus", 0,
                                                           cpus - 1)]
            if gpus:
                items.append(pkg_desc.ResourceDescriptorItem.list(
                    "gpus", [str(i) for i in range(gpus)]))
            config = pkg_worker.WorkerConfiguration(
                descriptor=pkg_desc.ResourceDescriptor(items=tuple(items)),
                group=group, time_limit_secs=time_limit,
            )
            w = pkg_worker.Worker.create(core.worker_id_counter.next(),
                                         config, core.resource_map)
            core.workers[w.worker_id] = w
            core.bump_membership()
            ids.append(w.worker_id)
        assert ids[0] == ids[1]
        return ids[0]

    def leave(self, worker_id):
        """A lost worker: its running tasks go back to their queues."""
        for core in (self.jax, self.port):
            core.workers.pop(worker_id)
            core.bump_membership()
        for task, (rq_id, prio, wid, _v) in list(self.running.items()):
            if wid == worker_id:
                del self.running[task]
                self.jax.queues.add(rq_id, prio, task)
                self.port.queues.add(rq_id, prio, task)

    def submit(self, n, cpus, gpus, priority, min_time=0.0):
        rq_ids = []
        for req, core in ((jax_req, self.jax), (port_req, self.port)):
            entries = [req.ResourceRequestEntry(
                core.resource_map.get_or_create("cpus"), cpus * U)]
            if gpus:
                entries.append(req.ResourceRequestEntry(
                    core.resource_map.get_or_create("gpus"), gpus * U))
            rqv = req.ResourceRequestVariants.single(req.ResourceRequest(
                entries=tuple(entries), min_time_secs=min_time))
            rq_ids.append(core.intern_rqv(rqv))
        assert rq_ids[0] == rq_ids[1]
        for _ in range(n):
            task = self.next_task
            self.next_task += 1
            self.priority_of[task] = priority
            self.jax.queues.add(rq_ids[0], priority, task)
            self.port.queues.add(rq_ids[0], priority, task)

    def finish(self, task):
        rq_id, _prio, wid, variant = self.running.pop(task)
        for core in (self.jax, self.port):
            w = core.workers[wid]
            w.unassign(task, core.variant_amounts(rq_id, variant, w))

    def widen(self, name):
        for core in (self.jax, self.port):
            core.resource_map.get_or_create(name)

    def toggle_reservation(self, worker_id):
        for core in (self.jax, self.port):
            w = core.workers[worker_id]
            w.mn_reserved = 0 if w.mn_reserved else 99
            core.bump_membership()

    def tick(self):
        """One dense tick on both sides, with the port's paranoid check;
        the assignments start on both sides' workers."""
        j_snap = self.jax.tick_cache.sync(self.jax)
        p_snap = self.port.tick_cache.sync(self.port)
        assert (j_snap is None) == (p_snap is None)
        if p_snap is None:
            return []
        port_cache.paranoid_check(
            self.port, p_snap, port_tick.create_batches(self.port.queues),
            self.port.rq_map, self.port.resource_map)
        want = jax_tick.run_tick(
            self.jax.queues, None, self.jax.rq_map, self.jax.resource_map,
            self.jax_model, dense=j_snap, key_cache=self.jax.tick_cache)
        got = port_tick.run_tick(
            self.port.queues, None, self.port.rq_map,
            self.port.resource_map, self.port_model, dense=p_snap,
            key_cache=self.port.tick_cache)
        assert got == [tuple(a) for a in want]
        for task, wid, rq_id, variant in got:
            for core in (self.jax, self.port):
                w = core.workers[wid]
                w.assign(task, core.variant_amounts(rq_id, variant, w))
            self.running[task] = (rq_id, self.priority_of[task], wid,
                                  variant)
        return got

    # -- the three assemblies ----------------------------------------------
    def compare_assemblies(self):
        p_snap = self.port.tick_cache.sync(self.port)
        j_snap = self.jax.tick_cache.sync(self.jax)
        assert (p_snap is None) == (j_snap is None)
        if p_snap is None or not self.port.queues.total_ready():
            return False
        assert p_snap.worker_ids == j_snap.worker_ids
        rows = [r for r in self.port.worker_rows() if r.cpu_floor <= 0]
        scratch = port_tick.assemble_solve_inputs(
            rows, port_tick.create_batches(self.port.queues),
            self.port.rq_map, self.port.resource_map)
        incr = port_tick.assemble_solve_inputs(
            None, port_tick.create_batches(self.port.queues),
            self.port.rq_map, self.port.resource_map, dense=p_snap,
            key_cache=self.port.tick_cache)
        jax_incr = jax_tick.assemble_solve_inputs(
            None, jax_tick.create_batches(self.jax.queues), self.jax.rq_map,
            self.jax.resource_map, dense=j_snap,
            key_cache=self.jax.tick_cache)
        assert set(scratch) == set(incr) == set(jax_incr)
        for key in incr:
            a, b, c = (np.asarray(x[key]) for x in (scratch, incr, jax_incr))
            assert a.dtype == b.dtype == c.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=f"{key}: scratch")
            np.testing.assert_array_equal(b, c, err_msg=f"{key}: jax")
        return True


@pytest.mark.parametrize("seed", range(2))
def test_randomized_mutation_golden_against_jax(seed, frozen_clock):
    rng = random.Random(seed)
    twin = Twin()
    workers = [twin.join(cpus=rng.choice([2, 4, 8])) for _ in range(3)]
    widened = 0
    compared = 0
    ticks_with_work = 0
    steps = 0
    while steps < 220:
        steps += 1
        frozen_clock.t += 0.5
        op = rng.random()
        if op < 0.30:
            twin.submit(n=rng.randrange(1, 6), cpus=rng.choice([1, 1, 2]),
                        gpus=rng.choice([0, 0, 0, 1]),
                        priority=(rng.randrange(0, 3), 0),
                        min_time=rng.choice([0.0, 0.0, 30.0]))
        elif op < 0.45 and twin.running:
            twin.finish(rng.choice(sorted(twin.running)))
        elif op < 0.55:
            workers.append(twin.join(
                cpus=rng.choice([2, 4, 8]), gpus=rng.choice([0, 0, 2]),
                time_limit=rng.choice([0.0, 0.0, 60.0, 3600.0])))
        elif op < 0.62 and len(workers) > 1:
            twin.leave(workers.pop(rng.randrange(len(workers))))
        elif op < 0.66:
            widened += 1
            twin.widen(f"res{widened}")
        elif op < 0.70:
            twin.toggle_reservation(rng.choice(workers))
        else:
            ticks_with_work += bool(twin.tick())
        compared += twin.compare_assemblies()
    assert compared > 100 and ticks_with_work > 10
    assert twin.port.tick_cache.incremental_syncs > 0
    assert twin.port.tick_cache.counters() == twin.jax.tick_cache.counters()
    stats = twin.port_model.resident_stats()
    assert stats["delta_uploads"] > 0 and stats["invalidations"] == 0


def test_steady_state_zero_full_rebuilds_and_dirty_rows():
    twin = Twin()
    for _ in range(3):
        twin.join(cpus=4)
    twin.submit(n=30, cpus=1, gpus=0, priority=(0, 0))
    twin.tick()
    cache = twin.port.tick_cache
    rebuilds = cache.full_rebuilds
    for task in sorted(twin.running)[:5]:
        twin.finish(task)
    twin.tick()
    twin.tick()
    assert cache.full_rebuilds == rebuilds
    assert cache.incremental_syncs >= 2
    assert cache.counters() == twin.jax.tick_cache.counters()


def test_membership_changes_rebuild_and_widening_pads():
    twin = Twin()
    w1 = twin.join(cpus=4)
    twin.submit(n=4, cpus=1, gpus=0, priority=(0, 0))
    twin.tick()
    cache = twin.port.tick_cache
    r0 = cache.full_rebuilds
    w2 = twin.join(cpus=2)
    twin.submit(n=1, cpus=1, gpus=0, priority=(0, 0))
    twin.tick()
    assert cache.full_rebuilds == r0 + 1 and w2 in cache.worker_ids
    twin.leave(w1)
    twin.tick()
    assert cache.full_rebuilds == r0 + 2 and w1 not in cache.worker_ids
    width = cache.n_r
    twin.widen("fpga")
    twin.submit(n=1, cpus=1, gpus=0, priority=(0, 0))
    assert twin.compare_assemblies()
    assert cache.n_r == width + 1
    assert np.all(cache.free[:, width:] == 0)


def test_overcommit_negative_free_stays_bit_identical():
    twin = Twin()
    w = twin.join(cpus=2)
    twin.submit(n=2, cpus=1, gpus=0, priority=(0, 0))
    twin.tick()
    for core in (twin.jax, twin.port):
        core.workers[w].assign(999_001, [(0, 50_000)])  # a prefill race
    twin.submit(n=1, cpus=1, gpus=0, priority=(0, 0))
    assert twin.compare_assemblies()
    cache = twin.port.tick_cache
    row = cache.worker_ids.index(w)
    assert cache.free[row, 0] < 0 and cache.nt_free[row] >= 0


def test_min_utilization_worker_disables_the_cache():
    twin = Twin()
    twin.join(cpus=4)
    for core in (twin.jax, twin.port):
        for worker in core.workers.values():
            worker.configuration.min_utilization = 0.5
        core.bump_membership()
    assert twin.port.tick_cache.sync(twin.port) is None
    assert twin.jax.tick_cache.sync(twin.jax) is None
    assert twin.port.worker_rows()[0].cpu_floor == \
        twin.jax.worker_rows()[0].cpu_floor > 0


def test_paranoid_check_names_a_corrupted_row():
    twin = Twin()
    twin.join(cpus=4)
    twin.join(cpus=8)
    twin.submit(n=3, cpus=1, gpus=0, priority=(0, 0))
    snap = twin.port.tick_cache.sync(twin.port)
    batches = port_tick.create_batches(twin.port.queues)
    port_cache.paranoid_check(twin.port, snap, batches, twin.port.rq_map,
                              twin.port.resource_map)
    snap.free[0, 0] += U  # the cache serves a stale row
    with pytest.raises(AssertionError, match="'free' diverged"):
        port_cache.paranoid_check(twin.port, snap, batches,
                                  twin.port.rq_map, twin.port.resource_map)


def test_phase_stats_match_jax():
    port_stats = port_cache.TickPhaseStats()
    jax_stats = jax_cache.TickPhaseStats()
    for phases in ({"assemble": 1.5, "mapping": 2.0},
                   {"assemble": 0.5, "pipeline_wait": 0.25},
                   {"mapping": 4.0}):
        port_stats.record(phases)
        jax_stats.record(phases)
    assert port_stats.snapshot() == jax_stats.snapshot()
    assert port_stats.shares() == jax_stats.shares()


def test_core_from_plain_matches_tick_state_from_plain(frozen_clock):
    plain = (
        ["cpus", "gpus", "mem"],
        [[{"entries": [("cpus", U, "compact")]}],
         [{"entries": [("cpus", 2 * U, "compact"), ("gpus", U, "all")]}]],
        [(t, t % 2, (t % 3, 0)) for t in range(1, 9)],
        [(1, [4 * U, 0, 8 * U], 4, INF_TIME, None, "g0"),
         (2, [8 * U, U, 16 * U], 8, 120, [8 * U, 2 * U, 16 * U], "g1"),
         (5, [0, 0, 0], 0, INF_TIME, [2 * U, 0, 0])],
    )
    core = core_from_plain(*plain)
    _rmap, _qmap, queues, rows = tick_state_from_plain(*plain)
    assert core.queues.total_ready() == queues.total_ready() == 8
    got = core.worker_rows()
    for mine, want in zip(got, rows, strict=True):
        assert (mine.worker_id, mine.free, mine.nt_free, mine.lifetime_secs,
                mine.group) == (want.worker_id, want.free, want.nt_free,
                                want.lifetime_secs, want.group)
        assert mine.total[:len(want.total or want.free)] == list(
            want.total or want.free)[:len(mine.total)]
    assert core.worker_id_counter.next() == 6
    snap = core.tick_cache.sync(core)
    assert snap.worker_ids == [1, 2, 5]
    assert snap.lifetime.tolist() == [INF_TIME, 120, INF_TIME]
