"""The port's native task queue and its one-call map-take against the
port's Python TaskQueue and the JAX package's queues, and the tick that maps
through them against the JAX package's run_tick (exact)."""

import random

import numpy as np
import pytest
import torch

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources.map import ResourceIdMap as JaxResourceIdMap
from hyperqueue_tpu.resources.map import ResourceRqMap as JaxResourceRqMap
from hyperqueue_tpu.resources.request import (
    ResourceRequest as JaxRequest,
    ResourceRequestEntry as JaxEntry,
    ResourceRequestVariants as JaxVariants,
)
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler.queues import TaskQueue as JaxTaskQueue
from hyperqueue_tpu.scheduler.queues import TaskQueues as JaxTaskQueues
from hyperqueue_tpu.utils import native as jax_native
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu_torch.resources.request import (
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.scheduler.queues import TaskQueue, TaskQueues
from hyperqueue_tpu_torch.utils import native
from hyperqueue_tpu_torch.utils.native import (
    NativeTaskQueue,
    load_native,
    make_task_queue,
)

# one intra-op thread per process (see tests/test_torch_imports.py)
torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1


@pytest.fixture
def lib():
    lib = load_native()
    if lib is None:
        pytest.skip("no C++ compiler: the native library is unavailable")
    return lib


def test_native_builds_and_queues_use_it(lib):
    q = NativeTaskQueue(lib)
    assert len(q) == 0
    assert isinstance(make_task_queue(), NativeTaskQueue)
    queues = TaskQueues()
    queues.add(3, (0, 0), 7)
    assert isinstance(queues.queue(3), NativeTaskQueue)


def test_make_task_queue_falls_back_to_python(monkeypatch):
    monkeypatch.setattr(native, "load_native", lambda: None)
    assert type(make_task_queue()) is TaskQueue


def test_native_basic_semantics(lib):
    q = NativeTaskQueue(lib)
    q.add((0, 0), 10)
    q.add((5, 0), 11)
    q.add((5, 0), 12)
    q.add((0, -3), 13)
    assert len(q) == 4
    assert q.priority_sizes() == [((5, 0), 2), ((0, 0), 1), ((0, -3), 1)]
    assert q.take((5, 0), 1) == [11]  # FIFO within a level
    q.remove(13)
    assert len(q) == 2
    assert q.priority_sizes() == [((5, 0), 1), ((0, 0), 1)]
    assert q.take((5, 0), 5) == [12]
    assert q.take((9, 9), 5) == []
    assert q.all_tasks() == [10]


@pytest.mark.parametrize("seed", range(5))
def test_native_queue_matches_python_and_jax_queues(lib, seed):
    """Random add/remove/take/priority_sizes/all_tasks on the port's native
    queue, the port's Python queue, the JAX package's Python queue and,
    where it builds, the JAX package's native queue: the same answers.
    all_tasks lists the native queue's levels in descending priority and a
    Python queue's in the order they were created, so the Python queues are
    compared as sets there."""
    rng = random.Random(seed)
    jax_lib = jax_native.load_native()
    nq, pq, jq = NativeTaskQueue(lib), TaskQueue(), JaxTaskQueue()
    jnq = jax_native.NativeTaskQueue(jax_lib) if jax_lib else None
    queues = [q for q in (nq, pq, jq, jnq) if q is not None]
    live = []
    for step in range(400):
        op = rng.random()
        if op < 0.5 or not live:
            prio = (rng.randint(-3, 3), rng.randint(-3, 3))
            task_id = seed * 100_000 + step
            for q in queues:
                q.add(prio, task_id)
            live.append(task_id)
        elif op < 0.7:
            task_id = live.pop(rng.randrange(len(live)))
            for q in queues:
                q.remove(task_id)
        elif op < 0.95:
            sizes = pq.priority_sizes()
            if sizes:
                prio, count = sizes[rng.randrange(len(sizes))]
                k = rng.randint(1, count + 1)
                got = [q.take(prio, k) for q in queues]
                assert all(g == got[0] for g in got)
                taken = set(got[0])
                live = [t for t in live if t not in taken]
        else:
            got = [q.all_tasks() for q in queues]
            assert sorted(got[0]) == sorted(live)
            assert all(sorted(g) == sorted(got[0]) for g in got)
            if jnq is not None:
                assert got[0] == got[-1]
        lens = [len(q) for q in queues]
        assert lens == [len(live)] * len(queues)
        sizes = [q.priority_sizes() for q in queues]
        assert all(s == sizes[0] for s in sizes)


def test_queues_version_counts_adds_and_removes(lib):
    queues = TaskQueues()
    queues.add(1, (0, 0), 1)
    queues.add(1, (0, 0), 2)
    queues.remove(1, 2)
    queues.remove(9, 3)  # no such queue: nothing changes
    assert queues.version == 3
    queues.queue(1).take((0, 0), 1)  # a take is not a mutation it counts
    assert queues.version == 3
    assert queues.total_ready() == 0


def _map_state(pkg, force_python):
    """tests/test_native.py's map-take instance in either package: 500
    tasks of five cpu classes at three priorities over six workers."""
    if pkg == "jax":
        rmap, qmap, queues = (JaxResourceIdMap(), JaxResourceRqMap(),
                              JaxTaskQueues())
        req, entry, variants, row, python_q = (
            JaxRequest, JaxEntry, JaxVariants, jax_tick.WorkerRow,
            JaxTaskQueue)
    else:
        rmap, qmap, queues = ResourceIdMap(), ResourceRqMap(), TaskQueues()
        req, entry, variants, row, python_q = (
            ResourceRequest, ResourceRequestEntry, ResourceRequestVariants,
            port_tick.WorkerRow, TaskQueue)
    cpus = rmap.get_or_create("cpus")
    if force_python:
        for rq in range(5):
            queues._queues[rq] = python_q()
    rq_ids = [
        qmap.get_or_create(variants.single(
            req(entries=(entry(cpus, (i + 1) * U),))))
        for i in range(5)
    ]
    rng = np.random.default_rng(7)
    for tid in range(1, 501):
        queues.add(rq_ids[int(rng.integers(0, 5))],
                   (int(rng.integers(0, 3)), 0), tid)
    rows = [row(worker_id=w + 1, free=[8 * U], nt_free=16,
                lifetime_secs=INF) for w in range(6)]
    return queues, rows, qmap, rmap


def test_map_take_matches_per_cell_path_and_jax(lib):
    """One tick mapped through hq_map_take, through the per-cell Python
    takes (Python queues) and by the JAX package's run_tick: the same
    assignments."""
    calls = []
    real = port_tick._native_map_take

    def counting(*args):
        out = real(*args)
        calls.append(out is not None)
        return out

    port_tick._native_map_take = counting
    try:
        native_out = port_tick.run_tick(
            *_map_state("port", False),
            GreedyCutScanModel(device="cpu", backend="device"))
        python_out = port_tick.run_tick(
            *_map_state("port", True),
            GreedyCutScanModel(device="cpu", backend="device"))
    finally:
        port_tick._native_map_take = real
    assert calls == [True, False]
    want = jax_tick.run_tick(*_map_state("jax", False),
                             JaxModel(backend="numpy"))
    assert native_out == python_out == want
    assert len(want) > 0


@pytest.mark.parametrize("seed", range(3))
def test_map_counts_native_and_python_agree_on_random_counts(lib, seed):
    """_map_counts over random counts (more than the queues hold in some
    cells): hq_map_take and the per-cell takes pop the same ids in the
    same order and leave the same queues."""
    rng = np.random.default_rng(seed)
    n_b, n_v, n_w = 6, 2, 5
    batches, both = [], (TaskQueues(), TaskQueues())
    for rq in range(3):
        both[1]._queues[rq] = TaskQueue()
    tid = 1
    for rq in range(3):
        for prio in ((1, 0), (0, -1)):
            n = int(rng.integers(0, 12))
            for _ in range(n):
                for q in both:
                    q.add(rq, prio, tid)
                tid += 1
            batches.append(port_tick.Batch(rq_id=rq, priority=prio, size=n))
    counts = rng.integers(0, 3, size=(n_b, n_v, n_w)).astype(np.int32)
    counts[rng.random((n_b, n_v, n_w)) < 0.5] = 0
    worker_ids = [11, 12, 13, 14, 15]
    got = [port_tick._map_counts(q, batches, worker_ids, counts)
           for q in both]
    assert got[0] == got[1]
    assert both[0].total_ready() == both[1].total_ready()
    for rq in range(3):
        assert (both[0].queue(rq).priority_sizes()
                == both[1].queue(rq).priority_sizes())
