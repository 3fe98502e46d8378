"""The autoalloc demand query beside the tick, on the CPU.

`compute_new_worker_query` solves the real workers plus fake rows with the
server's model. On the port that is a second launch site of K1 (the
`alloc_query` site) on the model that carries the tick's resident state,
where a `solve` would re-key the residency on the query's W and leave the
query's state after the solve in the tick's tensors and mirror. Pinned
here, tolerance 0:

- ticks (synchronous, and pipelined: dispatch now, take later) with
  queries before the dispatch, between the dispatch and the take, and
  after the take give the same counts, free_after and nt_after as the same
  ticks without queries, and the JAX package's counts and the state they
  leave;
- the queries leave the residency's uploads, invalidations, bucket
  buffers and the model's last backend as the ticks alone leave them, and
  each launches K1 once at its own site;
- each query's counts equal the JAX model's on the same inputs, through
  the bare model and through the watchdog;
- on a Core, a pipelined `run_tick` with demand queries between its
  dispatch and its take maps what the same ticks map without them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu_torch.autoalloc import query as port_query
from hyperqueue_tpu_torch.models import greedy
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.ops import assign
from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
from hyperqueue_tpu_torch.scheduler.tick import create_batches, run_tick
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.utils.constants import INF_TIME

from test_torch_tick_cache import Twin

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

N_W, N_R, N_B, N_V = 20, 2, 6, 2
N_TICKS = 6
# fake rows of a query: inside the tick's padded W bucket (32), and across
# it (64)
FAKE_ROWS = (4, 30)


def tick_inputs(rng, free):
    """One tick's solve inputs over the workers' current `free`."""
    needs = rng.integers(1, 4, size=(N_B, N_V, N_R)).astype(np.int32)
    needs[:, 1, 1] = 0  # the second variant needs no second resource
    return dict(
        free=free.astype(np.int32),
        nt_free=np.full(N_W, 8, dtype=np.int32),
        lifetime=np.full(N_W, INF_TIME, dtype=np.int32),
        needs=needs,
        sizes=rng.integers(1, 12, size=N_B).astype(np.int32),
        min_time=np.zeros((N_B, N_V), dtype=np.int32),
    )


def query_inputs(kwargs, n_fake):
    """The tick's inputs with `n_fake` fresh rows appended, as the demand
    query appends its fake workers."""
    q = dict(kwargs)
    q["free"] = np.concatenate(
        [kwargs["free"], np.full((n_fake, N_R), 6, dtype=np.int32)])
    q["nt_free"] = np.concatenate(
        [kwargs["nt_free"], np.full(n_fake, 8, dtype=np.int32)])
    q["lifetime"] = np.concatenate(
        [kwargs["lifetime"], np.full(n_fake, INF_TIME, dtype=np.int32)])
    return q


def after(kwargs, counts):
    """The state a solve leaves: free and nt_free less what it placed."""
    used = np.einsum("bvw,bvr->wr", counts.astype(np.int64),
                     kwargs["needs"].astype(np.int64))
    return (kwargs["free"] - used).astype(np.int32), \
        (kwargs["nt_free"] - counts.sum(axis=(0, 1))).astype(np.int32)


def run_ticks(seed, pipelined, when=(), n_fake=4, through_watchdog=False):
    """N_TICKS ticks on one model; between the ticks some workers' tasks
    finish (seeded). `when` names where queries run: "before" the
    dispatch, "pending" between the dispatch and the take, "after" the
    take. Returns the ticks' (counts, free_after, nt_after), the queries'
    (inputs, counts), the model and the residency stats."""
    rng = np.random.default_rng(seed)
    model = GreedyCutScanModel(device="cpu", backend="device")
    solver = SolverWatchdog(model, timeout_s=0) if through_watchdog \
        else model
    free = rng.integers(2, 12, size=(N_W, N_R)).astype(np.int32)
    ticks, queries = [], []

    def query(kwargs):
        q = query_inputs(kwargs, n_fake)
        queries.append((q, np.array(solver.solve_query(**q), copy=True)))

    for _ in range(N_TICKS):
        kwargs = tick_inputs(rng, free)
        if "before" in when:
            query(kwargs)
        if pipelined:
            handle = solver.solve_async(**kwargs)
            if "pending" in when:
                query(kwargs)
            counts = handle.result()
        else:
            counts = solver.solve(**kwargs)
        counts = np.array(counts, copy=True)
        res = model._res
        n_w = kwargs["free"].shape[0]
        ticks.append((counts, res.free[:n_w, :N_R].numpy().copy(),
                      res.nt_free[:n_w].numpy().copy(),
                      res._m_free[:n_w, :N_R].copy(),
                      res._m_nt[:n_w].copy()))
        if "after" in when:
            query(kwargs)
        free = ticks[-1][1].copy()
        # a seeded few workers get resources back
        back = rng.choice(N_W, size=5, replace=False)
        free[back] += rng.integers(1, 4, size=(5, N_R)).astype(np.int32)
    return ticks, queries, model


# (pipelined, when): a synchronous tick has no pending solve
INTERLEAVINGS = [
    (False, ("before",)), (False, ("after",)), (False, ("before", "after")),
    (True, ("before",)), (True, ("pending",)), (True, ("after",)),
    (True, ("before", "pending", "after")),
]


@pytest.mark.parametrize("n_fake", FAKE_ROWS)
@pytest.mark.parametrize(
    "pipelined,when", INTERLEAVINGS,
    ids=[("pipelined-" if p else "sync-") + "+".join(w)
         for p, w in INTERLEAVINGS])
def test_queries_leave_the_ticks_bit_equal(pipelined, when, n_fake):
    seed = 7
    alone, _, model_alone = run_ticks(seed, pipelined)
    assign.reset_launch_counts()
    mixed, queries, model_mixed = run_ticks(seed, pipelined, when, n_fake)
    assert queries
    for k, (a, m) in enumerate(zip(alone, mixed)):
        for name, x, y in zip(("counts", "free", "nt", "mirror free",
                               "mirror nt"), a, m):
            assert np.array_equal(x, y), (k, name)
    # the residency saw the ticks only
    stats = ("full_uploads", "delta_uploads", "invalidations",
             "upload_bytes_total")
    assert [model_mixed._res.stats()[s] for s in stats] == \
        [model_alone._res.stats()[s] for s in stats]
    assert model_mixed.shape_allocations == model_alone.shape_allocations
    assert model_mixed.last_backend == model_alone.last_backend
    assert len(model_mixed._buffers) == len(model_alone._buffers)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_ticks_and_queries_equal_the_jax_package(pipelined):
    seed = 11
    when = ("before", "pending", "after") if pipelined else ("before",
                                                             "after")
    ticks, queries, _ = run_ticks(seed, pipelined, when,
                                  through_watchdog=True)
    jax = JaxModel(backend="numpy")
    rng = np.random.default_rng(seed)
    free = rng.integers(2, 12, size=(N_W, N_R)).astype(np.int32)
    for counts, free_after, nt_after, _m_free, _m_nt in ticks:
        kwargs = tick_inputs(rng, free)
        want = np.asarray(jax.solve(**kwargs))
        assert np.array_equal(counts, want)
        want_free, want_nt = after(kwargs, want)
        assert np.array_equal(free_after, want_free)
        assert np.array_equal(nt_after, want_nt)
        free = free_after.copy()
        back = rng.choice(N_W, size=5, replace=False)
        free[back] += rng.integers(1, 4, size=(5, N_R)).astype(np.int32)
    for q, counts in queries:
        assert np.array_equal(counts, np.asarray(jax.solve(**q)))


def test_each_query_launches_k1_at_its_own_site(monkeypatch):
    """Each tick's solve reaches K1's wrapper at the `tick` site and each
    query's at `alloc_query` (the site the wrapper counts its launch
    under on the card; on the CPU it runs the plain version uncounted, so
    the site is read where the model passes it), and a query of a
    host-sticky model solves on the host."""
    sites = []
    kernel = greedy.greedy_cut_scan

    def recording(*args, site="tick", **kwargs):
        sites.append(site)
        return kernel(*args, site=site, **kwargs)

    monkeypatch.setattr(greedy, "greedy_cut_scan", recording)
    ticks, queries, _ = run_ticks(3, True, ("pending",))
    assert sorted(sites) == sorted(["tick"] * len(ticks)
                                   + ["alloc_query"] * len(queries))
    assert len(ticks) == len(queries) == N_TICKS
    host = GreedyCutScanModel(device="cpu", backend="numpy")
    kwargs = query_inputs(tick_inputs(np.random.default_rng(1),
                                      np.full((N_W, N_R), 5, np.int32)), 3)
    before = host.last_backend
    want = np.asarray(JaxModel(backend="numpy").solve(**kwargs))
    assert np.array_equal(host.solve_query(**kwargs), want)
    assert host.last_backend == before
    assert host._buffers == {}


def _demand_queries(core):
    """Two worker shapes a queue could start: 4 cpus (3 of them) and 2
    cpus (2 of them)."""
    from hyperqueue_tpu_torch.resources.descriptor import (
        ResourceDescriptor,
        ResourceDescriptorItem,
    )
    from hyperqueue_tpu_torch.resources.worker_resources import (
        WorkerResources,
    )

    return [
        port_query.WorkerTypeQuery(
            resources=WorkerResources.from_descriptor(
                ResourceDescriptor(items=(
                    ResourceDescriptorItem.range("cpus", 0, cpus - 1),)),
                core.resource_map),
            max_sn_workers=max_sn, declared_ids=frozenset({0}))
        for cpus, max_sn in ((4, 3), (2, 2))
    ]


def test_run_tick_with_queries_maps_what_it_maps_alone():
    """Two port cores of one state, ticking pipelined in the server's
    order; one answers demand queries between each dispatch and its take.
    Both map the same lists, and each query's response equals the one a
    host model with no resident state computes at the same moment."""
    results = []
    for with_queries in (False, True):
        twin = Twin()
        for cpus in (4, 4, 8, 2):
            twin.join(cpus=cpus)
        twin.submit(n=40, cpus=1, gpus=0, priority=(0, 0))
        twin.submit(n=12, cpus=2, gpus=0, priority=(1, 0))
        core = twin.port
        model = SolverWatchdog(GreedyCutScanModel(device="cpu"),
                               timeout_s=0)
        host = GreedyCutScanModel(device="cpu", backend="numpy")
        pipeline = TickPipeline()
        mapped_lists, responses = [], []
        for _ in range(4):
            mapped = pipeline.take_result(model=model)
            mapped_lists.append(mapped)
            for task, wid, rq_id, variant in mapped:
                w = core.workers[wid]
                w.assign(task, core.variant_amounts(rq_id, variant, w))
            snap = core.tick_cache.sync(core)
            run_tick(core.queues, None, core.rq_map, core.resource_map,
                     model, batches=create_batches(core.queues), dense=snap,
                     key_cache=core.tick_cache, pipeline=pipeline)
            if with_queries:
                responses.append((
                    port_query.compute_new_worker_query(
                        core, model, _demand_queries(core)),
                    port_query.compute_new_worker_query(
                        core, host, _demand_queries(core))))
        results.append((mapped_lists, responses))
    (alone, _), (mixed, responses) = results
    assert alone == mixed
    assert sum(map(len, alone)) > 0
    for got, want in responses:
        assert got == want
    assert any(got.single_node_workers_per_query != [0, 0]
               for got, _ in responses)
