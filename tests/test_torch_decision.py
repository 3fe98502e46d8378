"""The port's decision records and oracle against the JAX package's (exact):
the reason registry, the dumb-loop oracle (solve_oracle, explain_unplaced),
and the production classifier (classify_class, build_unplaced_entries,
variant_fits_free) on a port Core and a JAX Core built from the same plain
data."""

import itertools

import numpy as np
import pytest
import torch

from hyperqueue_tpu.ids import IdCounter as JaxIdCounter
from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.resources.descriptor import (
    ResourceDescriptor as JaxDescriptor,
    ResourceDescriptorItem as JaxItem,
)
from hyperqueue_tpu.resources.request import (
    AllocationPolicy as JaxPolicy,
    ResourceRequest as JaxRequest,
    ResourceRequestEntry as JaxEntry,
    ResourceRequestVariants as JaxVariants,
)
from hyperqueue_tpu.scheduler import decision as jax_decision
from hyperqueue_tpu.scheduler import oracle as jax_oracle
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler.queues import encode_sched_priority
from hyperqueue_tpu.server.core import Core as JaxCore
from hyperqueue_tpu.server.worker import (
    Worker as JaxWorker,
    WorkerConfiguration as JaxConfiguration,
)
from hyperqueue_tpu_torch.convert import core_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.scheduler import decision
from hyperqueue_tpu_torch.scheduler import oracle
from hyperqueue_tpu_torch.scheduler import tick as port_tick

# one intra-op thread per process (see tests/test_torch_imports.py)
torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1


def test_reason_registry_matches_jax():
    names = sorted(n for n in dir(jax_decision) if n.startswith("REASON_"))
    assert names == sorted(n for n in dir(decision)
                           if n.startswith("REASON_"))
    for name in names:
        assert getattr(decision, name) == getattr(jax_decision, name)
    assert decision.ALL_REASONS == jax_decision.ALL_REASONS
    assert len(decision.ALL_REASONS) == len(names)
    assert decision.MAX_UNPLACED_ENTRIES == jax_decision.MAX_UNPLACED_ENTRIES
    assert decision.FREE_SCAN_BUDGET == jax_decision.FREE_SCAN_BUDGET
    counts = {"insufficient-capacity": 30, "gang-incomplete": 7,
              "solver-deferred": 12}
    assert (decision.format_reason_counts(counts)
            == jax_decision.format_reason_counts(counts)
            == "30 insufficient-capacity, 12 solver-deferred, "
               "7 gang-incomplete")


def oracle_case(seed, gang=False, affinity=False):
    """Nested-list inputs of solve_oracle: workers partly busy, some short-
    lived, absent variants, min_time gating; optionally gang rows over
    worker groups and a policy affinity matrix with exclusions."""
    rng = np.random.default_rng(seed)
    n_w, n_r = int(rng.integers(2, 9)), int(rng.integers(1, 4))
    n_b, n_v = int(rng.integers(1, 7)), int(rng.integers(1, 3))
    total = rng.integers(0, 9, size=(n_w, n_r)) * U
    free = total - rng.integers(0, 3, size=(n_w, n_r)) * (U // 2)
    free = np.maximum(free, 0)
    needs = rng.integers(0, 4, size=(n_b, n_v, n_r)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U // 2)
    min_time = np.where(rng.random((n_b, n_v)) < 0.3, 600, 0)
    kw = dict(
        free=free.tolist(), nt_free=rng.integers(0, 6, size=n_w).tolist(),
        lifetime=np.where(rng.random(n_w) < 0.3, 300, INF).tolist(),
        needs=needs.tolist(),
        sizes=rng.integers(0, 3 * n_w, size=n_b).tolist(),
        min_time=min_time.tolist(),
        scarcity=rng.random(n_r).round(3).tolist(),
    )
    extra = {}
    if gang:
        extra["gang_nodes"] = np.where(rng.random(n_b) < 0.4,
                                       rng.integers(1, 4, size=n_b),
                                       0).tolist()
        extra["gang_ok"] = (rng.random(n_w) < 0.7).astype(int).tolist()
        extra["group_ids"] = rng.integers(0, 2, size=n_w).tolist()
    if affinity:
        extra["affinity"] = np.where(rng.random((n_b, n_w)) < 0.2, 0.0,
                                     rng.choice([0.5, 1.0, 2.0],
                                                size=(n_b, n_w))).tolist()
    return kw, extra, total.tolist()


@pytest.mark.parametrize("mode", ["plain", "gang", "affinity", "both"])
@pytest.mark.parametrize("seed", range(6))
def test_oracle_and_explain_match_jax(seed, mode):
    kw, extra, total = oracle_case(seed, gang=mode in ("gang", "both"),
                                   affinity=mode in ("affinity", "both"))
    want = jax_oracle.solve_oracle(**kw, **extra)
    got = oracle.solve_oracle(**kw, **extra)
    assert got == want
    gang_kw = {k: v for k, v in extra.items() if k != "affinity"}
    args = [kw[k] for k in ("free", "nt_free", "lifetime", "needs", "sizes",
                            "min_time")]
    for tot in (None, total):
        want_r = jax_oracle.explain_unplaced(*args, want, total=tot,
                                             **gang_kw)
        got_r = oracle.explain_unplaced(*args, got, total=tot, **gang_kw)
        assert got_r == want_r
        assert set(got_r) <= decision.ALL_REASONS | {None}


def plain_state(seed):
    """Plain tick state with every reason reachable: classes no worker can
    hold, a class whose min_time outlives every worker and one that only
    some outlive, an ALL-policy class, and more tasks than the cluster
    takes."""
    rng = np.random.default_rng(seed)
    resources = ["cpus", "gpus", "mem"]
    classes = [
        [{"entries": [("cpus", U, "compact")]}],
        [{"entries": [("cpus", 2 * U, "compact"), ("gpus", U, "compact")]}],
        [{"entries": [("cpus", 64 * U, "compact")]}],          # too big
        [{"entries": [("cpus", U, "compact")], "min_time_secs": 3600.0}],
        [{"entries": [("cpus", 4 * U, "compact"), ("mem", 2 * U, "compact")]},
         {"entries": [("cpus", 8 * U, "compact")]}],
        [{"entries": [("gpus", 0, "all")]}],
        [{"entries": [("mem", 64 * U, "compact")]}],           # too big
        [{"entries": [("cpus", U, "compact")], "min_time_secs": 600.0}],
    ]
    tasks = []
    for tid in range(1, int(rng.integers(40, 90))):
        job = int(rng.integers(1, 4))
        tasks.append((tid, int(rng.integers(0, len(classes))),
                      (int(rng.integers(0, 2)), encode_sched_priority(
                          job, int(rng.integers(0, 3))))))
    workers = []
    for wid in range(1, int(rng.integers(3, 7))):
        total = [int(rng.choice([4, 8])) * U,
                 int(rng.choice([0, 2])) * U, 8 * U]
        free = list(total)
        if rng.random() < 0.4:
            free[0] -= 2 * U
        # no worker outlives the 3,600 s class; some outlive the 600 s one
        workers.append((wid, free, int(rng.integers(2, 6)),
                        int(rng.choice([100, 1800])), total))
    return resources, classes, tasks, workers


def jax_core_from_plain(resources, classes, tasks, workers):
    """A JAX Core from plain data, as convert.core_from_plain builds the
    port's."""
    core = JaxCore()
    for name in resources:
        core.resource_map.get_or_create(name)
    for variants in classes:
        core.rq_map.get_or_create(JaxVariants(variants=tuple(
            JaxRequest(
                entries=tuple(JaxEntry(resource_id=resources.index(n),
                                       amount=int(a),
                                       policy=JaxPolicy.parse(p))
                              for n, a, p in v["entries"]),
                min_time_secs=float(v.get("min_time_secs", 0.0)))
            for v in variants)))
    for task_id, cls, prio in tasks:
        core.queues.add(cls, prio, task_id)
    for wid, free, nt_free, lifetime, total in workers:
        items = tuple(JaxItem.sum(resources[r], int(a))
                      for r, a in enumerate(total) if a > 0)
        worker = JaxWorker.create(wid, JaxConfiguration(
            descriptor=JaxDescriptor(items=items),
            time_limit_secs=0.0 if lifetime >= INF else float(lifetime)),
            core.resource_map)
        worker.free = list(free)
        worker.nt_free = nt_free
        core.workers[wid] = worker
    core.worker_id_counter = JaxIdCounter(start=max(core.workers) + 1)
    core.bump_membership()
    return core


@pytest.mark.parametrize("seed", range(4))
def test_classify_class_matches_jax_core(seed):
    plain = plain_state(seed)
    core, j_core = core_from_plain(*plain), jax_core_from_plain(*plain)
    seen = set()
    for rq_id, degraded, check_free in itertools.product(
            range(len(plain[1])), (False, True), (False, True)):
        got = decision.classify_class(core, rq_id, degraded=degraded,
                                      check_free=check_free)
        want = jax_decision.classify_class(j_core, rq_id, degraded=degraded,
                                           check_free=check_free)
        assert got == want, (rq_id, degraded, check_free)
        seen.add(got)
    assert {decision.REASON_NO_MATCHING_WORKER,
            decision.REASON_WORKER_LIFETIME} <= seen
    assert core.capable_memo.keys() == j_core.capable_memo.keys()
    for w, jw in zip(core.workers.values(), j_core.workers.values()):
        for rq_id in range(len(plain[1])):
            for v, jv in zip(core.rq_map.get_variants(rq_id).variants,
                             j_core.rq_map.get_variants(rq_id).variants):
                assert (decision.variant_fits_free(w, v)
                        == jax_decision.variant_fits_free(jw, jv))


def _start(core, assignments):
    for task, wid, rq_id, variant in assignments:
        w = core.workers[wid]
        w.assign(task, core.variant_amounts(rq_id, variant, w))


@pytest.mark.parametrize("seed", range(4))
def test_unplaced_entries_after_a_tick_match_jax(seed):
    """One tick through both packages over their Cores, the assignments
    started on the workers, then build_unplaced_entries over the leftover
    batches, with the lookahead and fairness marks and degraded or not:
    the same entries."""
    plain = plain_state(seed)
    core, j_core = core_from_plain(*plain), jax_core_from_plain(*plain)
    got = port_tick.run_tick(core.queues, core.worker_rows(), core.rq_map,
                             core.resource_map,
                             GreedyCutScanModel(device="cpu",
                                                backend="device"))
    want = jax_tick.run_tick(j_core.queues, j_core.worker_rows(),
                             j_core.rq_map, j_core.resource_map,
                             JaxModel(backend="numpy"))
    assert got == want
    _start(core, got)
    _start(j_core, want)
    left = port_tick.create_batches(core.queues)
    j_left = jax_tick.create_batches(j_core.queues)
    assert [(b.rq_id, b.priority, b.size) for b in left] == \
        [(b.rq_id, b.priority, b.size) for b in j_left]
    placed_blevel = {1: 2, 2: 1}
    fairness = max(b.priority for b in left) if left else None
    for degraded, marks in itertools.product((False, True), (False, True)):
        kw = dict(degraded=degraded)
        if marks:
            kw.update(placed_blevel=placed_blevel, fairness_placed=fairness)
        entries = decision.build_unplaced_entries(core, left, {}, **kw)
        j_entries = jax_decision.build_unplaced_entries(j_core, j_left, {},
                                                        **kw)
        assert entries == j_entries
    assert entries


def test_unplaced_entries_truncate_past_the_limit():
    resources = ["cpus"]
    classes = [[{"entries": [("cpus", (64 + c) * U, "compact")]}]
               for c in range(3)]
    tasks = [(t, t % 3, (0, -t)) for t in range(1, 100)]
    workers = [(1, [4 * U], 4, INF, [4 * U])]
    core = core_from_plain(resources, classes, tasks, workers)
    j_core = jax_core_from_plain(resources, classes, tasks, workers)
    entries = decision.build_unplaced_entries(
        core, port_tick.create_batches(core.queues), {})
    assert entries == jax_decision.build_unplaced_entries(
        j_core, jax_tick.create_batches(j_core.queues), {})
    assert entries[-1]["reason"] == decision.REASON_TRUNCATED
    assert len(entries) == decision.MAX_UNPLACED_ENTRIES + 1
