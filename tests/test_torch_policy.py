"""The port's scheduling policy (hyperqueue_tpu_torch.scheduler.policy and
.predict) against the JAX package's, on identical inputs.

Both packages run the same float32 numpy and float64 Python arithmetic, so
every comparison is exact: affinity rows with assert_array_equal, boosts,
predictions and Jain indices with ==.
"""

import types

import numpy as np
import pytest

from hyperqueue_tpu.resources.map import ResourceIdMap, ResourceRqMap
from hyperqueue_tpu.resources.request import (
    ResourceRequest,
    ResourceRequestEntry,
    ResourceRequestVariants,
)
from hyperqueue_tpu.scheduler import policy as jax_policy
from hyperqueue_tpu.scheduler.predict import (
    RuntimePredictor as JaxPredictor,
)
from hyperqueue_tpu.scheduler.queues import encode_sched_priority
from hyperqueue_tpu.scheduler.tick import Batch as JaxBatch
from hyperqueue_tpu_torch.convert import (
    group_ids,
    policy_table_from_plain,
    tick_state_from_plain,
)
from hyperqueue_tpu_torch.scheduler import policy as port_policy
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor

U = 10_000
INF = 2**31 - 1

POLICY_TOML = """
[affinity."cpus"]
"*"  = 1.0
fast = 2.0
slow = 0.0

[affinity."cpus+gpus"]
fast = 0.5

[affinity."nodes"]
"*"  = 1.0
slow = 0.0

[fairness]
enabled   = true
max_boost = 3

[prediction]
enabled    = true
max_boost  = 4
ewma_alpha = 0.25
"""

POLICY_PLAIN = {
    "affinity": {
        "cpus": {"*": 1.0, "fast": 2.0, "slow": 0.0},
        "cpus+gpus": {"fast": 0.5},
        "nodes": {"*": 1.0, "slow": 0.0},
    },
    "fairness": {"enabled": True, "max_boost": 3},
    "prediction": {"enabled": True, "max_boost": 4, "ewma_alpha": 0.25},
}

GROUPS = ["fast", "slow", "default", "fast", "slow", "mid"]


def _table_fields(table):
    return (table.affinity, table.fairness_enabled, table.fairness_max_boost,
            table.prediction_enabled, table.prediction_max_boost,
            table.ewma_alpha, table.seed_journal)


def test_from_file_and_from_plain_match_jax(tmp_path):
    path = tmp_path / "policy.toml"
    path.write_text(POLICY_TOML)
    want = jax_policy.PolicyTable.from_file(str(path))
    got = port_policy.PolicyTable.from_file(str(path))
    assert _table_fields(got) == _table_fields(want)
    assert got.source == want.source == str(path)
    assert _table_fields(policy_table_from_plain(POLICY_PLAIN)) == \
        _table_fields(want)


@pytest.mark.parametrize("text, match", [
    ("[affinity]\ncpus = 2.0\n", "must be a table"),
    ('[affinity."cpus"]\nfast = -1.0\n', "negative"),
])
def test_from_file_rejects_what_jax_rejects(tmp_path, text, match):
    path = tmp_path / "policy.toml"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        jax_policy.PolicyTable.from_file(str(path))
    with pytest.raises(ValueError, match=match):
        port_policy.PolicyTable.from_file(str(path))


def _jax_maps(classes):
    """The JAX package's interning maps for tick_state_from_plain's
    resources ("cpus", "gpus", "mem") and classes."""
    resource_map = ResourceIdMap()
    for name in ("cpus", "gpus", "mem"):
        resource_map.get_or_create(name)
    rq_map = ResourceRqMap()
    for variants in classes:
        rq_map.get_or_create(ResourceRequestVariants(variants=tuple(
            ResourceRequest(
                entries=tuple(ResourceRequestEntry(resource_map.get(n), a)
                              for n, a, _p in v["entries"]),
                n_nodes=v.get("n_nodes", 0),
            ) for v in variants
        )))
    return resource_map, rq_map


def test_weight_and_task_class_match_jax():
    want = jax_policy.PolicyTable(affinity=POLICY_PLAIN["affinity"])
    got = policy_table_from_plain(POLICY_PLAIN)
    for tclass in ("cpus", "cpus+gpus", "nodes", "mem", "none"):
        assert got.has_row(tclass) == want.has_row(tclass)
        for wclass in GROUPS + ["other"]:
            assert got.weight(tclass, wclass) == want.weight(tclass, wclass)
    # the labels, through the port's own maps built from the same plain data
    classes = [
        [{"entries": [("cpus", U, "compact")]}],
        [{"entries": [("gpus", U, "compact"), ("cpus", 2 * U, "compact")]}],
        [{"entries": [], "n_nodes": 3}],
        [{"entries": [("mem", U, "compact")]},
         {"entries": [("cpus", U, "compact")]}],
    ]
    p_resources, p_rq_map, _q, _rows = tick_state_from_plain(
        ["cpus", "gpus", "mem"], classes, [], [])
    j_resources, j_rq_map = _jax_maps(classes)
    labels = [port_policy.task_class(p_rq_map.get_variants(i), p_resources)
              for i in range(len(classes))]
    assert labels == [
        jax_policy.task_class(j_rq_map.get_variants(i), j_resources)
        for i in range(len(classes))
    ]
    assert labels == ["cpus", "cpus+gpus", "nodes", "mem"]


def _ledger():
    return types.SimpleNamespace(
        rows={
            1: {"label": "train", "resource_seconds": {"cpus": 90.0}},
            2: {"label": "eval", "resource_seconds": {"cpus": 10.0,
                                                      "gpus": 5.0}},
            3: {"label": "etl", "resource_seconds": {}},
        },
        open_runs={
            (1, 0): {"usage": {"cpus": 4.0}},
            (1, 1): {"usage": {"cpus": 2.0, "gpus": 1.0}},
            (2, 0): {"usage": {"cpus": 1.0}},
        },
    )


def _fed(predictor_cls):
    p = predictor_cls(alpha=0.25)
    for label, runtime in [("train", 40.0), ("eval", 10.0), ("train", 60.0),
                           ("etl", 3.0), ("eval", -1.0), ("", 2.0)]:
        p.observe(label, runtime)
    return p


@pytest.mark.parametrize("use_plain", [False, True], ids=["file", "plain"])
def test_tick_context_matches_jax(tmp_path, use_plain):
    path = tmp_path / "policy.toml"
    path.write_text(POLICY_TOML)
    names = {1: None, 2: "eval", 3: "etl"}  # job 1 falls back to the ledger
    want_state = jax_policy.PolicyState(
        jax_policy.PolicyTable.from_file(str(path)),
        predictor=_fed(JaxPredictor), ledger=_ledger(), job_name=names.get,
        live_jobs=lambda: [1, 2, 3, 4],
    )
    got_state = port_policy.PolicyState(
        policy_table_from_plain(POLICY_PLAIN) if use_plain
        else port_policy.PolicyTable.from_file(str(path)),
        predictor=_fed(RuntimePredictor), ledger=_ledger(),
        job_name=names.get, live_jobs=lambda: [1, 2, 3, 4],
    )
    classes = [
        [{"entries": [("cpus", U, "compact")]}],
        [{"entries": [("cpus", 2 * U, "compact"), ("gpus", U, "compact")]}],
        [{"entries": [], "n_nodes": 2}],
        [{"entries": [("mem", U, "compact")]}],
    ]
    workers = [(i + 1, [8 * U, 0, 16 * U], 8, INF, None, g)
               for i, g in enumerate(GROUPS)]
    resource_map, rq_map, _q, rows = tick_state_from_plain(
        ["cpus", "gpus", "mem"], classes, [], workers)
    j_resources, j_rq_map = _jax_maps(classes)
    j_workers = {r.worker_id: types.SimpleNamespace(group=r.group)
                 for r in rows}
    p_workers = {r.worker_id: r for r in rows}
    worker_ids = [r.worker_id for r in rows]
    spec = [(0, 1), (1, 2), (2, 3), (3, 1), (0, 3)]  # (rq_id, job)
    j_batches = [JaxBatch(rq_id=rq, priority=(0, encode_sched_priority(j)),
                          size=4) for rq, j in spec]
    p_batches = [port_tick.Batch(rq_id=rq,
                                 priority=(0, encode_sched_priority(j)),
                                 size=4) for rq, j in spec]
    for _ in range(2):  # the second tick reads the class cache
        want = want_state.tick_context(j_workers, j_rq_map, j_resources,
                                       worker_ids, j_batches)
        got = got_state.tick_context(p_workers, rq_map, resource_map,
                                     worker_ids, p_batches)
        assert sorted(got.rows) == sorted(want.rows) == [0, 1, 2]
        for rq in want.rows:
            np.testing.assert_array_equal(got.rows[rq], want.rows[rq])
            assert got.rows[rq].dtype == want.rows[rq].dtype
        assert got.boosts == want.boosts
        assert got.boosts  # fairness and prediction both act
        for j in (1, 2, 3, 4):
            sched = encode_sched_priority(j)
            assert got.boost_for_sched(sched) == want.boost_for_sched(sched)
    assert got_state.observe_jain() == want_state.observe_jain()
    assert got_state.last_jain == want_state.last_jain
    stats, want_stats = got_state.stats(), want_state.stats()
    assert stats.pop("source") == ("plain" if use_plain else str(path))
    want_stats.pop("source")
    assert stats == want_stats
    assert got_state.predictor.stats() == want_state.predictor.stats()
    assert got_state.predictor.peek("train") == \
        want_state.predictor.peek("train")
    assert group_ids(rows).tolist() == [0, 1, 2, 0, 1, 3]


def test_observe_jain_edge_cases_match_jax():
    for ledger in (None, types.SimpleNamespace(rows={}, open_runs={}),
                   types.SimpleNamespace(rows={}, open_runs={
                       (1, 0): {"usage": {"cpus": 2.0}},
                       (2, 0): {"usage": {"cpus": 2.0}}})):
        want = jax_policy.PolicyState(jax_policy.PolicyTable(), ledger=ledger)
        got = port_policy.PolicyState(port_policy.PolicyTable(), ledger=ledger)
        assert got.observe_jain() == want.observe_jain()


def test_seed_journal_raises(tmp_path):
    """The predictor's journal seed, which raised until the journal was
    ported: the same journal seeds the same table in both packages, and
    `build_policy` with a `seed_journal` builds the same policy."""
    from hyperqueue_tpu.events.journal import Journal as JaxJournal

    journal = tmp_path / "seed.journal"
    records = [
        {"event": "job-submitted", "job": 1, "desc": {"name": "train"}},
        {"event": "job-submitted", "job": 2, "desc": {"name": "etl"}},
        {"event": "task-started", "job": 1, "task": 0, "started_at": 10.0},
        {"event": "task-started", "job": 1, "task": 1, "time": 11.0},
        {"event": "task-started", "job": 2, "task": 0, "started_at": 5.0},
        {"event": "task-finished", "job": 1, "task": 0, "time": 14.5},
        # worker stamps win over the commit time where both ride along
        {"event": "task-finished", "job": 1, "task": 1, "time": 30.0,
         "trace": {"spawned_at": 12.0, "exited_at": 13.25}},
        {"event": "task-finished", "job": 2, "task": 0, "time": 9.0},
        # unpaired: skipped, not fatal
        {"event": "task-finished", "job": 3, "task": 0, "time": 1.0},
    ]
    writer = JaxJournal(journal)
    writer.open_for_append()
    for rec in records:
        writer.write(rec)
    writer.close()
    got, want = RuntimePredictor(alpha=0.5), JaxPredictor(alpha=0.5)
    assert got.seed_from_journal(str(journal)) == \
        want.seed_from_journal(str(journal)) == 3
    for label in ("train", "etl", "job"):
        assert got.peek(label) == want.peek(label)
    assert got.stats() == want.stats()
    path = tmp_path / "policy.toml"
    path.write_text(f'[prediction]\nenabled = true\newma_alpha = 0.5\n'
                    f'seed_journal = "{journal}"\n')
    state = port_policy.build_policy(str(path))
    jax_state = jax_policy.build_policy(str(path))
    assert state.predictor.stats() == jax_state.predictor.stats()
    assert state.predictor.peek("train") == jax_state.predictor.peek("train")
    assert state.stats() == jax_state.stats()
    # without a seed the table builds a policy with a predictor, as in JAX
    path.write_text("[prediction]\nenabled = true\newma_alpha = 0.5\n")
    state = port_policy.build_policy(str(path))
    want_state = jax_policy.build_policy(str(path))
    assert state.predictor.alpha == want_state.predictor.alpha == 0.5
    assert port_policy.build_policy(None) is None
