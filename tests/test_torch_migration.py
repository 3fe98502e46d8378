"""The JAX package's resharding tests (tests/test_migration.py), run
against the port on the CPU, and the port's ownership log and rebalance
planner held against the JAX package's.

Every case of tests/test_migration.py but the federated simulator's
(`test_sim_*`, whose module the port has not yet) runs with the port
swapped in (`test_torch_cli_e2e.run_scenario`), its `serverdir` included;
the online shard add through real processes stays `slow`, as in the JAX
file. The cross-package cases feed seeded inputs through both packages'
pure functions (`plan_rebalance`, `added_shard_block`) and require equal
outputs, and hold the `ownership.log` one package writes byte-equal to the
other's and readable by it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import test_migration as jax_migration
from test_torch_cli_e2e import run_scenario

from hyperqueue_tpu.server import federation as jax_fed
from hyperqueue_tpu.utils import ownership as jax_own
from hyperqueue_tpu.utils import serverdir as jax_serverdir
from hyperqueue_tpu_torch.server import federation as port_fed
from hyperqueue_tpu_torch.utils import ownership as port_own
from hyperqueue_tpu_torch.utils import serverdir as port_serverdir

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.federation


def _cases() -> list:
    params = []
    for name, fn in vars(jax_migration).items():
        if not name.startswith("test_") or name.startswith("test_sim_") \
                or getattr(fn, "__module__", None) != jax_migration.__name__:
            continue
        marks = [m for m in getattr(fn, "pytestmark", ())
                 if m.name == "slow"]
        params.append(pytest.param(fn, id=name, marks=marks))
    return params


@pytest.mark.parametrize("case", _cases())
def test_migration_case_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_migration, "serverdir", port_serverdir)
    run_scenario(jax_migration, case, tmp_path, monkeypatch)


def test_twins_cover_every_case_but_the_simulators():
    names = {p.id for p in _cases()}
    assert "test_e2e_migration_with_pinned_session" in names
    assert "test_e2e_online_shard_add" in names
    assert not any(n.startswith("test_sim_") for n in names)
    assert len(names) == 11


@pytest.mark.parametrize("seed", range(6))
def test_plan_rebalance_agrees_with_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    now = 5_000.0
    for mod in (jax_fed, port_fed):
        monkeypatch.setattr(mod.clock, "now", lambda: now)
    planned = 0
    for _ in range(60):
        samples = {}
        for shard in range(int(rng.integers(1, 6))):
            if rng.random() < 0.1:
                samples[shard] = None
                continue
            samples[shard] = {
                "time": now - float(rng.choice([0.0, 2.0, 600.0])),
                "ready": int(rng.integers(0, 40)),
                "mn_queued": int(rng.integers(0, 4)),
                "workers": [{"id": w, "prefilled": int(rng.integers(0, 6))}
                            for w in range(int(rng.integers(0, 4)))],
            }
        ratio = float(rng.choice([1.2, 1.5, 2.0]))
        jax_plan = jax_fed.plan_rebalance(samples, min_ratio=ratio)
        port_plan = port_fed.plan_rebalance(samples, min_ratio=ratio)
        assert port_plan == jax_plan
        planned += port_plan is not None
    assert planned > 0


def test_added_shard_block_agrees_with_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        base = int(rng.integers(1, 9))
        shard = base + int(rng.integers(0, 4000))
        assert port_own.added_shard_block(shard, base) == \
            jax_own.added_shard_block(shard, base)
    assert port_own.ADDED_ID_BASE == jax_own.ADDED_ID_BASE
    assert port_own.ADDED_ID_SPAN == jax_own.ADDED_ID_SPAN
    for own in (port_own, jax_own):
        with pytest.raises(own.OwnershipError, match="base shard"):
            own.added_shard_block(1, 2)


def _drive_log(own, serverdir, root, rng_seed: int) -> None:
    """One seeded history of the ownership log: migrations claimed,
    committed, finished or aborted, a shard added online and rebalance
    verdicts."""
    rng = np.random.default_rng(rng_seed)
    serverdir.write_federation(root, 2)
    store = own.OwnershipStore(root)
    for i in range(12):
        mig = f"m-{i}"
        job = int(rng.integers(1, 40))
        src = store.load().shard_for_job(job)
        try:
            store.begin_migration(job, src, 1 - src, mig=mig)
        except own.MigrationClaimed:
            continue
        if rng.random() < 0.25:
            store.abort_migration(mig, reason="seeded")
            continue
        store.commit_migration(mig)
        if rng.random() < 0.8:
            store.finish_migration(mig)
    serverdir.grow_federation(root, 3)
    store.record_verdict({"from": 0, "to": 2, "moved": None,
                          "reason": "seeded verdict"})


def test_ownership_log_is_byte_equal_and_read_by_the_other_package(
        tmp_path, monkeypatch):
    ticks = {"jax": 0.0, "port": 0.0}

    def fixed(name):
        def now():
            ticks[name] += 1.0
            return 1_700_000_000.0 + ticks[name]
        return now

    monkeypatch.setattr(jax_own.clock, "now", fixed("jax"))
    monkeypatch.setattr(port_own.clock, "now", fixed("port"))
    _drive_log(jax_own, jax_serverdir, tmp_path / "jax", 11)
    _drive_log(port_own, port_serverdir, tmp_path / "port", 11)
    jax_bytes = (tmp_path / "jax" / "ownership.log").read_bytes()
    assert (tmp_path / "port" / "ownership.log").read_bytes() == jax_bytes
    assert (tmp_path / "port" / "federation.json").read_bytes() == \
        (tmp_path / "jax" / "federation.json").read_bytes()
    # each package reads the other's log to the same map
    for root in ("jax", "port"):
        jax_map = dataclasses.asdict(
            jax_own.OwnershipStore(tmp_path / root).load())
        port_map = dataclasses.asdict(
            port_own.OwnershipStore(tmp_path / root).load())
        assert port_map == jax_map
        assert port_map["shard_count"] == 3 and port_map["epoch"] > 4
    # a torn final line (a kill -9 inside an append) never happened, in
    # either reader
    with open(tmp_path / "jax" / "ownership.log", "ab") as f:
        f.write(b'{"kind": "migration-intent", "mig": "torn"')
    assert dataclasses.asdict(
        port_own.OwnershipStore(tmp_path / "jax").load()) == \
        dataclasses.asdict(jax_own.OwnershipStore(tmp_path / "jax").load())
    # an append after the torn line reads alike in both packages (the
    # reader stops at the first undecodable line, which the append
    # extends)
    port_own.OwnershipStore(tmp_path / "jax").record_verdict(
        {"from": 1, "to": 0, "moved": None, "reason": "after the tear"})
    assert dataclasses.asdict(
        port_own.OwnershipStore(tmp_path / "jax").load()) == \
        dataclasses.asdict(jax_own.OwnershipStore(tmp_path / "jax").load())
