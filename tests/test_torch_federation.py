"""The JAX package's federation tests (tests/test_federation.py), run
against the port on the CPU, and the port's federation held against the
JAX package's.

Every case of tests/test_federation.py runs with the port swapped in
(`test_torch_cli_e2e.run_scenario`): its three `HqEnv` scenarios start the
port's shards, standby and workers as `python -m hyperqueue_tpu_torch`
processes with `--scheduler cpu`. The cross-package cases feed the same
seeded inputs through both packages' pure functions (`plan_lending`) and
require equal outputs, and read in one package the lease and federation
descriptor the other wrote. A fenced server of either package stops
without sending its workers `stop`.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import test_federation as jax_federation
from test_torch_cli_e2e import run_scenario, scenarios

from hyperqueue_tpu.server import federation as jax_fed
from hyperqueue_tpu.utils import lease as jax_lease
from hyperqueue_tpu.utils import serverdir as jax_serverdir
from hyperqueue_tpu_torch.server import bootstrap as port_bootstrap
from hyperqueue_tpu_torch.server import federation as port_fed
from hyperqueue_tpu_torch.utils import lease as port_lease
from hyperqueue_tpu_torch.utils import serverdir as port_serverdir

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.federation


class CpuServer(port_bootstrap.Server):
    """The port's `Server` with the CPU as its default device (a test
    that builds one in-process solves on the CPU, as the shards it
    spawns do under `--scheduler cpu`)."""

    def __init__(self, *args, device: str = "cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


@pytest.mark.parametrize("scenario", scenarios(jax_federation))
def test_federation_case_on_the_port(scenario, tmp_path, monkeypatch):
    monkeypatch.setattr(port_bootstrap, "Server", CpuServer)
    run_scenario(jax_federation, scenario, tmp_path, monkeypatch)


def _random_samples(rng: np.random.Generator, now: float) -> dict:
    """A seeded fleet of shard samples as the subscribe plane sends them:
    some shards stale or down, backlogs, idle and busy workers, pending
    reasons."""
    samples = {}
    for shard in range(int(rng.integers(2, 6))):
        if rng.random() < 0.1:
            samples[shard] = None
            continue
        workers = [
            {"id": int(wid), "running": int(rng.integers(0, 3)) *
             int(rng.random() < 0.5), "prefilled": int(rng.random() < 0.2)}
            for wid in rng.choice(50, size=int(rng.integers(0, 6)),
                                  replace=False)
        ]
        reasons = {}
        if rng.random() < 0.5:
            reasons["insufficient-capacity"] = int(rng.integers(1, 9))
        samples[shard] = {
            "time": now - float(rng.choice([0.1, 1.0, 60.0])),
            "ready": int(rng.integers(0, 12)) * int(rng.random() < 0.6),
            "mn_queued": int(rng.integers(0, 3)) * int(rng.random() < 0.2),
            "n_workers": len(workers),
            "workers": workers,
            "pending_reasons": reasons,
        }
    return samples


@pytest.mark.parametrize("seed", range(8))
def test_plan_lending_agrees_with_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    now = 1_000.0
    for mod in (jax_fed, port_fed):
        monkeypatch.setattr(mod.clock, "now", lambda: now)
    moved = 0
    for _ in range(50):
        samples = _random_samples(rng, now)
        exclude = {(int(rng.integers(0, 5)), int(rng.integers(0, 50)))
                   for _ in range(int(rng.integers(0, 4)))}
        jax_moves = jax_fed.plan_lending(samples, exclude=exclude)
        port_moves = port_fed.plan_lending(samples, exclude=exclude)
        assert port_moves == jax_moves
        moved += len(port_moves)
    assert moved > 0  # the seeds reach the planner's moving branch


@pytest.mark.parametrize("writer,reader", [
    (port_lease, jax_lease), (jax_lease, port_lease)],
    ids=["port-writes", "jax-writes"])
def test_lease_file_is_read_by_the_other_package(writer, reader, tmp_path):
    """A lease one package acquired, renewed and released reads the same
    in the other, and the other's claim fences the first holder."""
    held = writer.ShardLease(tmp_path, timeout=30.0)
    rec = held.acquire("owner-a")
    assert rec["epoch"] == 1 and held.renew()
    other = reader.ShardLease(tmp_path, timeout=30.0)
    assert other.read() == held.read()
    assert other.state() == "held"
    with pytest.raises(reader.LeaseHeldError):
        other.acquire("owner-b")
    # a stale lease (timeout 0) is claimed across packages: epoch 2, and
    # the first holder's next renew finds itself fenced
    claimer = reader.ShardLease(tmp_path, timeout=0.0)
    assert claimer.state() == "stale"
    assert claimer.acquire("owner-b")["epoch"] == 2
    assert held.renew() is False
    assert writer.ShardLease(tmp_path, timeout=30.0).read()["owner"] == \
        "owner-b"
    claimer.release()
    assert held.read() is None and other.state() == "absent"


@pytest.mark.parametrize("writer,reader", [
    (port_serverdir, jax_serverdir), (jax_serverdir, port_serverdir)],
    ids=["port-writes", "jax-writes"])
def test_federation_descriptor_is_read_by_the_other_package(
        writer, reader, tmp_path):
    root = tmp_path / "root"
    desc = writer.write_federation(root, 2)
    assert reader.load_federation(root) == desc
    assert (root / "federation.json").read_text() == json.dumps(
        desc, indent=2)
    # the other package refuses a conflicting count and grows it online
    with pytest.raises(ValueError, match="refusing to restart"):
        reader.write_federation(root, 3)
    grown = reader.grow_federation(root, 3)
    assert writer.load_federation(root) == grown == {
        "version": 1, "shard_count": 3, "base_shard_count": 2}
    for k in range(3):
        assert writer.shard_path(root, k).is_dir()
    assert reader.load_federation(tmp_path) is None


class _SeenWorker:
    """A worker connection of the server: closed at shutdown."""

    closed = False

    def close(self):
        self.closed = True


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fenced_server_sends_its_workers_no_stop(pkg, tmp_path):
    """A server whose lease a successor claimed is fenced: its shutdown
    leaves the workers to the successor (no `stop`), and it does not
    release the successor's lease; an unfenced shard's clean shutdown
    sends `stop` and retires its own lease."""
    if pkg == "jax":
        from hyperqueue_tpu.server.bootstrap import Server
        lease_mod, kw = jax_lease, {}
    else:
        from hyperqueue_tpu_torch.server.bootstrap import Server
        lease_mod, kw = port_lease, {"device": "cpu"}

    results = {}
    for fenced in (True, False):
        root = tmp_path / f"{pkg}-{fenced}"

        async def life():
            server = Server(
                server_dir=root / "shard-0000", federation_root=root,
                shard_count=2, shard_id=0, lease_timeout=1.5,
                journal_path=root / "shard-0000" / "journal.bin",
                memory_transport=True, client_plane="reactor",
                profile_hz=0, **kw)
            await server.start()
            sent = []
            server.comm.send_stop = sent.append
            conn = server._worker_conns[1] = _SeenWorker()
            if fenced:
                # a successor claims the lease (stale to it): the renew
                # loop finds the new owner and fences this incarnation
                lease_mod.ShardLease(server.server_dir, 0.0).acquire(
                    "successor")
                await asyncio.wait_for(server._stop_event.wait(), 20.0)
            await server.shutdown()
            lease = lease_mod.ShardLease(server.server_dir, 30.0).read()
            # the connection closes either way: a fenced server's workers
            # reconnect to the successor
            assert conn.closed
            return server.fenced, sent, lease

        results[fenced] = asyncio.run(life())
    fenced_flag, sent, lease = results[True]
    assert fenced_flag is True and sent == []
    assert lease["owner"] == "successor" and lease["epoch"] == 2
    fenced_flag, sent, lease = results[False]
    assert fenced_flag is False and sent == [1] and lease is None


def test_successor_kwargs_carry_the_device():
    """A successor that a watcher promotes (in a standby or a peer shard)
    is built from `federation_server_kwargs`: the JAX server's subset plus
    the device, so it solves where its predecessor did."""
    from hyperqueue_tpu.server.bootstrap import Server as JaxServer

    port = CpuServer(server_dir="/nonexistent", scheduler="cpu",
                     reattach_timeout=7.0, lazy_array_threshold=0)
    jax = JaxServer(server_dir="/nonexistent", scheduler="cpu",
                    reattach_timeout=7.0, lazy_array_threshold=0)
    kwargs = port.federation_server_kwargs()
    assert kwargs.pop("device") == "cpu"
    assert kwargs == jax.federation_server_kwargs()


def test_failed_promotion_on_the_card_is_no_host_fallback(
        tmp_path, monkeypatch, caplog):
    """Without CUDA, a watcher whose successors solve on the card fails
    the promotion of a dead shard: the scan raises (the watcher's loop
    logs it, as the JAX watcher does), nothing is promoted, nothing runs
    on the host, and the dead holder's lease stays as it was."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "root"
    port_serverdir.write_federation(root, 2)
    port_lease.ShardLease(port_serverdir.shard_path(root, 1), 0.0).acquire(
        "dead-holder")
    watcher = port_fed.FailoverWatcher(
        root, server_kwargs={"device": "cuda", "profile_hz": 0},
        lease_timeout=0.5, own_shard=0)
    time.sleep(0.6)  # the holder's lease goes stale
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(watcher.scan_once())
    assert watcher.promoted == {}
    lease = port_lease.ShardLease(port_serverdir.shard_path(root, 1),
                                  30.0).read()
    assert (lease["owner"], lease["epoch"]) == ("dead-holder", 1)
    assert not (port_serverdir.shard_path(root, 1) / "hq-current").exists()

    # the watcher's loop logs the failed scan and keeps watching
    async def one_pass():
        task = asyncio.ensure_future(watcher.run())
        await asyncio.sleep(watcher.poll * 2.5)
        task.cancel()

    watcher.poll = 0.05
    with caplog.at_level("ERROR", logger=port_fed.logger.name):
        asyncio.run(one_pass())
    assert "failover scan failed" in caplog.text
    assert watcher.promoted == {}


def test_api_client_on_a_federation_root(tmp_path, monkeypatch):
    """`api.Client(root)` over two port shards on the CPU: each submit
    lands on the shard `HQ_SHARD` names (job ids in that shard's class),
    the waits and reads route by job id, and the federated session fans
    `job_info` out per job."""
    from test_torch_cli_e2e import PortCliEnv

    from hyperqueue_tpu_torch.api import Client, Job
    from hyperqueue_tpu_torch.client.connection import FederatedSession

    with PortCliEnv(tmp_path) as env:
        for k in (0, 1):
            env.start_shard(k, 2, "--lease-timeout", "2")
        for k in (0, 1):
            env.start_worker("--shard", str(k), cpus=1)
        ids = []
        with Client(env.server_dir) as client:
            assert isinstance(client._session, FederatedSession)
            for k in (0, 1, 1):
                monkeypatch.setenv("HQ_SHARD", str(k))
                client._session = FederatedSession(env.server_dir)
                job = Job(name=f"on-{k}")
                job.program(["true"])
                ids.append(client.submit(job))
            client.wait_for_jobs(ids)
            infos = client.job_info(ids)
        assert [(i - 1) % 2 for i in ids] == [0, 1, 1]
        assert [i["id"] for i in infos] == ids
        assert all(i["counters"]["finished"] == 1 for i in infos)
