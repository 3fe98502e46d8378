"""The port's server directory and access records against the JAX
package's, on the CPU.

Access records: the same fields, written by the port's `store_access`
(atomic, 0600) and read by the JAX `load_access` and back; split
single-plane records; `load_access` riding out a torn record and failing
fast without a server. The `hq-current` lifecycle: each instance dir
repoints it, and a started port server's clean stop retires it only while
it still names that server's instance. The federation descriptor refuses,
naming ROADMAP item 10.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import types

import pytest
import torch

import test_torch_server_start as server_start
from hyperqueue_tpu.utils import serverdir as jax_serverdir
from hyperqueue_tpu_torch.utils import serverdir as port_serverdir

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(name="jax", serverdir=jax_serverdir),
    "port": types.SimpleNamespace(name="port", serverdir=port_serverdir),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
@pytest.mark.parametrize("auth", ["both", "no-client", "no-worker"])
def test_access_record_written_by_one_read_by_the_other(tmp_path, writer,
                                                        reader, auth):
    w, r = PKGS[writer].serverdir, PKGS[reader].serverdir
    record = w.generate_access(
        "node17", 4001, 4002,
        disable_client_auth=auth == "no-client",
        disable_worker_auth=auth == "no-worker",
        worker_host="node17-ib" if writer == "port" else None)
    instance = w.create_instance_dir(tmp_path)
    w.store_access(instance, record)
    path = instance / w.ACCESS_FILE
    assert oct(path.stat().st_mode & 0o777) == "0o600"
    loaded = r.load_access(tmp_path)
    assert loaded.to_json() == record.to_json()
    assert loaded.client_key_bytes() == record.client_key_bytes()
    assert loaded.worker_key_bytes() == record.worker_key_bytes()
    assert loaded.host_for_workers() == record.host_for_workers()
    # the same fields, field for field, as the JAX record
    assert set(vars(loaded)) == set(vars(jax_serverdir.AccessRecord(
        "u", "h", 1, 2, None, None)))
    for role in ("client", "worker"):
        split = record.to_json(role)
        assert split == jax_serverdir.AccessRecord.from_json(
            record.to_json()).to_json(role)
        assert set(r.AccessRecord.from_json(split).to_json(role)) == \
            set(split)


def test_generate_access_keys_and_uid(pkg):
    a = pkg.serverdir.generate_access("h", 1, 2)
    b = pkg.serverdir.generate_access("h", 1, 2)
    assert a.server_uid != b.server_uid and len(a.server_uid) == 16
    assert len(a.client_key_bytes()) == len(a.worker_key_bytes()) == 32
    assert a.client_key != a.worker_key
    c = pkg.serverdir.generate_access("h", 1, 2, disable_client_auth=True,
                                      disable_worker_auth=True)
    assert c.client_key_bytes() is None and c.worker_key_bytes() is None


def test_instance_dirs_and_hq_current(tmp_path, pkg):
    sd = pkg.serverdir
    first = sd.create_instance_dir(tmp_path)
    second = sd.create_instance_dir(tmp_path)
    assert (first.name, second.name) == ("001", "002")
    link = tmp_path / sd.CURRENT_LINK
    assert link.is_symlink() and os.readlink(link) == "002"
    # a stray tmp link from an interrupted flip is replaced, not fatal
    (tmp_path / f".{sd.CURRENT_LINK}.tmp").symlink_to("001")
    third = sd.create_instance_dir(tmp_path)
    assert os.readlink(link) == third.name == "003"


def test_load_access_rides_out_a_torn_record(tmp_path, pkg):
    sd = pkg.serverdir
    instance = sd.create_instance_dir(tmp_path)
    record = sd.generate_access("h", 5, 6)
    path = instance / sd.ACCESS_FILE
    path.write_text(json.dumps(record.to_json())[:20])   # torn

    def publish():
        time.sleep(0.1)
        sd.store_access(instance, record)

    t = threading.Thread(target=publish)
    t.start()
    try:
        loaded = sd.load_access(tmp_path, retry_secs=5.0)
    finally:
        t.join()
    assert loaded.to_json() == record.to_json()
    # a torn record nobody fixes propagates once the window closes
    path.write_text("{")
    with pytest.raises(ValueError):
        sd.load_access(tmp_path, retry_secs=0.05)


def test_load_access_without_a_server_fails_fast(tmp_path, pkg):
    t0 = time.monotonic()
    with pytest.raises(FileNotFoundError, match="no running server"):
        pkg.serverdir.load_access(tmp_path / "nothing", retry_secs=5.0)
    assert time.monotonic() - t0 < 1.0


def test_federation_descriptor_waits_for_item_10(tmp_path):
    for fn in (port_serverdir.write_federation,
               port_serverdir.grow_federation):
        with pytest.raises(NotImplementedError, match="item 10"):
            fn(tmp_path, 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        port_serverdir.load_federation(tmp_path)
    # the shard-path helpers are the JAX package's
    for k in (0, 7, 12):
        assert port_serverdir.shard_path(tmp_path, k) == \
            jax_serverdir.shard_path(tmp_path, k)
        assert port_serverdir.shard_id_of(
            port_serverdir.shard_path(tmp_path, k)) == k
    assert port_serverdir.shard_for_job(9, 4) == \
        jax_serverdir.shard_for_job(9, 4) == 0


def test_started_server_publishes_and_retires_hq_current(tmp_path):
    """A started port server publishes its access record under a fresh
    instance dir (read by the JAX `load_access`); a clean stop removes
    `hq-current` — unless a newer instance took it over meanwhile."""
    async def life(newer: bool):
        server = server_start.PKGS["port"].server(
            server_dir=tmp_path / f"srv-{newer}", client_plane="reactor",
            fanout_senders=0)
        access = await server.start()
        try:
            loaded = jax_serverdir.load_access(server.server_dir)
            assert loaded.to_json() == access.to_json()
            assert loaded.client_port == server.client_port > 0
            assert loaded.worker_port == server.worker_port > 0
            if newer:
                port_serverdir.create_instance_dir(server.server_dir)
        finally:
            server.stop()
            await asyncio.wait_for(server.run_until_stopped(), 20.0)
        link = server.server_dir / port_serverdir.CURRENT_LINK
        return link.is_symlink(), (server.server_dir / "001").is_dir()

    with server_start.server_process_state(fixed=False):
        assert asyncio.run(asyncio.wait_for(life(False), 30.0)) == \
            (False, True)
        assert asyncio.run(asyncio.wait_for(life(True), 30.0)) == \
            (True, True)
