"""The port's usage ledger (hyperqueue_tpu_torch.server.accounting) against
the JAX package's, and the server's event path into it.

The non-`env` tests of tests/test_accounting.py run twinned, against both
packages; a seeded random record stream folds into equal ledgers in both;
and a port Server and a JAX Server, driven through `_client_submit` and the
reactor's handlers on a few workers under one clock, journal byte-identical
files and end with equal ledgers.
"""

from __future__ import annotations

import asyncio
import random
import shutil
import types

import pytest
import torch

from hyperqueue_tpu.events import journal as jax_journal
from hyperqueue_tpu.events import restore as jax_restore
from hyperqueue_tpu.events import snapshot as jax_snapshot
from hyperqueue_tpu.server import accounting as jax_accounting
from hyperqueue_tpu.server import bootstrap as jax_bootstrap
from hyperqueue_tpu.server import reactor as jax_reactor
from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu_torch.events import journal as port_journal
from hyperqueue_tpu_torch.events import restore as port_restore
from hyperqueue_tpu_torch.events import snapshot as port_snapshot
from hyperqueue_tpu_torch.server import accounting as port_accounting
from hyperqueue_tpu_torch.server import bootstrap as port_bootstrap
from hyperqueue_tpu_torch.server import reactor as port_reactor
from hyperqueue_tpu_torch.transport.framing import attach_trace
from hyperqueue_tpu_torch.utils import clock as port_clock

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", accounting=jax_accounting, journal=jax_journal,
        snapshot=jax_snapshot, restore=jax_restore.restore_from_journal,
        server=jax_bootstrap.Server, reactor=jax_reactor, clock=jax_clock),
    "port": types.SimpleNamespace(
        name="port", accounting=port_accounting, journal=port_journal,
        snapshot=port_snapshot, restore=port_restore.restore_from_journal,
        server=lambda **kw: port_bootstrap.Server(device="cpu", **kw),
        reactor=port_reactor, clock=port_clock),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


def _submit(ledger, job_id, name, n_tasks=4):
    ledger.observe("job-submitted", {
        "event": "job-submitted", "job": job_id, "time": 1.0,
        "desc": {"name": name,
                 "array": {"ids": list(range(n_tasks)), "body": {}}},
    })


def _start(ledger, job_id, task, t, instance=0, queued=None, usage=None):
    ledger.observe("task-started", {
        "event": "task-started", "job": job_id, "task": task,
        "instance": instance, "workers": [1], "time": t,
        "queued_at": queued if queued is not None else t,
        "assigned_at": t, "started_at": t,
        "usage": usage or {"cpus": 2.0},
    })


# ------------------------------------------------------------- unit: fold
def test_ledger_basic_lifecycle_charges(pkg):
    led = pkg.accounting.AccountingLedger()
    _submit(led, 1, "train")
    _start(led, 1, 0, t=12.0, queued=10.0, usage={"cpus": 2.0, "gpus": 1.0})
    led.observe("task-finished", {
        "event": "task-finished", "job": 1, "task": 0, "time": 22.0,
    })
    row = led.job_report([1])[1]
    assert row["label"] == "train"
    assert row["task_seconds"] == pytest.approx(10.0)
    assert row["wait_seconds"] == pytest.approx(2.0)
    assert row["cpu_seconds"] == pytest.approx(20.0)
    assert row["gpu_seconds"] == pytest.approx(10.0)
    assert row["runs"] == 1 and row["finished"] == 1
    assert row["running"] == 0 and row["crash_retries"] == 0
    totals = led.rollup()["totals"]
    assert totals["jobs"] == 1
    assert totals["cpu_seconds"] == pytest.approx(20.0)
    assert led.brief()["task_seconds"] == pytest.approx(10.0)


def test_ledger_crash_retry_delta_charging(pkg):
    led = pkg.accounting.AccountingLedger()
    _submit(led, 1, "flaky")
    _start(led, 1, 0, t=5.0, instance=0)
    led.observe("task-restarted", {
        "event": "task-restarted", "job": 1, "task": 0,
        "crash_count": 1, "instance": 1, "time": 8.0,
    })
    _start(led, 1, 0, t=9.0, instance=1)
    led.observe("task-finished", {
        "event": "task-finished", "job": 1, "task": 0, "time": 15.0,
    })
    row = led.job_report([1])[1]
    assert row["crash_retries"] == 1
    assert row["runs"] == 2
    assert row["task_seconds"] == pytest.approx(3.0 + 6.0)
    led.observe("task-restarted", {
        "event": "task-restarted", "job": 1, "task": 1,
        "crash_count": 0, "instance": 1, "time": 16.0,
    })
    assert led.job_report([1])[1]["crash_retries"] == 1


def test_ledger_reattach_same_instance_single_span(pkg):
    led = pkg.accounting.AccountingLedger()
    _submit(led, 1, "ml")
    _start(led, 1, 0, t=12.0, queued=10.0)
    _start(led, 1, 0, t=12.0, queued=10.0)
    led.observe("task-finished", {
        "event": "task-finished", "job": 1, "task": 0, "time": 30.0,
    })
    row = led.job_report([1])[1]
    assert row["runs"] == 1
    assert row["task_seconds"] == pytest.approx(18.0)
    assert row["wait_seconds"] == pytest.approx(2.0)


def test_ledger_capture_seed_roundtrip_bit_equal(pkg):
    led = pkg.accounting.AccountingLedger()
    _submit(led, 1, "a")
    _submit(led, 2, "b")
    _start(led, 1, 0, t=3.0, queued=1.0)
    _start(led, 2, 1, t=4.0, usage={"cpus": 8.0})
    led.observe("task-finished", {
        "event": "task-finished", "job": 1, "task": 0, "time": 9.0,
    })
    led.observe("task-restarted", {
        "event": "task-restarted", "job": 2, "task": 1,
        "crash_count": 2, "instance": 1, "time": 10.0,
    })
    cap = led.capture()
    other = pkg.accounting.AccountingLedger()
    other.seed(cap)
    assert other.capture() == cap
    assert other.rollup() == led.rollup()
    assert led.capture() == cap
    # a capture seeds the other package's ledger to the same state
    twin = PKGS["port" if pkg.name == "jax" else "jax"] \
        .accounting.AccountingLedger()
    twin.seed(cap)
    assert twin.capture() == cap and twin.rollup() == led.rollup()


def test_ledger_migration_moves_usage_exactly_once(pkg):
    src = pkg.accounting.AccountingLedger()
    _submit(src, 7, "mover")
    _start(src, 7, 0, t=2.0, queued=1.0)
    src.observe("task-finished", {
        "event": "task-finished", "job": 7, "task": 0, "time": 12.0,
    })
    _start(src, 7, 1, t=5.0)
    accrued = src.rollup()["totals"]
    src.observe("migration-out", {
        "event": "migration-out", "job": 7, "mig": "m1", "time": 20.0,
    })
    assert src.rows[7]["migrating"] is True
    export = src.export_job(7)
    dst = pkg.accounting.AccountingLedger()
    mig_in = {
        "event": "migration-in", "job": 7, "mig": "m1", "time": 21.0,
        "record": {"job": 7, "job_state": {"name": "mover"},
                   "accounting": export},
    }
    dst.observe("migration-in", mig_in)
    state_once = dst.capture()
    dst.observe("migration-in", mig_in)
    assert dst.capture() == state_once
    src.observe("migration-out-done", {
        "event": "migration-out-done", "job": 7, "mig": "m1", "time": 22.0,
    })
    assert 7 not in src.rows
    assert src.rollup()["totals"]["jobs"] == 0
    moved = dst.rollup()["totals"]
    assert moved["task_seconds"] == pytest.approx(accrued["task_seconds"])
    assert moved["cpu_seconds"] == pytest.approx(accrued["cpu_seconds"])
    assert moved["running"] == 1
    assert dst.rows[7]["migrated_in"] is True
    dst.observe("task-finished", {
        "event": "task-finished", "job": 7, "task": 1, "time": 30.0,
    })
    assert dst.rollup()["totals"]["task_seconds"] == pytest.approx(
        accrued["task_seconds"] + 25.0
    )


def test_ledger_ignores_unaccounted_kinds(pkg):
    led = pkg.accounting.AccountingLedger()
    led.observe("worker-connected", {"event": "worker-connected", "id": 1})
    led.observe("slo-alert", {"event": "slo-alert", "alert": "x:page"})
    assert led.rows == {}
    assert "task-started" in pkg.accounting.ACCOUNTED_KINDS
    assert port_accounting.ACCOUNTED_KINDS == jax_accounting.ACCOUNTED_KINDS


# --------------------------------------------- restore: snapshot bit-equal
def _write_records(pkg, path, records):
    j = pkg.journal.Journal(path)
    j.open_for_append()
    for r in records:
        j.write(r)
    j.close()


def _make_server(pkg, tmp_path, name, journal):
    server = pkg.server(server_dir=tmp_path / name, journal_path=journal,
                        reattach_timeout=60.0)
    pkg.restore(server)
    return server


def _history_with_usage():
    records = []
    seq = [0]

    def emit(rec):
        rec["seq"] = seq[0]
        rec["time"] = 1_000.0 + seq[0]
        seq[0] += 1
        records.append(rec)

    emit({"event": "server-uid", "server_uid": "uid-boot-1"})
    emit({"event": "job-submitted", "job": 1,
          "desc": {"name": "train",
                   "array": {"ids": [0, 1], "body": {"cmd": ["true"]}}}})
    emit({"event": "task-started", "job": 1, "task": 0, "instance": 0,
          "variant": 0, "workers": [1], "queued_at": 1_000.5,
          "assigned_at": 1_001.0, "started_at": 1_001.5,
          "usage": {"cpus": 4.0}})
    emit({"event": "task-finished", "job": 1, "task": 0})
    emit({"event": "task-started", "job": 1, "task": 1, "instance": 0,
          "variant": 0, "workers": [1], "queued_at": 1_000.5,
          "assigned_at": 1_002.0, "started_at": 1_002.5,
          "usage": {"cpus": 4.0}})
    return records


def test_accounting_snapshot_restore_bit_equal_to_full_replay(tmp_path, pkg):
    records = _history_with_usage()
    j_orig = tmp_path / "orig.bin"
    _write_records(pkg, j_orig, records)
    a = _make_server(pkg, tmp_path, "a", j_orig)
    assert a.accounting.rows[1]["task_seconds"] > 0
    assert (1, 1) in a.accounting.open_runs
    a.n_boots += 1
    a.journal_uids.add("uid-boot-A")
    a._event_seq += 1
    tail_finish = {"event": "task-finished", "job": 1, "task": 1,
                   "time": 1_010.0}
    j_replay = tmp_path / "replay.bin"
    shutil.copy(j_orig, j_replay)
    jw = pkg.journal.Journal(j_replay)
    jw.open_for_append()
    jw.write({"event": "server-uid", "server_uid": "uid-boot-A",
              "seq": a._event_seq - 1, "time": 9_999.0})
    jw.write(dict(tail_finish, seq=a._event_seq))
    jw.close()
    c = _make_server(pkg, tmp_path, "c", j_replay)
    j_snap = tmp_path / "snap.bin"
    state = pkg.snapshot.capture_state(a)
    assert state.get("accounting")
    pkg.snapshot.write_snapshot(j_snap, state)
    _write_records(pkg, j_snap, [
        {"event": "server-uid", "server_uid": "uid-boot-A",
         "seq": state["seq"] - 1, "time": 9_999.0},
        dict(tail_finish, seq=state["seq"]),
    ])
    b = _make_server(pkg, tmp_path, "b", j_snap)
    assert b.last_restore["snapshot"] is not None
    assert b.accounting.capture() == c.accounting.capture()
    row = b.accounting.job_report([1])[1]
    assert row["runs"] == 2
    assert row["task_seconds"] == pytest.approx(
        (1_003.0 - 1_001.5) + (1_010.0 - 1_002.5)
    )
    # the other package restores the same files to the same ledgers
    other = PKGS["port" if pkg.name == "jax" else "jax"]
    assert _make_server(other, tmp_path, "b2", j_snap).accounting.capture() \
        == b.accounting.capture()
    assert _make_server(other, tmp_path, "c2", j_replay).accounting \
        .capture() == c.accounting.capture()


def test_pre_accounting_snapshot_restores_empty_ledger(tmp_path, pkg):
    records = _history_with_usage()
    j = tmp_path / "j.bin"
    _write_records(pkg, j, records)
    a = _make_server(pkg, tmp_path, "a", j)
    a.n_boots += 1
    a.journal_uids.add("uX")
    a._event_seq += 1
    state = pkg.snapshot.capture_state(a)
    state["accounting"] = None
    j2 = tmp_path / "old.bin"
    pkg.snapshot.write_snapshot(j2, state)
    b = _make_server(pkg, tmp_path, "b", j2)
    assert b.accounting.rows == {}


# ------------------------------------------------ property: same stream
def _random_stream(rng: random.Random, n_events: int = 400) -> list[dict]:
    """A random record stream over a few jobs: submits and opens, starts
    with usage and stamps (reattach re-emits included), restarts with
    crash counters that may fall back, terminal events, migrations, and
    unaccounted kinds."""
    out = []
    t = 100.0
    instances: dict = {}
    for _ in range(n_events):
        t += rng.choice([0.0, 0.25, 1.5, rng.random() * 7])
        job = rng.randint(1, 5)
        task = rng.randint(0, 6)
        kind = rng.choice([
            "job-submitted", "job-opened", "task-started", "task-started",
            "task-started", "task-restarted", "task-finished",
            "task-failed", "task-canceled", "migration-out",
            "migration-out-done", "worker-connected", "job-completed",
        ])
        rec = {"event": kind, "job": job, "time": t}
        if kind == "job-submitted":
            rec["desc"] = {"name": rng.choice(["train", "eval", "etl"])}
        elif kind == "job-opened":
            rec["name"] = rng.choice(["open-a", "open-b"])
        elif kind == "task-started":
            key = (job, task)
            if rng.random() < 0.3:  # a reattach re-emit, same instance
                instance = instances.get(key, 0)
            else:
                instance = instances.get(key, -1) + 1
            instances[key] = instance
            queued = t - rng.random() * 3
            rec.update(task=task, instance=instance, workers=[1],
                       queued_at=queued if rng.random() < 0.8 else 0.0,
                       assigned_at=t, started_at=rng.choice([t, 0.0]),
                       usage={"cpus": rng.choice([1.0, 2.0, 0.5]),
                              **({"gpus": 1.0} if rng.random() < 0.3
                                 else {})})
        elif kind == "task-restarted":
            rec.update(task=task, crash_count=rng.randint(0, 3),
                       instance=instances.get((job, task), 0) + 1)
        elif kind in ("task-finished", "task-failed", "task-canceled"):
            rec["task"] = task
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
def test_same_stream_gives_equal_ledgers(seed):
    """The same records into both ledgers: equal capture(), rollup(),
    job_report() and brief() after every record."""
    stream = _random_stream(random.Random(seed))
    jax_led = jax_accounting.AccountingLedger()
    port_led = port_accounting.AccountingLedger()
    for rec in stream:
        jax_led.observe(rec["event"], rec)
        port_led.observe(rec["event"], rec)
        assert port_led.capture() == jax_led.capture(), rec
    assert port_led.rollup() == jax_led.rollup()
    assert port_led.job_report() == jax_led.job_report()
    assert port_led.brief() == jax_led.brief()
    for job_id in range(1, 6):
        assert port_led.export_job(job_id) == jax_led.export_job(job_id)


# ----------------------------------------- the server's event path, twinned
class _Comm:
    def __init__(self):
        self.compute = []

    def send_compute(self, worker_id, tasks):
        self.compute.append((worker_id, tasks))

    def send_cancel(self, worker_id, task_ids):
        pass

    def send_retract(self, worker_id, task_refs):
        pass

    def ask_for_scheduling(self):
        pass


class _TickClock:
    """Both packages' clock: moves only where `_drive` moves it."""

    def __init__(self):
        self.t = 5_000.0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _workers(pkg, resource_map):
    from hyperqueue_tpu.resources import descriptor as jax_descriptor
    from hyperqueue_tpu.server import worker as jax_worker
    from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
    from hyperqueue_tpu_torch.server import worker as port_worker

    desc_mod = jax_descriptor if pkg.name == "jax" else port_descriptor
    worker_mod = jax_worker if pkg.name == "jax" else port_worker
    out = []
    for wid, (cpus, gpus) in enumerate([(4, 0), (8, 2), (2, 0)], start=1):
        items = [desc_mod.ResourceDescriptorItem.sum("cpus", cpus * 10_000)]
        if gpus:
            items.append(desc_mod.ResourceDescriptorItem.sum(
                "gpus", gpus * 10_000))
        config = worker_mod.WorkerConfiguration(
            descriptor=desc_mod.ResourceDescriptor(items=tuple(items)),
            hostname=f"node{wid}")
        out.append(worker_mod.Worker.create(wid, config, resource_map))
    return out


def _drive(pkg, tmp_path, tick_clock):
    """A journaled server on greedy-numpy through submits (an eager graph,
    a lazy array with entries, an open job's second submit), worker
    registration, ticks, starts, finishes, a failure, a restart and a
    worker loss. Returns (server, journal path)."""
    journal = tmp_path / f"{pkg.name}.bin"
    server = pkg.server(server_dir=tmp_path / pkg.name, journal_path=journal,
                        scheduler="greedy-numpy", journal_plane="reactor",
                        lazy_array_threshold=8)
    server.journal = pkg.journal.Journal(journal)
    server.journal.open_for_append()
    server.n_boots += 1
    server.journal_uids.add("uid-1")
    server.emit_event("server-uid", {"server_uid": "uid-1"})
    comm = server.comm = _Comm()
    core = server.core
    rq_gpu = {"variants": [{"entries": [
        {"name": "cpus", "amount": 20_000},
        {"name": "gpus", "amount": 10_000}]}]}
    submits = [
        {"name": "graph", "submit_dir": "/", "tasks": [
            {"id": 0, "body": {"cmd": ["a"]}},
            {"id": 1, "body": {"cmd": ["b"]}, "deps": [0]},
            {"id": 2, "body": {"cmd": ["c"]}, "request": rq_gpu,
             "priority": 3}]},
        {"name": "array", "submit_dir": "/", "array": {
            "id_range": [0, 12], "body": {"cmd": ["echo"]},
            "entries": [f"e{i}" for i in range(12)], "priority": 1}},
        {"name": "open", "submit_dir": "/", "open": True,
         "array": {"ids": [0, 1, 2], "body": {"cmd": ["o"]}}},
    ]
    loop = asyncio.new_event_loop()
    try:
        for i, desc in enumerate(submits):
            msg = attach_trace({"job": desc}, f"trace-{i}",
                               sent_at=tick_clock.t - 0.5)
            loop.run_until_complete(server._client_submit(msg))
            tick_clock.t += 0.125
        for worker in _workers(pkg, core.resource_map):
            pkg.reactor.on_new_worker(core, comm, server.events, worker)
        started = []
        for tick in range(6):
            tick_clock.t += 0.25
            comm.compute = []
            pkg.reactor.schedule(core, comm, server.events, server.model,
                                 prefill=False)
            for _wid, batch in comm.compute:
                for m in batch:
                    pkg.reactor.on_task_running(
                        core, server.events, m["id"], m["instance"],
                        wtrace={"accepted_at": tick_clock.t,
                                "launch_at": tick_clock.t + 0.01,
                                "spawned_at": tick_clock.t + 0.02})
                    started.append(m["id"])
            tick_clock.t += 0.5
            running = [tid for tid in sorted(started)
                       if tid in core.tasks and not core.tasks[tid].is_done]
            for n, tid in enumerate(running):
                task = core.tasks[tid]
                if tick < 3 and task.assigned_worker == 2:
                    continue  # still running when worker 2 is lost
                if tick == 2 and n == 0:
                    pkg.reactor.on_task_failed(
                        core, comm, server.events, tid, task.instance_id,
                        "boom")
                elif (tid + tick) % 3:
                    pkg.reactor.on_task_finished(
                        core, comm, server.events, tid, task.instance_id,
                        wtrace={"spawned_at": tick_clock.t - 0.4,
                                "exited_at": tick_clock.t - 0.1,
                                "sent_at": tick_clock.t - 0.05})
            if tick == 3:
                # a worker is lost: its running tasks restart elsewhere
                pkg.reactor.on_remove_worker(core, comm, server.events, 2,
                                             "connection lost")
            if tick == 4:
                loop.run_until_complete(server._client_submit(
                    attach_trace({"job": {
                        "job_id": 3, "name": "open", "submit_dir": "/",
                        "array": {"ids": [7, 8], "body": {"cmd": ["o"]}}}},
                        "trace-late", sent_at=tick_clock.t)))
    finally:
        loop.close()
    server.journal.close()
    return server, journal


def test_server_event_path_journals_identical_records(tmp_path):
    """The port's Server and the JAX Server, driven alike under one clock,
    journal the same records byte for byte and fold the same ledger."""
    tick_clock = _TickClock()
    previous = [mod.install(tick_clock) for mod in (jax_clock, port_clock)]
    try:
        servers = {}
        for pkg in PKGS.values():
            tick_clock.t = 5_000.0
            servers[pkg.name] = _drive(pkg, tmp_path, tick_clock)
    finally:
        for mod, prev in zip((jax_clock, port_clock), previous):
            mod.install(prev)
    (jax_server, jax_path), (port_server, port_path) = \
        servers["jax"], servers["port"]
    jax_records = list(jax_journal.Journal.read_all(jax_path))
    kinds = {r["event"] for r in jax_records}
    assert {"job-submitted", "worker-connected", "task-started",
            "task-finished", "task-failed", "task-restarted",
            "worker-lost", "job-completed"} <= kinds
    assert list(port_journal.Journal.read_all(port_path)) == jax_records
    assert port_path.read_bytes() == jax_path.read_bytes()
    assert port_server.accounting.capture() == \
        jax_server.accounting.capture()
    assert port_server.accounting.rollup() == jax_server.accounting.rollup()
    assert port_server.accounting.job_report() == \
        jax_server.accounting.job_report()
    assert port_server.accounting.rows[1]["resource_seconds"].get("cpus")
    # the journal replays into the ledger the live fold built
    refold = port_accounting.AccountingLedger()
    for rec in port_journal.Journal.read_all(port_path):
        refold.observe(rec["event"], rec)
    assert refold.capture() == port_server.accounting.capture()
