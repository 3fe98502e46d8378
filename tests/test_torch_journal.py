"""The port's journal, snapshots, restore and journal plane against the
JAX package's, on the CPU.

The unit tests of tests/test_journal.py and the non-`env` tests of
tests/test_snapshot.py run twinned: each against both packages (`pkg`
parametrizes them), and where both can run on the same files, the two are
compared (records, fingerprints, bytes). Then the cross-package cases: a
JAX-written journal read by the port, byte-identical journal files for the
same records under the same clock, snapshots restored across packages, a
100,000-id lazy array through a snapshot restore, the journal plane's
release and kill semantics inside asyncio.run, and three restore cases
where a snapshot restore and a journal replay of the same history differ in
the JAX package, which the port keeps (ROADMAP Queue 3).
"""

from __future__ import annotations

import asyncio
import random
import shutil
import struct
import types

import pytest
import torch

import test_snapshot as jax_snapshot_tests
from hyperqueue_tpu.events import journal as jax_journal
from hyperqueue_tpu.events import restore as jax_restore
from hyperqueue_tpu.events import snapshot as jax_snapshot
from hyperqueue_tpu.ids import make_task_id
from hyperqueue_tpu.server import bootstrap as jax_bootstrap
from hyperqueue_tpu.server import journal_plane as jax_plane
from hyperqueue_tpu.server import protocol as jax_protocol
from hyperqueue_tpu.server import reactor as jax_reactor
from hyperqueue_tpu.server import task as jax_task
from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu_torch.events import journal as port_journal
from hyperqueue_tpu_torch.events import outputlog as port_outputlog
from hyperqueue_tpu_torch.events import restore as port_restore
from hyperqueue_tpu_torch.events import snapshot as port_snapshot
from hyperqueue_tpu_torch.server import bootstrap as port_bootstrap
from hyperqueue_tpu_torch.server import journal_plane as port_plane
from hyperqueue_tpu_torch.server import protocol as port_protocol
from hyperqueue_tpu_torch.server import reactor as port_reactor
from hyperqueue_tpu_torch.server import task as port_task
from hyperqueue_tpu_torch.utils import clock as port_clock

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

# how long a journal-plane test may wait for a release before it fails
PLANE_TIMEOUT_S = 20.0


def _jax_server(**kwargs):
    return jax_bootstrap.Server(**kwargs)


def _port_server(**kwargs):
    return port_bootstrap.Server(device="cpu", **kwargs)


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", journal=jax_journal, snapshot=jax_snapshot,
        restore=jax_restore.restore_from_journal, server=_jax_server,
        plane=jax_plane, protocol=jax_protocol, reactor=jax_reactor,
        task=jax_task, clock=jax_clock),
    "port": types.SimpleNamespace(
        name="port", journal=port_journal, snapshot=port_snapshot,
        restore=port_restore.restore_from_journal, server=_port_server,
        plane=port_plane, protocol=port_protocol, reactor=port_reactor,
        task=port_task, clock=port_clock),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


def _write(pkg, path, records):
    j = pkg.journal.Journal(path)
    j.open_for_append()
    for r in records:
        j.write(r)
    j.close()


def _restored(pkg, server_dir, journal, reattach_timeout=60.0, **kwargs):
    server = pkg.server(server_dir=server_dir, journal_path=journal,
                        reattach_timeout=reattach_timeout, **kwargs)
    pkg.restore(server)
    return server


def _fingerprint(server, pkg) -> dict:
    """tests/test_snapshot.py `_fingerprint`, with the package's own
    rqv_to_wire: the restorable state of a server, t_ready zeroed for the
    tasks that are not held for reattach."""
    core = server.core
    jobs = {}
    for job_id, job in server.jobs.jobs.items():
        jobs[job_id] = {
            "name": job.name, "open": job.is_open,
            "cancel_reason": job.cancel_reason,
            "submitted_at": round(job.submitted_at, 6),
            "counters": dict(job.counters), "submits": job.submits,
            "tasks": {
                t.job_task_id: (t.status, t.error, round(t.submitted_at, 6),
                                t.started_at, t.finished_at)
                for t in job.tasks.values()
            },
        }
    tasks = {}
    body_groups: dict[int, list[int]] = {}
    for task_id, task in core.tasks.items():
        held = task_id in server.reattach_pending
        tasks[task_id] = {
            "instance": task.instance_id, "crashes": task.crash_counter,
            "state": task.state.value, "priority": task.priority,
            "entry": task.entry, "body": task.body,
            "deps": tuple(sorted(task.deps)),
            "crash_limit": task.crash_limit,
            "stamps": (task.t_ready, task.t_assigned, task.t_started)
            if held else (0.0, task.t_assigned, task.t_started),
            "rqv": pkg.protocol.rqv_to_wire(
                core.rq_map.get_variants(task.rq_id), core.resource_map),
            "held": held,
        }
        body_groups.setdefault(id(task.body), []).append(task_id)
    return {
        "jobs": jobs, "tasks": tasks, "ready": core.queues.total_ready(),
        "fence_floor": core.instance_fence_floor,
        "event_seq": server._event_seq,
        "uids": sorted(server.journal_uids), "n_boots": server.n_boots,
        "body_sharing": sorted(tuple(sorted(g))
                               for g in body_groups.values()),
    }


def _frame_bounds(blob, magic_len=8):
    bounds = [magic_len]
    pos = magic_len
    while pos < len(blob):
        (length,) = struct.unpack_from("<I", blob, pos)
        pos += 8 + length
        bounds.append(pos)
    return bounds


# --------------------------------------------------------------------------
# twins of tests/test_journal.py
# --------------------------------------------------------------------------
def test_journal_roundtrip(tmp_path, pkg):
    path = tmp_path / "j.bin"
    _write(pkg, path, [{"event": "a", "job": 1},
                       {"event": "b", "job": 2, "data": b"\x00"}])
    assert list(pkg.journal.Journal.read_all(path)) == [
        {"event": "a", "job": 1},
        {"event": "b", "job": 2, "data": b"\x00"},
    ]


def test_journal_torn_tail_truncated(tmp_path, pkg):
    path = tmp_path / "j.bin"
    _write(pkg, path, [{"event": "a", "job": 1}])
    size_after_one = path.stat().st_size
    with open(path, "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial garbage")
    assert len(list(pkg.journal.Journal.read_all(path))) == 1
    j = pkg.journal.Journal(path)
    j.open_for_append()
    assert path.stat().st_size == size_after_one
    j.write({"event": "b", "job": 1})
    j.close()
    assert len(list(pkg.journal.Journal.read_all(path))) == 2


_RESTORE_RECORDS = [
    {"event": "job-submitted", "job": 1,
     "desc": {"name": "j", "tasks": [{"id": 0, "body": {}},
                                     {"id": 1, "body": {}}]},
     "n_tasks": 2},
    {"event": "task-started", "job": 1, "task": 0, "instance": 0,
     "variant": 0, "workers": [1]},
    {"event": "task-restarted", "job": 1, "task": 0, "crash_count": 2,
     "instance": 1},
    {"event": "task-started", "job": 1, "task": 0, "instance": 1,
     "variant": 0, "workers": [2]},
]


def test_restore_roundtrips_instance_and_crash_counters(tmp_path, pkg):
    journal = tmp_path / "j.bin"
    _write(pkg, journal, _RESTORE_RECORDS)
    stride = pkg.task.INSTANCE_GENERATION_STRIDE
    server = _restored(pkg, tmp_path, journal, reattach_timeout=30.0)
    started = server.core.tasks[make_task_id(1, 0)]
    fresh = server.core.tasks[make_task_id(1, 1)]
    assert started.instance_id == 1
    assert started.crash_counter == 2
    assert started.task_id in server.reattach_pending
    assert server.core.queues.total_ready() == 1
    assert fresh.instance_id == stride
    assert server.core.instance_fence_floor == stride
    server = _restored(pkg, tmp_path, journal, reattach_timeout=0.0)
    started = server.core.tasks[make_task_id(1, 0)]
    assert started.instance_id == stride
    assert started.crash_counter == 2
    assert not server.reattach_pending
    assert server.core.queues.total_ready() == 2


def test_restore_counters_survive_mid_record_truncation(tmp_path,
                                                       fixed_clocks):
    """Every cut of the journal restores the complete-record prefix, in
    both packages, to the same state (fingerprints equal; these records
    carry no time, so the job's submit stamp is the restoring clock's)."""
    journal = tmp_path / "j.bin"
    _write(PKGS["port"], journal, _RESTORE_RECORDS)
    blob = journal.read_bytes()
    bounds = _frame_bounds(blob)
    torn = tmp_path / "torn.bin"
    for cut in range(8, len(blob)):
        torn.write_bytes(blob[:cut])
        n_complete = sum(1 for b in bounds[1:] if b <= cut)
        prints = []
        for pkg in PKGS.values():
            assert len(list(pkg.journal.Journal.read_all(torn))) \
                == n_complete, (pkg.name, cut)
            server = _restored(pkg, tmp_path / pkg.name, torn,
                               reattach_timeout=30.0)
            if n_complete >= 2:
                task = server.core.tasks[make_task_id(1, 0)]
                assert task.crash_counter == (2 if n_complete >= 3 else 0)
                held = task.task_id in server.reattach_pending
                assert held == (n_complete != 3)
            prints.append(_fingerprint(server, pkg))
        assert prints[0] == prints[1], cut
        # appending over the torn tail truncates it cleanly
        j = port_journal.Journal(torn)
        j.open_for_append()
        assert torn.stat().st_size == bounds[n_complete]
        j.write({"event": "job-closed", "job": 1})
        j.close()
        assert len(list(jax_journal.Journal.read_all(torn))) \
            == n_complete + 1


def test_journal_prune(tmp_path, pkg):
    path = tmp_path / "j.bin"
    _write(pkg, path, [{"event": "job-submitted", "job": 1},
                       {"event": "job-submitted", "job": 2},
                       {"event": "task-finished", "job": 1, "task": 0},
                       {"event": "worker-connected", "id": 1},
                       {"event": "server-uid", "server_uid": "u"}])
    kept = pkg.journal.Journal.prune(path, keep_jobs={2})
    assert kept == 2
    assert list(pkg.journal.Journal.read_all(path)) == [
        {"event": "job-submitted", "job": 2},
        {"event": "server-uid", "server_uid": "u"},
    ]


def test_graph_submit_without_ids_journals_assigned_ids(tmp_path, pkg):
    server = pkg.server(server_dir=tmp_path)
    job = server.jobs.create_job(name="g", submit_dir=str(tmp_path))
    desc = {"tasks": [{"body": {"n": i}} for i in range(3)]}
    server._build_tasks(job, desc)
    ids = [t.get("id") for t in pkg.protocol.expand_desc_tasks(desc)]
    assert sorted(ids) == [0, 1, 2]


# --------------------------------------------------------------------------
# twins of tests/test_snapshot.py (non-env)
# --------------------------------------------------------------------------
def _three_record_journal(pkg, path):
    _write(pkg, path, [{"event": "a", "job": 1, "seq": 0},
                       {"event": "b", "job": 2, "seq": 1},
                       {"event": "c", "job": 3, "seq": 2}])
    return _frame_bounds(path.read_bytes())


def test_crc_mid_file_corruption_raises_then_salvages(tmp_path, pkg):
    path = tmp_path / "j.bin"
    bounds = _three_record_journal(pkg, path)
    blob = bytearray(path.read_bytes())
    blob[bounds[1] + 8 + 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(pkg.journal.JournalCorruption):
        list(pkg.journal.Journal.read_all(path))
    records = list(pkg.journal.Journal.read_all(path, salvage=True))
    assert [r["event"] for r in records] == ["a", "c"]
    with pytest.raises(pkg.journal.JournalCorruption):
        pkg.journal.Journal(path).open_for_append()
    j = pkg.journal.Journal(path, salvage=True)
    j.open_for_append()
    j.write({"event": "d", "job": 4, "seq": 3})
    j.close()
    assert [r["event"] for r in pkg.journal.Journal.read_all(
        path, salvage=True)] == ["a", "c", "d"]


def test_crc_corrupt_final_record_is_a_torn_tail(tmp_path, pkg):
    path = tmp_path / "j.bin"
    bounds = _three_record_journal(pkg, path)
    blob = bytearray(path.read_bytes())
    blob[bounds[2] + 8 + 1] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert [r["event"] for r in pkg.journal.Journal.read_all(path)] \
        == ["a", "b"]
    j = pkg.journal.Journal(path)
    j.open_for_append()
    assert path.stat().st_size == bounds[2]
    j.write({"event": "c2", "job": 3, "seq": 2})
    j.close()
    assert [r["event"] for r in pkg.journal.Journal.read_all(path)] \
        == ["a", "b", "c2"]


def test_v1_journal_read_and_append_transparent(tmp_path, pkg):
    from hyperqueue_tpu_torch.transport import codec

    path = tmp_path / "old.bin"
    records = [{"event": "job-submitted", "job": 1, "seq": 0},
               {"event": "task-finished", "job": 1, "task": 0, "seq": 1}]
    with open(path, "wb") as f:
        f.write(pkg.journal.MAGIC_V1)
        for r in records:
            data = codec.packb(r)
            f.write(struct.pack("<I", len(data)) + data)
    assert list(pkg.journal.Journal.read_all(path)) == records
    j = pkg.journal.Journal(path)
    j.open_for_append()
    j.write({"event": "job-closed", "job": 1, "seq": 2})
    j.close()
    assert path.read_bytes()[:8] == pkg.journal.MAGIC_V1
    assert len(list(pkg.journal.Journal.read_all(path))) == 3
    pkg.journal.Journal.prune(path, keep_jobs={1})
    assert path.read_bytes()[:8] == pkg.journal.MAGIC
    assert len(list(pkg.journal.Journal.read_all(path))) == 3


def _boot(server, uid):
    """What a server's start does to the journal state: one more boot."""
    server.n_boots += 1
    server.journal_uids.add(uid)
    server._event_seq += 1


@pytest.mark.parametrize("seed", [1, 7, 42, 1234, 9999])
def test_snapshot_roundtrip_property(tmp_path, seed, pkg):
    """capture(full_replay(J)) restored == full_replay(J + this boot's
    server-uid record), in each package, and equal across packages."""
    records = jax_snapshot_tests._random_history(random.Random(seed))
    j_orig = tmp_path / "orig.bin"
    _write(pkg, j_orig, records)
    a = _restored(pkg, tmp_path / "a", j_orig)
    _boot(a, "uid-boot-A")
    j_replay = tmp_path / "replay.bin"
    shutil.copy(j_orig, j_replay)
    jw = pkg.journal.Journal(j_replay)
    jw.open_for_append()
    jw.write({"event": "server-uid", "server_uid": "uid-boot-A",
              "seq": a._event_seq - 1, "time": 9_999.0})
    jw.close()
    c = _restored(pkg, tmp_path / "c", j_replay)
    j_snap = tmp_path / "snap.bin"
    pkg.snapshot.write_snapshot(j_snap, pkg.snapshot.capture_state(a))
    b = _restored(pkg, tmp_path / "b", j_snap)
    assert b.last_restore["snapshot"] is not None
    assert _fingerprint(b, pkg) == _fingerprint(c, pkg)
    assert sorted(b.reattach_pending) == sorted(c.reattach_pending)
    # the other package restores the same files to the same state
    other = PKGS["port" if pkg.name == "jax" else "jax"]
    c2 = _restored(other, tmp_path / "c2", j_replay)
    b2 = _restored(other, tmp_path / "b2", j_snap)
    assert _fingerprint(c2, other) == _fingerprint(c, pkg)
    assert _fingerprint(b2, other) == _fingerprint(b, pkg)
    assert b2.accounting.capture() == b.accounting.capture()
    assert c2.accounting.capture() == c.accounting.capture()


def test_snapshot_plus_tail_replay(tmp_path, pkg):
    records = [
        {"event": "server-uid", "server_uid": "u1", "seq": 0, "time": 1.0},
        {"event": "job-submitted", "job": 1, "seq": 1, "time": 2.0,
         "desc": {"name": "a",
                  "array": {"ids": [0, 1], "body": {"cmd": ["true"]}}}},
        {"event": "task-started", "job": 1, "task": 0, "instance": 0,
         "variant": 0, "workers": [1], "seq": 2, "time": 3.0},
    ]
    j1 = tmp_path / "j1.bin"
    _write(pkg, j1, records)
    a = _restored(pkg, tmp_path / "a", j1)
    _boot(a, "uA")
    j2 = tmp_path / "j2.bin"
    state = pkg.snapshot.capture_state(a)
    pkg.snapshot.write_snapshot(j2, state)
    _write(pkg, j2, [
        dict(records[1]),
        {"event": "server-uid", "server_uid": "uA",
         "seq": state["seq"] - 1, "time": 3.5},
        {"event": "task-finished", "job": 1, "task": 0,
         "seq": state["seq"], "time": 4.0},
        {"event": "job-submitted", "job": 2, "seq": state["seq"] + 1,
         "time": 5.0,
         "desc": {"name": "late", "array": {"ids": [0], "body": {}}}},
    ])
    b = _restored(pkg, tmp_path / "b", j2)
    assert b.last_restore["skipped_pre_watermark"] == 2
    assert b.last_restore["tail_events"] == 2
    job1 = b.jobs.jobs[1]
    assert job1.tasks[0].status == "finished"
    assert job1.counters["finished"] == 1
    assert job1.n_tasks() == 2
    assert 2 in b.jobs.jobs and b.jobs.jobs[2].n_tasks() == 1
    assert b.n_boots == 2


def test_torn_snapshot_falls_back_to_prev_then_full_replay(tmp_path, pkg):
    records = [
        {"event": "server-uid", "server_uid": "u1", "seq": 0, "time": 1.0},
        {"event": "job-submitted", "job": 1, "seq": 1, "time": 2.0,
         "desc": {"name": "a", "array": {"ids": [0], "body": {}}}},
    ]
    journal = tmp_path / "j.bin"
    _write(pkg, journal, records)
    a = _restored(pkg, tmp_path / "a", journal)
    _boot(a, "uA")
    pkg.snapshot.write_snapshot(journal, pkg.snapshot.capture_state(a))
    a._event_seq += 1
    pkg.snapshot.write_snapshot(journal, pkg.snapshot.capture_state(a))
    snap = pkg.snapshot.snapshot_path(journal)
    prev = pkg.snapshot.prev_snapshot_path(journal)
    assert snap.exists() and prev.exists()
    good = snap.read_bytes()
    snap.write_bytes(good[: len(good) // 2])
    b = _restored(pkg, tmp_path / "b", journal)
    assert b.last_restore["snapshot"] == str(prev)
    assert 1 in b.jobs.jobs
    flipped = bytearray(good)
    flipped[len(pkg.snapshot.MAGIC) + 10] ^= 0xFF
    snap.write_bytes(bytes(flipped))
    b2 = _restored(pkg, tmp_path / "b2", journal)
    assert b2.last_restore["snapshot"] == str(prev)
    prev.write_bytes(good[: len(good) // 3])
    b3 = _restored(pkg, tmp_path / "b3", journal)
    assert b3.last_restore["snapshot"] is None
    assert 1 in b3.jobs.jobs
    assert b3.core.queues.total_ready() == 1


def test_prev_snapshot_fallback_survives_gc_exactly_once(tmp_path, pkg):
    journal = tmp_path / "j.bin"
    _write(pkg, journal, [
        {"event": "server-uid", "server_uid": "u1", "seq": 0, "time": 1.0},
        {"event": "job-submitted", "job": 1, "seq": 1, "time": 2.0,
         "desc": {"name": "closes-between",
                  "array": {"ids": [0], "body": {}}}},
        {"event": "job-submitted", "job": 2, "seq": 2, "time": 3.0,
         "desc": {"name": "stays-live",
                  "array": {"ids": [0], "body": {}}}},
    ])
    server = _restored(pkg, tmp_path / "a", journal, reattach_timeout=15.0)
    _boot(server, "uA")
    server.journal = pkg.journal.Journal(journal)
    server.journal.open_for_append()
    asyncio.run(server.compact_journal(reason="test"))
    server.events.on_task_finished(make_task_id(1, 0))
    stats = asyncio.run(server.compact_journal(reason="test"))
    assert stats["gc_floor"] < stats["watermark"]
    server.journal.close()
    snap = pkg.snapshot.snapshot_path(journal)
    blob = bytearray(snap.read_bytes())
    blob[len(pkg.snapshot.MAGIC) + 12] ^= 0xFF
    snap.write_bytes(bytes(blob))
    b = _restored(pkg, tmp_path / "b", journal, reattach_timeout=15.0)
    assert b.last_restore["snapshot"] == str(
        pkg.snapshot.prev_snapshot_path(journal))
    job1 = b.jobs.jobs[1]
    assert job1.tasks[0].status == "finished"
    assert job1.counters["finished"] == 1
    assert make_task_id(1, 0) not in b.core.tasks
    assert b.core.queues.total_ready() == 1


def test_capture_marks_assigned_not_running(tmp_path, pkg):
    journal = tmp_path / "j.bin"
    _write(pkg, journal, [
        {"event": "server-uid", "server_uid": "u1", "seq": 0, "time": 1.0},
        {"event": "job-submitted", "job": 1, "seq": 1, "time": 2.0,
         "desc": {"name": "a", "array": {"ids": [0], "body": {}}}},
    ])
    a = _restored(pkg, tmp_path / "a", journal)
    task = next(iter(a.core.tasks.values()))
    task.state = pkg.task.TaskState.ASSIGNED
    task.assigned_worker = 7
    state = pkg.snapshot.capture_state(a)
    (entry,) = state["jobs"][0]["pending"]
    assert entry["running"] is False


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
def _records(seed):
    return jax_snapshot_tests._random_history(random.Random(seed))


@pytest.mark.parametrize("seed", [1, 7, 42, 1234, 9999])
def test_same_records_give_byte_identical_journals(tmp_path, seed):
    """Both packages write the same bytes for the same records, read each
    other's files to the same records, and prune them alike."""
    records = _records(seed)
    records.append({"event": "misc", "job": 1, "seq": 10**6,
                    "big": 2**63, "neg": -(2**40), "f": 1e-300,
                    "data": b"\x00" * 300, "text": "é" * 40,
                    "nested": {"l": [1, [2, (3, None)]], "k": True}})
    paths = {}
    for pkg in PKGS.values():
        paths[pkg.name] = tmp_path / f"{pkg.name}.bin"
        _write(pkg, paths[pkg.name], records)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    want = list(jax_journal.Journal.read_all(paths["jax"]))
    assert list(port_journal.Journal.read_all(paths["jax"])) == want
    for pkg in PKGS.values():
        pkg.journal.Journal.prune(paths[pkg.name], keep_jobs={1, 3})
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()


def test_snapshot_files_are_byte_identical(tmp_path, fixed_clocks):
    """Under one clock, the two packages restore the same journal and
    capture it into the same snapshot bytes."""
    records = _records(42)
    journal = tmp_path / "j.bin"
    _write(PKGS["jax"], journal, records)
    blobs = []
    for pkg in PKGS.values():
        server = _restored(pkg, tmp_path / pkg.name, journal)
        state = pkg.snapshot.capture_state(server)
        path = tmp_path / f"{pkg.name}.snapbase"
        pkg.snapshot.write_snapshot(path, state)
        blobs.append(pkg.snapshot.snapshot_path(path).read_bytes())
        assert pkg.snapshot.read_snapshot(
            pkg.snapshot.snapshot_path(path))["seq"] == state["seq"]
    assert blobs[0] == blobs[1]


def test_outputlog_files_match(tmp_path):
    from hyperqueue_tpu.events import outputlog as jax_outputlog

    for mod, name in ((jax_outputlog, "jax"), (port_outputlog, "port")):
        w = mod.StreamWriter(tmp_path / name, worker_id=3, server_uid="u")
        w.write_chunk(make_task_id(1, 0), 0, mod.STDOUT, b"hello ")
        w.write_chunk(make_task_id(1, 0), 1, mod.STDOUT, b"again")
        w.write_chunk(make_task_id(1, 2), 0, mod.STDERR, b"\xff")
        w.close_task(make_task_id(1, 0), 1)
        w.close()
    assert (tmp_path / "jax" / "u.3.hqs").read_bytes() == \
        (tmp_path / "port" / "u.3.hqs").read_bytes()
    want = jax_outputlog.OutputLog(tmp_path / "port")
    got = port_outputlog.OutputLog(tmp_path / "jax")
    assert got.summary() == want.summary()
    assert list(got.export()) == list(want.export())
    assert got.cat(make_task_id(1, 0), port_outputlog.STDOUT) == b"again"
    assert got.job_ids() == want.job_ids() == [1]


def _lazy_history(n_ids=100_000):
    records = [
        {"event": "server-uid", "server_uid": "u1", "seq": 0, "time": 1.0},
        {"event": "job-submitted", "job": 1, "seq": 1, "time": 2.0,
         "desc": {"name": "big", "open": True,
                  "array": {"id_range": [0, n_ids],
                            "body": {"cmd": ["true"]}}}},
    ]
    seq = 2
    for task in (5, 17, 40_000, 99_999):
        records.append({"event": "task-started", "job": 1, "task": task,
                        "instance": 0, "variant": 0, "workers": [1],
                        "seq": seq, "time": 3.0 + seq,
                        "queued_at": 2.0, "assigned_at": 2.5,
                        "started_at": 3.0})
        seq += 1
    records.append({"event": "task-finished", "job": 1, "task": 17,
                    "seq": seq, "time": 10.0})
    return records, seq + 1


def test_lazy_array_restores_untouched_ids_in_chunks(tmp_path):
    """A 100,000-id lazy array: a full replay and a snapshot plus tail
    both materialize exactly the ids the journal touched; the rest stay
    in chunks; both packages agree on every file."""
    records, seq = _lazy_history()
    journal = tmp_path / "j.bin"
    _write(PKGS["port"], journal, records)
    prints = {}
    for pkg in PKGS.values():
        a = _restored(pkg, tmp_path / f"a-{pkg.name}", journal)
        job = a.jobs.jobs[1]
        assert len(job.tasks) == 4 and job.n_lazy == 100_000 - 4
        assert a.core.lazy.job_unmaterialized(1) == 100_000 - 4
        _boot(a, "uA")
        snap_journal = tmp_path / f"snap-{pkg.name}.bin"
        state = pkg.snapshot.capture_state(a)
        assert len(state["jobs"][0]["lazy"]) <= 5  # chunks, not ids
        pkg.snapshot.write_snapshot(snap_journal, state)
        _write(pkg, snap_journal, [
            {"event": "task-started", "job": 1, "task": 70_000,
             "instance": 0, "variant": 0, "workers": [2],
             "seq": state["seq"], "time": 20.0},
            {"event": "task-finished", "job": 1, "task": 5,
             "seq": state["seq"] + 1, "time": 21.0},
        ])
        b = _restored(pkg, tmp_path / f"b-{pkg.name}", snap_journal)
        job = b.jobs.jobs[1]
        assert b.last_restore["snapshot"] is not None
        assert len(job.tasks) == 5
        assert job.n_lazy + len(job.tasks) == 100_000
        assert b.core.queues.total_ready() == 100_000 - 5
        prints[pkg.name] = _fingerprint(b, pkg)
    assert prints["jax"] == prints["port"]


# --------------------------------------------------------------------------
# where a snapshot restore and a journal replay differ (ROADMAP Queue 3)
# --------------------------------------------------------------------------
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


class _FixedClock:
    def __init__(self, t=1_000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _worker(pkg, wid, cpus, resource_map):
    from hyperqueue_tpu.resources import descriptor as jax_descriptor
    from hyperqueue_tpu.server import worker as jax_worker
    from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
    from hyperqueue_tpu_torch.server import worker as port_worker

    desc_mod = jax_descriptor if pkg.name == "jax" else port_descriptor
    worker_mod = jax_worker if pkg.name == "jax" else port_worker
    config = worker_mod.WorkerConfiguration(
        descriptor=desc_mod.ResourceDescriptor(
            items=(desc_mod.ResourceDescriptorItem.sum("cpus", cpus * 10_000),)
        ))
    return worker_mod.Worker.create(wid, config, resource_map)


def _lazy_server(pkg, tmp_path, name, body, n_ids=8_192):
    """A server whose one job is a lazy array of `n_ids` one-cpu tasks,
    journaled through _client_submit, and two 4-cpu workers."""
    server = pkg.server(server_dir=tmp_path / name,
                        journal_path=tmp_path / f"{name}.bin",
                        reattach_timeout=60.0, scheduler="greedy-numpy",
                        journal_plane="reactor")
    server.journal = pkg.journal.Journal(server.journal_path)
    server.journal.open_for_append()
    server.comm = _Comm()
    asyncio.run(server._client_submit({"job": {
        "name": "lazy", "submit_dir": "/", "open": True,
        "array": {"id_range": [0, n_ids], "body": body,
                  "request": {"variants": [{"entries": [
                      {"name": "cpus", "amount": 10_000}]}]}}}}))
    for wid in (1, 2):
        pkg.reactor.on_new_worker(
            server.core, server.comm, server.events,
            _worker(pkg, wid, 4, server.core.resource_map))
    return server


def _tick_and_start(pkg, server, prefill):
    server.comm.compute = []
    pkg.reactor.schedule(server.core, server.comm, server.events,
                         server.model, prefill=prefill)
    for _wid, batch in server.comm.compute:
        for m in batch:
            if not server.core.tasks[m["id"]].prefilled:
                pkg.reactor.on_task_running(server.core, server.events,
                                            m["id"], m["instance"])


def _snapshot_vs_replay(pkg, tmp_path, server, name, tail=None):
    """(B, C) after the server's boot record: B restored from a snapshot
    of `server` plus the journal's tail (what `tail(server)` journals
    after the capture), C by full replay of the same journal."""
    server.journal_uids.add("uA")
    server.n_boots += 1
    server.emit_event("server-uid", {"server_uid": "uA"})
    pkg.snapshot.write_snapshot(server.journal_path,
                                pkg.snapshot.capture_state(server))
    if tail is not None:
        tail(server)
    server.journal.flush()
    replay = tmp_path / f"{name}-replay.bin"
    shutil.copyfile(server.journal_path, replay)
    b = _restored(pkg, tmp_path / f"{name}-b", server.journal_path,
                  scheduler="greedy-numpy")
    c = _restored(pkg, tmp_path / f"{name}-c", replay,
                  scheduler="greedy-numpy")
    assert b.last_restore["snapshot"] is not None
    assert c.last_restore["snapshot"] is None
    return b, c


@pytest.fixture
def fixed_clocks():
    previous = [mod.install(_FixedClock()) for mod in (jax_clock, port_clock)]
    yield
    for mod, prev in zip((jax_clock, port_clock), previous):
        mod.install(prev)


def test_prefilled_tasks_materialize_only_in_a_snapshot_restore(
        tmp_path, fixed_clocks):
    """A snapshot holds every materialized task as its own record, so the
    tasks prefill handed to a worker (assigned, not started, not
    journaled) come back materialized from a snapshot but lazy from a
    journal replay. Both packages do this; without prefill, B and C
    agree."""
    out = {}
    for pkg in PKGS.values():
        for prefill in (True, False):
            name = f"{pkg.name}-{prefill}"
            server = _lazy_server(pkg, tmp_path, name, {"cmd": ["true"]})
            _tick_and_start(pkg, server, prefill)
            b, c = _snapshot_vs_replay(pkg, tmp_path, server, name)
            started = 8  # two 4-cpu workers, one-cpu tasks
            assert len(c.jobs.jobs[1].tasks) == started
            out[name] = (len(b.jobs.jobs[1].tasks),
                         _fingerprint(b, pkg) == _fingerprint(c, pkg))
    assert out["jax-False"] == out["port-False"] == (8, True)
    # prefill gives each worker a backlog; B materializes it, C does not
    assert out["jax-True"] == out["port-True"]
    assert out["port-True"][0] > 8 and out["port-True"][1] is False


def test_empty_array_body_loses_sharing_across_a_snapshot(
        tmp_path, fixed_clocks):
    """Restore resolves a lazy chunk's body as `spec.get("body") or {}`:
    an empty body becomes a fresh dict, so a snapshot restore splits one
    array's tasks into two body groups (the snapshot's own records, and
    the ids the journal's tail touched) where a replay keeps one. Both
    packages do this; a non-empty body keeps its sharing."""

    def tail(server):
        # the tasks on worker 1 finish, two more start there
        pkg_of = PKGS["jax"] if server.__module__.startswith(
            "hyperqueue_tpu.") else PKGS["port"]
        core = server.core
        for task_id in sorted(core.workers[1].assigned_tasks):
            pkg_of.reactor.on_task_finished(
                core, server.comm, server.events, task_id,
                core.tasks[task_id].instance_id)
        _tick_and_start(pkg_of, server, prefill=False)

    out = {}
    for pkg in PKGS.values():
        for body in ({}, {"cmd": ["true"]}):
            name = f"{pkg.name}-{bool(body)}"
            server = _lazy_server(pkg, tmp_path, name, body)
            _tick_and_start(pkg, server, prefill=False)
            b, c = _snapshot_vs_replay(pkg, tmp_path, server, name, tail)
            for restored in (b, c):
                assert len(restored.jobs.jobs[1].tasks) == 12
            fb, fc = _fingerprint(b, pkg), _fingerprint(c, pkg)
            out[name] = {k for k in fb if fb[k] != fc[k]}
    assert out["jax-True"] == out["port-True"] == set()
    assert out["jax-False"] == out["port-False"] == {"body_sharing"}


class _SteppingClock(_FixedClock):
    """Moves on at every read, as the system clock does."""

    def time(self):
        self.t += 0.001
        return self.t

    def monotonic(self):
        return self.time()


def test_stamps_differ_across_restores_under_a_moving_clock(tmp_path):
    """A live server stamps a lazy task's submit and a task's finish twice:
    the array chunk's submitted_at (the submit's receive time), then the
    job-submitted record's time; the jobs layer's finished_at, then the
    task-finished record's time. A snapshot restore keeps the first of
    each pair, a replay the second, so under a clock that moves between
    the reads the restores differ in those two stamps (and nowhere else).
    Both packages do this; under a clock that moves only between events
    they agree (the chip run's journal path uses such a clock)."""
    fields = ("status", "error", "submitted_at", "started_at", "finished_at")
    out = {}
    for pkg in PKGS.values():
        for moving in (True, False):
            name = f"{pkg.name}-{moving}"
            previous = pkg.clock.install(
                _SteppingClock() if moving else _FixedClock())
            try:
                server = _lazy_server(pkg, tmp_path, name, {"cmd": ["x"]})
                _tick_and_start(pkg, server, prefill=False)
                task_id = next(iter(server.core.workers[1].assigned_tasks))
                pkg.reactor.on_task_finished(
                    server.core, server.comm, server.events, task_id,
                    server.core.tasks[task_id].instance_id)
                b, c = _snapshot_vs_replay(pkg, tmp_path, server, name)
            finally:
                pkg.clock.install(previous)
            fb, fc = _fingerprint(b, pkg), _fingerprint(c, pkg)
            job_b, job_c = fb["jobs"][1]["tasks"], fc["jobs"][1]["tasks"]
            out[name] = (
                {k for k in fb if fb[k] != fc[k]},
                {fields[i] for t in job_b for i in range(len(fields))
                 if job_b[t][i] != job_c[t][i]},
            )
    assert out["jax-False"] == out["port-False"] == (set(), set())
    assert out["jax-True"] == out["port-True"] == (
        {"jobs"}, {"submitted_at", "finished_at"})


def test_server_restore_through_open_journal(tmp_path):
    """The port's `_open_journal` (the journal block of the JAX start())
    restores, opens the appender and journals this boot's uid; a second
    boot fences past the first."""

    async def boot(uid, submit):
        server = _port_server(server_dir=tmp_path / uid,
                              journal_path=tmp_path / "j.bin",
                              reattach_timeout=0.0,
                              scheduler="greedy-numpy")
        await asyncio.wait_for(server._open_journal(uid), PLANE_TIMEOUT_S)
        if submit:
            reply = await server._client_submit({"job": {
                "name": "kept", "submit_dir": "/",
                "array": {"ids": [0, 1, 2], "body": {}}}})
            assert reply["n_tasks"] == 3
        server._close_journal()
        return server

    first = asyncio.run(boot("u1", True))
    assert first.n_boots == 1 and first.last_restore is None
    second = asyncio.run(boot("u2", False))
    assert second.last_restore["tail_events"] == 2
    assert second.n_boots == 2
    assert second.journal_uids == {"u1", "u2"}
    assert second.core.instance_fence_floor == \
        port_task.INSTANCE_GENERATION_STRIDE
    assert second.core.queues.total_ready() == 3
    kinds = [r["event"] for r in port_journal.Journal.read_all(
        tmp_path / "j.bin")]
    assert kinds == ["server-uid", "job-submitted", "server-uid"]


def test_unported_server_keywords_refuse(monkeypatch, tmp_path):
    """Every keyword of the JAX server is ported: the federation's
    (`shard_count`, `federation_root`, `promoted`, `failover_watch`) are
    stored as the JAX server stores them, and a chaos plan naming a
    federation site no longer refuses (a standalone server never reaches
    that site). The simulator's in-memory transport follows the JAX
    server's rule: it needs the in-loop client plane. `metrics_port=` and
    the planes of a standalone server are accepted. (Until the federation
    was ported, the federation's keywords and chaos sites refused here.)"""
    fields = ("shard_id", "shard_count", "federation_root", "promoted",
              "failover_watch", "lease", "fenced", "lease_timeout")
    for kwargs in ({"shard_count": 2}, {"federation_root": "/nonexistent"},
                   {"promoted": True}, {"failover_watch": True},
                   {"shard_count": 3, "shard_id": 2, "lease_timeout": 2.0}):
        port = _port_server(server_dir="/nonexistent", **kwargs)
        jax = _jax_server(server_dir="/nonexistent", **kwargs)
        assert {f: getattr(port, f) for f in fields} == \
            {f: getattr(jax, f) for f in fields}
    for server_cls in (_port_server, _jax_server):
        with pytest.raises(ValueError, match="shard id 2 outside 0..1"):
            server_cls(server_dir="/nonexistent", shard_count=2, shard_id=2)
    for server_cls in (_port_server, _jax_server):
        with pytest.raises(ValueError, match="client_plane='reactor'"):
            server_cls(server_dir="/nonexistent", memory_transport=True)
        sim_server = server_cls(server_dir="/nonexistent",
                                memory_transport=True,
                                client_plane="reactor")
        assert sim_server.memory_transport
    server = _port_server(server_dir="/nonexistent", fanout_senders=4,
                          client_plane="reactor", metrics_port=0)
    assert (server.fanout_senders, server.client_plane) == (4, "reactor")
    assert server.requested_metrics_port == 0
    # a chaos plan naming a federation site: a standalone server starts
    # and stops under it (the site fires only in a federation's driver)
    from hyperqueue_tpu_torch.utils import chaos

    monkeypatch.setattr(chaos, "_PLAN", chaos.FaultPlan({"rules": [
        {"site": "federation.migration", "op": "claim", "action": "kill"},
        {"site": "server.recv", "action": "drop"}]}))
    monkeypatch.setattr(chaos, "ACTIVE", True)
    fed_plan = _port_server(server_dir=tmp_path / "fed", host="127.0.0.1",
                            client_port=0, worker_port=0,
                            client_plane="reactor")

    async def start_then_stop(srv):
        try:
            return await srv.start()
        finally:
            await srv.shutdown()

    assert asyncio.run(start_then_stop(fed_plan)).server_uid
    # a plan of server sites runs: its rule at the journal's first event
    # (after the write and flush) fires inside start()
    monkeypatch.setattr(chaos, "_PLAN", chaos.FaultPlan({"rules": [
        {"site": "server.event", "event": "server-uid", "action": "raise"}]}))
    chaotic = _port_server(server_dir=tmp_path / "sd", host="127.0.0.1",
                           client_port=0, worker_port=0,
                           journal_path=tmp_path / "j.bin")

    with pytest.raises(chaos.ChaosInjectedError):
        asyncio.run(start_then_stop(chaotic))
    kinds = [r["event"] for r in port_journal.Journal.read_all(
        tmp_path / "j.bin")]
    assert kinds == ["server-uid"]


# --------------------------------------------------------------------------
# the journal plane, on a running loop
# --------------------------------------------------------------------------
def _plane(pkg, path, loop, **kwargs):
    journal = pkg.journal.Journal(path)
    journal.open_for_append()
    plane = pkg.plane.JournalPlane(journal, fsync_always=False,
                                   flush_each=True, loop=loop, **kwargs)
    plane.start()
    return journal, plane


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, PLANE_TIMEOUT_S))


def test_plane_releases_at_durability(tmp_path, pkg):
    async def body():
        loop = asyncio.get_running_loop()
        path = tmp_path / "j.bin"
        journal, plane = _plane(pkg, path, loop)
        plane._test_delay = 0.2
        released = []
        done = asyncio.Event()

        def on_durable(tag):
            # what the callback releases is already in the file
            seen = [r["n"] for r in pkg.journal.Journal.read_all(path)]
            released.append((tag, seen))
            if tag == "second":
                done.set()

        plane.append({"event": "x", "n": 1})
        plane.when_durable(lambda: on_durable("first"))
        assert released == []  # the batch is still in the commit thread
        plane.append({"event": "x", "n": 2})
        plane.when_durable(lambda: on_durable("second"))
        await done.wait()
        assert [t for t, _s in released] == ["first", "second"]
        assert 1 in released[0][1] and released[1][1] == [1, 2]
        # caught up: a callback now runs inline
        ran = []
        plane.when_durable(lambda: ran.append(True))
        assert ran == [True]
        assert plane.stop()
        journal.close()
        return plane.stats()

    stats = _run(body())
    assert stats["enqueued"] == stats["durable"] == 2


def test_plane_barrier_suspend_resume(tmp_path, pkg):
    async def body():
        loop = asyncio.get_running_loop()
        path = tmp_path / "j.bin"
        journal, plane = _plane(pkg, path, loop)
        for n in range(5):
            plane.append({"event": "x", "n": n})
        plane.barrier(sync=True)
        assert len(list(pkg.journal.Journal.read_all(path))) == 5
        plane.suspend()
        size = path.stat().st_size
        plane.append({"event": "x", "n": 5})
        await asyncio.sleep(0.1)
        assert path.stat().st_size == size  # parked: nothing written
        plane.resume()
        plane.barrier()
        assert [r["n"] for r in pkg.journal.Journal.read_all(path)] \
            == list(range(6))
        assert plane.stop()
        journal.close()
        return plane.stats()

    stats = _run(body())
    assert stats["durable"] == 6 and stats["depth"] == 0


def test_plane_max_pending_stall_is_counted(tmp_path, pkg):
    async def body():
        loop = asyncio.get_running_loop()
        journal, plane = _plane(pkg, tmp_path / "j.bin", loop,
                                max_pending=2)
        plane._test_delay = 0.05
        before = pkg.plane._STALLS_TOTAL.labels().value
        for n in range(8):
            plane.append({"event": "x", "n": n})
        plane.barrier()
        stalls = pkg.plane._STALLS_TOTAL.labels().value - before
        assert plane.stop()
        journal.close()
        return stalls, plane.stats()

    stalls, stats = _run(body())
    assert stalls >= 1
    assert stats["durable"] == 8


def test_plane_commit_ms_reports_the_commits(tmp_path):
    async def body():
        loop = asyncio.get_running_loop()
        journal, plane = _plane(PKGS["port"], tmp_path / "j.bin", loop)
        assert plane.commit_ms()["count"] == 0
        for n in range(3):
            plane.append({"event": "x", "n": n})
            plane.barrier()
        assert plane.stop()
        journal.close()
        return plane

    plane = _run(body())
    ms = plane.commit_ms()
    assert ms["count"] == plane.commits == 3
    assert 0 < ms["p50"] <= ms["p99"] <= ms["max"]


def _jax_open_journal(server, uid):
    """The journal block of the JAX Server.start(), without the rest."""
    server.journal = jax_journal.Journal(server.journal_path)
    if server.journal_path.exists():
        jax_restore.restore_from_journal(server)
    server.journal.open_for_append()
    server.jplane = jax_plane.JournalPlane(
        server.journal, fsync_always=server.journal_fsync == "always",
        flush_each=not server.journal_flush_period,
        loop=asyncio.get_running_loop(), lag=None, on_fatal=server.stop)
    server.jplane.start()
    server.journal_uids.add(uid)
    server.n_boots += 1
    server.emit_event("server-uid", {"server_uid": uid})


def test_kill_between_enqueue_and_commit_releases_nothing(tmp_path, pkg):
    """kill -9 while the commit thread still holds the batch: the ack
    registered behind the submit never runs, and a restore shows no trace
    of the job."""
    journal = tmp_path / "j.bin"

    async def doomed():
        server = pkg.server(server_dir=tmp_path / "a", journal_path=journal,
                            scheduler="greedy-numpy",
                            journal_fsync="always")
        if pkg.name == "jax":
            _jax_open_journal(server, "u1")
        else:
            await server._open_journal("u1")
        server.jplane.barrier(sync=True)
        server.jplane._test_delay = 1.0
        acked = []
        await server._client_submit({"job": {
            "name": "doomed", "submit_dir": "/",
            "array": {"ids": [0], "body": {}}}})
        server.jplane.when_durable(lambda: acked.append(True))
        await asyncio.sleep(0.2)
        plane = server.jplane
        server._event_listeners.clear()
        server.journal.kill()
        server.journal = None
        server.jplane = None
        # the commit thread wakes from its delay into a dead appender
        for _ in range(100):
            if plane._dead or not plane._thread.is_alive():
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.1)
        return acked, plane

    acked, plane = _run(doomed())
    assert acked == []
    assert plane._dead
    restored = _restored(pkg, tmp_path / "b", journal)
    assert {j.name for j in restored.jobs.jobs.values()} == set()
    assert restored.n_boots == 1
