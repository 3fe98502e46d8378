"""Crash-resume: snapshot load + journal tail replay into a fresh server.

Reference: crates/hyperqueue/src/server/restore.rs — StateRestorer replays
events, reconstructs jobs/open-state, re-submits unfinished tasks into the
core with preserved instance/crash counters (gateway.rs:201-205) so stale
messages from pre-crash workers are discarded; finished tasks are skipped and
their dependents see them as satisfied.

Two-phase bounded restore (events/snapshot.py): phase 1 loads the newest
valid snapshot — seeding the SAME accumulators a journal replay fills, so
everything downstream is one code path — and phase 2 replays only journal
records at/after the snapshot's event-seq watermark. A torn/corrupt
snapshot falls back to the previous snapshot, then to a full replay.
Restore cost is O(live state + tail), not O(history).
"""

from __future__ import annotations

import logging
import time

from hyperqueue_tpu_torch.events import snapshot as snapshot_mod
from hyperqueue_tpu_torch.events.journal import Journal
from hyperqueue_tpu_torch.ids import make_task_id
from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority
from hyperqueue_tpu_torch.server import reactor
from hyperqueue_tpu_torch.server.jobs import JobManager
from hyperqueue_tpu_torch.server.protocol import (
    expand_desc_tasks,
    rqv_from_wire,
    submit_record,
)
from hyperqueue_tpu_torch.server.task import Task
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.restore")

TERMINAL = {"task-finished": "finished", "task-failed": "failed",
            "task-canceled": "canceled"}

# restores are rare; the histogram's job is distinguishing "instant" from
# "the journal needs compaction" — hence buckets out to a minute
_RESTORE_SECONDS = REGISTRY.histogram(
    "hq_restore_duration_seconds",
    "journal/snapshot restore duration at server start",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0),
)


class _RestoreAcc:
    """The replay accumulators: filled by a snapshot seed and/or journal
    records, applied to the server once at the end."""

    def __init__(self):
        self.task_status: dict[tuple[int, int], tuple[str, str]] = {}
        # terminal event wall-clock per task (timeline: finished_at survives)
        self.task_finished_at: dict[tuple[int, int], float] = {}
        # lifecycle stamps of the LAST start per task: (queued, assigned,
        # started) — `hq job timeline` keeps one unbroken span across a
        # server restart + reattach instead of restarting the clock
        self.task_started_at: dict[tuple[int, int],
                                   tuple[float, float, float]] = {}
        # highest instance id seen per task (journal: last task-started OR
        # task-restarted; snapshot: the live instance at capture)
        self.task_instances: dict[tuple[int, int], int] = {}
        # True while the LAST lifecycle event was a start (the task may
        # still be running on a reconnecting worker)
        self.task_maybe_running: dict[tuple[int, int], bool] = {}
        self.task_variants: dict[tuple[int, int], int] = {}
        self.task_crashes: dict[tuple[int, int], int] = {}
        self.job_descs: dict[int, list[dict]] = {}
        # distributed-trace reconstruction: trace ids + stamps
        # replayed from events (or seeded whole from a snapshot), so a
        # restored server answers `hq task trace` with the SAME unbroken
        # trace the crashed one was assembling
        self.task_submit_trace: dict[tuple[int, int], dict] = {}
        self.task_wtrace: dict[tuple[int, int], dict] = {}
        # lend annotations accumulate across task-started events — a
        # later home-shard restart must not erase an earlier
        # borrowed-worker start's note (the live store keeps every note)
        self.task_lends: dict[tuple[int, int], list] = {}
        self.task_finish_wtrace: dict[tuple[int, int], dict] = {}
        self.task_trace_seed: dict[int, dict] = {}
        # unmaterialized lazy array chunks from a snapshot:
        # (job_id, spec) pairs registered into the core's LazyStore at the
        # end of restore, AFTER the journal tail names which of their ids
        # gained per-task state and must materialize eagerly instead
        self.lazy_chunks: list[tuple[int, dict]] = []
        # restore generation: every boot that owned this journal wrote one
        # server-uid record; a snapshot folds the pre-watermark count into
        # n_boots and tail records add to it. Fencing jumps re-issued tasks
        # to n_boots * stride, past everything a prior boot could have
        # issued in its lost journal tail.
        self.n_boots = 0
        # allocation-exact restore: queue_id -> queue wire dict
        # (with "_allocs": {alloc_id: alloc wire}) rebuilt from the
        # snapshot's autoalloc table + alloc-* journal-tail events
        self.autoalloc: dict[int, dict] = {}
        self.next_alloc_queue_id = 1
        # alloc-submit-attempt records with no journaled outcome: possible
        # orphans the service pidfile-scans at start (_adopt_orphans)
        self.alloc_attempts: list[dict] = []
        # elastic resharding: jobs sealed for export whose
        # migration had not finalized at the crash (job_id -> out record);
        # they restore held/paused until the coordinator re-drives or
        # aborts the migration
        self.migrating_out: dict[int, dict] = {}
        # jobs this shard handed off (migration-out-done replayed):
        # job_id -> destination shard, for wrong-shard redirects
        self.migrated_out: dict[int, int] = {}


def _seed_autoalloc(acc: _RestoreAcc, table: dict | None) -> None:
    if not table:
        return
    for qd in table.get("queues") or ():
        q = dict(qd)
        q["_allocs"] = {a["id"]: dict(a) for a in q.pop("allocations", ())}
        acc.autoalloc[q["id"]] = q
    acc.next_alloc_queue_id = max(
        acc.next_alloc_queue_id, table.get("next_queue_id", 1)
    )
    acc.alloc_attempts.extend(dict(a) for a in table.get("attempts") or ())


def _replay_alloc_record(acc: _RestoreAcc, kind: str, record: dict) -> None:
    """One alloc-* journal record into the allocation accumulator. The
    wire shapes mirror state.py to_wire/from_wire exactly, so the service
    rebuilds the table the crashed server held at its last journal write."""
    qid = record.get("queue_id")
    if qid is None:
        return
    if kind == "alloc-queue-created":
        acc.autoalloc[qid] = {
            "id": qid, "state": "running",
            "params": record.get("params")
            or {"manager": record.get("manager", "slurm")},
            "consecutive_failures": 0, "_allocs": {},
        }
        acc.next_alloc_queue_id = max(acc.next_alloc_queue_id, qid + 1)
        return
    queue = acc.autoalloc.get(qid)
    if queue is None:
        return  # e.g. the probe queue, never created
    if kind == "alloc-queue-removed":
        acc.autoalloc.pop(qid, None)
        acc.alloc_attempts = [
            a for a in acc.alloc_attempts if a.get("queue_id") != qid
        ]
    elif kind == "alloc-queue-paused":
        queue["state"] = "paused"
    elif kind == "alloc-queue-resumed":
        queue["state"] = "running"
        queue["quarantine_until"] = 0.0
    elif kind == "alloc-queue-quarantined":
        queue["state"] = "quarantined"
        queue["quarantine_until"] = float(record.get("until", 0.0))
        queue["quarantines"] = int(record.get("quarantines", 1))
    elif kind == "alloc-submit-attempt":
        acc.alloc_attempts.append(
            {"queue_id": qid, "workdir": record.get("workdir", "")}
        )
    elif kind == "alloc-submit-failed":
        _pop_attempt(acc, qid)
    elif kind == "alloc-queued":
        _pop_attempt(acc, qid)
        aid = record.get("alloc")
        if aid:
            queue["_allocs"][aid] = {
                "id": aid, "queue": qid,
                "worker_count": record.get("worker_count", 1),
                "status": "queued",
                "queued_at": float(record.get("time", 0.0)),
                "workdir": record.get("workdir", ""),
            }
    else:
        alloc = queue["_allocs"].get(record.get("alloc"))
        if alloc is None:
            return
        if kind == "alloc-started":
            alloc["status"] = "running"
            if not alloc.get("started_at"):
                alloc["started_at"] = float(record.get("time", 0.0))
        elif kind == "alloc-worker-bound":
            alloc["ever_bound"] = True
            if alloc["status"] == "queued":
                alloc["status"] = "running"
                alloc["started_at"] = float(record.get("time", 0.0))
        elif kind in ("alloc-finished", "alloc-failed", "alloc-cancelled"):
            alloc["status"] = kind[len("alloc-"):]
            alloc["ended_at"] = float(record.get("time", 0.0))
            if record.get("reason"):
                alloc["reason"] = record["reason"]


def _pop_attempt(acc: _RestoreAcc, qid: int) -> None:
    """An attempt's outcome landed in the journal: it is not an orphan."""
    for i, attempt in enumerate(acc.alloc_attempts):
        if attempt.get("queue_id") == qid:
            del acc.alloc_attempts[i]
            return


def _seed_from_snapshot(server, acc: _RestoreAcc, state: dict) -> None:
    """Phase 1: install a snapshot as if the pre-watermark journal had just
    been replayed. Touches only server.jobs/_event_seq/journal_uids and the
    accumulators, so a failure can be rolled back before falling back to
    the previous snapshot or a full replay."""
    bodies = state["bodies"]
    requests = state["requests"]
    for jd in state["jobs"]:
        seed_job(server, acc, jd, bodies, requests)
    for task_id, rec in (state.get("traces") or {}).items():
        acc.task_trace_seed[int(task_id)] = rec
    _seed_autoalloc(acc, state.get("autoalloc"))
    acc.n_boots = state["n_boots"]
    server.journal_uids.update(state.get("server_uids") or ())
    # usage ledger at the snapshot watermark; None for
    # pre-accounting snapshots — the tail replay refills what it can
    server.accounting.seed(state.get("accounting"))
    if state["seq"] > server._event_seq:
        server._event_seq = state["seq"]
    # forgotten jobs are absent from the snapshot but their ids must not be
    # reused — a reconnecting worker could still hold a forgotten job's
    # task under the same (job, task) id
    server.jobs.job_id_counter.ensure_above(state.get("next_job_id", 1) - 1)


def seed_job(server, acc: _RestoreAcc, jd: dict,
             bodies: list, requests: list) -> None:
    """Seed ONE job (snapshot per-job shape) into server.jobs + the
    accumulators. Shared by the snapshot seed and the migration-record
    import replay: a migrated-in job flows through the exact
    path a snapshot-restored one does, so every restore invariant —
    reattach holds, fencing, original clocks — carries over to moves."""
    job_id = jd["id"]
    job = server.jobs.create_job(
        name=jd["name"],
        submit_dir=jd["submit_dir"],
        max_fails=jd["max_fails"],
        is_open=jd["open"],
        job_id=job_id,
    )
    job.submitted_at = jd["submitted_at"]
    job.cancel_reason = jd["cancel_reason"]
    job.submits = list(jd["submits"])
    for tid, status, error, finished_at, started_at, submitted_at in (
        jd["done"]
    ):
        server.jobs.attach_task(job, tid)
        info = job.tasks[tid]
        info.submitted_at = submitted_at
        key = (job_id, tid)
        acc.task_status[key] = (status, error)
        acc.task_finished_at[key] = finished_at
        if started_at:
            acc.task_started_at[key] = (0.0, 0.0, started_at)
    for uid, s in (jd.get("streams") or {}).items():
        job.streams[uid] = {
            "applied": set(s["applied"]), "sealed": bool(s["sealed"]),
        }
        if not s["sealed"]:
            job.open_streams += 1
        server._stream_jobs[uid] = job_id
    for spec in jd.get("lazy") or ():
        resolved = dict(spec)
        resolved["body"] = bodies[spec["b"]]
        resolved["request"] = requests[spec["rq"]]
        acc.lazy_chunks.append((job_id, resolved))
    descs = acc.job_descs.setdefault(job_id, [])
    for t in jd["pending"]:
        tid = t["id"]
        server.jobs.attach_task(job, tid)
        job.tasks[tid].submitted_at = t["submitted_at"]
        desc = {
            "id": tid,
            # index into the shared tables: tasks of one array get the
            # SAME body object back, preserving the identity sharing
            # the compute-message dedup relies on
            "body": bodies[t["b"]],
            "request": requests[t["rq"]],
            "priority": t["priority"],
            "crash_limit": t["crash_limit"],
            "deps": t["deps"],
        }
        if "entry" in t:
            desc["entry"] = t["entry"]
        descs.append(desc)
        key = (job_id, tid)
        if t["crashes"]:
            acc.task_crashes[key] = t["crashes"]
        if t["running"]:
            acc.task_instances[key] = t["instance"]
            acc.task_variants[key] = t["variant"]
            acc.task_maybe_running[key] = True
            acc.task_started_at[key] = tuple(t["stamps"])
        elif t["instance"]:
            # not running, but the instance counter moved (crashes,
            # assignment at capture): restore must fence past it
            acc.task_instances[key] = t["instance"]
            acc.task_variants[key] = t["variant"]
            acc.task_maybe_running[key] = False



def _array_replays_lazy(server, array: dict) -> bool:
    """Should this journaled array desc stay compact through replay?
    Mirrors the live ingest decision (_ingest_array_desc): at/above the
    server's lazy threshold and single-node only (multi-node requests
    never register lazily)."""
    threshold = getattr(server, "lazy_array_threshold", 1 << 62)
    id_range = array.get("id_range")
    n = (
        int(id_range[1]) - int(id_range[0])
        if id_range is not None
        else len(array.get("ids") or ())
    )
    if n < threshold:
        return False
    variants = (array.get("request") or {}).get("variants") or []
    return not any(v.get("n_nodes") for v in variants)


def _seed_migration_record(server, acc: _RestoreAcc, rec: dict) -> None:
    """migration-in replay: re-import the embedded migration record.

    The record is self-contained (fresh bodies/requests tables captured
    by snapshot.capture_job on the source), so replay needs nothing from
    the source shard. Instances are floored at the source's fence
    watermark BEFORE this boot's own fence bump, keeping instance ids
    monotonic across the move — a SIGSTOP'd source resuming later can
    never collide with an incarnation the destination issues."""
    jd = rec.get("job_state") or {}
    job_id = jd.get("id")
    if job_id is None or job_id in server.jobs.jobs:
        return  # duplicate import (a re-driven migration): first wins
    # a returning job (migrated out earlier, now migrating back in)
    # must clear its own wrong-shard tombstone, mirroring the live
    # import path in bootstrap._apply_migration_record
    acc.migrating_out.pop(job_id, None)
    acc.migrated_out.pop(job_id, None)
    seed_job(server, acc, jd, rec.get("bodies") or [],
             rec.get("requests") or [])
    src_fence = int(rec.get("fence", 0))
    for t in jd.get("pending") or ():
        key = (job_id, t["id"])
        if src_fence:
            acc.task_instances[key] = max(
                acc.task_instances.get(key, 0), src_fence
            )
        # the source's workers never reattach here: requeue, don't hold
        acc.task_maybe_running[key] = False


def _drop_migrated_job(server, acc: _RestoreAcc, job_id: int,
                       to_shard: int) -> None:
    """migration-out-done replay: the handoff finalized before the crash.
    Only a tombstone survives, for wrong-shard redirects."""
    job = server.jobs.jobs.pop(job_id, None)
    if job is not None:
        for uid in job.streams:
            server._stream_jobs.pop(uid, None)
    acc.job_descs.pop(job_id, None)
    acc.lazy_chunks = [(j, s) for j, s in acc.lazy_chunks if j != job_id]
    for table in (acc.task_status, acc.task_finished_at,
                  acc.task_started_at, acc.task_instances,
                  acc.task_maybe_running, acc.task_variants,
                  acc.task_crashes):
        for key in [k for k in table if k[0] == job_id]:
            del table[key]
    acc.migrating_out.pop(job_id, None)
    acc.migrated_out[job_id] = to_shard


def _replay_record(server, acc: _RestoreAcc, record: dict) -> None:
    """One journal record into the accumulators (phase 2 / full replay)."""
    kind = record.get("event")
    job_id = record.get("job")
    # usage-ledger fold: the same observe() the live emit
    # path runs, on the same records in the same order — replay rebuilds
    # the ledger bit-equal to the crashed instance's. getattr: test
    # harnesses replay into bare fakes that carry no ledger
    ledger = getattr(server, "accounting", None)
    if ledger is not None:
        ledger.observe(kind, record)
    if kind == "job-submitted":
        desc = record.get("desc") or {}
        job = server.jobs.jobs.get(job_id)
        if job is None:
            job = server.jobs.create_job(
                name=desc.get("name", "job"),
                submit_dir=desc.get("submit_dir", "/"),
                max_fails=desc.get("max_fails"),
                is_open=desc.get("open", False),
                job_id=job_id,
            )
        submit_time = float(record.get("time", 0.0))
        if submit_time and (
            not job.tasks or submit_time < job.submitted_at
        ):
            job.submitted_at = submit_time
        # chunked-submit stream bookkeeping: applied chunk
        # indexes are the exactly-once fence a reconnecting client's
        # retried chunks are deduplicated against — restored for BOTH the
        # compact-lazy and the expanded replay paths below
        chunk = record.get("chunk")
        if isinstance(chunk, dict) and chunk.get("uid"):
            uid = chunk["uid"]
            server._stream_jobs[uid] = job_id
            stream = job.streams.get(uid)
            if stream is None:
                stream = job.streams[uid] = {
                    "applied": set(), "sealed": False,
                }
                job.open_streams += 1
            stream["applied"].add(int(chunk.get("i", 0)))
            if chunk.get("last") and not stream["sealed"]:
                stream["sealed"] = True
                job.open_streams = max(job.open_streams - 1, 0)
        array = desc.get("array")
        if array and _array_replays_lazy(server, array):
            # keep the array COMPACT through replay: it re-registers as a
            # lazy chunk at the end of restore (minus any journal-tail-
            # touched ids), exactly like a snapshot's "lazy" table — a
            # crash right after a 1M-task lazy submit must not make
            # restore O(tasks)
            id_range = array.get("id_range")
            n_array = (
                int(id_range[1]) - int(id_range[0])
                if id_range is not None else len(array["ids"])
            )
            spec: dict = {
                "request": array.get("request") or {},
                "body": array.get("body") or {},
                "priority": int(array.get("priority", 0)),
                "crash_limit": int(array.get("crash_limit", 5)),
                "submitted_at": submit_time,
                "ready_at": submit_time,
            }
            if id_range is not None:
                spec["id_range"] = [int(id_range[0]), int(id_range[1])]
            else:
                spec["ids"] = list(array["ids"])
            if array.get("entries") is not None:
                spec["entries"] = list(array["entries"])
            tctx0 = record.get("trace")
            if isinstance(tctx0, dict) and tctx0.get("id"):
                spec["trace"] = {**tctx0, "commit_at": submit_time}
            acc.lazy_chunks.append((job_id, spec))
            job.submits.append(submit_record(desc, n_array))
            return
        expanded = expand_desc_tasks(desc)
        for t in expanded:
            server.jobs.attach_task(job, t.get("id", 0))
            if submit_time:
                # keep the ORIGINAL submit clock, not the restore's
                job.tasks[t.get("id", 0)].submitted_at = submit_time
        if expanded:
            job.submits.append(submit_record(desc, len(expanded)))
        acc.job_descs.setdefault(job_id, []).extend(expanded)
        tctx = record.get("trace")
        if isinstance(tctx, dict) and tctx.get("id"):
            # per task, not per job: an open job accumulates submits, each
            # with its own trace id and clocks
            sub_trace = {**tctx, "commit_at": float(record.get("time", 0.0))}
            for t in expanded:
                acc.task_submit_trace[(job_id, t.get("id", 0))] = sub_trace
    elif kind == "job-opened":
        if job_id not in server.jobs.jobs:
            server.jobs.create_job(
                name=record.get("name", "job"),
                submit_dir=record.get("submit_dir", "/"),
                is_open=True,
                job_id=job_id,
            )
    elif kind == "job-closed":
        job = server.jobs.jobs.get(job_id)
        if job is not None:
            job.is_open = False
            # a close seals abandoned chunk streams (mirrors the live
            # _client_close_job), or the restored job could never end
            job.seal_streams()
    elif kind == "job-streams-sealed":
        # a forced seal (cancel / rejected chunk) — no `last` chunk event
        # exists for these, so the dedicated record re-seals on replay
        job = server.jobs.jobs.get(job_id)
        if job is not None:
            for uid in record.get("uids") or ():
                stream = job.streams.get(uid)
                if stream is not None and not stream["sealed"]:
                    stream["sealed"] = True
                    job.open_streams = max(job.open_streams - 1, 0)
    elif kind == "job-completed":
        job = server.jobs.jobs.get(job_id)
        if job is not None:
            if record.get("cancel_reason"):
                job.cancel_reason = record["cancel_reason"]
            # a job that reported completion has no open streams by
            # definition (belt and braces for pre-seal-event journals)
            job.seal_streams()
    elif kind in TERMINAL:
        acc.task_status[(job_id, record["task"])] = (
            TERMINAL[kind],
            record.get("error", ""),
        )
        acc.task_finished_at[(job_id, record["task"])] = float(
            record.get("time", 0.0)
        )
        tctx = record.get("trace")
        if isinstance(tctx, dict):
            acc.task_finish_wtrace[(job_id, record["task"])] = tctx
    elif kind == "task-started":
        key = (job_id, record["task"])
        acc.task_instances[key] = max(
            record.get("instance", 0), acc.task_instances.get(key, 0)
        )
        acc.task_variants[key] = record.get("variant", 0)
        acc.task_maybe_running[key] = True
        acc.task_started_at[key] = (
            float(record.get("queued_at", 0.0)),
            float(record.get("assigned_at", 0.0)),
            float(record.get("started_at", 0.0))
            or float(record.get("time", 0.0)),
        )
        tctx = record.get("trace")
        if isinstance(tctx, dict):
            wt = dict(tctx)
            wt["_worker"] = (record.get("workers") or [0])[0]
            wt["_instance"] = record.get("instance", 0)
            acc.task_wtrace[key] = wt
            lends = wt.get("lends")
            if lends is None:
                # legacy journals: scalar lent_from for the first worker
                lf = wt.get("lent_from")
                lends = ([[wt["_worker"], int(lf)]]
                         if lf is not None and int(lf) >= 0 else [])
            for lend_wid, home in lends:
                acc.task_lends.setdefault(key, []).append({
                    "worker": int(lend_wid),
                    "home_shard": int(home),
                    "instance": record.get("instance", 0),
                    "time": float(record.get("started_at", 0.0))
                    or float(record.get("time", 0.0)),
                })
    elif kind == "task-restarted":
        key = (job_id, record["task"])
        acc.task_crashes[key] = record.get(
            "crash_count", acc.task_crashes.get(key, 0)
        )
        acc.task_instances[key] = max(
            record.get("instance", 0), acc.task_instances.get(key, 0)
        )
        acc.task_maybe_running[key] = False
    elif kind == "server-uid":
        server.journal_uids.add(record.get("server_uid") or "")
        acc.n_boots += 1
    elif kind == "migration-out":
        # export sealed: the job stays here — held — until the
        # coordinator's re-driven migration commits or aborts the move
        acc.migrating_out[job_id] = dict(record)
    elif kind == "migration-in":
        _seed_migration_record(server, acc, record.get("record") or {})
    elif kind == "migration-out-done":
        _drop_migrated_job(server, acc, job_id, int(record.get("to", -1)))
    elif isinstance(kind, str) and kind.startswith("alloc-"):
        _replay_alloc_record(acc, kind, record)


def _apply_lazy_chunks(server, acc: _RestoreAcc) -> None:
    """Re-register a snapshot's unmaterialized array chunks.

    Each chunk re-enters the lazy store with its ORIGINAL clocks and
    interned request; ids that gained per-task state in the journal tail
    (started/crashed/terminal after the snapshot) are dropped from the
    chunk and appended to acc.job_descs so the standard per-task restore
    path (reattach holds, fencing, counters) handles them."""
    from hyperqueue_tpu_torch.server.lazy import ArrayChunk

    touched: dict[int, set[int]] = {}
    for key in (
        set(acc.task_status)
        | set(acc.task_instances)
        | set(acc.task_maybe_running)
        | set(acc.task_crashes)
    ):
        touched.setdefault(key[0], set()).add(key[1])
    core = server.core
    for job_id, spec in acc.lazy_chunks:
        job = server.jobs.jobs.get(job_id)
        if job is None:
            continue
        rqv = rqv_from_wire(spec.get("request") or {}, core.resource_map)
        rq_id = core.intern_rqv(rqv)
        if "id_range" in spec:
            lo, hi = int(spec["id_range"][0]), int(spec["id_range"][1])
            id_range, ids = (lo, hi), None
            dead = [d for d in (spec.get("dead") or ()) if lo <= d < hi]
            contains = lambda t: lo <= t < hi  # noqa: E731
        else:
            ids = [int(t) for t in spec["ids"]]
            id_range = None
            dead = []
            id_set = set(ids)
            contains = lambda t: t in id_set  # noqa: E731
        hits = sorted(
            t for t in touched.get(job_id, ()) if contains(t)
        )
        chunk = ArrayChunk(
            job_id=job_id,
            rq_id=rq_id,
            priority=(int(spec.get("priority", 0)),
                      encode_sched_priority(job_id)),
            body=spec.get("body") or {},
            crash_limit=int(spec.get("crash_limit", 5)),
            id_range=id_range,
            ids=ids,
            entries=spec.get("entries"),
            submitted_at=float(spec.get("submitted_at") or 0.0),
            ready_at=float(spec.get("ready_at") or 0.0),
            trace=spec.get("trace"),
        )
        core.lazy.register(core, chunk)
        for t in dead:
            core.lazy.drop_id(core, job_id, t)
        descs = acc.job_descs.setdefault(job_id, [])
        for t in hits:
            if not core.lazy.drop_id(core, job_id, t):
                continue  # a dead id that also shows as touched
            server.jobs.attach_task(job, t)
            job.tasks[t].submitted_at = chunk.submitted_at
            if chunk.trace and chunk.trace.get("id"):
                # the chunk's submit stamps open this task's restored
                # trace, same as materialization would have
                acc.task_submit_trace.setdefault(
                    (job_id, t), dict(chunk.trace)
                )
            desc = {
                "id": t,
                "body": chunk.body,
                "request": spec.get("request") or {},
                "priority": chunk.priority[0],
                "crash_limit": chunk.crash_limit,
                "deps": (),
            }
            if chunk.entries is not None:
                index = chunk.index_of(t)
                if index is not None:
                    desc["entry"] = chunk.entries[index]
            descs.append(desc)
        if core.lazy.job_unmaterialized(job_id):
            server.comm.ask_for_scheduling()


def _rebuild_traces(server, acc: _RestoreAcc) -> None:
    """Reassemble the per-task trace store from what the journal (and/or
    snapshot) preserved, mirroring the spans the live EventBridge records.
    Span dedup on (name, instance) makes seeding + tail replay idempotent,
    so a snapshot-seeded trace merged with tail events stays ONE trace."""
    traces = server.core.traces
    if not traces.enabled:
        return
    for task_id, rec in acc.task_trace_seed.items():
        traces.seed(task_id, rec)
    keys = (
        set(acc.task_submit_trace)
        | set(acc.task_wtrace)
        | set(acc.task_finish_wtrace)
    )
    for key in sorted(keys):
        job_id, job_task_id = key
        task_id = make_task_id(job_id, job_task_id)
        sub = acc.task_submit_trace.get(key) or {}
        wt = acc.task_wtrace.get(key) or {}
        fin = acc.task_finish_wtrace.get(key) or {}
        trace_id = sub.get("id") or wt.get("id") or fin.get("id")
        if traces.get(task_id) is None:
            if not trace_id:
                continue
            traces.begin(task_id, trace_id)
        instance = wt.get("_instance", acc.task_instances.get(key, 0))
        wid = wt.get("_worker", 0)
        # fleet trace stitching: a start on a borrowed worker
        # journaled its lend context — rebuild the same annotation the
        # live EventBridge stamped (annotate() dedups against a snapshot-
        # seeded copy)
        for note in acc.task_lends.get(key, ()):
            traces.annotate(task_id, {
                "kind": "lend",
                "host_shard": getattr(server, "shard_id", 0),
                **note,
            })
        parent = None
        sent = float(sub.get("sent_at") or 0.0)
        recv = float(sub.get("recv_at") or 0.0)
        commit = float(sub.get("commit_at") or 0.0)
        if sent and recv:
            parent = traces.span(
                task_id, "client/submit", sent, recv, "client",
            ) or parent
        if recv and commit:
            parent = traces.span(
                task_id, "server/submit", recv, commit, "server",
                parent=parent,
            ) or parent
        stamps = acc.task_started_at.get(key)
        if stamps is not None:
            queued, assigned, _started = stamps
            if queued and assigned:
                parent = traces.span(
                    task_id, "server/queue", queued, assigned, "server",
                    instance, parent,
                ) or parent
            accepted = wt.get("accepted_at")
            if assigned and accepted:
                parent = traces.span(
                    task_id, "server/dispatch", assigned, accepted,
                    "server", instance, parent,
                ) or parent
            launch = wt.get("launch_at")
            if accepted and launch:
                parent = traces.span(
                    task_id, "worker/accept", accepted, launch,
                    f"worker:{wid}", instance, parent,
                ) or parent
            spawned = wt.get("spawned_at")
            if launch and spawned:
                parent = traces.span(
                    task_id, "worker/spawn", launch, spawned,
                    f"worker:{wid}", instance, parent,
                ) or parent
        if fin:
            terminal_at = acc.task_finished_at.get(key, 0.0)
            spawned = fin.get("spawned_at") or (
                stamps[2] if stamps else 0.0
            )
            exited = fin.get("exited_at")
            if spawned and exited:
                parent = traces.span(
                    task_id, "worker/run", spawned, exited,
                    f"worker:{wid}", instance, parent,
                ) or parent
            sent_up = fin.get("sent_at")
            if sent_up and terminal_at:
                parent = traces.span(
                    task_id, "worker/uplink", sent_up, terminal_at,
                    f"worker:{wid}", instance, parent,
                ) or parent
            if terminal_at:
                traces.span(
                    task_id, "server/commit", terminal_at, terminal_at,
                    "server", instance, parent,
                )
            traces.close(task_id)


def restore_from_journal(server) -> None:
    """Restore server.jobs/server.core from the snapshot + journal pair.

    Tasks that were RUNNING at the crash (a task-started with no terminal
    event — or, via a snapshot, RUNNING at capture with no later terminal)
    are held in server.reattach_pending instead of being requeued: their
    pre-crash worker keeps running them through the outage
    (`--on-server-lost reconnect`) and reclaims them at re-registration
    with the preserved instance id. Only when no worker reclaims a task
    within `--reattach-timeout` is it fenced (instance bump) and requeued
    (see Server._reattach_reaper). With the window disabled the fence +
    requeue happens here, the pre-reattach behavior.
    """
    t_restore0 = time.perf_counter()
    salvage = getattr(server, "journal_salvage", False)
    acc = _RestoreAcc()

    # --- phase 1: newest valid snapshot, with fallback -----------------
    watermark = None
    snap_used = None
    for state, snap_path in snapshot_mod.iter_snapshot_candidates(
        server.journal_path
    ):
        try:
            _seed_from_snapshot(server, acc, state)
            watermark = state["seq"]
            snap_used = snap_path
            break
        except Exception:
            logger.exception(
                "snapshot %s failed to load; falling back", snap_path
            )
            # the seed only touched jobs/seq/uids + accumulators: reset
            # them and try the next candidate (then full replay)
            server.jobs = JobManager()
            server.journal_uids = set()
            server._event_seq = 0
            server._stream_jobs = {}
            server.accounting.seed(None)
            acc = _RestoreAcc()

    # --- phase 2: journal tail replay ----------------------------------
    n_events = 0
    n_skipped = 0
    if server.journal_path.exists():
        for record in Journal.read_all(server.journal_path, salvage=salvage):
            # continue the event sequence where the journal left off so
            # stream-with-history seq dedup stays monotonic across restarts
            seq = record.get("seq")
            if isinstance(seq, int) and seq >= server._event_seq:
                server._event_seq = seq + 1
            if (
                watermark is not None
                and isinstance(seq, int)
                and seq < watermark
            ):
                # pre-watermark records survive GC only so that
                # `journal stream --history` keeps live jobs' timelines;
                # their effects are already inside the snapshot
                n_skipped += 1
                continue
            n_events += 1
            _replay_record(server, acc, record)

    # lazy snapshot chunks: ids the journal tail touched (a start, crash,
    # or terminal event after the snapshot) must materialize through the
    # normal per-task path; everything else re-registers as a lazy chunk —
    # a restored 1M-task lazy array stays O(chunks + touched)
    if acc.lazy_chunks:
        _apply_lazy_chunks(server, acc)

    # apply terminal statuses to job counters (with the ORIGINAL clock so
    # `hq job timeline` of a restored job reports true phase durations)
    for (job_id, task_id), (status, error) in acc.task_status.items():
        job = server.jobs.jobs.get(job_id)
        if job is None or task_id not in job.tasks:
            continue
        info = job.tasks[task_id]
        info.status = status
        info.error = error
        info.finished_at = acc.task_finished_at.get((job_id, task_id), 0.0)
        stamps = acc.task_started_at.get((job_id, task_id))
        if stamps is not None:
            info.started_at = stamps[2]
        job.counters[status] += 1

    # re-submit unfinished tasks into the core
    from hyperqueue_tpu_torch.server.task import INSTANCE_GENERATION_STRIDE

    fence_floor = max(acc.n_boots, 1) * INSTANCE_GENERATION_STRIDE
    server.core.instance_fence_floor = fence_floor
    server.n_boots = acc.n_boots
    resubmitted = 0
    held = 0
    reattach_window = getattr(server, "reattach_timeout", 0.0)
    reattach_deadline = clock.monotonic() + reattach_window
    for job_id, descs in acc.job_descs.items():
        job = server.jobs.jobs.get(job_id)
        if job is None:
            continue
        new_tasks = []
        for t in descs:
            job_task_id = t.get("id", 0)
            key = (job_id, job_task_id)
            if key in acc.task_status:
                continue  # already terminal
            rqv = rqv_from_wire(t.get("request") or {}, server.core.resource_map)
            rq_id = server.core.intern_rqv(rqv)
            deps = tuple(
                make_task_id(job_id, d)
                for d in t.get("deps", ())
                if acc.task_status.get((job_id, d), ("",))[0] != "finished"
            )
            # failed/canceled dependency => this task can never run; mark it
            dead_dep = any(
                acc.task_status.get((job_id, d), ("",))[0]
                in ("failed", "canceled")
                for d in t.get("deps", ())
            )
            if dead_dep:
                job.tasks[job_task_id].status = "canceled"
                job.counters["canceled"] += 1
                continue
            task = Task(
                task_id=make_task_id(job_id, job_task_id),
                rq_id=rq_id,
                priority=(int(t.get("priority", 0)),
                          encode_sched_priority(job_id)),
                body=t.get("body", {}),
                entry=t.get("entry"),
                deps=deps,
                crash_limit=int(t.get("crash_limit", 5)),
            )
            task.crash_counter = acc.task_crashes.get(key, 0)
            started_instance = acc.task_instances.get(key)
            if started_instance is None:
                # never started AS FAR AS THE JOURNAL KNOWS. The start —
                # or a whole start/requeue/restart chain — may sit in the
                # crashed boot's lost tail (worker uplink coalescing + the
                # in-flight journal batch) while an incarnation still runs
                # on a reconnecting worker; re-issuing at an id that chain
                # reached would execute one instance twice, invisible to
                # the (task, instance) equality fence. Jumping to this
                # boot's generation base clears every id any prior boot
                # could have issued; the reconnecting worker's stale claim
                # is then discarded and its copy killed at re-registration.
                task.fence_instance(fence_floor)
                new_tasks.append(task)
                continue
            # preserved instance id: stale pre-crash worker messages carry
            # older instance ids and are dropped (reference gateway.rs:204
            # adjust_instance_id_and_crash_counters)
            task.instance_id = started_instance
            task.assigned_variant = acc.task_variants.get(key, 0)
            if (
                reattach_window > 0
                and acc.task_maybe_running.get(key)
                and not rqv.is_multi_node
            ):
                # maybe still running on a reconnecting worker: hold it out
                # of the queues (state WAITING, deps all finished) until a
                # worker reclaims it or the window expires. Gangs are never
                # held — a partial gang reattach is worthless, so they are
                # fenced + requeued like before.
                stamps = acc.task_started_at.get(key)
                if stamps is not None:
                    # pre-seed the lifecycle chain from the journal: on
                    # reattach the task keeps its ORIGINAL start (one
                    # unbroken timeline, no duplicate spawn phase)
                    task.t_ready, task.t_assigned, task.t_started = stamps
                server.core.tasks[task.task_id] = task
                server.reattach_pending[task.task_id] = reattach_deadline
                held += 1
            else:
                # fence out the pre-crash incarnation (and anything past
                # it in the lost tail) and requeue now
                task.fence_instance(fence_floor)
                new_tasks.append(task)
        if new_tasks:
            reactor.on_new_tasks(server.core, server.comm, new_tasks)
            resubmitted += len(new_tasks)

    # elastic resharding: restore the handoff tombstones and
    # re-seal jobs whose export had no journaled finalize — they stay
    # paused until the coordinator re-drives (or aborts) the migration
    server.migrated_out.update(acc.migrated_out)
    if acc.migrating_out:
        server.migrating_out.update(acc.migrating_out)
        reactor.pause_jobs(server.core, server.comm,
                           list(acc.migrating_out))
    _rebuild_traces(server, acc)

    # hand the reconstructed allocation table to the autoalloc service
    # (created after restore in Server.start): restored active allocations
    # are reconciled against the manager on the first refresh — never
    # double-submitted, never leaked — and unresolved submit attempts are
    # pidfile-scanned for orphans
    if acc.autoalloc or acc.alloc_attempts:
        queues_out = []
        for q in acc.autoalloc.values():
            qd = dict(q)
            qd["allocations"] = list(qd.pop("_allocs", {}).values())
            queues_out.append(qd)
        server.restored_autoalloc = {
            "queues": queues_out,
            "next_queue_id": acc.next_alloc_queue_id,
            "attempts": acc.alloc_attempts,
        }
    duration = time.perf_counter() - t_restore0
    _RESTORE_SECONDS.observe(duration)
    server.last_restore = {
        "duration_s": round(duration, 4),
        "snapshot": str(snap_used) if snap_used else None,
        "tail_events": n_events,
        "skipped_pre_watermark": n_skipped,
        "jobs": len(server.jobs.jobs),
        "resubmitted": resubmitted,
        "held_for_reattach": held,
    }
    logger.info(
        "restored %d jobs in %.3fs (%s, %d tail events, %d tasks "
        "resubmitted, %d held for reattach) from %s",
        len(server.jobs.jobs),
        duration,
        f"snapshot {snap_used.name}" if snap_used else "full replay",
        n_events,
        resubmitted,
        held,
        server.journal_path,
    )
