"""Server-state snapshots: the O(live-state) half of journal compaction.

Reference: crates/hyperqueue/src/server/event/journal/prune.rs bounds the
journal by rewriting it; here the bound is stronger — a snapshot captures
the full restorable server state (jobs, task statuses and counters, open
submits, instance-fence lineage, the event-seq watermark) so restore can
load it and replay only the post-snapshot journal tail instead of every
event ever written. Restore time and memory become O(live state), not
O(history).

File format (`<journal>.snap`, fallback `<journal>.snap.prev`):

    8-byte magic "hqtpusn1" | u32-LE payload length | msgpack payload
    | u32-LE CRC32 of payload

Durability contract: the snapshot is written to a temp file, fsynced,
published with an atomic rename, and the parent directory is fsynced —
only then may the journal GC drop anything the snapshot covers. The
previous snapshot is rotated to `.snap.prev` first, so a torn/corrupt
newest snapshot falls back to the previous one, and from there to a full
journal replay. A crash at ANY point leaves at least one restorable
source (chaos-tested in the JAX package's tests/test_snapshot.py).

The payload is deliberately shaped like the journal-replay accumulators in
events/restore.py: loading a snapshot seeds exactly the state a full
replay of the pre-watermark journal would have produced (property-tested
bit-equal), so every restore invariant — reattach holds, original
timeline clocks, generation-base fencing — is preserved by construction.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from pathlib import Path

from hyperqueue_tpu_torch.events.journal import fsync_dir
from hyperqueue_tpu_torch.ids import make_task_id, task_id_task
from hyperqueue_tpu_torch.transport import codec
from hyperqueue_tpu_torch.utils import clock

MAGIC = b"hqtpusn1"
VERSION = 1
_LEN = struct.Struct("<I")

logger = logging.getLogger("hq.snapshot")

_TERMINAL = ("finished", "failed", "canceled")


class SnapshotError(RuntimeError):
    """The snapshot file is torn, corrupt, or from an unknown version."""


def snapshot_path(journal_path: Path) -> Path:
    return Path(str(journal_path) + ".snap")


def prev_snapshot_path(journal_path: Path) -> Path:
    return Path(str(journal_path) + ".snap.prev")


def have_snapshot(journal_path: Path) -> bool:
    return (
        snapshot_path(journal_path).exists()
        or prev_snapshot_path(journal_path).exists()
    )


# --------------------------------------------------------------------------
# capture: live server state -> snapshot payload
# --------------------------------------------------------------------------
def capture_state(server) -> dict:
    """Serialize the server's restorable state as of NOW.

    Must run synchronously on the reactor loop (no awaits between the
    event-seq watermark read and the last field captured): the watermark
    asserts "everything below this seq is inside", which is only true
    while no handler can interleave.

    Task bodies and resource requests are deduped through shared tables:
    an array's tasks share ONE body object in the core, and the snapshot
    preserves that sharing (the wire-level body dedup relies on identity,
    see protocol.expand_desc_tasks) while keeping the payload O(live
    state) rather than O(tasks x body size).
    """
    from hyperqueue_tpu_torch.server.protocol import rqv_to_wire
    from hyperqueue_tpu_torch.server.task import TaskState

    bodies: list[dict] = []
    body_index: dict[int, int] = {}
    requests: list[dict] = []
    request_index: dict[int, int] = {}
    jobs_out = [
        capture_job(server, job, bodies, body_index, requests, request_index)
        for job in server.jobs.jobs.values()
    ]
    # live tasks' distributed traces (utils/trace.py TaskTraceStore): the
    # GC'd journal prefix held their submit/start events, so the snapshot
    # must carry the assembled spans or a snapshot-seeded restore would
    # break the "one unbroken trace across restart" contract. Terminal
    # tasks are excluded — bounded by live state like everything else here.
    live_task_ids = [
        make_task_id(jd["id"], t["id"])
        for jd in jobs_out
        for t in jd["pending"]
    ]
    # allocation table: queues + allocation lifecycle + submits
    # in flight, so a snapshot-seeded restore reconciles the live
    # allocation set against the manager instead of forgetting it
    autoalloc = getattr(server, "autoalloc", None)
    return {
        "version": VERSION,
        "time": clock.now(),
        "autoalloc": autoalloc.capture() if autoalloc is not None else None,
        "traces": server.core.traces.snapshot_live(live_task_ids),
        # event-seq watermark: every event with seq < this is folded into
        # the snapshot; restore replays only seq >= this from the journal
        "seq": server._event_seq,
        # server-uid records written up to the watermark (this boot
        # included): the next restore's instance-generation fence base
        "n_boots": server.n_boots,
        "server_uids": sorted(server.journal_uids),
        "next_job_id": server.jobs.job_id_counter.peek(),
        # usage ledger as of the SAME watermark: capture runs
        # synchronously between emits, so the captured rows correspond
        # exactly to the events with seq < watermark — a snapshot-seeded
        # restore is bit-equal to a full replay. Optional on read:
        # pre-accounting snapshots seed an empty ledger.
        "accounting": (
            server.accounting.capture()
            if getattr(server, "accounting", None) is not None
            else None
        ),
        "bodies": bodies,
        "requests": requests,
        "jobs": jobs_out,
    }


def capture_job(server, job, bodies: list, body_index: dict,
                requests: list, request_index: dict) -> dict:
    """One job's restorable state, in the snapshot's per-job shape.

    Shared by :func:`capture_state` (all jobs, shared dedup tables) and
    the migration export RPC (one job with fresh tables makes
    a self-contained migration record). Lazy array chunks are captured in
    CHUNK form (id ranges + tombstones), so capturing — and migrating — a
    1M-task lazy array is O(chunks), never O(tasks)."""
    from hyperqueue_tpu_torch.server.protocol import rqv_to_wire
    from hyperqueue_tpu_torch.server.task import TaskState

    core = server.core
    done = []
    pending = []
    for info in job.tasks.values():
        if info.status in _TERMINAL:
            done.append([
                info.job_task_id, info.status, info.error,
                info.finished_at, info.started_at, info.submitted_at,
            ])
            continue
        task_id = make_task_id(job.job_id, info.job_task_id)
        task = core.tasks.get(task_id)
        if task is None:
            # jobs-layer entry with no core task: without the core
            # record there is no body/request to rebuild it from, so
            # it cannot ride the snapshot (should not happen outside
            # forget/teardown races — scream if it ever does)
            logger.error(
                "snapshot: non-terminal task %d.%d has no core "
                "record; it will be missing from the snapshot",
                job.job_id, info.job_task_id,
            )
            continue
        body_key = id(task.body)
        body_i = body_index.get(body_key)
        if body_i is None:
            body_i = len(bodies)
            body_index[body_key] = body_i
            bodies.append(task.body)
        rq_i = request_index.get(task.rq_id)
        if rq_i is None:
            rq_i = len(requests)
            request_index[task.rq_id] = rq_i
            requests.append(
                rqv_to_wire(
                    core.rq_map.get_variants(task.rq_id),
                    core.resource_map,
                )
            )
        entry = {
            "id": info.job_task_id,
            "b": body_i,
            "rq": rq_i,
            "priority": task.priority[0],
            "crash_limit": task.crash_limit,
            "deps": [task_id_task(d) for d in task.deps],
            "submitted_at": info.submitted_at,
            "instance": task.instance_id,
            "crashes": task.crash_counter,
            "variant": task.assigned_variant,
            # journal-replay parity: "the last lifecycle event was a
            # start" == the incarnation may still run on a worker that
            # will reconnect and reclaim it. ASSIGNED tasks (compute
            # sent, start not yet reported) have no journaled start, so
            # replay would fence + re-issue them — capture the same.
            "running": (
                task.state is TaskState.RUNNING
                or task_id in server.reattach_pending
            ),
            "stamps": [task.t_ready, task.t_assigned, task.t_started],
        }
        if task.entry is not None:
            entry["entry"] = task.entry
        pending.append(entry)
    jd = {
        "id": job.job_id,
        "name": job.name,
        "submit_dir": job.submit_dir,
        "max_fails": job.max_fails,
        "open": job.is_open,
        "cancel_reason": job.cancel_reason,
        "submitted_at": job.submitted_at,
        "submits": job.submits,
        "done": done,
        "pending": pending,
    }
    # chunked-submit streams: applied chunk indexes are the
    # exactly-once fence for client retries; they must survive any
    # restore the journal would have survived
    if job.streams:
        jd["streams"] = {
            uid: {"applied": sorted(s["applied"]),
                  "sealed": bool(s["sealed"])}
            for uid, s in job.streams.items()
        }
    # unmaterialized lazy array chunks: O(chunks + tombstones) — the
    # whole point is that a 1M-task lazy array snapshots (and
    # restores) without expanding to per-task records
    lazy_out = []
    for seg in server.core.lazy.segments_of(job.job_id):
        chunk = seg.chunk
        body_key = id(chunk.body)
        body_i = body_index.get(body_key)
        if body_i is None:
            body_i = len(bodies)
            body_index[body_key] = body_i
            bodies.append(chunk.body)
        rq_i = request_index.get(chunk.rq_id)
        if rq_i is None:
            rq_i = len(requests)
            request_index[chunk.rq_id] = rq_i
            requests.append(
                rqv_to_wire(
                    core.rq_map.get_variants(chunk.rq_id),
                    core.resource_map,
                )
            )
        spec: dict = {
            "b": body_i,
            "rq": rq_i,
            "priority": chunk.priority[0],
            "crash_limit": chunk.crash_limit,
            "submitted_at": chunk.submitted_at,
            "ready_at": chunk.ready_at,
        }
        if chunk.trace:
            spec["trace"] = chunk.trace
        if chunk.id_range is not None and chunk.entries is None:
            spec["id_range"] = [
                chunk.id_range[0] + seg.pos, chunk.id_range[1],
            ]
            dead = [
                chunk.id_at(i) for i in sorted(seg.dead) if i >= seg.pos
            ]
            if dead:
                spec["dead"] = dead
        else:
            remaining = list(seg.remaining_ids())
            spec["ids"] = remaining
            if chunk.entries is not None:
                spec["entries"] = [
                    chunk.entries[chunk.index_of(t)] for t in remaining
                ]
        lazy_out.append(spec)
    if lazy_out:
        jd["lazy"] = lazy_out
    return jd


# --------------------------------------------------------------------------
# write: temp -> fsync -> rotate prev -> atomic rename -> dir fsync
# --------------------------------------------------------------------------
def write_snapshot(journal_path: Path, state: dict) -> Path:
    """Durably publish `state` as the newest snapshot.

    Crash matrix (kill -9 injectable at each named chaos point once the
    chaos plane is ported):
    - mid-snapshot-write: only the temp file is torn; .snap/.snap.prev
      untouched.
    - pre-rename: temp complete but unpublished; old snapshots intact.
    - between the rotations: .snap.prev holds the previously-newest
      snapshot; .snap may be briefly absent — restore falls back to prev.
    - post-rename: the new snapshot is durable; the journal still holds
      everything (GC has not run yet), so restore is merely un-compacted.
    """
    snap = snapshot_path(journal_path)
    prev = prev_snapshot_path(journal_path)
    tmp = Path(str(snap) + ".tmp")
    payload = codec.packb(state)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(_LEN.pack(len(payload)))
        half = len(payload) // 2
        f.write(payload[:half])
        # the chaos plane's "mid-snapshot-write" kill site goes here
        # (ROADMAP Queue 1 item 10)
        f.write(payload[half:])
        f.write(_LEN.pack(zlib.crc32(payload)))
        f.flush()
        os.fsync(f.fileno())
    # the "pre-rename" kill site (ROADMAP Queue 1 item 10)
    if snap.exists():
        os.replace(snap, prev)
    os.replace(tmp, snap)
    fsync_dir(snap.parent)
    # the "post-rename" kill site (ROADMAP Queue 1 item 10)
    return snap


# --------------------------------------------------------------------------
# load: newest valid snapshot, with fallback
# --------------------------------------------------------------------------
def read_snapshot(path: Path) -> dict:
    """Parse + validate one snapshot file; SnapshotError on any defect."""
    try:
        blob = path.read_bytes()
    except OSError as e:
        raise SnapshotError(f"{path}: {e}") from e
    if len(blob) < len(MAGIC) + _LEN.size or blob[: len(MAGIC)] != MAGIC:
        raise SnapshotError(f"{path}: bad magic")
    (length,) = _LEN.unpack_from(blob, len(MAGIC))
    start = len(MAGIC) + _LEN.size
    if len(blob) < start + length + _LEN.size:
        raise SnapshotError(f"{path}: torn (payload incomplete)")
    payload = blob[start : start + length]
    (crc,) = _LEN.unpack_from(blob, start + length)
    if zlib.crc32(payload) != crc:
        raise SnapshotError(f"{path}: CRC mismatch")
    try:
        state = codec.unpackb(payload, strict_map_key=False)
    except Exception as e:
        raise SnapshotError(f"{path}: undecodable payload") from e
    if not isinstance(state, dict) or state.get("version") != VERSION:
        raise SnapshotError(
            f"{path}: unsupported snapshot version "
            f"{state.get('version') if isinstance(state, dict) else '?'}"
        )
    for key in ("seq", "n_boots", "jobs", "bodies", "requests"):
        if key not in state:
            raise SnapshotError(f"{path}: missing field {key!r}")
    return state


def iter_snapshot_candidates(journal_path: Path):
    """Yield (state, path) for each readable snapshot, newest first.

    A corrupt/torn newest snapshot logs loudly and falls through to the
    previous one; the caller falls back to full journal replay when the
    iterator is empty."""
    for path in (snapshot_path(journal_path), prev_snapshot_path(journal_path)):
        if not path.exists():
            continue
        try:
            yield read_snapshot(path), path
        except SnapshotError as e:
            logger.error("ignoring unusable snapshot: %s", e)


def snapshot_stats(journal_path: Path) -> dict:
    """Cheap (stat-only) observability fields for `hq journal info` /
    `hq server stats` / the metrics collect hook."""
    out: dict = {"path": None, "bytes": 0, "age_seconds": None}
    snap = snapshot_path(journal_path)
    prev = prev_snapshot_path(journal_path)
    try:
        # stat() directly, no exists() pre-check: a concurrent compaction's
        # rotate window (.snap briefly absent between the two renames)
        # must read as "none right now", not crash the scrape
        st = snap.stat()
        out.update(
            path=str(snap), bytes=st.st_size,
            age_seconds=max(clock.now() - st.st_mtime, 0.0),
        )
    except OSError:
        pass
    try:
        out["prev_bytes"] = prev.stat().st_size
    except OSError:
        out["prev_bytes"] = 0
    return out
