"""Per-job / per-label usage accounting ledger.

The server already journals every task-lifecycle transition with its
stamps (``queued_at``/``assigned_at``/``started_at`` on task-started,
the record clock on restart/terminal events). This module folds those
records into an incremental ledger of consumed resource-time — the
per-entity usage table fairness policies are computed over (Gavel,
arXiv:2008.09213) and the substrate quota/admission control needs
before it can be enforced.

Design rules:

- **Pure fold.** ``observe(kind, record)`` consumes the SAME record
  dict the journal persists, and is called from exactly three places:
  the live ``emit_event`` path, snapshot-tail/full replay
  (``events/restore.py``), and migration-record import. Live state and
  a kill -9 replay therefore produce bit-identical ledgers by
  construction — same records, same order, same float operations.
- **O(1) per event.** A run-span opens at task-started (resource
  amounts ride the record's ``usage`` field) and closes at the next
  restart/terminal record; closing charges ``duration x amount`` per
  resource. No per-tick walks, no timers.
- **Exactly-once across moves.** A migration record carries the
  source's accrued row (``export_job``); the destination seeds it from
  the journaled ``migration-in`` record (idempotent replace), and the
  source drops its copy only at the journaled ``migration-out-done``
  tombstone — the same discipline job state itself follows.
- **Reattach-safe.** A reattaching worker re-emits task-started with
  the SAME instance and the preserved original ``started_at``; the fold
  treats that as a refresh of the open span, never a second one.

Rows outlive ``job forget`` deliberately (forget is not journaled):
usage is an audit surface, not job state.
"""

from __future__ import annotations

# event kinds the fold consumes — exported so the hot emit path can
# skip record construction for irrelevant kinds when nobody else
# consumes events (sim servers without a journal)
ACCOUNTED_KINDS = frozenset((
    "job-submitted", "job-opened",
    "task-started", "task-restarted",
    "task-finished", "task-failed", "task-canceled",
    "migration-out", "migration-in", "migration-out-done",
))

_TERMINAL_STATUS = {
    "task-finished": "finished",
    "task-failed": "failed",
    "task-canceled": "canceled",
}

VERSION = 1


def _new_row(label: str) -> dict:
    return {
        "label": label,
        # wall-clock seconds of task execution (sum over run spans;
        # gang tasks count ONE task-second per wall second — resource
        # charges below carry the gang width)
        "task_seconds": 0.0,
        # ready -> running latency, charged once per dispatched span
        "wait_seconds": 0.0,
        # resource name -> amount x seconds (cpus/gpus/... in human
        # units; a 4-cpu task running 10 s charges 40 cpu-seconds)
        "resource_seconds": {},
        # crash-charged retries: increments of the task crash counter
        # (clean-stop restarts and migrations charge nothing)
        "crash_retries": 0,
        "runs": 0,
        "finished": 0,
        "failed": 0,
        "canceled": 0,
        # provenance flags for rollup transparency across moves
        "migrated_in": False,
        "migrating": False,
    }


class AccountingLedger:
    """Incremental per-job usage ledger; per-label rollups are derived
    at query time so a migrated row never double-counts its label."""

    def __init__(self):
        self.rows: dict[int, dict] = {}
        # (job, task) -> {"started", "instance", "usage"} for spans
        # currently running (task-started seen, no close yet)
        self.open_runs: dict[tuple[int, int], dict] = {}
        # (job, task) -> last crash_count folded, for delta charging
        self.last_crash: dict[tuple[int, int], int] = {}

    # ------------------------------------------------------------ fold
    def observe(self, kind: str, record: dict) -> None:
        if kind not in ACCOUNTED_KINDS:
            return
        job_id = record.get("job")
        if kind == "job-submitted":
            desc = record.get("desc") or {}
            row = self.rows.get(job_id)
            if row is None:
                self.rows[job_id] = _new_row(
                    str(desc.get("name", "job"))
                )
            return
        if kind == "job-opened":
            if job_id not in self.rows:
                self.rows[job_id] = _new_row(
                    str(record.get("name", "job"))
                )
            return
        if kind == "task-started":
            self._on_started(job_id, record)
            return
        if kind == "task-restarted":
            key = (job_id, record.get("task"))
            self._close_run(key, float(record.get("time", 0.0)))
            crash = int(record.get("crash_count", 0))
            last = self.last_crash.get(key, 0)
            if crash > last:
                self._row(job_id)["crash_retries"] += crash - last
                self.last_crash[key] = crash
            return
        status = _TERMINAL_STATUS.get(kind)
        if status is not None:
            key = (job_id, record.get("task"))
            self._close_run(key, float(record.get("time", 0.0)))
            self._row(job_id)[status] += 1
            self.last_crash.pop(key, None)
            return
        if kind == "migration-out":
            self._row(job_id)["migrating"] = True
            return
        if kind == "migration-in":
            self._on_migration_in(record.get("record") or {})
            return
        if kind == "migration-out-done":
            # tombstone: the destination owns the accrued usage now
            self.rows.pop(job_id, None)
            for table in (self.open_runs, self.last_crash):
                for key in [k for k in table if k[0] == job_id]:
                    del table[key]
            return

    def _row(self, job_id: int) -> dict:
        row = self.rows.get(job_id)
        if row is None:
            # task events for a job whose submit predates the journal
            # (rotated away) still accrue, under a placeholder label
            row = self.rows[job_id] = _new_row("job")
        return row

    def _on_started(self, job_id: int, record: dict) -> None:
        key = (job_id, record.get("task"))
        instance = int(record.get("instance", 0))
        started = float(record.get("started_at", 0.0)) or float(
            record.get("time", 0.0)
        )
        usage = record.get("usage") or {}
        run = self.open_runs.get(key)
        if run is not None and run["instance"] == instance:
            # reattach re-emit: one unbroken span — refresh the stamps
            # (started_at is preserved by the reattach path), never a
            # second wait charge or a second span
            run["started"] = started
            run["usage"] = dict(usage)
            return
        if run is not None:
            # a restart whose task-restarted record predates this
            # journal (defensive): close the stale span at its own
            # start so nothing is charged twice
            self._close_run(key, started)
        row = self._row(job_id)
        queued = float(record.get("queued_at", 0.0))
        if queued and started > queued:
            row["wait_seconds"] += started - queued
        self.open_runs[key] = {
            "started": started,
            "instance": instance,
            "usage": dict(usage),
        }

    def _close_run(self, key: tuple, end: float) -> None:
        run = self.open_runs.pop(key, None)
        if run is None:
            return
        row = self._row(key[0])
        duration = end - run["started"]
        if duration <= 0.0:
            return
        row["task_seconds"] += duration
        row["runs"] += 1
        resource_seconds = row["resource_seconds"]
        for name, amount in run["usage"].items():
            resource_seconds[name] = (
                resource_seconds.get(name, 0.0) + duration * amount
            )

    def _on_migration_in(self, rec: dict) -> None:
        jd = rec.get("job_state") or {}
        job_id = rec.get("job", jd.get("id"))
        if job_id is None:
            return
        acct = rec.get("accounting")
        if acct and acct.get("row"):
            # idempotent REPLACE: the exported row is the accrued truth;
            # a re-driven import lands on the same state
            row = dict(_new_row("job"), **acct["row"])
            row["resource_seconds"] = dict(
                row.get("resource_seconds") or {}
            )
            self.rows[job_id] = row
            for task_id, run in acct.get("open_runs") or ():
                self.open_runs[(job_id, task_id)] = dict(run)
            for task_id, crash in acct.get("last_crash") or ():
                self.last_crash[(job_id, task_id)] = int(crash)
        elif job_id not in self.rows:
            # pre-accounting migration record: start a fresh row
            self.rows[job_id] = _new_row(str(jd.get("name", "job")))
        row = self.rows[job_id]
        row["migrated_in"] = True
        row["migrating"] = False

    # ------------------------------------------------- snapshot capture
    def capture(self) -> dict:
        """Msgpack-safe full state for the journal snapshot (tuple keys
        become lists; ordering sorted so captures are deterministic)."""
        return {
            "version": VERSION,
            "rows": [
                [job_id, self._wire_row(self.rows[job_id])]
                for job_id in sorted(self.rows)
            ],
            "open_runs": [
                [list(key), dict(self.open_runs[key])]
                for key in sorted(self.open_runs)
            ],
            "last_crash": [
                [list(key), self.last_crash[key]]
                for key in sorted(self.last_crash)
            ],
        }

    @staticmethod
    def _wire_row(row: dict) -> dict:
        out = dict(row)
        out["resource_seconds"] = dict(row["resource_seconds"])
        return out

    def seed(self, state: dict | None) -> None:
        """Install a snapshot's captured ledger (None = pre-accounting
        snapshot: start empty; the journal tail refills what it can)."""
        self.rows = {}
        self.open_runs = {}
        self.last_crash = {}
        if not state:
            return
        for job_id, row in state.get("rows") or ():
            merged = dict(_new_row("job"), **row)
            merged["resource_seconds"] = dict(
                merged.get("resource_seconds") or {}
            )
            self.rows[int(job_id)] = merged
        for key, run in state.get("open_runs") or ():
            self.open_runs[(int(key[0]), int(key[1]))] = dict(run)
        for key, crash in state.get("last_crash") or ():
            self.last_crash[(int(key[0]), int(key[1]))] = int(crash)

    # ------------------------------------------------- migration export
    def export_job(self, job_id: int) -> dict:
        """Self-contained accrual for ONE job, embedded in a migration
        record so the destination seeds exactly what the source drops."""
        row = self.rows.get(job_id)
        return {
            "row": self._wire_row(row) if row is not None else None,
            "open_runs": [
                [key[1], dict(run)]
                for key, run in sorted(self.open_runs.items())
                if key[0] == job_id
            ],
            "last_crash": [
                [key[1], crash]
                for key, crash in sorted(self.last_crash.items())
                if key[0] == job_id
            ],
        }

    # ---------------------------------------------------------- queries
    def job_report(self, job_ids=None) -> dict[int, dict]:
        """Public per-job rows (derived cpu/gpu shorthand included),
        charged-to-now for open spans via ``now`` in rollup callers —
        deliberately NOT here: reports show only CLOSED charges, so a
        report is stable under replay at any instant."""
        if job_ids is None:
            job_ids = sorted(self.rows)
        out = {}
        running = {}
        for key in self.open_runs:
            running[key[0]] = running.get(key[0], 0) + 1
        for job_id in job_ids:
            row = self.rows.get(job_id)
            if row is None:
                continue
            out[job_id] = self._public_row(row, running.get(job_id, 0))
        return out

    @staticmethod
    def _public_row(row: dict, running: int) -> dict:
        resource_seconds = {
            name: round(secs, 6)
            for name, secs in sorted(row["resource_seconds"].items())
        }
        return {
            "label": row["label"],
            "task_seconds": round(row["task_seconds"], 6),
            "wait_seconds": round(row["wait_seconds"], 6),
            "cpu_seconds": resource_seconds.get("cpus", 0.0),
            "gpu_seconds": resource_seconds.get("gpus", 0.0),
            "resource_seconds": resource_seconds,
            "crash_retries": row["crash_retries"],
            "runs": row["runs"],
            "finished": row["finished"],
            "failed": row["failed"],
            "canceled": row["canceled"],
            "running": running,
            "migrated_in": row["migrated_in"],
            "migrating": row["migrating"],
        }

    def rollup(self) -> dict:
        """Per-label aggregation + grand totals (labels derived from job
        rows at query time: a migrated job contributes to exactly one
        shard's rollup because exactly one shard holds its row)."""
        labels: dict[str, dict] = {}
        totals = _agg_new()
        running = {}
        for key in self.open_runs:
            running[key[0]] = running.get(key[0], 0) + 1
        for job_id, row in self.rows.items():
            agg = labels.get(row["label"])
            if agg is None:
                agg = labels[row["label"]] = _agg_new()
            for target in (agg, totals):
                _agg_add(target, row, running.get(job_id, 0))
        return {
            "labels": {
                name: _agg_round(labels[name])
                for name in sorted(labels)
            },
            "totals": _agg_round(totals),
        }

    def brief(self) -> dict:
        """Tiny rollup for the subscribe-plane sample block / fleet
        feed: totals only, cheap enough to ride every sample."""
        rolled = self.rollup()["totals"]
        return {
            "jobs": rolled["jobs"],
            "task_seconds": rolled["task_seconds"],
            "cpu_seconds": rolled["cpu_seconds"],
            "gpu_seconds": rolled["gpu_seconds"],
            "wait_seconds": rolled["wait_seconds"],
            "crash_retries": rolled["crash_retries"],
            "running": rolled["running"],
        }


def _agg_new() -> dict:
    return {
        "jobs": 0, "task_seconds": 0.0, "wait_seconds": 0.0,
        "cpu_seconds": 0.0, "gpu_seconds": 0.0,
        "resource_seconds": {}, "crash_retries": 0, "runs": 0,
        "finished": 0, "failed": 0, "canceled": 0, "running": 0,
    }


def _agg_add(agg: dict, row: dict, running: int) -> None:
    agg["jobs"] += 1
    agg["task_seconds"] += row["task_seconds"]
    agg["wait_seconds"] += row["wait_seconds"]
    agg["crash_retries"] += row["crash_retries"]
    agg["runs"] += row["runs"]
    agg["finished"] += row["finished"]
    agg["failed"] += row["failed"]
    agg["canceled"] += row["canceled"]
    agg["running"] += running
    resource_seconds = agg["resource_seconds"]
    for name, secs in row["resource_seconds"].items():
        resource_seconds[name] = resource_seconds.get(name, 0.0) + secs
    agg["cpu_seconds"] = resource_seconds.get("cpus", 0.0)
    agg["gpu_seconds"] = resource_seconds.get("gpus", 0.0)


def _agg_round(agg: dict) -> dict:
    out = dict(agg)
    for field in ("task_seconds", "wait_seconds", "cpu_seconds",
                  "gpu_seconds"):
        out[field] = round(out[field], 6)
    out["resource_seconds"] = {
        name: round(secs, 6)
        for name, secs in sorted(agg["resource_seconds"].items())
    }
    return out
