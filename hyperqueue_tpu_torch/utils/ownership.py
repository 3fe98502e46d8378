"""Journaled job-ownership map for elastic resharding (the port's copy of
the JAX package's `utils/ownership.py`).

The federation's original routing rule — shard k of N owns every job id
with ``(job_id - 1) % N == k`` — is static arithmetic: nothing can move.
This module adds the dynamic layer on top: an append-only, epoch-fenced
**ownership log** at the federation root (``ownership.log``) that records
job migrations and online shard additions. Routing becomes a three-level
resolution, in precedence order:

1. an explicit assignment from a committed migration record,
2. the added-shard id-block rule (shards added online allocate job ids
   from reserved high blocks, see :data:`ADDED_ID_BASE`),
3. the modulo partition frozen at ``base_shard_count`` — the shard count
   the federation booted with, which never changes even as shards are
   added (pre-existing job ids must keep routing to their journals).

Durability discipline mirrors ``utils/lease.py``: writers serialize
through a flock on ``.ownership.lock`` and fsync every append; readers
are lock-free and tolerate a torn final line (the kill -9 artifact —
an append that never completed simply never happened). Every appended
record carries a monotonically increasing ``epoch``; the epoch is the
fencing token the whole migration protocol hangs off.

Record kinds (one JSON object per line):

``migration-intent``   a migration ``mig`` of ``job`` from shard
                       ``from`` to ``to`` has been claimed. At most one
                       in-flight intent may exist per job (double claims
                       raise :class:`MigrationClaimed`). Ownership is
                       UNCHANGED — the source still owns the job.
``migration-commit``   the destination durably imported the job: this
                       line is the linearization point of the ownership
                       transfer. From here the destination owns the job
                       no matter who crashes.
``migration-done``     the source dropped its sealed copy; the migration
                       is fully retired.
``migration-abort``    the migration was abandoned before commit; the
                       source keeps the job.
``shard-add``          shard ``shard`` joined online; carries the new
                       ``shard_count`` and the shard's reserved job-id
                       block base.
``rebalance``          a coordinator rebalance verdict (moved / held /
                       why) — pure observability, no routing effect.
"""

from __future__ import annotations

import fcntl
import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

from hyperqueue_tpu_torch.utils import clock

OWNERSHIP_FILE = "ownership.log"
LOCK_FILE = ".ownership.lock"

# Shards added online allocate job ids from reserved high blocks so the
# id alone still routes (the whole point of the original partition): the
# base shards' strided counters live in low id space, added shard k
# (k >= base_shard_count) owns ids in
#   (ADDED_ID_BASE + (k - base)*SPAN, ADDED_ID_BASE + (k - base + 1)*SPAN].
# ids.make_task_id caps job ids at 2^32 - 1, so the scheme supports
# ~4030 added shards of ~1M jobs each; a base shard would need 2^26
# jobs (at its stride) to ever collide with the reserved region.
ADDED_ID_BASE = 1 << 26
ADDED_ID_SPAN = 1 << 20


class OwnershipError(RuntimeError):
    """Malformed or inconsistent ownership-log operation."""


class MigrationClaimed(OwnershipError):
    """A different in-flight migration already claims this job."""


def added_shard_block(shard_id: int, base_shard_count: int) -> tuple[int, int]:
    """Job-id block ``(lo, hi]`` reserved for an added shard."""
    idx = int(shard_id) - int(base_shard_count)
    if idx < 0:
        raise OwnershipError(
            f"shard {shard_id} is a base shard of a {base_shard_count}-way "
            "federation; it has no reserved id block"
        )
    lo = ADDED_ID_BASE + idx * ADDED_ID_SPAN
    return lo, lo + ADDED_ID_SPAN


@dataclass
class OwnershipMap:
    """A point-in-time read of the ownership log, ready to route."""

    epoch: int = 0
    base_shard_count: int = 1
    shard_count: int = 1
    # job -> shard, from committed migrations (latest commit wins)
    assignments: dict[int, int] = field(default_factory=dict)
    # mig uid -> intent record, for migrations not yet done/aborted
    intents: dict[str, dict] = field(default_factory=dict)
    # mig uid -> True once committed (subset of intents until done)
    committed: set[str] = field(default_factory=set)
    retired: set[str] = field(default_factory=set)   # done or aborted
    verdicts: list[dict] = field(default_factory=list)
    shard_adds: list[dict] = field(default_factory=list)

    def shard_for_job(self, job_id: int) -> int:
        job_id = int(job_id)
        owner = self.assignments.get(job_id)
        if owner is not None:
            return owner
        if job_id > ADDED_ID_BASE:
            shard = (
                self.base_shard_count
                + (job_id - 1 - ADDED_ID_BASE) // ADDED_ID_SPAN
            )
            if shard < self.shard_count:
                return shard
        return (job_id - 1) % max(self.base_shard_count, 1)

    def in_flight(self) -> list[dict]:
        """Live migrations with their protocol phase, newest first."""
        out = []
        for mig, rec in self.intents.items():
            phase = "finalizing" if mig in self.committed else "exporting"
            out.append({**rec, "phase": phase})
        out.sort(key=lambda r: -r.get("epoch", 0))
        return out

    def migration_of(self, mig: str) -> dict | None:
        rec = self.intents.get(mig)
        if rec is not None:
            return rec
        return None

    def owned_counts(self, jobs_by_shard: dict[int, list[int]] | None = None
                     ) -> dict[int, int]:
        """Per-shard count of explicitly reassigned jobs (the map's own
        contribution; modulo-owned jobs are counted by the shards)."""
        counts: dict[int, int] = {}
        for shard in self.assignments.values():
            counts[shard] = counts.get(shard, 0) + 1
        return counts


class OwnershipStore:
    """Reader/writer for the federation root's ownership log."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.path = self.root / OWNERSHIP_FILE
        self.lock_path = self.root / LOCK_FILE

    # --- plumbing --------------------------------------------------------
    @contextmanager
    def _locked(self):
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)

    def _records(self) -> list[dict]:
        try:
            raw = self.path.read_bytes()
        except FileNotFoundError:
            return []
        records = []
        for line in raw.split(b"\n"):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                # torn tail from a killed appender: the record never
                # happened. Anything after it is unreachable by
                # construction (appends are serialized by the flock).
                break
        return records

    def _append(self, record: dict) -> dict:
        """Append one record (caller holds the lock), fsynced."""
        record = dict(record)
        record["epoch"] = self.current_epoch() + 1
        record.setdefault("at", clock.now())
        with open(self.path, "ab") as f:
            f.write(json.dumps(record, sort_keys=True).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        return record

    def current_epoch(self) -> int:
        records = self._records()
        return records[-1]["epoch"] if records else 0

    # --- reads -----------------------------------------------------------
    def load(self) -> OwnershipMap:
        from hyperqueue_tpu_torch.utils import serverdir

        fed = serverdir.load_federation(self.root)
        base = int(fed["base_shard_count"]) if fed else 1
        count = int(fed["shard_count"]) if fed else 1
        m = OwnershipMap(base_shard_count=base, shard_count=count)
        for rec in self._records():
            m.epoch = rec["epoch"]
            kind = rec.get("kind")
            if kind == "migration-intent":
                m.intents[rec["mig"]] = rec
            elif kind == "migration-commit":
                rec_i = m.intents.get(rec["mig"])
                if rec_i is not None:
                    m.committed.add(rec["mig"])
                    m.assignments[int(rec_i["job"])] = int(rec_i["to"])
            elif kind in ("migration-done", "migration-abort"):
                m.intents.pop(rec["mig"], None)
                m.committed.discard(rec["mig"])
                m.retired.add(rec["mig"])
            elif kind == "shard-add":
                m.shard_adds.append(rec)
                m.shard_count = max(m.shard_count, int(rec["shard_count"]))
            elif kind == "rebalance":
                m.verdicts.append(rec)
        return m

    # --- migration protocol ----------------------------------------------
    def begin_migration(self, job_id: int, from_shard: int, to_shard: int,
                        mig: str) -> dict:
        """Claim a migration. Idempotent for the SAME mig uid (a crashed
        driver re-claims its own record); a different live migration of
        the same job raises :class:`MigrationClaimed`."""
        with self._locked():
            m = self.load()
            existing = m.intents.get(mig)
            if existing is not None:
                return existing
            if mig in m.retired:
                raise OwnershipError(f"migration {mig} is already retired")
            for other in m.intents.values():
                if int(other["job"]) == int(job_id):
                    raise MigrationClaimed(
                        f"job {job_id} is already migrating under "
                        f"{other['mig']} ({other['from']} -> {other['to']})"
                    )
            owner = m.shard_for_job(job_id)
            if owner != int(from_shard):
                raise OwnershipError(
                    f"job {job_id} is owned by shard {owner}, "
                    f"not {from_shard}"
                )
            return self._append({
                "kind": "migration-intent", "mig": mig,
                "job": int(job_id), "from": int(from_shard),
                "to": int(to_shard),
            })

    def commit_migration(self, mig: str) -> dict | None:
        """The ownership linearization point. Idempotent."""
        with self._locked():
            m = self.load()
            if mig in m.committed or mig in m.retired:
                return None
            if mig not in m.intents:
                raise OwnershipError(f"migration {mig} has no intent")
            return self._append({"kind": "migration-commit", "mig": mig})

    def finish_migration(self, mig: str) -> dict | None:
        with self._locked():
            m = self.load()
            if mig in m.retired:
                return None
            if mig not in m.committed:
                raise OwnershipError(
                    f"migration {mig} is not committed; abort it instead"
                )
            return self._append({"kind": "migration-done", "mig": mig})

    def abort_migration(self, mig: str, reason: str = "") -> dict | None:
        with self._locked():
            m = self.load()
            if mig in m.retired:
                return None
            if mig in m.committed:
                raise OwnershipError(
                    f"migration {mig} is committed; it can only finish"
                )
            if mig not in m.intents:
                return None
            return self._append({
                "kind": "migration-abort", "mig": mig, "reason": reason,
            })

    # --- elasticity ------------------------------------------------------
    def record_shard_add(self, shard_id: int, shard_count: int) -> dict | None:
        """Record an online shard addition. Idempotent per shard id."""
        with self._locked():
            m = self.load()
            for rec in m.shard_adds:
                if int(rec["shard"]) == int(shard_id):
                    return None
            lo, _hi = added_shard_block(shard_id, m.base_shard_count)
            return self._append({
                "kind": "shard-add", "shard": int(shard_id),
                "shard_count": int(shard_count), "id_base": lo,
            })

    def record_verdict(self, verdict: dict) -> dict:
        with self._locked():
            return self._append({"kind": "rebalance", **verdict})
