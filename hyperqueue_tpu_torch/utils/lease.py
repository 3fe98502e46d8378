"""Atomic shard leases for federated failover (the port's copy of the
JAX package's `utils/lease.py`).

Each server shard holds a lease file (``lease.json``) in its shard dir and
renews it on a fixed cadence. A successor (warm standby or peer shard) may
claim a shard only when the lease has gone stale — the holder stopped
renewing for longer than the timeout, i.e. the process is dead or wedged.

Every lease mutation (claim, renew, release) runs under an exclusive
``flock`` on a sibling ``lease.lock`` file, making each one an atomic
read-check-write. The kernel releases the flock when the holding process
dies (kill -9 included), so a claimer that crashes mid-claim leaves
nothing to break; a SIGSTOPped process paused *inside* a renew keeps the
lock and simply delays the claim until it resumes or dies — which is the
correct outcome, because a paused-mid-write owner resuming later must not
be able to overwrite a successor's claim unseen. When two would-be
successors race for the same dead shard, exactly one takes the lock and
rewrites the lease; the loser backs off with ``LeaseRaceLost``.

Fencing: every successful acquire bumps the lease ``epoch``. The holder
re-reads the file under the lock on every renew — finding a different
owner (or epoch) means a successor claimed the shard while this process
was presumed dead (SIGSTOP, VM pause); the holder must stop immediately
instead of keeping a second scheduler + journal appender alive. The
fencing window is bounded by the renew interval; the journal's CRC
framing + seq numbers make anything written inside that window
detectable downstream.

A clean shutdown releases (removes) the lease, so watchers never promote
a successor for a shard an operator deliberately stopped.

Caveat: flock coordination is per-filesystem — all of a shard's
would-be owners must see the same (local or properly flock-supporting
shared) filesystem, the same assumption the server dir itself makes.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import time
from pathlib import Path

from hyperqueue_tpu_torch.events.journal import fsync_dir
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.lease")

LEASE_FILE = "lease.json"
LOCK_FILE = "lease.lock"


class LeaseError(Exception):
    pass


class LeaseHeldError(LeaseError):
    """The current holder is alive (fresh lease) — not claimable."""


class LeaseRaceLost(LeaseError):
    """Another claimer holds the lease lock right now — back off."""


class ShardLease:
    """One shard's lease: acquire (with stale takeover), renew, release.

    `timeout` is the staleness bound: a lease not renewed for `timeout`
    seconds is claimable. Renew on ~timeout/3 so one delayed write never
    looks like a death.
    """

    def __init__(self, shard_dir: Path, timeout: float = 15.0):
        self.shard_dir = Path(shard_dir)
        self.timeout = float(timeout)
        self.path = self.shard_dir / LEASE_FILE
        self.lock_path = self.shard_dir / LOCK_FILE
        self.owner: str | None = None
        self.epoch = 0

    # --- reads (lock-free: watchers poll these) -------------------------
    def read(self) -> dict | None:
        """Current lease record, or None (missing/torn — a torn record is
        a crashed writer, treated like no lease)."""
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (ValueError, OSError):
            return None

    def state(self) -> str:
        """"absent" | "held" | "stale" — what a watcher sees."""
        record = self.read()
        if record is None:
            return "absent"
        age = clock.now() - float(record.get("renewed_at") or 0.0)
        return "stale" if age > self.timeout else "held"

    def age_seconds(self) -> float | None:
        record = self.read()
        if record is None:
            return None
        return max(clock.now() - float(record.get("renewed_at") or 0.0), 0.0)

    # --- writes (flock-serialized) --------------------------------------
    @contextlib.contextmanager
    def _locked(self):
        """Exclusive, non-blocking flock over every lease mutation: the
        read-check-write inside becomes atomic against other mutators.
        Released by the kernel if the holder dies — no debris to break."""
        self.shard_dir.mkdir(parents=True, exist_ok=True)
        fd = os.open(self.lock_path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                raise LeaseRaceLost(
                    f"lease lock busy at {self.lock_path}"
                ) from None
            yield
        finally:
            os.close(fd)  # closing the fd releases the flock

    def _write(self, record: dict) -> None:
        tmp = self.shard_dir / f".{LEASE_FILE}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(self.path)
        fsync_dir(self.shard_dir)

    def acquire(self, owner: str) -> dict:
        """Claim the shard for `owner`.

        Succeeds when the lease is absent (first boot) or stale (holder
        dead). Raises LeaseHeldError while the holder is alive and
        LeaseRaceLost when another mutator holds the lock — the caller
        backs off and retries (or gives up: the shard found its
        successor).
        """
        with self._locked():
            current = self.read()
            if current is not None and self.state() == "held" and (
                current.get("owner") != owner
            ):
                raise LeaseHeldError(
                    f"shard lease held by {current.get('owner')!r} "
                    f"(epoch {current.get('epoch')})"
                )
            record = {
                "owner": owner,
                "epoch": int((current or {}).get("epoch") or 0) + 1,
                "renewed_at": clock.now(),
                "pid": os.getpid(),
            }
            self._write(record)
        self.owner = owner
        self.epoch = record["epoch"]
        return record

    def renew(self) -> bool:
        """Refresh the holder's renewed_at stamp. Returns False when this
        holder has been FENCED: a successor claimed the shard (different
        owner, or a different epoch) — the caller must stop now. The
        check and the write share one flock, so a holder resuming from a
        long pause can never overwrite a successor's claim unseen."""
        if self.owner is None:
            raise LeaseError("renew() before acquire()")
        try:
            with self._locked():
                current = self.read()
                if current is not None and (
                    current.get("owner") != self.owner
                    or int(current.get("epoch") or 0) != self.epoch
                ):
                    return False
                self._write({
                    "owner": self.owner,
                    "epoch": self.epoch,
                    "renewed_at": clock.now(),
                    "pid": os.getpid(),
                })
            return True
        except LeaseRaceLost:
            # a claimer holds the lock RIGHT NOW — which only happens
            # when our lease already looks stale to it. Skip this renew;
            # the next one reads the claim's outcome and fences honestly.
            logger.warning(
                "lease lock busy during renew (a successor may be "
                "claiming); deferring to the next renewal"
            )
            return True

    def release(self) -> None:
        """Clean shutdown: retire the lease so watchers don't promote a
        successor for a deliberately-stopped shard. Only if this holder
        still owns it — a fenced instance must not delete its successor's
        lease."""
        if self.owner is None:
            return
        try:
            with self._locked():
                current = self.read()
                if current is not None and (
                    current.get("owner") == self.owner
                    and int(current.get("epoch") or 0) == self.epoch
                ):
                    try:
                        self.path.unlink()
                    except OSError:
                        pass
        except LeaseRaceLost:
            pass  # someone is claiming what they believe is stale: let them
        self.owner = None
