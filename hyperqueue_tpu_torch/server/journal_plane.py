"""Journal plane: group commit + fsync on a dedicated thread.

Without this plane, `Server.emit_event` performs the journal append
(msgpack encode + CRC framing + write + flush, + fsync under
`--journal-fsync always`) inline on the reactor loop — the `journal` lag
plane of the stall detector. This module turns `emit_event` into an
enqueue:

- the **reactor** appends records to a pending deque (one lock-guarded
  list op) and registers *visibility callbacks* — client acks, event
  deliveries to listeners/subscribers — against the current enqueue
  ticket;
- the **commit thread** drains whole batches, performs ONE buffered
  write (+ flush/fsync per the configured policy) per batch, then posts
  the new durability watermark back to the reactor loop, which releases
  every callback at or below it.

Durability-before-visibility is therefore preserved *by construction*:
nothing externally observable (an ack frame, a completion surfaced to a
subscriber, a job_wait response) runs before the records that justify it
are as durable as the fsync policy promises — exactly the contract the
old synchronous group-commit block enforced, now without holding the
event loop for the disk.

Group commit gets BETTER under load, not worse: the deeper the backlog
the more records amortize one write+fsync, which is the arxiv 2002.07062
batch-architecture argument applied to the durability plane.

`--journal-plane reactor` keeps the old inline behavior (escape hatch,
mirroring `--client-plane reactor`).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

import numpy as np

from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.journal")

_COMMITS_TOTAL = REGISTRY.counter(
    "hq_journal_plane_commits_total",
    "group commits performed by the journal commit thread",
)
_BATCH_RECORDS = REGISTRY.histogram(
    "hq_journal_plane_batch_records",
    "records folded into one journal-plane group commit",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384),
)
_COMMIT_SECONDS = REGISTRY.histogram(
    "hq_journal_plane_commit_seconds",
    "journal-plane group commit latency (write + flush + fsync)",
)
_STALLS_TOTAL = REGISTRY.counter(
    "hq_journal_plane_stalls_total",
    "reactor enqueues that blocked on the journal plane's pending bound "
    "(the disk cannot keep up with the event rate)",
)


class JournalPlane:
    """The commit thread + watermark bookkeeping around one Journal.

    Thread ownership: between start() and stop()/suspend(), the commit
    thread is the ONLY writer of the underlying Journal. The reactor
    interacts through append/when_durable (non-blocking) and
    barrier/suspend (deliberately blocking, for chaos injection points,
    compaction swaps and shutdown).
    """

    def __init__(
        self,
        journal,
        *,
        fsync_always: bool,
        flush_each: bool,
        loop,
        lag=None,
        on_fatal=None,
        max_pending: int = 65536,
    ):
        self.journal = journal
        self.fsync_always = fsync_always
        # flush-to-OS per commit (the default per-event policy, batched);
        # False = a periodic loop calls request_flush instead
        self.flush_each = flush_each
        self.loop = loop
        self.lag = lag
        self.on_fatal = on_fatal
        self.max_pending = max(int(max_pending), 1)
        self._cv = threading.Condition()
        self._pending: deque = deque()  # (enqueue_monotonic, record)
        self._enqueued = 0   # tickets handed out
        self._durable = 0    # tickets committed per the fsync policy
        self._synced = 0     # tickets covered by an actual fsync
        self._sync_target = 0
        self._flush_req = False
        self._flush_req_sync = False
        self._suspended = False
        self._parked = threading.Event()
        self._stop = False
        self._dead = False
        self._callbacks: deque = deque()  # (ticket, cb), ticket-ordered
        self._thread: threading.Thread | None = None
        self.commits = 0
        self.records = 0
        self.max_batch = 0
        # seconds of each recent group commit (write + flush + fsync), for
        # commit_ms(); the histogram below keeps only its buckets
        self.commit_seconds: deque = deque(maxlen=65536)
        # test hook (tests/test_server_planes.py): stretch the
        # enqueue->commit window so the durability-before-visibility
        # property is observable — an ack must NOT beat the commit
        self._test_delay = float(
            os.environ.get("HQ_JOURNAL_PLANE_TEST_DELAY", "0") or 0
        )

    # --- reactor side ---------------------------------------------------
    def append(self, record: dict) -> int:
        """Enqueue one journal record; returns its ticket."""
        with self._cv:
            if len(self._pending) >= self.max_pending and not self._dead:
                # the disk is behind the event rate: park the reactor on
                # the commit (bounded memory beats an unbounded deque; the
                # stall is visible in the counter and the lag plane)
                _STALLS_TOTAL.inc()
                target = self._enqueued
                self._cv.notify_all()
                self._cv.wait_for(
                    lambda: self._durable >= target or self._dead
                )
            self._enqueued += 1
            self._pending.append((clock.monotonic(), record))
            self._cv.notify_all()
            return self._enqueued

    def when_durable(self, cb) -> None:
        """Run `cb` (on the reactor loop) once everything enqueued so far
        is committed. Runs inline when the plane is already caught up —
        callbacks always fire in enqueue order."""
        with self._cv:
            ticket = self._enqueued
            if self._durable >= ticket and not self._callbacks:
                run_now = True
            else:
                self._callbacks.append((ticket, cb))
                run_now = False
        if run_now:
            cb()

    def barrier(self, sync: bool = False) -> None:
        """Block the calling thread until everything enqueued so far is
        committed (and fsynced, with sync=True). Used by the chaos
        injection point, compaction's capture barrier, explicit flush
        RPCs and shutdown — the deliberate stop-the-world moments.

        sync=False only guarantees the records reached the appender
        (commit_batch); under --journal-flush-period the file-object
        buffer may still hold them. A caller about to RE-READ the file
        (history replay, journal info) must pass sync=True."""
        with self._cv:
            target = self._enqueued
            if sync:
                self._sync_target = max(self._sync_target, target)
            self._cv.notify_all()
            self._cv.wait_for(
                lambda: self._dead
                or (
                    self._durable >= target
                    and (not sync or self._synced >= target)
                )
            )
            if self._dead:
                raise RuntimeError("journal plane failed; see server log")

    def request_flush(self, sync: bool = False) -> None:
        """Non-blocking flush request (the periodic flush loop's lever)."""
        with self._cv:
            self._flush_req = True
            self._flush_req_sync = self._flush_req_sync or sync
            self._cv.notify_all()

    def suspend(self) -> None:
        """Drain + park the commit thread so the caller may close/replace
        the journal appender (compaction swap, prune). The caller MUST
        not await between suspend() and resume() — appends would pile up
        against a parked thread. Raises if the plane died (a dead thread
        can never park; blocking the reactor on it would wedge the
        server past even its own stop())."""
        with self._cv:
            if self._dead:
                raise RuntimeError("journal plane failed; see server log")
            self._suspended = True
            self._parked.clear()
            self._cv.notify_all()
        self._parked.wait()
        if self._dead:
            raise RuntimeError("journal plane failed; see server log")

    def resume(self) -> None:
        with self._cv:
            self._suspended = False
            self._cv.notify_all()

    def depth(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        return {
            "mode": "thread",
            "depth": len(self._pending),
            "enqueued": self._enqueued,
            "durable": self._durable,
            "commits": self.commits,
            "max_batch": self.max_batch,
            "mean_batch": round(self.records / self.commits, 2)
            if self.commits else 0.0,
        }

    def commit_ms(self) -> dict:
        """Commit latency of the recent group commits in ms: count, p50,
        p99 and max (None while nothing was committed)."""
        with self._cv:
            secs = np.array(self.commit_seconds, dtype=np.float64)
        if not secs.size:
            return {"count": 0, "p50": None, "p99": None, "max": None}
        return {
            "count": int(secs.size),
            "p50": float(np.percentile(secs, 50) * 1e3),
            "p99": float(np.percentile(secs, 99) * 1e3),
            "max": float(secs.max() * 1e3),
        }

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="hq-journal", daemon=True
        )
        self._thread.start()

    def stop(self) -> bool:
        """Drain everything, then join the thread. The journal stays
        open — the owner closes it. Returns False when the thread did
        not finish within the deadline: the owner must then NOT close
        the journal (closing the appender under a still-writing thread
        would turn a clean stop into silent crash-consistency)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is None:
            return True
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            logger.critical(
                "journal plane did not drain within 30s at shutdown "
                "(%d records pending); leaving the appender open",
                len(self._pending),
            )
            return False
        return True

    # --- commit thread --------------------------------------------------
    def _run(self) -> None:
        from hyperqueue_tpu_torch.utils import profiler

        # plane label for the sampling profiler: commit-thread CPU shows
        # up as the `journal` plane next to its lag histogram.
        # Unregistered on EVERY exit path (clean drain and crash alike) so
        # a recycled thread ident can never wear a stale label.
        profiler.register_plane("journal")
        try:
            self._run_inner()
        finally:
            profiler.unregister_plane()

    def _run_inner(self) -> None:
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(
                        lambda: self._pending
                        or self._stop
                        or self._suspended
                        or self._flush_req
                        or self._sync_target > self._synced
                    )
                    if self._suspended:
                        # only park fully drained: the swap must see
                        # every acknowledged-enqueued record on disk.
                        # _parked is re-set on EVERY wakeup while
                        # suspended: a second suspend() arriving before
                        # this thread observed the first resume() clears
                        # _parked and must still see it set again, or
                        # the reactor would wait forever.
                        if not self._pending:
                            while self._suspended:
                                self._parked.set()
                                self._cv.wait()
                            continue
                    if self._stop and not self._pending:
                        return
                    batch = list(self._pending)
                    self._pending.clear()
                    sync_goal = self._sync_target
                    flush_req = self._flush_req
                    flush_sync = self._flush_req_sync
                    self._flush_req = False
                    self._flush_req_sync = False
                t0 = time.perf_counter()
                if batch and self._test_delay:
                    time.sleep(self._test_delay)
                if batch:
                    self.journal.begin_batch()
                    for _ts, record in batch:
                        self.journal.write(record)
                    self.journal.commit_batch()
                new_durable = self._durable + len(batch)
                want_sync = (
                    (self.fsync_always and batch)
                    or sync_goal > self._synced
                    or flush_sync
                )
                if want_sync or (batch and self.flush_each) or flush_req:
                    self.journal.flush(sync=want_sync)
                now = clock.monotonic()
                with self._cv:
                    self._durable = new_durable
                    if want_sync:
                        self._synced = new_durable
                    self._cv.notify_all()
                if batch:
                    self.commits += 1
                    self.records += len(batch)
                    self.max_batch = max(self.max_batch, len(batch))
                    _COMMITS_TOTAL.inc()
                    _BATCH_RECORDS.observe(len(batch))
                    commit_s = time.perf_counter() - t0
                    _COMMIT_SECONDS.observe(commit_s)
                    with self._cv:
                        self.commit_seconds.append(commit_s)
                    try:
                        # the lag observation rides the release callback
                        # so every LagTracker write stays loop-affine
                        # (a stats snapshot or /metrics render iterating
                        # the dicts must never race an insert)
                        self.loop.call_soon_threadsafe(
                            self._release, new_durable,
                            now - batch[0][0],
                        )
                    except RuntimeError:
                        return  # loop gone (shutdown)
        except Exception:  # noqa: BLE001 - a dead journal is fatal
            logger.critical("journal plane crashed", exc_info=True)
            with self._cv:
                self._dead = True
                self._cv.notify_all()
            self._parked.set()  # a waiting suspend() must not hang forever
            if self.on_fatal is not None:
                try:
                    self.loop.call_soon_threadsafe(self.on_fatal)
                except RuntimeError:
                    pass

    # --- reactor loop side ----------------------------------------------
    def _release(self, durable: int, lag_s: float | None = None) -> None:
        if lag_s is not None and self.lag is not None:
            # the re-pointed `journal` lag plane: handoff latency
            # (enqueue -> durable) of the oldest record in the batch,
            # not loop hold time
            self.lag.observe("journal", lag_s)
        cbs = self._callbacks
        while cbs and cbs[0][0] <= durable:
            _ticket, cb = cbs.popleft()
            try:
                cb()
            except Exception:  # noqa: BLE001 - one bad callback must not
                # wedge every later ack behind it
                logger.exception("durability callback failed")
