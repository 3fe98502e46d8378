"""Federated control plane: shard failover + cross-shard worker lending.

The port's copy of the JAX package's `server/federation.py`. A
federation is N server shards, each owning a
static partition of the job-id space with its own journal, snapshot
lineage, solve loop, and ports (utils/serverdir.py federation layout).
This module adds the two cross-shard actors:

``FailoverWatcher`` — runs inside a warm standby (``hq server start
--standby``) or an idle peer shard (``--failover-watch``). It polls every
shard's lease; a stale lease means the owning process died (kill -9
included). The watcher claims the shard through the atomic lease protocol
(utils/lease.py — exactly one of many racing watchers wins), then boots a
full Server over the dead shard's dir: the existing two-phase restore
(events/restore.py) replays its journal+snapshot, n_boots/server-uid
lineage bumps fence the dead incarnation, and publishing a fresh instance
dir + access record triggers the reconnect choreography — workers ``--on-server-lost reconnect`` and REATTACH their running
tasks, client SubmitStreams replay unacked chunks exactly-once, and
subscribers resume.

``FederationCoordinator`` — the thin elasticity loop: one subscribe feed
per shard (the subscribe sample stream: backlog depth, insufficient-capacity
pending reasons, per-worker idleness) drives ``plan_lending``, a pure
function mapping shard samples to (lender, worker, borrower) moves; each
move is a ``worker_lend`` RPC ordering an idle worker to re-register with
the starved shard. No task state migrates — capacity moves, tasks stay
with their journal (Gavel, arxiv 2008.09213; JASDA's scheduler-driven
atomization, arxiv 2510.14599, motivates chunks as the cross-shard unit).

Every Server this module boots (a promoted successor in a standby or a
peer shard) takes the `device` of its `server_kwargs`: a successor solves
where its predecessor did, on the card unless the caller asked for the
CPU. A promotion that fails there is logged and released, never retried
on the host.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from pathlib import Path

from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.utils.lease import (
    LeaseHeldError,
    LeaseRaceLost,
    ShardLease,
)
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.federation")

_FAILOVERS = REGISTRY.counter(
    "hq_federation_failovers_total",
    "dead shards claimed and promoted by this process's failover watcher",
)

# exported from the WATCHER/coordinator process (standby or
# --failover-watch peer), not the shard itself: the per-shard
# hq_federation_lease_age_seconds gauge vanishes exactly when the shard
# dies — this one survives the death it reports
_SHARD_UP = REGISTRY.gauge(
    "hq_federation_shard_up",
    "1 while the shard's lease is held (live owner), 0 while it is "
    "stale or absent — set by the failover watcher's lease scan",
    labels=("shard",),
)

JOURNAL_NAME = "journal.bin"


def shard_journal_path(root: Path, shard_id: int) -> Path:
    """Federated shards journal at a FIXED path inside their shard dir so
    a successor knows where to restore from without out-of-band config."""
    return serverdir.shard_path(root, shard_id) / JOURNAL_NAME


# --------------------------------------------------------------- lending
#: a sample older than this many seconds is dead data — never lend on it
SAMPLE_FRESH_SECS = 10.0
#: per-borrower cooldown: one lend, then wait for the next samples to
#: reflect it before lending again (prevents thrash on a slow feed)
LEND_COOLDOWN_SECS = 3.0

# pending reasons that mean "more workers would help" (scheduler/
# decision.py REASON_*); anything else (paused, dependencies, matching)
# is not solved by capacity
_CAPACITY_REASONS = ("insufficient-capacity", "worker-lifetime")


def _idle_workers(sample: dict) -> list[int]:
    return [
        w["id"]
        for w in sample.get("workers") or ()
        if not w.get("running") and not w.get("prefilled")
    ]


def _backlog(sample: dict) -> int:
    # ready counts only what still sits in SERVER queues — the solver
    # prefills deep per-worker batches, so a hot shard's whole backlog
    # can live in worker prefill queues while total_ready() reads 0.
    # Waiting work is waiting work wherever it queues: count both, or
    # the rebalancer sees a drowning shard as balanced.
    queued_on_workers = sum(
        int(w.get("prefilled") or 0) for w in sample.get("workers") or ()
    )
    return (int(sample.get("ready") or 0)
            + int(sample.get("mn_queued") or 0) + queued_on_workers)


def _wants_capacity(sample: dict) -> bool:
    if _backlog(sample) <= 0:
        return False
    if not sample.get("n_workers"):
        return True  # backlog and literally nobody to run it
    if _idle_workers(sample):
        return False  # transient: it has idle capacity of its own
    reasons = sample.get("pending_reasons") or {}
    return any(reasons.get(r) for r in _CAPACITY_REASONS)


def plan_lending(samples: dict[int, dict | None],
                 exclude=frozenset()) -> list[dict]:
    """Map the latest per-shard samples to worker moves.

    Pure and deterministic (unit-testable): neediest borrowers first
    (deepest backlog), one worker per borrower per round, drawn from the
    lender with the most idle workers and no backlog of its own. Shards
    without a fresh sample neither lend nor borrow. `exclude` holds
    (shard, worker_id) pairs the lender refused recently (wrong
    --on-server-lost policy, raced busy) — without it the planner would
    re-pick the same doomed worker every round and starve the borrower
    even though a lendable sibling idles right next to it.
    """
    now = clock.now()
    fresh = {
        k: s
        for k, s in samples.items()
        if s is not None and now - float(s.get("time") or 0.0) <= (
            SAMPLE_FRESH_SECS
        )
    }
    borrowers = sorted(
        (k for k, s in fresh.items() if _wants_capacity(s)),
        key=lambda k: -_backlog(fresh[k]),
    )
    idle_pool = {}
    for k, s in fresh.items():
        if _backlog(s) != 0:
            continue
        idle = [w for w in _idle_workers(s) if (k, w) not in exclude]
        if idle:
            idle_pool[k] = idle
    moves: list[dict] = []
    for borrower in borrowers:
        lenders = sorted(
            (k for k in idle_pool if k != borrower and idle_pool[k]),
            key=lambda k: -len(idle_pool[k]),
        )
        if not lenders:
            break
        lender = lenders[0]
        moves.append({
            "from": lender,
            "worker_id": idle_pool[lender].pop(),
            "to": borrower,
        })
    return moves


# ------------------------------------------------------------- migration
# Exactly-once live job migration. The driver (coordinator
# side) runs a 5-phase protocol; every phase is idempotent on both shards
# AND in the ownership log, so a crashed driver re-runs the same mig uid
# from the top and converges. The chaos site `federation.migration` fires
# BETWEEN phases with shard=-1 ("the coordinator") so a kill matrix can
# land a kill -9 at every protocol boundary.

_MIGRATIONS = REGISTRY.counter(
    "hq_federation_migrations_total",
    "live job migrations driven to completion by this process",
)
_MIGRATION_SECONDS = REGISTRY.histogram(
    "hq_federation_migration_seconds",
    "end-to-end duration of one live job migration (claim to done)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0),
)
_JOBS_MOVED = REGISTRY.counter(
    "hq_federation_jobs_moved_total",
    "jobs whose ownership transferred to another shard (rebalancer and "
    "manual `hq fleet migrate` moves both count)",
)


class MigrationError(RuntimeError):
    """A migration RPC returned an error the driver cannot retry past."""


def _shard_rpc(root: Path, shard_id: int, msg: dict,
               retry_window: float = 5.0) -> dict:
    from hyperqueue_tpu_torch.client.connection import ClientSession

    shard_dir = serverdir.shard_path(root, shard_id)
    with ClientSession(shard_dir, retry_window=retry_window) as session:
        return session.request(msg)


async def drive_migration_async(root: Path, job_id: int, to_shard: int,
                                *, mig: str | None = None, store=None,
                                rpc=None, from_shard: int | None = None,
                                ) -> dict:
    """Run the migration protocol for one job; returns the move record.

    Re-entrant: pass the same ``mig`` uid to resume a crashed driver's
    protocol. Phases (ownership.log is the source of truth throughout):

    1. ``claim``     append migration-intent (a double claim of the same
                     job by a DIFFERENT mig raises MigrationClaimed);
    2. ``export``    source seals + drains the job and hands back a
                     self-contained record (journaled `migration-out`
                     + barrier on the source first);
    3. ``import``    destination journals `migration-in` (embedding the
                     record) + barrier, then acks — or acks dup;
    4. ``commit``    append migration-commit: THE linearization point of
                     the ownership transfer;
    5. ``finalize``  source drops its sealed copy behind a journaled
                     tombstone (`migration-out-done`), then
                     migration-done retires the log entry.

    Kill -9 of source / destination / driver at ANY point leaves exactly
    one durable owner: before commit the source still owns the job (an
    un-finalized destination import is unreachable — routing still says
    source — and a re-driven import acks dup); after commit the
    destination owns it and finalize merely garbage-collects the sealed
    source copy, which answers wrong-shard from its tombstone on."""
    from hyperqueue_tpu_torch.utils import chaos
    from hyperqueue_tpu_torch.utils.ownership import OwnershipStore
    from hyperqueue_tpu_torch.utils.trace import new_trace_id

    store = store or OwnershipStore(root)
    if rpc is None:
        async def rpc(shard, msg):  # noqa: ANN001 - local default
            return _shard_rpc(root, shard, msg)
    if from_shard is None:
        from_shard = store.load().shard_for_job(job_id)
    mig = mig or f"mig-{new_trace_id()}"
    t0 = time.perf_counter()
    intent = store.begin_migration(job_id, from_shard, to_shard, mig)
    from_shard, to_shard = int(intent["from"]), int(intent["to"])
    chaos.fire("federation.migration", op="claim", shard=-1,
               ctx="coordinator")
    if mig not in store.load().committed:
        resp = await rpc(from_shard, {
            "op": "migration_export", "mig": mig, "job": int(job_id),
            "to": to_shard,
        })
        if resp.get("op") == "error":
            # the source says the job already lives elsewhere (a PRIOR
            # finalized migration) — this claim is moot; abort it
            store.abort_migration(mig, reason=resp.get("message", ""))
            raise MigrationError(
                f"export of job {job_id} failed: {resp.get('message')}"
            )
        chaos.fire("federation.migration", op="export", shard=-1,
                   ctx="coordinator")
        resp = await rpc(to_shard, {
            "op": "migration_import", "mig": mig,
            "record": resp["record"],
        })
        if resp.get("op") == "error":
            raise MigrationError(
                f"import of job {job_id} failed: {resp.get('message')}"
            )
        chaos.fire("federation.migration", op="import", shard=-1,
                   ctx="coordinator")
        store.commit_migration(mig)
    chaos.fire("federation.migration", op="commit", shard=-1,
               ctx="coordinator")
    resp = await rpc(from_shard, {
        "op": "migration_finalize", "mig": mig, "job": int(job_id),
        "to": to_shard,
    })
    if resp.get("op") == "error":
        raise MigrationError(
            f"finalize of job {job_id} failed: {resp.get('message')}"
        )
    chaos.fire("federation.migration", op="finalize", shard=-1,
               ctx="coordinator")
    store.finish_migration(mig)
    seconds = time.perf_counter() - t0
    _MIGRATIONS.inc()
    _JOBS_MOVED.inc()
    _MIGRATION_SECONDS.observe(seconds)
    logger.info(
        "migrated job %d: shard %d -> shard %d (%s, %.3fs)",
        job_id, from_shard, to_shard, mig, seconds,
    )
    return {"mig": mig, "job": int(job_id), "from": from_shard,
            "to": to_shard, "seconds": round(seconds, 4)}


def drive_migration(root: Path, job_id: int, to_shard: int, *,
                    mig: str | None = None, store=None, rpc=None,
                    from_shard: int | None = None) -> dict:
    """Synchronous twin of :func:`drive_migration_async` (CLI and
    coordinator threads; the simulator awaits the async form on its own
    loop with a memory-transport rpc)."""
    sync_rpc = rpc

    async def arpc(shard, msg):
        # ClientSession drives a PRIVATE event loop; calling it on the
        # thread already running asyncio.run's loop would nest loops
        # (RuntimeError) — hop to an executor thread for each sync RPC
        loop = asyncio.get_running_loop()
        if sync_rpc is not None:
            return await loop.run_in_executor(None, sync_rpc, shard, msg)
        return await loop.run_in_executor(
            None, _shard_rpc, root, shard, msg
        )

    return asyncio.run(drive_migration_async(
        root, job_id, to_shard, mig=mig, store=store, rpc=arpc,
        from_shard=from_shard,
    ))


def recover_migrations(root: Path, store=None, rpc=None) -> list[dict]:
    """Re-drive every in-flight migration intent in the ownership log
    (coordinator start / `hq fleet migrate --recover`): a pre-commit
    intent restarts from export (the sealed source re-exports, the
    destination dedups), a committed one skips straight to finalize."""
    from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

    store = store or OwnershipStore(root)
    out = []
    for rec in store.load().in_flight():
        try:
            out.append(drive_migration(
                root, int(rec["job"]), int(rec["to"]), mig=rec["mig"],
                store=store, rpc=rpc, from_shard=int(rec["from"]),
            ))
        except Exception as e:  # noqa: BLE001 - recover what can be
            logger.warning("re-driving migration %s failed: %s",
                           rec.get("mig"), e)
    return out


# ------------------------------------------------------------ rebalancer
#: a rebalance fires only while max(backlog) exceeds mean(backlog) by
#: this ratio — the hysteresis band that keeps near-balanced fleets still
REBALANCE_RATIO = 1.5
#: and only this often per donor shard (migrations are heavier than
#: lends; give the moved job's backlog time to show up in the samples)
REBALANCE_COOLDOWN_SECS = 10.0


def plan_rebalance(samples: dict[int, dict | None],
                   min_ratio: float = REBALANCE_RATIO) -> dict | None:
    """Pick one hot->cold whole-job move from per-shard backlog samples,
    or None while the fleet is balanced. Pure and deterministic.

    Hysteresis: no move unless the hottest shard's backlog exceeds the
    fleet mean by ``min_ratio`` AND beats the coldest by more than one
    job's worth of slack (moving a job between near-equal shards would
    just oscillate). The coldest shard receives — idle added shards have
    backlog 0 and become immediate receivers, which is exactly how
    `--shards N -> N+1` drains the hot shard onto the new one."""
    now = clock.now()
    fresh = {
        k: s for k, s in samples.items()
        if s is not None
        and now - float(s.get("time") or 0.0) <= SAMPLE_FRESH_SECS
    }
    if len(fresh) < 2:
        return None
    backlogs = {k: _backlog(s) for k, s in fresh.items()}
    mean = sum(backlogs.values()) / len(backlogs)
    if mean <= 0:
        return None
    hot = max(sorted(backlogs), key=lambda k: backlogs[k])
    cold = min(sorted(backlogs), key=lambda k: backlogs[k])
    if hot == cold or backlogs[hot] < min_ratio * mean:
        return None
    if backlogs[hot] - backlogs[cold] < 2:
        return None
    return {
        "from": hot, "to": cold,
        "ratio": round(backlogs[hot] / mean, 3),
        "backlogs": dict(sorted(backlogs.items())),
    }


class FederationCoordinator:
    """Thread-based lending loop: one subscribe feed per shard feeding
    ``plan_lending``; each move becomes a ``worker_lend`` RPC against the
    lender. Shard death is routine here — a dead feed clears its sample
    and keeps retrying until the shard's successor comes up.

    With ``rebalance=True`` a second control thread turns the same
    samples into WHOLE-JOB moves: largest-pending job first,
    hottest shard to coldest, each move one exactly-once
    :func:`drive_migration` run, each verdict appended to the ownership
    log for `hq fleet` to show."""

    def __init__(self, root: Path, sample_interval: float = 1.0,
                 cooldown: float = LEND_COOLDOWN_SECS,
                 rebalance: bool = False,
                 rebalance_ratio: float = REBALANCE_RATIO,
                 rebalance_cooldown: float = REBALANCE_COOLDOWN_SECS):
        self.root = Path(root)
        self.sample_interval = sample_interval
        self.cooldown = cooldown
        self.rebalance = rebalance
        self.rebalance_ratio = rebalance_ratio
        self.rebalance_cooldown = rebalance_cooldown
        self.migrations_done = 0
        self.last_verdict: dict | None = None
        self._last_rebalance: dict[int, float] = {}
        self.samples: dict[int, dict | None] = {}
        self.moves_issued = 0
        self._last_lend: dict[int, float] = {}
        # (shard, worker_id) the lender refused, with expiry stamps: a
        # 'policy' worker stays unlendable, but worker ids churn and a
        # 'busy' race clears, so entries age out instead of pinning
        self._refused: dict[tuple[int, int], float] = {}
        self.refusal_ttl = 60.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # --- feeds ----------------------------------------------------------
    def _feed(self, shard_id: int) -> None:
        from hyperqueue_tpu_torch.client import connection

        shard_dir = serverdir.shard_path(self.root, shard_id)
        while not self._stop.is_set():
            try:
                for frame in connection.subscribe(
                    shard_dir, filters=("__samples_only__",),
                    sample_interval=self.sample_interval,
                ):
                    if self._stop.is_set():
                        return
                    if frame.get("op") == "sample":
                        self.samples[shard_id] = frame
            except Exception as e:  # noqa: BLE001 - shard down is routine
                logger.debug("shard %d feed down (%s)", shard_id, e)
            # the feed ended (shard died or dropped us): its last sample
            # is no longer trustworthy
            self.samples[shard_id] = None
            self._stop.wait(min(self.sample_interval, 1.0))

    def _control(self) -> None:
        while not self._stop.wait(self.sample_interval):
            try:
                now = clock.monotonic()
                self._refused = {
                    key: t for key, t in self._refused.items()
                    if now - t < self.refusal_ttl
                }
                moves = plan_lending(
                    dict(self.samples), exclude=set(self._refused)
                )
                for move in moves:
                    if now - self._last_lend.get(move["to"], 0.0) < (
                        self.cooldown
                    ):
                        continue
                    if self._issue(move):
                        self._last_lend[move["to"]] = now
                        self.moves_issued += 1
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("lending pass failed")

    # --- rebalancing ---------------------------------------------------
    def _rebalance_control(self) -> None:
        import os

        from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

        store = OwnershipStore(self.root)
        try:
            # a coordinator that died mid-protocol left intents behind:
            # converge them before planning anything new
            recover_migrations(self.root, store=store)
        except Exception:  # noqa: BLE001 - recovery must not kill the loop
            logger.exception("migration recovery failed")
        # HQ_REBALANCE_INTERVAL decouples the rebalancer's tick from the
        # sampling interval: a test drives it fast and deterministically
        # instead of sleeping for the sampler's cadence
        try:
            interval = float(
                os.environ.get("HQ_REBALANCE_INTERVAL", "") or
                self.sample_interval
            )
        except ValueError:
            interval = self.sample_interval
        while not self._stop.wait(interval):
            try:
                self._rebalance_pass(store)
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("rebalance pass failed")

    def _rebalance_pass(self, store) -> None:
        plan = plan_rebalance(
            dict(self.samples), min_ratio=self.rebalance_ratio
        )
        if plan is None:
            return
        now = clock.monotonic()
        if now - self._last_rebalance.get(plan["from"], 0.0) < (
            self.rebalance_cooldown
        ):
            return
        backlogs = plan["backlogs"]
        job_id = self._pick_job(
            plan["from"], cap=backlogs[plan["from"]] - backlogs[plan["to"]]
        )
        if job_id is None:
            self.last_verdict = store.record_verdict({
                "moved": None, "from": plan["from"], "to": plan["to"],
                "reason": f"imbalance {plan['ratio']}x but no movable job",
            })
            self._last_rebalance[plan["from"]] = now
            return
        try:
            move = drive_migration(
                self.root, job_id, plan["to"], store=store,
                from_shard=plan["from"],
            )
        except Exception as e:  # noqa: BLE001 - verdict either way
            logger.warning("rebalance migration of job %d failed: %s",
                           job_id, e)
            self.last_verdict = store.record_verdict({
                "moved": None, "from": plan["from"], "to": plan["to"],
                "job": job_id, "reason": f"migration failed: {e}",
            })
        else:
            self.migrations_done += 1
            self.last_verdict = store.record_verdict({
                "moved": job_id, "from": plan["from"], "to": plan["to"],
                "mig": move["mig"], "seconds": move["seconds"],
                "reason": f"backlog imbalance {plan['ratio']}x "
                          f"{plan['backlogs']}",
            })
        self._last_rebalance[plan["from"]] = now

    def _pick_job(self, shard_id: int,
                  cap: float = float("inf")) -> int | None:
        """Largest-pending-first: the job whose move shifts the most
        backlog in one migration. Open jobs are skipped (a mid-stream
        SubmitStream CAN follow a move, but the planner prefers moves
        that cannot even need a redirect); so are terminated ones.

        ``cap`` is the hot-cold backlog gap: moving a job with pending
        >= the gap would leave the RECEIVER at least as hot as the donor
        was — the next pass would just move it back. Requiring a strict
        peak improvement is what makes the rebalancer convergent instead
        of ping-ponging one indivisible job between two shards."""
        try:
            resp = _shard_rpc(self.root, shard_id, {"op": "job_list"})
        except Exception as e:  # noqa: BLE001 - shard may just have died
            logger.debug("job_list on shard %d failed: %s", shard_id, e)
            return None
        best, best_pending = None, 0
        for info in resp.get("jobs", ()):
            c = info.get("counters") or {}
            pending = int(info.get("n_tasks", 0)) - (
                int(c.get("finished", 0)) + int(c.get("failed", 0))
                + int(c.get("canceled", 0))
            )
            if info.get("is_open"):
                continue
            if best_pending < pending < cap:
                best, best_pending = int(info["id"]), pending
        return best

    def _issue(self, move: dict) -> bool:
        from hyperqueue_tpu_torch.client.connection import ClientSession

        lender_dir = serverdir.shard_path(self.root, move["from"])
        try:
            with ClientSession(lender_dir, retry_window=2.0) as session:
                resp = session.request({
                    "op": "worker_lend",
                    "worker_id": move["worker_id"],
                    "to_shard": move["to"],
                })
            lent = bool(resp.get("lent"))
            if lent:
                logger.info(
                    "lent worker %d: shard %d -> shard %d",
                    move["worker_id"], move["from"], move["to"],
                )
            else:
                # a refused worker (policy/busy) must not be re-picked
                # every pass while lendable siblings idle beside it
                self._refused[(move["from"], move["worker_id"])] = (
                    clock.monotonic()
                )
                logger.info(
                    "shard %d refused to lend worker %d (%s)",
                    move["from"], move["worker_id"],
                    resp.get("reason", "?"),
                )
            return lent
        except Exception as e:  # noqa: BLE001 - lender may just have died
            logger.debug("worker_lend to shard %d failed: %s",
                         move["from"], e)
            return False

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        fed = serverdir.load_federation(self.root)
        if fed is None:
            raise ValueError(f"no federation at {self.root}")
        for k in range(fed["shard_count"]):
            t = threading.Thread(
                target=self._feed, args=(k,), daemon=True,
                name=f"hq-fed-feed-{k}",
            )
            t.start()
            self._threads.append(t)
        ctl = threading.Thread(
            target=self._control, daemon=True, name="hq-fed-coordinator"
        )
        ctl.start()
        self._threads.append(ctl)
        if self.rebalance:
            reb = threading.Thread(
                target=self._rebalance_control, daemon=True,
                name="hq-fed-rebalancer",
            )
            reb.start()
            self._threads.append(reb)

    def stop(self) -> None:
        self._stop.set()


# -------------------------------------------------------------- failover
class FailoverWatcher:
    """Scan shard leases; claim and promote stale ones.

    ``server_kwargs`` seeds each promoted Server (scheduler kind, fsync
    policy, ...); server_dir/shard identity/journal/lease settings are
    filled in per shard. ``own_shard`` (peer-shard mode) is never
    scanned, and ``eligible`` — when given — gates claiming (an idle-peer
    policy hook: a shard drowning in its own backlog should leave the
    claim to the standby).
    """

    def __init__(
        self,
        root: Path,
        server_kwargs: dict | None = None,
        lease_timeout: float = 15.0,
        poll: float | None = None,
        own_shard: int = -1,
        eligible=None,
    ):
        self.root = Path(root)
        self.server_kwargs = dict(server_kwargs or {})
        self.lease_timeout = float(lease_timeout)
        self.poll = poll if poll is not None else max(lease_timeout / 3, 0.1)
        self.own_shard = own_shard
        self.eligible = eligible
        self.promoted: dict[int, object] = {}
        self._promoted_tasks: dict[int, asyncio.Task] = {}
        # /readyz input: monotonic stamp of the last scan that
        # COMPLETED (a scan that raised does not count as a heartbeat) —
        # distinguishes a standby whose lease-scan loop died or wedged
        # from a healthy idle one
        self.last_scan: float = 0.0
        # optional SLO engine (utils/slo.py): the standby is where
        # hq_federation_shard_up lives, so shard-availability burn rates
        # are evaluated here, piggybacked on the scan cadence
        self.slo = None

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.poll)
            try:
                await self.scan_once()
                self.last_scan = clock.monotonic()
            except Exception:  # noqa: BLE001 - watcher must outlive scans
                logger.exception("failover scan failed")
            if self.slo is not None:
                try:
                    for transition in self.slo.evaluate():
                        logger.warning(
                            "slo %s [%s]: %s (burn %.2f over %s)",
                            transition["slo"], transition["severity"],
                            transition["state"], transition["burn_rate"],
                            transition["window"][0],
                        )
                except Exception:  # noqa: BLE001 - alerting is advisory
                    logger.exception("slo evaluation failed")

    async def scan_once(self) -> None:
        fed = serverdir.load_federation(self.root)
        if fed is None:
            return
        # a promoted server that has since stopped (operator `server
        # stop`, a fence, a crash of its own) no longer covers its shard:
        # prune it so a LATER death of that shard is claimable again
        for shard_id, task in list(self._promoted_tasks.items()):
            if task.done():
                self.promoted.pop(shard_id, None)
                del self._promoted_tasks[shard_id]
        for shard_id in range(fed["shard_count"]):
            shard_dir = serverdir.shard_path(self.root, shard_id)
            lease = ShardLease(shard_dir, self.lease_timeout)
            state = lease.state()
            # liveness gauge for EVERY shard (own shard included): the
            # scan is the one place that reads all leases anyway, and a
            # scraper needs the dead shard's 0 from a surviving process
            _SHARD_UP.labels(shard_id).set(1.0 if state == "held" else 0.0)
            if shard_id == self.own_shard or shard_id in self.promoted:
                continue
            if state != "stale":
                # "absent" = never started or cleanly stopped: an operator
                # decision, not a death — nothing to fail over
                continue
            if self.eligible is not None and not self.eligible():
                logger.info(
                    "shard %d lease is stale but this peer is busy; "
                    "leaving the claim to another successor", shard_id,
                )
                continue
            await self.promote(shard_id, fed["shard_count"])

    async def promote(self, shard_id: int, shard_count: int) -> None:
        """Claim + boot a Server over the dead shard's dir. The Server's
        own start() performs the atomic lease acquisition (so a lost race
        aborts before any journal access) and the two-phase restore."""
        from hyperqueue_tpu_torch.server.bootstrap import Server

        shard_dir = serverdir.shard_path(self.root, shard_id)
        kwargs = dict(self.server_kwargs)
        kwargs.update(
            server_dir=shard_dir,
            shard_id=shard_id,
            shard_count=shard_count,
            federation_root=self.root,
            lease_timeout=self.lease_timeout,
            journal_path=shard_journal_path(self.root, shard_id),
            promoted=True,
        )
        server = Server(**kwargs)
        t0 = time.perf_counter()
        try:
            await server.start()
        except (LeaseHeldError, LeaseRaceLost) as e:
            logger.info(
                "shard %d claim lost to a racing successor (%s); backing "
                "off", shard_id, e,
            )
            return
        except Exception:
            # claimed but could not finish promotion: tear down whatever
            # start() already brought up (the lease RENEW loop included —
            # a leaked renewer would keep the claim alive forever) and
            # release, so the next scan can try again instead of waiting
            # a full staleness window
            logger.exception("shard %d promotion failed", shard_id)
            try:
                await server.shutdown()
            except Exception:  # noqa: BLE001 - release is what matters
                logger.exception("shard %d promotion cleanup failed",
                                 shard_id)
                if server.lease is not None:
                    server.lease.release()
            return
        _FAILOVERS.inc()
        self.promoted[shard_id] = server
        self._promoted_tasks[shard_id] = asyncio.create_task(
            server.run_until_stopped()
        )
        logger.warning(
            "promoted to shard %d/%d in %.2fs (restore: %s)",
            shard_id, shard_count, time.perf_counter() - t0,
            server.last_restore,
        )

    async def shutdown(self) -> None:
        for server in self.promoted.values():
            server.stop()
        for task in self._promoted_tasks.values():
            try:
                await asyncio.wait_for(task, timeout=5.0)
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                task.cancel()


async def standby_main(
    root: Path,
    server_kwargs: dict | None = None,
    lease_timeout: float = 15.0,
    poll: float | None = None,
    coordinate: bool = True,
    sample_interval: float = 1.0,
    metrics_port: int | None = None,
    metrics_host: str = "0.0.0.0",
    rebalance: bool = False,
) -> None:
    """`hq server start --standby`: a warm successor process.

    Waits for the federation descriptor, then watches every shard's
    lease and promotes into dead shards; optionally also runs the
    lending coordinator (the federation needs exactly one — run it on
    the standby, the one process with no shard of its own to favor).
    The process stays warm: the server modules, the solver stack and
    torch are already imported, so a promotion pays restore + bind time
    only.
    """
    while serverdir.load_federation(root) is None:
        await asyncio.sleep(0.25)
    # warm the heavy imports up front, not at promotion time
    from hyperqueue_tpu_torch.server import bootstrap  # noqa: F401

    fed = serverdir.load_federation(root)
    coordinator = None
    if coordinate:
        coordinator = FederationCoordinator(
            root, sample_interval=sample_interval, rebalance=rebalance
        )
        coordinator.start()
    watcher = FailoverWatcher(
        root,
        server_kwargs=server_kwargs,
        lease_timeout=lease_timeout,
        poll=poll,
    )
    # the standby's registry is where hq_federation_shard_up lives, so
    # the shard-availability SLO is evaluated here (riding the scan
    # loop); transitions land in hq_slo_* gauges on this endpoint
    from hyperqueue_tpu_torch.utils.slo import SloEngine

    watcher.slo = SloEngine()
    metrics_server = None
    if metrics_port is not None:
        # the standby is the process that SURVIVES shard deaths, so its
        # endpoint is where hq_federation_shard_up / failovers_total stay
        # scrapeable through a failover
        from hyperqueue_tpu_torch.utils.metrics import start_metrics_server

        def _probe_healthz():
            return True, {"role": "standby"}

        def _probe_readyz():
            # ready = the lease-scan loop is actually turning over: the
            # last COMPLETED scan is recent. A standby whose watcher task
            # died or wedged keeps serving /metrics (the endpoint is a
            # separate task) but must fail readiness — it can no longer
            # promote into a dead shard.
            stale_after = max(3.0 * watcher.poll, 1.0)
            if watcher.last_scan <= 0.0:
                return False, {"role": "standby",
                               "checks": {"scan": "never ran"}}
            age = clock.monotonic() - watcher.last_scan
            ok = age < stale_after
            detail = "ok" if ok else f"stale ({age:.1f}s)"
            return ok, {"role": "standby", "checks": {"scan": detail},
                        "promoted_shards": sorted(watcher.promoted)}

        metrics_server, bound = await start_metrics_server(
            REGISTRY, metrics_port, host=metrics_host,
            probes={"/healthz": _probe_healthz, "/readyz": _probe_readyz},
        )
        print(
            f"| standby metrics on http://{metrics_host}:{bound}/metrics"
            " (+ /healthz /readyz)",
            flush=True,
        )
    logger.warning(
        "standby ready: watching %d shard(s) at %s (lease timeout %.1fs)",
        fed["shard_count"], root, lease_timeout,
    )
    try:
        await watcher.run()
    finally:
        if coordinator is not None:
            coordinator.stop()
        if metrics_server is not None:
            metrics_server.close()
        await watcher.shutdown()
