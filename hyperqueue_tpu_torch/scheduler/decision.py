"""Scheduling-decision vocabulary: reason codes and the per-tick unplaced
entries.

A task left pending must name WHICH constraint held it back, not just "not
scheduled" (Gavel, arXiv:2008.09213 §5). This module is the single registry
of reason codes: every code the scheduler can emit is a ``REASON_*``
constant here.

Classification runs once per tick over the LEFTOVER batches only (classes
the solve did not drain), never per task: tasks of one request class share
one reason, so the cost is O(leftover classes x workers).

The registry holds every code of the JAX package, and the port emits each
of them: the reactor (server/reactor.schedule) assembles these entries,
with one ``queue-paused`` entry per paused job, into the per-tick
DecisionRecord it pushes into the flight recorder (utils/flight.py).
"""

from __future__ import annotations

from hyperqueue_tpu_torch.resources.request import AllocationPolicy
from hyperqueue_tpu_torch.scheduler.queues import (
    decode_sched_blevel,
    decode_sched_job,
)

# --- reason codes (the registry) -------------------------------------------
# No connected worker could EVER run the task (resource totals too small,
# or the resource name is not provided anywhere).
REASON_NO_MATCHING_WORKER = "no-matching-worker"
# Capable workers exist, but everything they have is currently occupied.
REASON_INSUFFICIENT_CAPACITY = "insufficient-capacity"
# A multi-node gang is waiting for enough idle same-group workers.
REASON_GANG_INCOMPLETE = "gang-incomplete"
# The task's job is paused (reactor.pause_jobs); it is held out of the
# queues.
REASON_QUEUE_PAUSED = "queue-paused"
# Capacity was free this tick but the solver deliberately left the class
# unplaced (priority interleaving, cut cap, gang reservation drain).
REASON_SOLVER_DEFERRED = "solver-deferred"
# Same as solver-deferred, but the tick ran on the watchdog's host-greedy
# fallback after the primary solver failed or timed out.
REASON_WATCHDOG_FALLBACK = "watchdog-fallback"
# Capable workers exist but none has enough remaining lifetime for the
# request's min_time (--time-request vs worker --time-limit).
REASON_WORKER_LIFETIME = "worker-lifetime"
# The task still waits on unfinished dependencies (not in any queue yet).
REASON_WAITING_DEPS = "waiting-dependencies"
# Marker entry: a pathological tick had more unplaced classes than a
# DecisionRecord keeps (MAX_UNPLACED_ENTRIES); the count is the folded tail.
REASON_TRUNCATED = "truncated"
# A multi-node gang had enough capable workers overall, but the fused solve
# found no single group with enough members free this tick (or in-solve
# holdback kept members idle for it) — the gang retries next tick.
REASON_GANG_GROUP_DEFERRED = "gang-group-deferred"
# The solve placed deeper critical-path work of the SAME job first (b-level
# lookahead); this class was deliberately held behind it this tick.
REASON_LOOKAHEAD_HELD = "lookahead-held"
# A fairness-boosted job (scheduler/policy.py dominant-resource deficit)
# jumped ahead of this class's original priority this tick; the class waits
# while the under-served job catches up to its fair share.
REASON_FAIRNESS_DEFERRED = "fairness-deferred"

ALL_REASONS = frozenset(
    value
    for name, value in globals().items()
    if name.startswith("REASON_")
)


def format_reason_counts(reasons: dict) -> str:
    """"30 insufficient-capacity, 7 gang-incomplete" — descending count.

    The one formatter for per-job pending-reason summaries, shared by
    `hq job info` and the dashboard so the two cannot drift.
    """
    return ", ".join(
        f"{n} {code}"
        for code, n in sorted(reasons.items(), key=lambda kv: -kv[1])
    )


def _lifetime_scan(core, rqv) -> tuple[bool, bool]:
    """(lifetime_ok, stable): can some amount-capable worker's REMAINING
    lifetime cover a variant's min_time — and is that verdict stable
    within the current membership epoch?  Lifetimes only shrink, so a
    False verdict is stable, and a True verdict is stable iff it is backed
    by an unlimited-lifetime worker or a zero-min_time variant; a True
    backed only by finite-lifetime workers must be re-checked each call.
    """
    ok = False
    for w in core.workers.values():
        for v in rqv.variants:
            if not w.resources.is_capable_of(v):
                continue
            if v.min_time_secs <= w.lifetime_secs():
                ok = True
                if (
                    v.min_time_secs <= 0
                    or w.configuration.time_limit_secs <= 0
                ):
                    return True, True
    return ok, not ok


def variant_fits_free(worker, variant, n_r: int | None = None) -> bool:
    """Can ONE task of `variant` start on `worker` RIGHT NOW (free-based)?

    Mirrors the solver's per-worker capacity test (oracle.solve_oracle caps):
    free amounts, the nt_free task slot, remaining lifetime vs min_time, and
    the ALL-policy idle-pool requirement.
    """
    if worker.nt_free <= 0:
        return False
    if variant.min_time_secs > worker.lifetime_secs():
        return False
    free = worker.free
    for entry in variant.entries:
        rid = entry.resource_id
        have = free[rid] if rid < len(free) else 0
        if entry.policy is AllocationPolicy.ALL:
            total = worker.resources.amount(rid)
            if total <= 0 or have != total:
                return False
        elif have < entry.amount:
            return False
    return True


def classify_class(
    core, rq_id: int, rqv=None, degraded: bool = False,
    check_free: bool = True,
) -> str:
    """Reason code for a request class the tick left unplaced.

    Decision ladder (most fundamental constraint wins):

    1. no worker's TOTAL resources could ever host any variant
       -> no-matching-worker
    2. amounts fit somewhere, but no such worker's remaining lifetime
       covers the variant's min_time -> worker-lifetime
    3. no worker could take one task from its FREE resources right now
       -> insufficient-capacity
    4. free capacity existed but the solve left the class anyway
       -> watchdog-fallback on a degraded tick, else solver-deferred

    Steps 1-2 are pure in (class, worker set): memoized on
    ``core.capable_memo`` keyed by the membership epoch, so steady-state
    ticks pay two dict lookups.  Step 3's free scan is per-tick by nature;
    ``check_free=False`` skips it (the per-tick path drops it past a
    budget, see build_unplaced_entries) — the solve already proved nothing
    fit, so the answer collapses to insufficient-capacity (or
    watchdog-fallback on a degraded tick, where the fallback's judgment is
    not the primary solver's).
    """
    if rqv is None:
        rqv = core.rq_map.get_variants(rq_id)
    cached = core.capable_memo.get(rq_id)
    if cached is None or cached[0] != core.membership_epoch:
        amount_capable = any(
            w.resources.is_capable_of_rqv(rqv)
            for w in core.workers.values()
        )
        lifetime_ok, stable = (
            _lifetime_scan(core, rqv) if amount_capable else (False, True)
        )
        cached = (core.membership_epoch, amount_capable, lifetime_ok, stable)
        core.capable_memo[rq_id] = cached
    _, amount_capable, lifetime_ok, stable = cached
    if amount_capable and not stable:
        # lifetime_ok was satisfied only by finite-lifetime workers, and
        # remaining lifetimes decay within an epoch — recompute (a False
        # verdict, or one backed by an unlimited worker, cannot change
        # until membership does, so those stay cached)
        lifetime_ok, stable = _lifetime_scan(core, rqv)
        if stable:
            core.capable_memo[rq_id] = (
                core.membership_epoch, amount_capable, lifetime_ok, True
            )
    if not amount_capable:
        return REASON_NO_MATCHING_WORKER
    if not lifetime_ok:
        return REASON_WORKER_LIFETIME
    if check_free:
        for w in core.workers.values():
            if w.mn_task or w.mn_reserved:
                continue  # carved out of the solve this tick
            if not w.resources.is_capable_of_rqv(rqv):
                continue
            if any(variant_fits_free(w, v) for v in rqv.variants):
                return (
                    REASON_WATCHDOG_FALLBACK if degraded
                    else REASON_SOLVER_DEFERRED
                )
        return REASON_INSUFFICIENT_CAPACITY
    return (
        REASON_WATCHDOG_FALLBACK if degraded
        else REASON_INSUFFICIENT_CAPACITY
    )


# unplaced entries kept per DecisionRecord; the tail is folded into a
# truncation marker so a pathological tick cannot bloat the flight ring
MAX_UNPLACED_ENTRIES = 64
# skip the per-worker free scan when classes x workers exceeds this: the
# scan only separates solver-deferred from insufficient-capacity, and at
# scale the solve's own verdict (nothing fit) is trusted instead — keeps
# decision recording inside the <=5% tick budget at 1k workers
FREE_SCAN_BUDGET = 20_000


def build_unplaced_entries(
    core, leftover_batches, rq_reasons, degraded: bool = False,
    placed_blevel: dict | None = None,
    fairness_placed: tuple | None = None,
) -> list[dict]:
    """Fold leftover batches into per-(class, job) unplaced entries.

    `rq_reasons` memoizes classify_class per rq_id for this tick.  Job
    attribution uses the scheduler priority component: the jobs layer
    submits every task with priority=(user, encode_sched_priority(job_id,
    blevel)) — see scheduler/queues.py — so one batch always belongs to
    exactly one job — EXCEPT the per-queue tail batch that create_batches
    folds past MAX_CUTS_PER_QUEUE, whose merged tasks are all charged to
    the tail batch's job (a known approximation at > 32 distinct priority
    levels per class; `hq task explain` still answers correctly for the
    other jobs via live classification).

    `placed_blevel` maps job_id -> max decoded b-level among batches that
    DID receive assignments this tick; a solver-deferred class whose own
    b-level is strictly below that mark was held behind deeper
    critical-path work of its own job and reports lookahead-held instead.

    `fairness_placed` is the LOWEST original priority tuple among batches
    of fairness-boosted jobs that received assignments this tick (None when
    no boosted job placed work): a still-solver-deferred class whose own
    original priority is strictly ABOVE that mark was overtaken by the
    fairness boost and reports fairness-deferred instead.
    """
    entries: list[dict] = []
    truncated = 0
    leftover_classes = {
        b.rq_id for b in leftover_batches if b.size > 0
    }
    check_free = (
        len(leftover_classes) * len(core.workers) <= FREE_SCAN_BUDGET
    )
    for batch in leftover_batches:
        if batch.size <= 0:
            continue
        if len(entries) >= MAX_UNPLACED_ENTRIES:
            truncated += batch.size
            continue
        reason = rq_reasons.get(batch.rq_id)
        if reason is None:
            reason = rq_reasons[batch.rq_id] = classify_class(
                core, batch.rq_id, degraded=degraded,
                check_free=check_free,
            )
        job_id = decode_sched_job(batch.priority[1])
        if placed_blevel and reason == REASON_SOLVER_DEFERRED:
            placed = placed_blevel.get(job_id)
            if (
                placed is not None
                and decode_sched_blevel(batch.priority[1]) < placed
            ):
                reason = REASON_LOOKAHEAD_HELD
        if (
            fairness_placed is not None
            and reason == REASON_SOLVER_DEFERRED
            and tuple(batch.priority) > tuple(fairness_placed)
        ):
            reason = REASON_FAIRNESS_DEFERRED
        entries.append({
            "rq_id": batch.rq_id,
            "job": job_id,
            "priority": batch.priority[0],
            "count": batch.size,
            "reason": reason,
        })
    if truncated:
        entries.append({
            "rq_id": None, "job": None, "priority": None,
            "count": truncated, "reason": REASON_TRUNCATED,
        })
    return entries
