"""Persistent tick-state cache: the dense snapshot survives across ticks.

Without this cache, every tick re-materializes the whole dense solver
state from Python dicts: `core.worker_rows()` rebuilds all `WorkerRow`s,
and `assemble_solve_inputs` re-allocates and re-fills the
`free`/`total`/`nt_free`/`lifetime` arrays from scratch.  At the 1M x 1k
north-star shape that host bookkeeping — not the solve — dominates the
tick (the reallocation round must be far cheaper than the work it places).

`TickStateCache` keeps the `(W, R)` matrices and `(W,)` vectors alive and
applies dirty-tracking deltas instead of rebuilding:

- every `Worker.assign`/`unassign` bumps the worker's `epoch`
  (server/worker.py) — the ONE funnel for free/nt_free mutation;
- `sync()` walks the eligible workers once, rewrites only rows whose
  epoch moved, and refreshes lifetimes for time-limited workers;
- membership changes (connect/disconnect, gang reservation flips) and
  resource-map widening are structural: the row map is rebuilt and the
  `full_rebuilds` counter increments — steady-state ticks must keep it
  at zero.

Correctness contract: an incremental assemble must be BIT-IDENTICAL to a
from-scratch assemble of the same state.  `paranoid_check` runs both
paths and asserts array equality; the server runs it every N ticks
(`--paranoid-tick N`, `Core.paranoid_tick`), and a randomized golden test
drives hundreds of mutation steps through both paths.

The cache deliberately disables itself (sync() returns None) while any
eligible worker carries a min-utilization floor: floored workers move in
and out of the dense row set per tick (run_tick's carve-out), so their
presence makes membership time-dependent — and they are rare, autoalloc
-spawned workers.  The legacy from-scratch path remains for that case.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(slots=True)
class DenseSnapshot:
    """One tick's dense worker-side state, aligned row-for-row.

    Arrays are OWNED by the cache and reused next tick: consumers must
    treat them as read-only (assemble_solve_inputs copies before any
    range-compression shift).
    """

    worker_ids: list[int]        # row -> worker_id, solve order
    free: np.ndarray             # (W, R) int64, uncompressed fractions
    total: np.ndarray            # (W, R) int64 pool totals
    nt_free: np.ndarray          # (W,) int32, clamped >= 0
    lifetime: np.ndarray         # (W,) int32 seconds


# entries of a tick's `phases` that are no phase of it: the time since
# the tick before that the record carries (the workers' answers, the
# collector's passes by where they fell) and their counts
PHASES_APART = ("since_ms", "since_n")
# phases that tile another phase (prefill_fill + prefill_retract =
# prefill): kept and shown, but counted once in shares()
SUB_PHASES = ("prefill_fill", "prefill_retract")


def tick_phases(phases: dict):
    """(name, ms) of the tick's own phases, sub-phases included."""
    return ((name, ms) for name, ms in phases.items()
            if name not in PHASES_APART)


@dataclass
class TickPhaseStats:
    """Per-phase tick latency breakdown, recorded once per tick.

    Mirrors the phases of one tick: batches -> assemble -> solve-dispatch
    -> device-sync -> mapping (and pipeline_wait on a pipelined tick), so
    a latency regression names its phase instead of one opaque number.
    """

    ticks: int = 0
    totals_ms: dict = field(default_factory=dict)   # phase -> cumulative ms
    last_ms: dict = field(default_factory=dict)     # phase -> last tick ms
    max_ms: dict = field(default_factory=dict)      # phase -> max ms

    def record(self, phases: dict) -> None:
        self.ticks += 1
        for name, ms in tick_phases(phases):
            self.totals_ms[name] = self.totals_ms.get(name, 0.0) + ms
            self.last_ms[name] = ms
            if ms > self.max_ms.get(name, 0.0):
                self.max_ms[name] = ms

    def snapshot(self) -> dict:
        out = {
            "ticks": self.ticks,
            "phases": {
                name: {
                    "total_ms": round(total, 3),
                    "mean_ms": round(total / max(self.ticks, 1), 4),
                    "last_ms": round(self.last_ms.get(name, 0.0), 4),
                    "max_ms": round(self.max_ms.get(name, 0.0), 4),
                }
                for name, total in sorted(self.totals_ms.items())
            },
        }
        return out

    def shares(self) -> dict:
        """Phase -> fraction of total tick time (all phases sum to ~1.0).

        A latency regression then names the phase whose share grew
        rather than one opaque wall-clock number."""
        totals = {name: t for name, t in self.totals_ms.items()
                  if name not in SUB_PHASES}
        total = sum(totals.values())
        if total <= 0:
            return {}
        return {
            name: round(t / total, 4)
            for name, t in sorted(totals.items())
        }


class TickStateCache:
    """Dirty-tracked dense snapshot of the schedulable workers."""

    def __init__(self) -> None:
        self.worker_ids: list[int] = []
        self._workers: list = []          # same order as worker_ids
        self._epochs: list[int] = []
        self._timed_rows: list[int] = []  # rows with a finite time limit
        # (core.membership_epoch, n_r) of the last sync: when unchanged,
        # the O(W) membership walk is skipped entirely and only row
        # CONTENT (Worker.epoch) is scanned
        self._sync_ver: tuple | None = None
        self._mu_blocked = False
        self.n_r = 0
        self.free: np.ndarray | None = None
        self.total: np.ndarray | None = None
        self.nt_free: np.ndarray | None = None
        self.lifetime: np.ndarray | None = None
        # telemetry (counters())
        self.full_rebuilds = 0
        self.incremental_syncs = 0
        self.rows_rewritten_last = 0
        # sort-key memo for assemble_solve_inputs: the (scarcity,
        # objective) keys are pure per rq class + per-tick free totals;
        # totals are often unchanged tick-over-tick (e.g. release then
        # re-assign), so the whole per-class key dict is reusable
        self.sort_key_sig: tuple | None = None
        self.sort_keys: dict = {}
        # batch-layout memo: needs/min_time/all_mask/weights are pure in
        # the sorted rq-id sequence (+ dims), which steady ticks repeat
        self.batch_layout_sig: tuple | None = None
        self.batch_layout: dict | None = None

    # ------------------------------------------------------------------
    def sync(self, core) -> DenseSnapshot | None:
        """Bring the dense arrays up to date with `core`; returns the
        snapshot, or None when the cache cannot serve this tick (a
        min-utilization worker is present — see module docstring)."""
        n_r = len(core.resource_map)
        ver = (core.membership_epoch, n_r)
        if self.free is not None and ver == self._sync_ver:
            # common steady-state tick: membership and map width unchanged
            # since last sync — only row content can have moved
            if self._mu_blocked or not self.worker_ids:
                return None
            self._refresh_dirty()
            return self._snapshot()

        eligible = []
        mu_blocked = False
        for w in core.workers.values():
            if w.mn_task != 0 or w.mn_reserved != 0 or w.draining:
                continue
            if w.configuration.min_utilization > 0.001:
                mu_blocked = True
                break
            eligible.append(w)
        self._sync_ver = ver
        self._mu_blocked = mu_blocked
        if mu_blocked:
            return None
        ids = [w.worker_id for w in eligible]
        if self.free is None or ids != self.worker_ids:
            self._rebuild(eligible, n_r)
        else:
            # same rows, same order (worker ids never recycle, so equal
            # ids means the same Worker objects): a pure width change
            # and/or content drift
            if n_r != self.n_r:
                self._widen(n_r)
            self._refresh_dirty()
        if not ids:
            return None
        return self._snapshot()

    def _snapshot(self) -> DenseSnapshot:
        return DenseSnapshot(
            worker_ids=self.worker_ids,
            free=self.free,
            total=self.total,
            nt_free=self.nt_free,
            lifetime=self.lifetime,
        )

    # ------------------------------------------------------------------
    def _rebuild(self, eligible: list, n_r: int) -> None:
        """Structural change (membership or first tick): rebuild the row
        map and every array.  Counted — steady state must never get here."""
        self.full_rebuilds += 1
        n_w = len(eligible)
        self.worker_ids = [w.worker_id for w in eligible]
        self._workers = eligible
        self._epochs = [w.epoch for w in eligible]
        self.n_r = n_r
        self.free = np.zeros((n_w, n_r), dtype=np.int64)
        self.total = np.zeros((n_w, n_r), dtype=np.int64)
        self.nt_free = np.zeros(n_w, dtype=np.int32)
        self.lifetime = np.zeros(n_w, dtype=np.int32)
        self._timed_rows = []
        for i, w in enumerate(eligible):
            self._write_row(i, w)
            self.lifetime[i] = w.lifetime_secs()
            if w.configuration.time_limit_secs > 0:
                self._timed_rows.append(i)

    def _widen(self, n_r: int) -> None:
        """Resource map grew: pad new zero columns (a worker's dense row
        may lag the map right after a new name is interned — the scratch
        path zero-fills the same columns)."""
        grow = n_r - self.n_r
        self.free = np.pad(self.free, ((0, 0), (0, grow)))
        self.total = np.pad(self.total, ((0, 0), (0, grow)))
        self.n_r = n_r

    def _write_row(self, i: int, w) -> None:
        """Full row write: free, POOL TOTALS and nt_free.  Only rebuild
        and widening call this — pool totals are static per worker, so the
        per-tick dirty path (_refresh_free_row) skips them."""
        self._write_free_row(i, w)
        amounts = w.resources.amounts
        n = min(len(amounts), self.n_r)
        row = self.total[i]
        row[:n] = amounts[:n]
        row[n:] = 0

    def _write_free_row(self, i: int, w) -> None:
        free = w.free
        n = min(len(free), self.n_r)
        row = self.free[i]
        row[:n] = free[:n]
        row[n:] = 0
        self.nt_free[i] = w.nt_free if w.nt_free > 0 else 0

    # above this dirty fraction, one C-level bulk conversion of every row
    # beats per-row Python writes (a heavily-loaded tick can touch every
    # worker between schedules — incremental must not lose to scratch then)
    _BULK_DIRTY_FRACTION = 8

    def _refresh_dirty(self) -> None:
        self.incremental_syncs += 1
        epochs = self._epochs
        workers = self._workers
        dirty = [
            i for i, w in enumerate(workers) if w.epoch != epochs[i]
        ]
        n_w = len(workers)
        if dirty and len(dirty) > n_w // self._BULK_DIRTY_FRACTION:
            free_lists = [w.free for w in workers]
            n_r = self.n_r
            if all(len(f) == n_r for f in free_lists):
                # one-shot C conversion of every row into persistent
                # storage (fromiter over a chained iterator beats both
                # np.array(list-of-lists) and slice assignment ~2.4x);
                # pool totals are static and stay untouched
                from itertools import chain

                self.free[:] = np.fromiter(
                    chain.from_iterable(free_lists), dtype=np.int64,
                    count=n_w * n_r,
                ).reshape(n_w, n_r)
                np.maximum(
                    np.fromiter(
                        (w.nt_free for w in workers), dtype=np.int32,
                        count=n_w,
                    ),
                    0,
                    out=self.nt_free,
                )
                for i in dirty:
                    epochs[i] = workers[i].epoch
            else:
                for i in dirty:
                    self._write_free_row(i, workers[i])
                    epochs[i] = workers[i].epoch
        else:
            for i in dirty:
                self._write_free_row(i, workers[i])
                epochs[i] = workers[i].epoch
        for i in self._timed_rows:
            self.lifetime[i] = workers[i].lifetime_secs()
        self.rows_rewritten_last = len(dirty)

    # ------------------------------------------------------------------
    def counters(self) -> dict:
        return {
            "full_rebuilds": self.full_rebuilds,
            "incremental_syncs": self.incremental_syncs,
            "rows_rewritten_last": self.rows_rewritten_last,
            "workers": len(self.worker_ids),
            "resources": self.n_r,
        }


def paranoid_check(core, snapshot: DenseSnapshot, batches, rq_map,
                   resource_map, gang_ok=None, group_ids=None,
                   policy=None) -> None:
    """Assert the incremental assembly is bit-identical to from-scratch.

    Runs BOTH assemble paths on copies of the batch list (assemble sorts
    in place but pops nothing), and compares every kwargs array exactly —
    including the fused-gang inputs (gang_nodes/gang_ok/group_onehot)
    and the policy affinity matrix when the tick carries them.  Raises
    AssertionError naming the first differing array.  Debug tool:
    `--paranoid-tick N` (Core.paranoid_tick) runs this every N ticks.
    """
    from hyperqueue_tpu_torch.scheduler.tick import Batch, assemble_solve_inputs

    def copy_batches(src):
        return [Batch(rq_id=b.rq_id, priority=b.priority, size=b.size,
                      gang_task=b.gang_task, gang_nodes=b.gang_nodes)
                for b in src]

    scratch_rows = [r for r in core.worker_rows() if r.cpu_floor <= 0]
    k_scratch = assemble_solve_inputs(
        scratch_rows, copy_batches(batches), rq_map, resource_map,
        gang_ok=gang_ok, group_ids=group_ids, policy=policy,
    )
    # key_cache=core.tick_cache: the check must exercise the SAME memoized
    # sort-key/batch-layout/needs32 path the production assemble uses, or
    # a corrupted memo would pass paranoid while feeding every real solve
    k_incr = assemble_solve_inputs(
        None, copy_batches(batches), rq_map, resource_map, dense=snapshot,
        key_cache=core.tick_cache, gang_ok=gang_ok, group_ids=group_ids,
        policy=policy,
    )
    scratch_ids = [r.worker_id for r in scratch_rows]
    assert scratch_ids == snapshot.worker_ids, (
        f"paranoid-tick: worker row order diverged "
        f"(scratch={scratch_ids[:8]}..., cache={snapshot.worker_ids[:8]}...)"
    )
    keys = set(k_scratch) | set(k_incr)
    for key in sorted(keys):
        a, b = k_scratch.get(key), k_incr.get(key)
        if key == "priorities":
            assert a == b, f"paranoid-tick: priorities diverged"
            continue
        assert (a is None) == (b is None), (
            f"paranoid-tick: key {key!r} present on one path only"
        )
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        if key == "lifetime" and a.shape == b.shape:
            # lifetime is wall-clock-derived for time-limited workers: the
            # cache stamped it at sync() and the scratch rows re-evaluate
            # it here, so crossing a 1-second boundary in between yields a
            # legitimate off-by-one — everything else must be exact
            assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
                initial=0
            ) <= 1, (
                "paranoid-tick: lifetime diverged beyond clock granularity"
            )
            continue
        assert np.array_equal(a, b), (
            f"paranoid-tick: array {key!r} diverged between incremental "
            f"and from-scratch assembly"
        )
