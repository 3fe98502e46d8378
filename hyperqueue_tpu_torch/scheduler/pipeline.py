"""Two-stage asynchronous tick pipeline.

The synchronous tick pays the device round trip on its critical path:
assemble -> dispatch -> BLOCK on readback -> map.  With the device-resident
state (parallel/resident.py) the solve's inputs live on the accelerator, so
the host has no reason to wait: tick k DISPATCHES solve k and immediately
maps the counts of solve k-1 (whose device execution overlapped all the
host work since the previous tick — applying assignments, journal writes,
network IO).  The readback at the top of tick k almost always finds the
result already materialized, so the device round trip disappears from the
tick's critical path entirely.

Order within a tick: `take_result` (which re-synchronizes the device
residency from the solve's outputs) comes BEFORE the tick cache's sync and
the next dispatch; a dispatch while the previous solve is unmapped would
force a full upload of the resident state every tick.

Semantics: assignments lag one tick (solve k's placements are applied at
tick k+1).  This is safe because the solve is pure — worker state advances
on the DEVICE via the in-place free/nt_free update, the host applies the same
deltas when it maps, and anything else that moved in between (completions,
new submits) reaches the device as next tick's dirty rows.  Mapped task
ids are popped from the live queues at map time: a task canceled while its
solve was in flight is simply no longer there to pop, and the counts cell
comes up short harmlessly.  Workers that disconnected in flight are
filtered by the reactor (their tasks go back to the queues).

The pipeline is OPT-IN (`hq server start --tick-pipeline`) and degrades to
the synchronous path whenever exactness tooling or fault handling needs
it: `--paranoid-tick` ticks force a drain + synchronous solve, and the
solver watchdog drains the pipeline before any fallback solve (a pending
handle that fails or times out is itself resolved by the watchdog's
fallback — see scheduler/watchdog.py).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils.trace import ranges as _ranges


@dataclass(slots=True)
class PendingSolve:
    """One dispatched-but-unmapped solve."""

    handle: object            # .result() -> unpadded counts (B, V, W)
    batches: list             # solve-ordered batches at dispatch time
    worker_ids: list          # row -> worker_id at dispatch time
    queues: object            # TaskQueues to pop from at map time
    backend: str | None       # model.last_backend at dispatch
    backend_reason: str       # model.last_backend_reason at dispatch
    dispatched_at: float = field(default_factory=_time.perf_counter)
    # wall-clock dispatch stamp: a trace export places the pipelined
    # solve's execution window by these recorded stamps instead of charging
    # it to the tick that happens to MAP it
    dispatched_wall: float = field(default_factory=clock.now)
    # (membership_epoch, queues.version, total_ready) at dispatch: the
    # reactor stamps it and, when this solve maps EMPTY and the signature
    # still matches (and no worker row moved), skips re-dispatching — an
    # unplaceable backlog must not spin the scheduler at min-delay cadence
    state_sig: tuple | None = None


class TickPipeline:
    """Holds at most one in-flight solve between reactor ticks."""

    def __init__(self) -> None:
        self.pending: PendingSolve | None = None
        # dispatch-time signature of the last solve that mapped EMPTY
        # (None once any solve maps assignments): while the live state
        # still matches it, re-solving is provably redundant and the
        # reactor skips the dispatch — see PendingSolve.state_sig
        self.idle_sig: tuple | None = None
        # telemetry (stats())
        self.dispatched = 0
        self.mapped = 0
        self.drains = 0
        self.last_wait_ms = 0.0

    @property
    def depth(self) -> int:
        return 1 if self.pending is not None else 0

    def put(self, pending: PendingSolve) -> None:
        assert self.pending is None, "tick pipeline depth is 1"
        self.pending = pending
        self.dispatched += 1

    def take_result(self, model=None, phases: dict | None = None,
                    decision: dict | None = None) -> list:
        """Materialize and map the pending solve; returns its assignments.

        The wait for the device result is timed separately
        (`pipeline_wait` phase): in steady state it is ~zero because the
        device ran during the inter-tick host work."""
        from hyperqueue_tpu_torch.scheduler.tick import _map_counts

        pending = self.pending
        if pending is None:
            return []
        self.pending = None
        _t0 = _time.perf_counter()
        ranges = _ranges()
        ranges.begin("pipeline_wait")
        counts = pending.handle.result()
        _t1 = _time.perf_counter()
        ranges.end("pipeline_wait")
        self.last_wait_ms = (_t1 - _t0) * 1e3
        if phases is not None:
            phases["pipeline_wait"] = (
                phases.get("pipeline_wait", 0.0) + self.last_wait_ms
            )
        if decision is not None:
            import numpy as np

            if model is not None and getattr(
                model, "last_solve_skipped", False
            ):
                status = "skipped"
            elif model is not None and getattr(
                model, "last_solve_degraded", False
            ):
                status = "fallback"
            else:
                status = "ok"
            decision["solver"] = {
                "status": status,
                "backend": pending.backend,
                "backend_reason": pending.backend_reason,
                "pipelined": True,
                # the solve cost the TICK paid is the readback wait — the
                # execution itself overlapped inter-tick host work;
                # inflight_ms (dispatch -> map, including server idle) is
                # kept separately for context
                "solve_ms": round(self.last_wait_ms, 4),
                "inflight_ms": round((_t1 - pending.dispatched_at) * 1e3, 1),
                # recorded dispatch/readback wall stamps: the trace export
                # renders the solve where it actually EXECUTED
                "dispatched_at_wall": pending.dispatched_wall,
                "mapped_at_wall": clock.now(),
                "objective": int(np.asarray(counts).sum()),
            }
        assignments = _map_counts(
            pending.queues, pending.batches, pending.worker_ids, counts,
            phases=phases,
        )
        self.mapped += 1
        self.idle_sig = pending.state_sig if not assignments else None
        return assignments

    def drain(self, model=None, phases: dict | None = None,
              decision: dict | None = None) -> list:
        """take_result, counted as a forced drain (paranoid tick, watchdog
        fallback, mu-worker tick, shutdown)."""
        if self.pending is not None:
            self.drains += 1
        return self.take_result(model=model, phases=phases,
                                decision=decision)

    def stats(self) -> dict:
        return {
            "depth": self.depth,
            "dispatched": self.dispatched,
            "mapped": self.mapped,
            "drains": self.drains,
            "last_wait_ms": round(self.last_wait_ms, 3),
        }
