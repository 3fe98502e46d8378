"""Server flight recorder: a bounded in-memory ring of scheduling history.

Black-box style: the last N per-tick DecisionRecords (scheduler/decision.py)
plus recent control-plane events (worker connect/lost, job submit/pause,
solver degradation) are kept in fixed-size rings, costing O(1) per tick and
a hard memory bound regardless of uptime.  ``hq server flight-recorder
dump`` exposes the rings; ``hq task explain`` joins them to answer "why is
this task not running and for how long"; ``hq server trace export`` folds
the tick ring into the scheduler row of the Perfetto timeline.

Idle ticks (nothing ready, nothing unplaced, nothing assigned) are dropped
so the ring's N ticks cover N ticks of actual scheduling work, not a quiet
night of heartbeats.
"""

from __future__ import annotations

from collections import deque

from hyperqueue_tpu_torch.utils import clock

DEFAULT_TICKS = 512
DEFAULT_EVENTS = 1024


class FlightRecorder:
    """Ring buffers of DecisionRecords + control-plane events.

    ``capacity_ticks=0`` disables recording entirely (``record_tick`` and
    ``record_event`` become no-ops) for deployments that want the last few
    bytes of tick budget back.
    """

    def __init__(
        self,
        capacity_ticks: int = DEFAULT_TICKS,
        capacity_events: int = DEFAULT_EVENTS,
    ):
        self.capacity_ticks = max(int(capacity_ticks), 0)
        self.enabled = self.capacity_ticks > 0
        self._ticks: deque = deque(maxlen=self.capacity_ticks or 1)
        self._events: deque = deque(maxlen=max(int(capacity_events), 1))
        self.dropped_idle_ticks = 0

    # --- recording ----------------------------------------------------
    def record_tick(self, record: dict) -> None:
        if not self.enabled:
            return
        counts = record.get("counts") or {}
        if not (
            counts.get("assigned")
            or counts.get("prefilled")
            or counts.get("unplaced")
            or counts.get("gang_assigned")
            or counts.get("paused")
        ):
            # idle tick: keep the ring's window on real decisions
            self.dropped_idle_ticks += 1
            return
        self._ticks.append(record)

    def record_event(self, kind: str, payload: dict | None = None) -> None:
        if not self.enabled:
            return
        self._events.append(
            {"time": clock.now(), "event": kind, **(payload or {})}
        )

    # --- queries ------------------------------------------------------
    def ticks(self) -> list[dict]:
        return list(self._ticks)

    def events(self) -> list[dict]:
        return list(self._events)

    def latest(self) -> dict | None:
        return self._ticks[-1] if self._ticks else None

    def reason_for(self, rq_id: int | None, job: int) -> dict | None:
        """Latest unplaced entry for (class, job), annotated with how many
        consecutive recent ticks the pair stayed unplaced (`deferred_ticks`,
        capped by the ring capacity) and the tick id it was last seen on.

        `rq_id=None` matches the job alone (paused/gang entries carry no
        class).
        """

        def match(record) -> dict | None:
            for entry in record.get("unplaced") or ():
                if entry.get("job") != job:
                    continue
                if rq_id is None or entry.get("rq_id") in (rq_id, None):
                    return entry
            return None

        latest_entry = None
        latest_tick = None
        deferred = 0
        for record in reversed(self._ticks):
            entry = match(record)
            if entry is None:
                break
            deferred += 1
            if latest_entry is None:
                latest_entry = entry
                latest_tick = record.get("tick")
        if latest_entry is None:
            return None
        # streak spans the whole (full) ring: the true deferral is >= this
        capped = (
            deferred == len(self._ticks)
            and len(self._ticks) == self.capacity_ticks
        )
        return {
            **latest_entry,
            "tick": latest_tick,
            "deferred_ticks": deferred,
            "deferred_capped": capped,
        }

    def dump(self) -> dict:
        return {
            "capacity_ticks": self.capacity_ticks,
            "capacity_events": self._events.maxlen,
            "dropped_idle_ticks": self.dropped_idle_ticks,
            "ticks": self.ticks(),
            "events": self.events(),
        }
