"""Declarative SLOs with multi-window burn-rate alerting.

The metrics plane (utils/metrics.py) records what happened; this module
judges it. An :class:`SloSpec` names a served-level objective over an
existing instrument — "95% of ticks complete under 250 ms", "99.9% of
shards are up" — and :class:`SloEngine` evaluates every spec on a
sliding window over the process registry, converting bad-event
fractions into **burn rates** (how many times faster than sustainable
the error budget is being consumed; SRE workbook chapter 5).

An alert fires when the burn rate exceeds a rule's factor on BOTH its
long and short window — the long window proves the problem is real,
the short window proves it is still happening (and resolves the alert
promptly once it stops). Two severities ship by default:

- ``page``  — 14.4x burn over 1 h + 5 m (budget gone in ~2 days)
- ``ticket`` — 6x burn over 6 h + 30 m (budget gone in ~5 days)

All windows scale by ``HQ_SLO_WINDOW_SCALE`` so the simulator (virtual
clock) and the bench smoke can compress hours into seconds without
touching the math. Evaluation is O(specs x rules) per tick and reads
only cumulative counters, so it is cheap enough to run everywhere the
registry lives: server reactor loop, standby watcher, simulator.

Alert *transitions* are the integration surface: ``evaluate`` returns
them, the server journals each as an ``slo-alert`` event (riding the
subscribe plane and the FleetFeed), and the exported gauges
``hq_slo_{error_budget_remaining,burn_rate,alerts_firing}`` expose the
same judgement to scrapers.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass, field

from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

# exported judgement (module-level like every other instrument so the
# docs catalog checker sees the literal registrations)
_BUDGET_REMAINING = REGISTRY.gauge(
    "hq_slo_error_budget_remaining",
    "fraction of the SLO's error budget left over its longest alert "
    "window (1 = untouched, 0 = exhausted, negative = overdrawn)",
    labels=("slo",),
)
_BURN_RATE = REGISTRY.gauge(
    "hq_slo_burn_rate",
    "error-budget burn rate per SLO and window (1 = exactly "
    "sustainable, 14.4 = page-level burn)",
    labels=("slo", "window"),
)
_ALERTS_FIRING = REGISTRY.gauge(
    "hq_slo_alerts_firing",
    "SLO burn-rate alerts currently firing, by severity",
    labels=("severity",),
)


@dataclass(frozen=True)
class SloSpec:
    """One objective over one instrument.

    kind "latency": ``metric`` is a histogram; an observation is good
    when it lands in a bucket whose upper edge is <= ``threshold``.
    kind "availability": ``metric`` is a 0/1 gauge family; each
    evaluation tick scores every series (good = value >= 1).
    """

    name: str
    description: str
    metric: str
    objective: float
    kind: str = "latency"
    threshold: float = 0.0
    labels: tuple = ()  # ((label, value), ...) filter on series

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


@dataclass(frozen=True)
class BurnRule:
    severity: str
    factor: float
    long_s: float
    short_s: float


DEFAULT_RULES = (
    BurnRule("page", 14.4, 3600.0, 300.0),
    BurnRule("ticket", 6.0, 21600.0, 1800.0),
)

DEFAULT_SPECS = (
    SloSpec(
        name="tick-latency",
        description="95% of scheduler ticks complete under 250 ms",
        metric="hq_tick_phase_seconds",
        labels=(("phase", "total"),),
        objective=0.95,
        threshold=0.25,
    ),
    SloSpec(
        name="submit-ack",
        description="99% of client RPCs leave the reactor handoff "
                    "within 500 ms",
        metric="hq_reactor_lag_seconds",
        labels=(("plane", "rpc"),),
        objective=0.99,
        threshold=0.5,
    ),
    SloSpec(
        name="queue-age",
        description="95% of tasks are assigned within 60 s of "
                    "becoming ready",
        metric="hq_task_queue_age_seconds",
        objective=0.95,
        threshold=60.0,
    ),
    SloSpec(
        name="restore-duration",
        description="99% of journal restores finish under 30 s",
        metric="hq_restore_duration_seconds",
        objective=0.99,
        threshold=30.0,
    ),
    SloSpec(
        name="shard-availability",
        description="99.9% shard liveness as seen by the failover "
                    "watcher's lease scan",
        metric="hq_federation_shard_up",
        kind="availability",
        objective=0.999,
    ),
)


def alert_names(specs=DEFAULT_SPECS, rules=DEFAULT_RULES) -> list[str]:
    """Every alert name this engine can emit (``<slo>:<severity>``) —
    the docs catalog checker fails on any of these missing from
    docs/observability.md, mirroring the metric-name checker."""
    return [f"{s.name}:{r.severity}" for s in specs for r in rules]


def window_scale() -> float:
    """HQ_SLO_WINDOW_SCALE compresses every alert window (sim/bench:
    hours become seconds without changing the burn-rate math)."""
    try:
        scale = float(os.environ.get("HQ_SLO_WINDOW_SCALE", "") or 1.0)
    except ValueError:
        scale = 1.0
    return scale if scale > 0 else 1.0


@dataclass
class _SpecState:
    # ring of (monotonic time, cumulative good, cumulative total)
    ring: deque = field(default_factory=lambda: deque(maxlen=4096))
    # availability specs accumulate their own cumulative counts
    # (gauges have no history; each evaluation tick scores the fleet)
    cum_good: float = 0.0
    cum_total: float = 0.0


class SloEngine:
    """Evaluates specs against the process registry; owns alert state.

    One instance per process (server, standby watcher, sim server) —
    construction is cheap and ``evaluate`` no-ops for specs whose
    metric has no data yet, so a worker-less standby only ever scores
    shard availability."""

    def __init__(self, registry=None, specs=DEFAULT_SPECS,
                 rules=DEFAULT_RULES, scale: float | None = None):
        self.registry = registry if registry is not None else REGISTRY
        self.specs = tuple(specs)
        self.rules = tuple(rules)
        self.scale = scale if scale is not None else window_scale()
        # evaluation cadence: ~1/10th of the shortest short window,
        # bounded to stay responsive in scaled-down runs and cheap in
        # production (15 s ticks for the default 5 m short window)
        shortest = min((r.short_s for r in self.rules), default=300.0)
        self.interval = min(15.0, max(0.05, shortest * self.scale / 10))
        self._state: dict[str, _SpecState] = {}
        self._firing: dict[tuple[str, str], dict] = {}
        self.history: deque = deque(maxlen=64)
        self.last_eval = 0.0

    # ------------------------------------------------------------ read
    def _read(self, spec: SloSpec) -> tuple[float, float] | None:
        metric = self.registry.get(spec.metric)
        if metric is None or not metric.series:
            return None
        want = dict(spec.labels)
        if spec.kind == "availability":
            up = total = 0.0
            for values, series in metric.series.items():
                sample = dict(zip(metric.label_names, values))
                if any(sample.get(k) != v for k, v in want.items()):
                    continue
                total += 1.0
                if series.value >= 1.0:
                    up += 1.0
            if total == 0.0:
                return None
            state = self._state.setdefault(spec.name, _SpecState())
            state.cum_good += up
            state.cum_total += total
            return state.cum_good, state.cum_total
        good = total = 0.0
        matched = False
        for values, series in metric.series.items():
            sample = dict(zip(metric.label_names, values))
            if any(sample.get(k) != v for k, v in want.items()):
                continue
            matched = True
            total += series.count
            for edge, n in zip(series.buckets, series.counts):
                if edge <= spec.threshold:
                    good += n
        if not matched:
            return None
        return good, total

    # -------------------------------------------------------- evaluate
    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation tick: sample every spec, update alert state,
        refresh the exported gauges. Returns the alert TRANSITIONS this
        tick (state "firing" or "resolved") for the caller to journal."""
        if now is None:
            now = clock.monotonic()
        self.last_eval = now
        transitions: list[dict] = []
        for spec in self.specs:
            reading = self._read(spec)
            state = self._state.setdefault(spec.name, _SpecState())
            if reading is None:
                continue
            state.ring.append((now, reading[0], reading[1]))
            longest = 0.0
            for rule in self.rules:
                long_w = rule.long_s * self.scale
                short_w = rule.short_s * self.scale
                burn_long = self._burn(state.ring, spec, now, long_w)
                burn_short = self._burn(state.ring, spec, now, short_w)
                if long_w > longest:
                    # budget remaining over the LONGEST window: burn 1.0
                    # sustained for the whole window consumes it exactly
                    longest = long_w
                    _BUDGET_REMAINING.labels(spec.name).set(
                        round(1.0 - burn_long, 6)
                    )
                _BURN_RATE.labels(spec.name, _wname(rule.long_s)).set(
                    round(burn_long, 6)
                )
                _BURN_RATE.labels(spec.name, _wname(rule.short_s)).set(
                    round(burn_short, 6)
                )
                key = (spec.name, rule.severity)
                firing = key in self._firing
                should_fire = (
                    burn_long >= rule.factor and burn_short >= rule.factor
                )
                if should_fire and not firing:
                    alert = {
                        "alert": f"{spec.name}:{rule.severity}",
                        "slo": spec.name,
                        "severity": rule.severity,
                        "state": "firing",
                        "since": now,
                        "burn_rate": round(burn_long, 3),
                        "burn_short": round(burn_short, 3),
                        "window": [long_w, short_w],
                        "objective": spec.objective,
                        "description": spec.description,
                    }
                    self._firing[key] = alert
                    self.history.append(dict(alert))
                    transitions.append(dict(alert))
                elif firing and not should_fire:
                    alert = self._firing.pop(key)
                    resolved = dict(alert)
                    resolved["state"] = "resolved"
                    resolved["burn_rate"] = round(burn_long, 3)
                    resolved["burn_short"] = round(burn_short, 3)
                    resolved["fired_for"] = round(
                        max(now - alert["since"], 0.0), 3
                    )
                    self.history.append(dict(resolved))
                    transitions.append(resolved)
                elif firing:
                    live = self._firing[key]
                    live["burn_rate"] = round(burn_long, 3)
                    live["burn_short"] = round(burn_short, 3)
        by_severity: dict[str, int] = {
            r.severity: 0 for r in self.rules
        }
        for (_, severity) in self._firing:
            by_severity[severity] = by_severity.get(severity, 0) + 1
        for severity, count in by_severity.items():
            _ALERTS_FIRING.labels(severity).set(count)
        return transitions

    @staticmethod
    def _burn(ring, spec: SloSpec, now: float, window: float) -> float:
        """Burn rate over one window: (bad fraction) / (error budget).
        The baseline is the newest sample at or before the window start
        — or the oldest sample while the ring is still shorter than the
        window (fraction-based, so a short actual span stays honest)."""
        if not ring:
            return 0.0
        start = now - window
        baseline = ring[0]
        for sample in reversed(ring):
            if sample[0] <= start:
                baseline = sample
                break
        head = ring[-1]
        d_total = head[2] - baseline[2]
        if d_total <= 0.0:
            return 0.0
        d_bad = d_total - (head[1] - baseline[1])
        return (d_bad / d_total) / spec.budget

    # ----------------------------------------------------------- state
    def alerts(self) -> dict:
        """Wire shape for the `hq alerts` RPC: currently-firing alerts
        plus the recent transition history (newest last)."""
        return {
            "firing": [dict(a) for a in self._firing.values()],
            "recent": [dict(a) for a in self.history],
            "interval": self.interval,
            "scale": self.scale,
        }

    def badge(self) -> dict:
        """Tiny firing summary for sample blocks / `hq top`: count plus
        the worst severity currently firing (page > ticket)."""
        severities = [a.get("severity") for a in self._firing.values()]
        worst = None
        if "page" in severities:
            worst = "page"
        elif severities:
            worst = sorted(severities)[0]
        return {"firing": len(self._firing), "worst": worst}

    def paging_alerts(self) -> list[dict]:
        """Firing page-severity alerts — the readiness-probe and
        autoalloc-quarantine input."""
        return [
            dict(a) for a in self._firing.values()
            if a.get("severity") == "page"
        ]

    def reset(self) -> None:
        """Drop every window and alert (mirrors LagTracker.reset on
        `hq server reset-metrics`): the next steady-state measurement
        window starts clean instead of inheriting a breach."""
        self._state.clear()
        self._firing.clear()
        self.history.clear()
        for severity in {r.severity for r in self.rules}:
            _ALERTS_FIRING.labels(severity).set(0)


def _wname(seconds: float) -> str:
    """Stable window label from the UNscaled rule duration (scaled runs
    keep the production series names)."""
    if seconds >= 3600:
        return f"{seconds / 3600:g}h"
    if seconds >= 60:
        return f"{seconds / 60:g}m"
    return f"{seconds:g}s"
