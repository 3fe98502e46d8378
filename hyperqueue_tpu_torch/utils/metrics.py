"""Process-wide metrics plane: registry, instruments, Prometheus exposition.

Reference: the reference factors every hot phase behind `trace_time!` spans
plus a dashboard event stream; production schedulers (Gavel, arXiv:2008.09213)
additionally presuppose scrapeable per-phase latency and utilization
telemetry. This module is the dependency-free substrate: counters, gauges and
fixed-bucket histograms with label support, rendered in the Prometheus text
exposition format (0.0.4). The reactor and the trace store record into it;
the HTTP endpoint that serves the exposition comes with the server's network
plane, which the port does not hold yet.

Design constraints:

- Zero hot-path cost when nothing scrapes: recording is a couple of dict
  lookups and float adds; anything expensive (walking server state, watchdog
  counters, per-worker fan-out) runs in *collect hooks* evaluated only at
  exposition time.
- Bounded memory: each metric caps its distinct label sets
  (``max_series``); series beyond the cap are dropped into a shared no-op
  series and counted in ``hq_metrics_dropped_series_total`` instead of
  growing without bound under a label-cardinality bug.
- One registry per process (one server or worker per process, like TRACER);
  ``snapshot()``/``export_samples()`` produce JSON-safe forms.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

# Prometheus-conventional latency buckets (seconds), tuned one decade lower
# than the defaults: tick phases and spawn latencies live in the 0.1 ms-1 s
# range on this codebase's targets.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

DEFAULT_MAX_SERIES = 64


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    # integers render without a trailing .0 (matches prometheus client
    # output and keeps the golden test readable)
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(float(value))


def _labels_str(names: tuple[str, ...], values: tuple[str, ...],
                extra: str = "") -> str:
    parts = [
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    ]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set_total(self, value: float) -> None:
        """Adopt an externally-tracked monotonic total (e.g. watchdog
        failure counts maintained outside the registry)."""
        self.value = float(value)

    def reset(self) -> None:
        self.value = 0.0


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def reset(self) -> None:
        self.value = 0.0


class _HistogramSeries:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)  # cumulative rendered at exposition
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        self.count += 1
        # per-bucket (non-cumulative) counts internally; cumulated on render
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                return

    def reset(self) -> None:
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0


class _NoopSeries:
    """Shared sink for label sets beyond the cardinality cap."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None: ...
    def dec(self, amount: float = 1.0) -> None: ...
    def set(self, value: float) -> None: ...
    def set_total(self, value: float) -> None: ...
    def observe(self, value: float) -> None: ...
    def reset(self) -> None: ...


_NOOP = _NoopSeries()


@dataclass
class Metric:
    name: str
    help: str
    type: str  # "counter" | "gauge" | "histogram"
    label_names: tuple[str, ...] = ()
    buckets: tuple[float, ...] = DEFAULT_BUCKETS
    max_series: int = DEFAULT_MAX_SERIES
    series: dict = field(default_factory=dict)  # label values -> series
    registry: "MetricsRegistry | None" = None

    def _make_series(self):
        if self.type == "counter":
            return _CounterSeries()
        if self.type == "gauge":
            return _GaugeSeries()
        return _HistogramSeries(self.buckets)

    def labels(self, *values, **kv):
        """Series for one label-value combination. Accepts positional values
        (in declaration order) or keyword form; values are stringified."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            values = tuple(str(kv[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, got {values}"
            )
        series = self.series.get(values)
        if series is None:
            if len(self.series) >= self.max_series:
                if self.registry is not None:
                    self.registry.dropped_series += 1
                return _NOOP
            series = self.series[values] = self._make_series()
        return series

    # label-less sugar: metric.inc()/set()/observe() on the () series
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_total(self, value: float) -> None:
        self.labels().set_total(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def remove(self, *values) -> None:
        """Drop one series (e.g. a disconnected worker's gauges)."""
        self.series.pop(tuple(str(v) for v in values), None)

    def clear(self) -> None:
        """Drop every series (values AND label sets)."""
        self.series.clear()

    def reset(self) -> None:
        for series in self.series.values():
            series.reset()

    # --- rendering ------------------------------------------------------
    def render(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.type}")
        for values in sorted(self.series):
            series = self.series[values]
            if self.type == "histogram":
                cumulative = 0
                for edge, n in zip(self.buckets, series.counts):
                    cumulative += n
                    labels = _labels_str(
                        self.label_names, values, f'le="{_format_value(float(edge))}"'
                    )
                    out.append(f"{self.name}_bucket{labels} {cumulative}")
                labels = _labels_str(self.label_names, values, 'le="+Inf"')
                out.append(f"{self.name}_bucket{labels} {series.count}")
                labels = _labels_str(self.label_names, values)
                out.append(f"{self.name}_sum{labels} {_format_value(series.sum)}")
                out.append(f"{self.name}_count{labels} {series.count}")
            else:
                labels = _labels_str(self.label_names, values)
                out.append(
                    f"{self.name}{labels} {_format_value(series.value)}"
                )


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._collect_hooks: list = []
        self.dropped_series = 0

    # --- registration (get-or-create; name is the identity) -------------
    def _get_or_create(self, name: str, help: str, type: str,
                       labels: tuple[str, ...], **kw) -> Metric:
        metric = self._metrics.get(name)
        if metric is not None:
            if metric.type != type:
                raise ValueError(
                    f"metric {name} already registered as {metric.type}"
                )
            return metric
        metric = Metric(
            name=name, help=help, type=type,
            label_names=tuple(labels), registry=self, **kw,
        )
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> Metric:
        return self._get_or_create(name, help, "counter", labels,
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> Metric:
        return self._get_or_create(name, help, "gauge", labels,
                                   max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  max_series: int = DEFAULT_MAX_SERIES) -> Metric:
        metric = self._get_or_create(name, help, "histogram", labels,
                                     buckets=tuple(buckets),
                                     max_series=max_series)
        return metric

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def add_collect_hook(self, fn) -> None:
        """fn() runs before every render/snapshot — the place to refresh
        gauges from live state (queue depths, watchdog counters, per-worker
        fan-out) without touching any hot path."""
        self._collect_hooks.append(fn)

    def remove_collect_hook(self, fn) -> None:
        if fn in self._collect_hooks:
            self._collect_hooks.remove(fn)

    def _collect(self) -> None:
        for fn in self._collect_hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 - a bad hook must not break scrapes
                logging.getLogger("hq.metrics").exception(
                    "metrics collect hook failed"
                )

    # --- output ---------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._collect()
        out: list[str] = []
        drops = self._metrics.get("hq_metrics_dropped_series_total")
        if self.dropped_series and drops is None:
            drops = self.counter(
                "hq_metrics_dropped_series_total",
                "label sets dropped by the per-metric cardinality cap",
            )
        if drops is not None:
            drops.labels().set_total(self.dropped_series)
        for name in sorted(self._metrics):
            self._metrics[name].render(out)
        return "\n".join(out) + "\n"

    def export_samples(self, prefix: str = "",
                       types: tuple[str, ...] = ("gauge", "counter"),
                       collect: bool = True) -> list[dict]:
        """JSON-safe scalar samples (no histograms), for piggybacking worker
        metrics on overview messages. Each: {name, type, labels, value} —
        deliberately NO help text: these ride on every overview of every
        worker and get journaled verbatim, so each repeated byte is journal
        growth and replay time."""
        if collect:
            self._collect()
        out = []
        for name in sorted(self._metrics):
            metric = self._metrics[name]
            if metric.type not in types or not name.startswith(prefix):
                continue
            for values, series in metric.series.items():
                out.append({
                    "name": name,
                    "type": metric.type,
                    "labels": dict(zip(metric.label_names, values)),
                    "value": series.value,
                })
        return out

    def snapshot(self) -> dict:
        """Full JSON-ready dump (histograms included) for debug RPCs."""
        self._collect()
        out: dict = {}
        for name in sorted(self._metrics):
            metric = self._metrics[name]
            series_out = []
            for values, series in sorted(metric.series.items()):
                entry: dict = {"labels": dict(zip(metric.label_names, values))}
                if metric.type == "histogram":
                    entry["count"] = series.count
                    entry["sum"] = round(series.sum, 6)
                    entry["buckets"] = dict(
                        zip((str(b) for b in metric.buckets), series.counts)
                    )
                else:
                    entry["value"] = series.value
                series_out.append(entry)
            out[name] = {"type": metric.type, "series": series_out}
        return out

    def reset(self) -> None:
        """Zero every series value (registrations and label sets survive so
        module-level instrument handles stay valid). The benchmark hook:
        reset, run a steady-state window, scrape."""
        for metric in self._metrics.values():
            metric.reset()
        self.dropped_series = 0


# process-wide registry (one server or worker per process, like TRACER)
REGISTRY = MetricsRegistry()
