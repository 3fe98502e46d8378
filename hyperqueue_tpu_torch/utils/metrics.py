"""Process-wide metrics plane: registry, instruments, Prometheus exposition.

Reference: the reference factors every hot phase behind `trace_time!` spans
plus a dashboard event stream; production schedulers (Gavel, arXiv:2008.09213)
additionally presuppose scrapeable per-phase latency and utilization
telemetry. This module is the dependency-free substrate: counters, gauges and
fixed-bucket histograms with label support, rendered in the Prometheus text
exposition format (0.0.4) over a minimal asyncio HTTP endpoint
(`--metrics-port` on server and worker, off by default).

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
  ``snapshot()``/``export_samples()`` produce JSON-safe forms so worker
  metrics can piggyback on overview messages and the server can re-export a
  cluster-wide view with a ``worker`` label.
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



# ---------------------------------------------------------------- scrape I/O
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


async def start_exposition_server(render, port: int, host: str = "0.0.0.0",
                                  probes: dict | None = None):
    """Serve GET /metrics on (host, port), answering with render()'s text
    (render may be sync or async). Returns (asyncio server, bound port) —
    pass port 0 for an ephemeral port (tests/CI).

    ``probes`` maps extra paths (``/healthz``, ``/readyz``) to callables
    returning ``(ok, detail_dict)``; they answer 200/503 with a JSON body
    (the health plane). Probes served off the same loop as the
    process's reactor are truthful by construction: a wedged loop cannot
    answer at all, which is the failure an orchestrator treats as down.

    Deliberately minimal HTTP/1.0-style handling: read the request head,
    answer one response, close. A metrics endpoint needs no keep-alive, no
    TLS, no routing beyond /metrics and the probe paths."""
    import asyncio
    import inspect
    import json

    async def handle(reader, writer):
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if not line.strip():
                    break
            parts = request.split()
            path = parts[1].decode("latin-1") if len(parts) > 1 else "/"
            path = path.split("?")[0]
            if probes and path in probes:
                try:
                    ok, detail = probes[path]()
                except Exception:  # noqa: BLE001 - a broken check IS unready
                    ok, detail = False, {"error": "probe raised"}
                body = (
                    json.dumps({"ok": bool(ok), **(detail or {})},
                               sort_keys=True) + "\n"
                ).encode("utf-8")
                status = "200 OK" if ok else "503 Service Unavailable"
                head = (
                    f"HTTP/1.1 {status}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                )
            elif path in ("/", "/metrics"):
                text = render()
                if inspect.isawaitable(text):
                    text = await text
                body = text.encode("utf-8")
                head = (
                    "HTTP/1.1 200 OK\r\n"
                    f"Content-Type: {CONTENT_TYPE}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                )
            else:
                body = b"not found\n"
                head = (
                    "HTTP/1.1 404 Not Found\r\n"
                    "Content-Type: text/plain\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                )
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    server = await asyncio.start_server(handle, host, port)
    bound = server.sockets[0].getsockname()[1]
    return server, bound


async def start_metrics_server(registry: MetricsRegistry, port: int,
                               host: str = "0.0.0.0",
                               probes: dict | None = None):
    """Serve a registry's exposition on (host, port); see
    start_exposition_server."""
    return await start_exposition_server(registry.render, port, host,
                                         probes=probes)


def probe(host: str, port: int, path: str = "/readyz",
          timeout: float = 5.0) -> tuple[int, dict]:
    """Blocking one-shot health-probe request (test/bench helper).
    Returns (http_status, parsed JSON body) — unlike :func:`scrape` a
    503 is a RESULT here, not an error."""
    import json
    import socket

    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode("latin-1")
        )
        chunks = []
        while True:
            data = sock.recv(65536)
            if not data:
                break
            chunks.append(data)
    raw = b"".join(chunks)
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0].split()
    status = int(status_line[1]) if len(status_line) > 1 else 0
    try:
        payload = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        payload = {}
    return status, payload


def scrape(host: str, port: int, timeout: float = 5.0) -> str:
    """Blocking one-shot scrape of a metrics endpoint (bench/test helper;
    no client library required)."""
    import socket

    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(
            f"GET /metrics HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode("latin-1")
        )
        chunks = []
        while True:
            data = sock.recv(65536)
            if not data:
                break
            chunks.append(data)
    raw = b"".join(chunks)
    head, _, body = raw.partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/1.1 200"):
        raise ConnectionError(
            f"metrics scrape failed: {head.splitlines()[0:1]}"
        )
    return body.decode("utf-8")


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text format into {name: {type, samples}} where
    samples is {(sample_name, frozenset(labels.items())): value}. Used by
    the golden/e2e tests and `bench.py --metrics` — a real parser would be
    a dependency; this handles exactly what `render` emits."""
    out: dict = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            types[name] = mtype
            out.setdefault(name, {"type": mtype, "samples": {}})
            continue
        if line.startswith("#"):
            continue
        # sample: name{labels} value
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_raw, _, value = rest.rpartition("} ")
            labels = {}
            # label values produced by render never contain unescaped
            # commas inside quotes in our usage; keep the split simple but
            # honor escaped quotes
            for part in _split_labels(labels_raw):
                k, _, v = part.partition("=")
                labels[k] = _unescape_label_value(v.strip('"'))
        else:
            name, _, value = line.rpartition(" ")
            labels = {}
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in types:
                base = base[: -len(suffix)]
                break
        entry = out.setdefault(
            base, {"type": types.get(base, "untyped"), "samples": {}}
        )
        entry["samples"][(name, frozenset(labels.items()))] = float(value)
    return out


def _unescape_label_value(value: str) -> str:
    """Inverse of _escape_label_value, processed left-to-right in ONE pass:
    chained str.replace would misread an escaped backslash followed by `n`
    (the sequence \\\\n) as an escaped newline."""
    out: list[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _split_labels(raw: str) -> list[str]:
    parts, buf, in_quotes, escaped = [], [], False, False
    for ch in raw:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
            buf.append(ch)
            continue
        if ch == "," and not in_quotes:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


def relabel_exposition(text: str, label: str, value: str) -> list[tuple]:
    """Parse one Prometheus text exposition into
    ``[(metric_name, help_line, type_line, [sample_line, ...]), ...]``
    with ``label="value"`` injected into every sample line.

    This is the fleet metrics proxy's building block: each
    shard's exposition is re-labelled with its shard id, then
    ``merge_expositions`` regroups the per-shard fragments so every
    metric's samples sit under ONE HELP/TYPE header (the text format
    forbids a metric appearing twice). Text-level on purpose — values
    round-trip byte-exact, no float re-formatting."""
    groups: list[tuple] = []
    current: list | None = None
    types: dict[str, str] = {}
    injected = f'{label}="{_escape_label_value(value)}"'
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name = line.split(None, 3)[2]
            current = [name, line, None, []]
            groups.append(current)
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            types[name] = mtype
            if current is None or current[0] != name:
                current = [name, None, line, []]
                groups.append(current)
            else:
                current[2] = line
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            head, rest = line.split("{", 1)
            line = f"{head}{{{injected}," + rest
        else:
            sample_name, _, sample_value = line.rpartition(" ")
            line = f"{sample_name}{{{injected}}} {sample_value}"
        # _bucket/_sum/_count samples belong to their histogram's group
        sample_base = line.split("{", 1)[0]
        base = sample_base
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in types:
                base = base[: -len(suffix)]
                break
        if current is None or current[0] != base:
            current = next((g for g in groups if g[0] == base), None)
            if current is None:
                current = [base, None, None, []]
                groups.append(current)
        current[3].append(line)
    return [tuple(g) for g in groups]


def merge_expositions(shard_texts: dict[str, str],
                      label: str = "shard",
                      exclude: frozenset = frozenset()) -> str:
    """One fleet-wide exposition from per-shard scrapes: every sample
    gains ``label="<shard>"`` and same-named metrics across shards merge
    under a single HELP/TYPE header (required by the text format). Shard
    order in the dict decides whose HELP text wins ties (they are
    identical across shards in practice). ``exclude`` drops metrics the
    caller synthesizes itself (the proxy's shard_up rows — a shard
    running a --failover-watch scan exports its OWN shard-labelled
    copies, which would collide with the injected label)."""
    merged: dict[str, list] = {}
    for shard, text in shard_texts.items():
        for name, help_line, type_line, samples in relabel_exposition(
            text, label, str(shard)
        ):
            if name in exclude:
                continue
            entry = merged.get(name)
            if entry is None:
                entry = merged[name] = [help_line, type_line, []]
            else:
                entry[0] = entry[0] or help_line
                entry[1] = entry[1] or type_line
            entry[2].extend(samples)
    out: list[str] = []
    for name in sorted(merged):
        help_line, type_line, samples = merged[name]
        if help_line:
            out.append(help_line)
        if type_line:
            out.append(type_line)
        out.extend(samples)
    return "\n".join(out) + "\n"


def histogram_summary(parsed: dict, name: str) -> dict:
    """Per-label-set {count, sum, mean, p50~, p95~, max_bucket} summary of a
    parsed histogram — percentile estimates from the cumulative bucket
    counts (upper bucket edge of the quantile's bucket). Feeds
    `bench.py --metrics` and `hq job timeline`-adjacent tooling."""
    entry = parsed.get(name)
    if not entry or entry["type"] != "histogram":
        return {}
    # regroup samples by label set (minus `le`)
    series: dict = {}
    for (sample, labels), value in entry["samples"].items():
        base_labels = frozenset(
            (k, v) for k, v in labels if k != "le"
        )
        bucket = series.setdefault(
            base_labels, {"buckets": [], "sum": 0.0, "count": 0.0}
        )
        le = dict(labels).get("le")
        if sample.endswith("_bucket") and le is not None:
            edge = float("inf") if le == "+Inf" else float(le)
            bucket["buckets"].append((edge, value))
        elif sample.endswith("_sum"):
            bucket["sum"] = value
        elif sample.endswith("_count"):
            bucket["count"] = value
    out = {}
    for base_labels, data in series.items():
        buckets = sorted(data["buckets"])
        count = data["count"]

        def quantile(q):
            if not count:
                return 0.0
            target = q * count
            for edge, cumulative in buckets:
                if cumulative >= target:
                    return edge
            return buckets[-1][0] if buckets else 0.0

        key = ",".join(
            f"{k}={v}" for k, v in sorted(base_labels)
        ) or "_"

        def finite(edge):
            # JSON-safe: the +Inf bucket becomes null ("beyond the largest
            # finite bucket") instead of json.dumps's non-RFC Infinity
            return edge if edge != float("inf") else None

        out[key] = {
            "count": int(count),
            "sum": round(data["sum"], 6),
            "mean": round(data["sum"] / count, 6) if count else 0.0,
            "p50_le": finite(quantile(0.50)),
            "p95_le": finite(quantile(0.95)),
        }
    return out
