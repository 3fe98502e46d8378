"""Span tracing around hot runtime phases.

Reference: crates/tako/src/internal/common/trace.rs:1-33 — `trace_time!`
wraps a block in a ScopedTimer that emits start/end tracing events; the
scheduler wraps its whole tick in one (scheduler/main.rs:49). Python
tracing emits are comparatively expensive, so this tracer keeps rolling
per-span statistics (count/total/max/last) plus a small ring of recent
spans in-process, logs each span at DEBUG like the reference's events, and
surfaces the aggregate through `snapshot()`. It holds only spans that no
other record measures: the workers' answers between ticks (`answers`)
and the collector's passes (`gc/gen0`-`gc/gen2`); the tick's own phases
live in `core.tick_stats` and `hq_tick_phase_seconds`.

The detailed timeline (`timeline_on`, `Ranges`) follows a torch profiler:
while one records in the process, the tick's phases, the answers' sums
and the collector's passes are also put on the profiler's clock.

`LagTracker` keeps the server event loop's per-plane lag histograms.
"""

from __future__ import annotations

import gc
import logging
import secrets
import sys
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from hyperqueue_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger("hq.trace")

# every span doubles as a histogram series in the metrics plane: the rolling
# SpanStats keep the debug-dump shape, the histogram adds the percentile
# view Prometheus consumers need (utils/metrics.py)
_SPAN_SECONDS = REGISTRY.histogram(
    "hq_span_seconds",
    "duration of traced runtime spans (utils/trace.py TRACER)",
    labels=("span",),
)


@dataclass(slots=True)
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    last_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt
        self.last_s = dt


@dataclass
class Tracer:
    stats: dict[str, SpanStats] = field(default_factory=dict)
    recent: deque = field(default_factory=lambda: deque(maxlen=256))

    def record(self, name: str, dt: float) -> None:
        """Record a measured duration directly (the `span` context manager
        for blocks that a `with` would force to re-indent)."""
        entry = self.stats.get(name)
        if entry is None:
            entry = self.stats[name] = SpanStats()
        entry.record(dt)
        _SPAN_SECONDS.labels(name).observe(dt)
        self.recent.append((name, dt))
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("span %s: %.3f ms", name, dt * 1000)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def snapshot(self, recent: int = 16) -> dict:
        """JSON-ready per-span statistics (+ the most recent spans, for
        "what just happened" debugging) for the debug dump."""
        out = {
            name: {
                "count": s.count,
                "total_ms": round(s.total_s * 1000, 3),
                "mean_ms": round(s.total_s / s.count * 1000, 4),
                "max_ms": round(s.max_s * 1000, 3),
                "last_ms": round(s.last_s * 1000, 4),
            }
            for name, s in sorted(self.stats.items())
        }
        if recent:
            out["_recent"] = [
                [name, round(dt * 1000, 4)]
                for name, dt in list(self.recent)[-recent:]
            ]
        return out

    def reset(self) -> None:
        self.stats.clear()
        self.recent.clear()
        _SPAN_SECONDS.reset()


# process-wide tracer (one server or worker per process)
TRACER = Tracer()
span = TRACER.span


# ----------------------------------------------------------------------
# The detailed timeline: on only while a torch profiler records in this
# process (an operator's `torch.profiler` capture, the benchmark's traced
# run). No flag or environment variable turns it on.
# ----------------------------------------------------------------------


def timeline_on() -> bool:
    """True while a torch profiler records in this process. Reads the
    profiler's process-wide flag, so it holds on every thread (the C++
    `_profiler_enabled()` answers for the calling thread only)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False  # no torch, no profiler
    return bool(torch.autograd.profiler._is_profiler_enabled)


class Ranges:
    """`torch.profiler.record_function` ranges opened and closed by name,
    for phases that a `with` block would force to re-indent. A profiler
    records the ranges of the threads it was started on; a profiler with
    `profile_all_threads` also those of the solve's thread."""

    __slots__ = ("_open",)

    def __init__(self):
        self._open: dict = {}

    def begin(self, name: str) -> None:
        import torch

        rf = torch.profiler.record_function(name)
        rf.__enter__()
        self._open[name] = rf

    def end(self, name: str) -> None:
        rf = self._open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


class _NoRanges:
    __slots__ = ()

    def begin(self, name: str) -> None: ...
    def end(self, name: str) -> None: ...


NO_RANGES = _NoRanges()


def ranges(on: bool | None = None):
    """A fresh `Ranges` while the timeline is on, else the no-op one;
    `on` is the caller's reading of `timeline_on()` where it has one."""
    if on is None:
        on = timeline_on()
    return Ranges() if on else NO_RANGES


class GcPasses:
    """The collector's passes, timed on the real `time.perf_counter` (never
    a simulated clock) by one `gc.callbacks` hook a process.

    Each pass's ms is summed by where it fell (`place`: "tick" while
    `reactor.schedule` runs, "answers" inside a worker's answer while the
    timeline is on, else "other"), and passes and ms by generation.
    The passes wait in a bounded ring until `flush()` records them
    through `TRACER` as `gc/gen<n>`: the hook itself touches no shared
    dict that a collection could interrupt. While the timeline is on,
    each pass is also a profiler range of the same name."""

    def __init__(self, ring: int = 1024):
        self.installed = False
        self.place = "other"
        self.ms = {"tick": 0.0, "answers": 0.0, "other": 0.0}
        self.gen_ms = [0.0, 0.0, 0.0]
        self.gen_n = [0, 0, 0]
        self.pending: deque = deque(maxlen=ring)
        self._t0 = None
        self._ranges = NO_RANGES

    def install(self) -> None:
        if not self.installed:
            self.installed = True
            gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        gen = info["generation"]
        if phase == "start":
            self._t0 = time.perf_counter()
            self._ranges = ranges()
            self._ranges.begin(f"gc/gen{gen}")
            return
        t0 = self._t0
        if t0 is None:
            return
        dt = time.perf_counter() - t0
        self._t0 = None
        self._ranges.end(f"gc/gen{gen}")
        self.ms[self.place] += dt * 1e3
        self.gen_ms[gen] += dt * 1e3
        self.gen_n[gen] += 1
        self.pending.append((gen, dt))

    def totals(self) -> tuple:
        """(tick, answers, other ms; gen-0, gen-1, gen-2 ms; gen-0, gen-1,
        gen-2 passes) so far."""
        ms = self.ms
        return (ms["tick"], ms["answers"], ms["other"], *self.gen_ms,
                *self.gen_n)

    def flush(self) -> None:
        """Record the passes since the last flush through `TRACER`."""
        pending = self.pending
        while pending:
            gen, dt = pending.popleft()
            TRACER.record(f"gc/gen{gen}", dt)


# process-wide, like TRACER; `Core` installs its hook
GC_PASSES = GcPasses()


# ----------------------------------------------------------------------
# Distributed per-task traces.
#
# One trace follows a task from client submit through journal commit,
# solve/dispatch, worker spawn and completion uplink.  Identity is carried
# as a trace id (stamped at submit, journaled, preserved across restore
# and reattach) plus a parent span id on the control-plane messages
# (transport/framing.py attach_trace/read_trace).  Spans are assembled
# SERVER-side in this bounded store — workers only stamp wall clocks onto
# the messages they already send, so the hot dispatch path gains a couple
# of dict writes, never an extra message.
# ----------------------------------------------------------------------

# trace ids ride journal events, so a deterministic run (the simulator's
# bit-identical-journal regression) must be able to derive them from a
# seed instead of the OS entropy pool; production keeps secrets.token_hex
_token_source = secrets.token_hex


def set_token_source(source) -> object:
    """Swap the trace-id entropy source (``fn(nbytes) -> hex str``);
    returns the previous source.  None restores ``secrets.token_hex``."""
    global _token_source
    previous = _token_source
    _token_source = source if source is not None else secrets.token_hex
    return previous


def new_trace_id() -> str:
    return _token_source(8)


# span names, in causal order, for a task launched on a real worker; the
# trace-smoke gate asserts a completed trace contains REQUIRED_HOPS
SPAN_ORDER = (
    "client/submit",   # client send -> server receive (client-stamped)
    "server/submit",   # receive -> tasks built + journal commit
    "server/queue",    # ready -> assigned (scheduler backlog)
    "server/dispatch", # assigned -> worker accepted the compute message
    "worker/accept",   # accepted -> launch dispatched
    "worker/spawn",    # launch dispatched -> process spawned
    "worker/run",      # spawned -> exit
    "worker/uplink",   # completion enqueued -> server received it
    "server/commit",   # received -> state applied + journal commit
)
REQUIRED_HOPS = frozenset(SPAN_ORDER) - {"client/submit"}


class TaskTraceStore:
    """Bounded per-task causal traces (flight-recorder pattern:
    O(1) per span, hard memory bound regardless of uptime).

    One record per task: ``{"trace_id", "spans": [...], "done"}``.  Spans
    are closed intervals ``{"name", "t0", "t1", "proc", "instance", "id",
    "parent"}`` deduplicated on (name, instance) — a reattach or a journal
    replay re-reporting a hop must not double it (one timeline per
    task).  ``capacity=0`` disables the store entirely.

    Records may also carry fleet ``notes``: point annotations
    stamped by cross-shard machinery — a worker lend (home/host shard), a
    failover promotion (lease epoch) — deduplicated on their identity
    keys so a journal replay or reattach re-reporting one keeps a single
    annotation. They ride snapshots and restores with the spans.
    """

    #: keys that identify an annotation for dedup (everything except the
    #: wall stamp, which legitimately differs between live and replay)
    _NOTE_IDENTITY = ("kind", "instance", "worker", "home_shard",
                      "host_shard", "shard", "lease_epoch")

    def __init__(self, capacity: int = 16384):
        self.capacity = max(int(capacity), 0)
        self.enabled = self.capacity > 0
        self._traces: OrderedDict[int, dict] = OrderedDict()
        # closed task ids in close() order: the O(1) eviction feed (a
        # full-store scan per insert would make a 1M-task submit O(n*cap)
        # on the reactor loop); entries may be stale (already evicted or
        # re-seeded) and are validated when popped
        self._closed: deque = deque()
        self.evictions = 0
        self._span_counter = 0

    def __len__(self) -> int:
        return len(self._traces)

    def new_span_id(self) -> str:
        self._span_counter += 1
        return f"s{self._span_counter:x}"

    def begin(self, task_id: int, trace_id: str) -> dict | None:
        if not self.enabled:
            return None
        rec = self._traces.get(task_id)
        if rec is None:
            rec = {"trace_id": trace_id, "spans": [], "done": False}
            self._traces[task_id] = rec
            self._evict()
        return rec

    def seed(self, task_id: int, rec: dict) -> None:
        """Adopt a restored record (journal replay / snapshot restore)."""
        if not self.enabled or not isinstance(rec, dict):
            return
        done = bool(rec.get("done"))
        adopted = {
            "trace_id": rec.get("trace_id") or new_trace_id(),
            "spans": list(rec.get("spans") or ()),
            "done": done,
        }
        if rec.get("notes"):
            adopted["notes"] = [dict(n) for n in rec["notes"]]
        self._traces[task_id] = adopted
        self._traces.move_to_end(task_id)
        if done:
            self._closed.append(task_id)
        self._evict()

    def span(
        self,
        task_id: int,
        name: str,
        t0: float,
        t1: float,
        proc: str,
        instance: int = 0,
        parent: str | None = None,
    ) -> str | None:
        """Record one closed span; returns its id (None when disabled,
        deduplicated, or the stamps are unusable)."""
        if not self.enabled or not t0 or not t1:
            return None
        rec = self._traces.get(task_id)
        if rec is None:
            rec = self.begin(task_id, new_trace_id())
        for existing in rec["spans"]:
            if existing["name"] == name and existing["instance"] == instance:
                return existing["id"]  # reattach/replay duplicate
        span_id = self.new_span_id()
        rec["spans"].append({
            "name": name,
            "t0": t0,
            "t1": max(t1, t0),  # cross-process clock skew must not make a
            "proc": proc,       # span negative
            "instance": instance,
            "id": span_id,
            "parent": parent,
        })
        return span_id

    def annotate(self, task_id: int, note: dict) -> None:
        """Attach one fleet annotation ({"kind", ...}) to a task's trace.
        Idempotent on the note's identity keys — restore replay and
        reattach re-report the same lend/failover fact."""
        if not self.enabled:
            return
        rec = self._traces.get(task_id)
        if rec is None:
            return
        notes = rec.setdefault("notes", [])
        identity = tuple(note.get(k) for k in self._NOTE_IDENTITY)
        for existing in notes:
            if tuple(
                existing.get(k) for k in self._NOTE_IDENTITY
            ) == identity:
                return
        notes.append(dict(note))

    def annotate_open(self, note: dict) -> int:
        """Annotate every trace still open (not done) — the failover
        promotion stamp: each task that lived through the shard death
        carries the epoch it survived. Returns how many were stamped."""
        stamped = 0
        for task_id, rec in self._traces.items():
            if not rec["done"]:
                self.annotate(task_id, note)
                stamped += 1
        return stamped

    def get(self, task_id: int) -> dict | None:
        return self._traces.get(task_id)

    def trace_id(self, task_id: int) -> str | None:
        rec = self._traces.get(task_id)
        return rec["trace_id"] if rec is not None else None

    def last_span_id(self, task_id: int) -> str | None:
        rec = self._traces.get(task_id)
        if rec is None or not rec["spans"]:
            return None
        return rec["spans"][-1]["id"]

    def wire_ctx(self, task_id: int) -> tuple[str, str | None] | None:
        """(trace_id, last_span_id) in one lookup — the per-task dispatch
        hot path stamps this onto every compute message."""
        rec = self._traces.get(task_id)
        if rec is None:
            return None
        spans = rec["spans"]
        return rec["trace_id"], (spans[-1]["id"] if spans else None)

    def close(self, task_id: int) -> None:
        rec = self._traces.get(task_id)
        if rec is not None and not rec["done"]:
            rec["done"] = True
            self._closed.append(task_id)

    def snapshot_live(self, task_ids) -> dict:
        """{task_id: record} for the given (live) tasks — the piece of
        trace state a journal snapshot must carry so a snapshot-seeded
        restore keeps traces unbroken (the superseded journal prefix that
        held the submit/start events is GC'd).

        Records are COPIED (span dicts are append-only, so copying the
        list suffices): the snapshot payload is serialized on an executor
        thread while the reactor keeps appending spans, and every other
        capture_state field is freshly built for the same reason."""
        out = {}
        for tid in task_ids:
            rec = self._traces.get(tid)
            if rec is not None:
                copied = {
                    "trace_id": rec["trace_id"],
                    "spans": list(rec["spans"]),
                    "done": rec["done"],
                }
                if rec.get("notes"):
                    copied["notes"] = [dict(n) for n in rec["notes"]]
                out[tid] = copied
        return out

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "tasks": len(self._traces),
            "evictions": self.evictions,
            "spans": sum(len(r["spans"]) for r in self._traces.values()),
        }

    def _evict(self) -> None:
        while len(self._traces) > self.capacity:
            # prefer evicting closed traces (oldest-closed first, from the
            # O(1) feed); fall back to the oldest live one so the bound is
            # hard either way
            victim = None
            while self._closed:
                tid = self._closed.popleft()
                rec = self._traces.get(tid)
                if rec is not None and rec["done"]:
                    victim = tid
                    break
            if victim is None:
                victim = next(iter(self._traces))
            del self._traces[victim]
            self.evictions += 1


# ----------------------------------------------------------------------
# Reactor loop-lag tracking: per-plane histograms of how long
# each work class held the server's event loop, plus the loop's own
# sleep-overshoot.  The rolling SpanStats mirror the TRACER shape for
# `hq server stats`; the histogram feeds Prometheus.  The stall watchdog
# (server/bootstrap.py) compares each observation against --stall-budget.
# ----------------------------------------------------------------------

LAG_PLANES = (
    "rpc", "journal", "solve", "fanout", "completion", "ingest", "loop",
)

_REACTOR_LAG_SECONDS = REGISTRY.histogram(
    "hq_reactor_lag_seconds",
    "per-plane server latency: loop occupancy for in-loop work classes "
    "(rpc/solve/completion/ingest) and the loop's own sleep-overshoot "
    "(loop); for the off-loop planes (journal/fanout) the "
    "observation is HANDOFF latency — reactor enqueue to durable commit "
    "/ frame on the wire",
    labels=("plane",),
)


class LagTracker:
    """Rolling per-plane loop-occupancy statistics + the shared
    `hq_reactor_lag_seconds` histogram."""

    def __init__(self):
        self.stats: dict[str, SpanStats] = {}

    def observe(self, plane: str, dt: float) -> None:
        entry = self.stats.get(plane)
        if entry is None:
            entry = self.stats[plane] = SpanStats()
        entry.record(dt)
        _REACTOR_LAG_SECONDS.labels(plane).observe(dt)

    def snapshot(self) -> dict:
        return {
            plane: {
                "count": s.count,
                "total_ms": round(s.total_s * 1000, 3),
                "mean_ms": round(s.total_s / s.count * 1000, 4),
                "max_ms": round(s.max_s * 1000, 3),
                "last_ms": round(s.last_s * 1000, 4),
            }
            for plane, s in sorted(self.stats.items())
        }

    def reset(self) -> None:
        self.stats.clear()
        _REACTOR_LAG_SECONDS.reset()
