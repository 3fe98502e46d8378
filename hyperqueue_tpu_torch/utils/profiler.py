"""Continuous profiling plane: a dependency-free sampling
profiler with per-plane CPU attribution.

A background daemon thread walks ``sys._current_frames()`` at a low,
configurable rate (``--profile-hz``, default ~19 Hz — deliberately prime
so the sampling beat cannot lock onto the scheduler's 10 ms cadence) and
folds every thread's stack into a bounded trie.  Threads self-register a
**plane label** at creation (``register_plane``) — reactor loop, journal
commit thread, fan-out senders, ingest thread, solve/watchdog thread,
worker runtime — so samples aggregate into per-plane CPU-share gauges
(``hq_profile_*``) next to the existing per-plane lag histograms.  Pool
threads that spawn lazily (ThreadPoolExecutor) are labelled by
thread-name prefix instead (``register_plane_prefix``).

Attribution is honest about blocking: ``sys._current_frames`` returns a
frame for every thread, parked or not, so a sample whose leaf frame is a
known wait site (``threading.py:wait``, ``selectors.py:select``,
``queue.py:get``, …) counts as *idle* — a plane's CPU share is its
active samples over the sampling window, not its thread count.

The profiler keeps a bounded ring of recent raw samples so the
stall detector can attach the stack burst from the exact window in which
the budget was blown (profile-on-stall), and renders flamegraph-
compatible folded stacks (``plane;frame;frame… count``) for
``hq server profile`` / ``hq fleet profile``.

Simulator contract (utils/clock.py): the sampler uses the REAL
``time.perf_counter``/``time.time`` only and refuses to start while a
simulated clock provider is installed — profiling is wall-clock
telemetry and must never perturb (or read) virtual time, so determinism
digests are bit-identical with profiling requested on or off.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

DEFAULT_HZ = 19.0
MAX_STACK_DEPTH = 48
TRUNCATED = "(truncated)"

# --- hq_profile_* instruments (docs/observability.md catalog) -----------
_PLANE_SHARE = REGISTRY.gauge(
    "hq_profile_plane_cpu_share",
    "CPU cores used by each plane over the sampling window "
    "(active samples / sampling passes; >1 on multi-threaded planes)",
    labels=("plane",), max_series=32,
)
_SAMPLES = REGISTRY.counter(
    "hq_profile_samples_total",
    "thread stack samples taken by the sampling profiler",
)
_THREADS = REGISTRY.gauge(
    "hq_profile_threads", "threads seen by the last sampling pass"
)
_TRIE_NODES = REGISTRY.gauge(
    "hq_profile_trie_nodes", "nodes held by the bounded folded-stack trie"
)
_TRIE_DROPPED = REGISTRY.counter(
    "hq_profile_trie_dropped_total",
    "stack frames folded into the (truncated) sink because the trie hit "
    "its node bound",
)


# --- plane registry -----------------------------------------------------
# thread ident -> plane label, written by the thread itself at creation;
# pool threads that spawn lazily match by name prefix instead
_plane_lock = threading.Lock()
_planes: dict[int, str] = {}
_prefixes: list[tuple[str, str]] = [
    ("hq-fanout", "fanout"),
    ("hq-journal", "journal"),
    ("hq-ingest", "ingest"),
    ("hq-solve", "solve"),
    ("hq-device", "solve"),
    ("hq-runner", "runner"),
]


def register_plane(label: str, ident: int | None = None) -> None:
    """Label the calling thread (or ``ident``) as one CPU plane. Call at
    thread entry; a restarted thread re-registers and simply overwrites."""
    with _plane_lock:
        _planes[ident if ident is not None else threading.get_ident()] = label


def unregister_plane(ident: int | None = None) -> None:
    with _plane_lock:
        _planes.pop(
            ident if ident is not None else threading.get_ident(), None
        )


def register_plane_prefix(prefix: str, label: str) -> None:
    """Name-prefix fallback for lazily-spawned pool threads
    (ThreadPoolExecutor names its workers ``<prefix>_N`` at first use,
    long after the pool object existed to register anything)."""
    with _plane_lock:
        for i, (p, _) in enumerate(_prefixes):
            if p == prefix:
                _prefixes[i] = (prefix, label)
                return
        _prefixes.append((prefix, label))


def plane_of(ident: int, name: str) -> str:
    with _plane_lock:
        label = _planes.get(ident)
        if label is not None:
            return label
        for prefix, plane in _prefixes:
            if name.startswith(prefix):
                return plane
    return "other"


def registered_planes() -> dict[int, str]:
    with _plane_lock:
        return dict(_planes)


# --- idle classification ------------------------------------------------
# leaf (file basename, function) pairs that mean "parked, not on-CPU":
# sys._current_frames returns blocked threads too, and a profiler that
# counted a selector sleep as reactor CPU would report 100% everywhere
_WAIT_LEAVES = frozenset({
    ("threading.py", "wait"),
    ("threading.py", "_wait_for_tstate_lock"),
    ("selectors.py", "select"),
    ("queue.py", "get"),
    ("socket.py", "accept"),
    ("socket.py", "recv_into"),
    ("ssl.py", "read"),
    ("subprocess.py", "_try_wait"),
    ("connection.py", "poll"),
    ("popen_fork.py", "poll"),
    ("selector_events.py", "sock_recv"),
})


def is_wait_leaf(filename: str, funcname: str) -> bool:
    return (os.path.basename(filename), funcname) in _WAIT_LEAVES


# --- bounded folded trie ------------------------------------------------
class FoldedTrie:
    """Per-plane stack counts as a bounded trie.

    Nodes are ``{frame_label: [count, children_dict]}``. Once the node
    budget is spent, unseen frames fold into a shared ``(truncated)``
    child per level instead of allocating — long-tail stacks degrade to a
    coarser prefix, memory stays O(max_nodes) forever."""

    def __init__(self, max_nodes: int = 20_000):
        self.max_nodes = max(int(max_nodes), 64)
        self.root: dict = {}
        self.nodes = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def fold(self, plane: str, frames: tuple[str, ...], n: int = 1) -> None:
        """Count one stack (root-first frame labels) under ``plane``."""
        with self._lock:
            children = self.root
            for label in (plane, *frames):
                node = children.get(label)
                if node is None:
                    if self.nodes >= self.max_nodes:
                        self.dropped += 1
                        label = TRUNCATED
                        node = children.get(label)
                        if node is None:
                            # the sink node itself is pre-budgeted: there
                            # is always room for one per level
                            node = children[label] = [0, {}]
                            self.nodes += 1
                        node[0] += n
                        return
                    node = children[label] = [0, {}]
                    self.nodes += 1
                children = node[1]
            node[0] += n

    def counts(self) -> dict[str, int]:
        """``"plane;frame;frame" -> count`` for every counted stack."""
        out: dict[str, int] = {}
        with self._lock:
            stack = [("", self.root)]
            while stack:
                path, children = stack.pop()
                for label, (count, kids) in children.items():
                    key = f"{path};{label}" if path else label
                    if count:
                        out[key] = out.get(key, 0) + count
                    if kids:
                        stack.append((key, kids))
        return out

    def clear(self) -> None:
        with self._lock:
            self.root = {}
            self.nodes = 0
            self.dropped = 0


def render_folded(counts: dict[str, int]) -> str:
    """Flamegraph-compatible folded text: one ``stack count`` per line,
    sorted for stable goldens."""
    return "".join(
        f"{stack} {count}\n" for stack, count in sorted(counts.items())
    )


def diff_counts(after: dict[str, int],
                before: dict[str, int]) -> dict[str, int]:
    """Window view between two cumulative ``counts()`` snapshots."""
    out = {}
    for stack, count in after.items():
        d = count - before.get(stack, 0)
        if d > 0:
            out[stack] = d
    return out


# --- the sampler --------------------------------------------------------
class SamplingProfiler:
    """Background ``sys._current_frames()`` sampler.

    ``publish=True`` (the process singleton) feeds the ``hq_profile_*``
    gauges through a registry collect hook; throwaway instances (tests,
    the ``hq server profile`` burst path on a ``--profile-hz 0`` server)
    keep the registry untouched."""

    def __init__(self, hz: float = DEFAULT_HZ, max_nodes: int = 20_000,
                 ring_capacity: int = 4096, publish: bool = False):
        self.hz = float(hz)
        self.trie = FoldedTrie(max_nodes)
        self.publish = publish
        self.passes = 0
        self.samples = 0
        # rolling ~5 s of per-pass {plane: [samples, active]} for the
        # "current" CPU-share gauges; cumulative totals live in the trie
        self._window: deque = deque(
            maxlen=max(16, min(int(self.hz * 5) or 16, 512))
        )
        # recent raw samples (wall_time, plane, folded_stack, active) —
        # the profile-on-stall burst source
        self.ring: deque = deque(maxlen=ring_capacity)
        self._label_cache: dict = {}
        self._threads_seen = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._hook = None

    # --- lifecycle ------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Start sampling; refuses (returns False) under a simulated
        clock — the profiler is real-wall-clock telemetry and must stay
        inert inside the deterministic simulator."""
        if self.hz <= 0 or clock.is_simulated():
            return False
        if self.running:
            return True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hq-profiler", daemon=True
        )
        self._thread.start()
        if self.publish and self._hook is None:
            self._hook = self._publish
            REGISTRY.add_collect_hook(self._hook)
        return True

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        if self._hook is not None:
            REGISTRY.remove_collect_hook(self._hook)
            self._hook = None

    def reset(self) -> None:
        """Clear every aggregate (the `hq server reset-metrics`
        convention: a steady-state window must not inherit startup CPU)."""
        self.trie.clear()
        self._window.clear()
        self.ring.clear()
        self.passes = 0
        self.samples = 0

    # --- sampling loop --------------------------------------------------
    def _loop(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        next_at = time.perf_counter() + interval
        while not self._stop.is_set():
            delay = next_at - time.perf_counter()
            if delay > 0:
                # Event.wait, not time.sleep: stop() interrupts mid-nap
                if self._stop.wait(delay):
                    break
            next_at = max(next_at + interval, time.perf_counter())
            try:
                self.sample_once(skip={own})
            except Exception:  # noqa: BLE001 - sampling must never kill
                pass           # the process it observes

    def sample_once(self, skip: set[int] | None = None) -> int:
        """One sampling pass over every live thread; returns samples
        taken. Public so tests can drive deterministic passes."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        now = time.time()
        pass_stats: dict[str, list] = {}
        taken = 0
        for ident, frame in frames.items():
            if skip and ident in skip:
                continue
            labels, leaf_file, leaf_func = self._walk(frame)
            plane = plane_of(ident, names.get(ident, ""))
            active = not is_wait_leaf(leaf_file, leaf_func)
            self.trie.fold(plane, labels)
            stat = pass_stats.setdefault(plane, [0, 0])
            stat[0] += 1
            stat[1] += int(active)
            self.ring.append((now, plane, ";".join(labels), active))
            taken += 1
        self._window.append(pass_stats)
        self._threads_seen = taken
        self.passes += 1
        self.samples += taken
        if self.publish:
            _SAMPLES.labels().inc(taken)
        return taken

    def _walk(self, frame) -> tuple[tuple[str, ...], str, str]:
        """Root-first frame labels plus the leaf (file, func) pair."""
        cache = self._label_cache
        rev = []
        leaf_code = frame.f_code
        depth = 0
        while frame is not None and depth < MAX_STACK_DEPTH:
            code = frame.f_code
            label = cache.get(code)
            if label is None:
                base = os.path.basename(code.co_filename)
                if base.endswith(".py"):
                    base = base[:-3]
                label = cache[code] = f"{base}.{code.co_name}"
            rev.append(label)
            frame = frame.f_back
            depth += 1
        rev.reverse()
        return tuple(rev), leaf_code.co_filename, leaf_code.co_name

    # --- views ----------------------------------------------------------
    def plane_shares(self) -> dict[str, dict]:
        """Per-plane sample counts + CPU share over the rolling window."""
        window = list(self._window)
        if not window:
            return {}
        out: dict[str, dict] = {}
        for pass_stats in window:
            for plane, (n, active) in pass_stats.items():
                agg = out.setdefault(
                    plane, {"samples": 0, "active": 0, "cpu": 0.0}
                )
                agg["samples"] += n
                agg["active"] += active
        passes = len(window)
        for agg in out.values():
            agg["cpu"] = round(agg["active"] / passes, 4)
        return out

    def snapshot(self) -> dict:
        return {
            "enabled": self.running,
            "hz": self.hz,
            "passes": self.passes,
            "samples": self.samples,
            "threads": self._threads_seen,
            "window_passes": len(self._window),
            "planes": self.plane_shares(),
            "trie": {
                "nodes": self.trie.nodes,
                "max_nodes": self.trie.max_nodes,
                "dropped": self.trie.dropped,
            },
        }

    def folded_counts(self) -> dict[str, int]:
        return self.trie.counts()

    def folded(self) -> str:
        return render_folded(self.folded_counts())

    def stall_burst(self, window_s: float, limit: int = 40) -> list[dict]:
        """Aggregated stacks sampled in the trailing ``window_s`` — the
        profile-on-stall attachment: what every plane was executing while
        the budget was being blown."""
        cutoff = time.time() - max(window_s, 0.0)
        agg: dict[tuple[str, str, bool], int] = {}
        for t, plane, stack, active in reversed(self.ring):
            if t < cutoff:
                break
            key = (plane, stack, active)
            agg[key] = agg.get(key, 0) + 1
        rows = [
            {"plane": plane, "stack": stack, "active": active, "count": n}
            for (plane, stack, active), n in agg.items()
        ]
        rows.sort(key=lambda r: (-r["count"], r["plane"], r["stack"]))
        return rows[:limit]

    def counter_track(self, bucket_s: float = 0.5) -> dict[str, list]:
        """Per-plane (wall_time, cores) series bucketed from the sample
        ring — the Perfetto counter track for `hq server trace export`."""
        per_bucket: dict[str, dict[float, int]] = {}
        for t, plane, _stack, active in self.ring:
            if not active:
                continue
            bucket = round(t - (t % bucket_s), 3)
            per_bucket.setdefault(plane, {})
            per_bucket[plane][bucket] = per_bucket[plane].get(bucket, 0) + 1
        expected = max(self.hz * bucket_s, 1e-9)
        return {
            plane: sorted(
                (t, round(n / expected, 4)) for t, n in buckets.items()
            )
            for plane, buckets in per_bucket.items()
        }

    # --- metrics --------------------------------------------------------
    def _publish(self) -> None:
        _PLANE_SHARE.clear()
        for plane, agg in self.plane_shares().items():
            _PLANE_SHARE.labels(plane).set(agg["cpu"])
        _THREADS.set(self._threads_seen)
        _TRIE_NODES.set(self.trie.nodes)
        _TRIE_DROPPED.labels().set_total(self.trie.dropped)


# --- process singleton --------------------------------------------------
# one server or worker per process (like REGISTRY / TRACER); the CLI's
# --profile-hz lands here through start_profiler
PROFILER = SamplingProfiler(publish=True)


def start_profiler(hz: float = DEFAULT_HZ) -> bool:
    """Configure + start the process profiler (idempotent); False when
    profiling is off (hz <= 0) or a simulated clock is installed."""
    if hz <= 0:
        return False
    if PROFILER.running:
        return True
    PROFILER.hz = float(hz)
    PROFILER._window = deque(
        maxlen=max(16, min(int(hz * 5) or 16, 512))
    )
    return PROFILER.start()


def stop_profiler() -> None:
    PROFILER.stop()
