"""Fleet aggregation plane (the port's copy of the JAX package's
`client/fleet.py`): the layer that makes N federated
shards operable as ONE cluster.

A federation is N server shards behind client-side routing, lease-fenced
failover and cross-shard worker lending, but every observability surface
of a server is per shard: each shard its own subscribe feed, its own
metrics port, its own trace store. This module is the fan-in:

``FleetFeed`` — one ``subscribe`` stream per live shard (via the
access-record machinery: every reconnect re-reads the shard's access
record, so a failed-over shard's successor is found automatically),
merged into a single arrival-ordered feed of frames tagged with a
``shard`` dimension. Shard death is ROUTINE here: a dead feed emits a
``shard-down`` marker and keeps re-resolving until the successor answers
(``shard-up``) — consumers render DOWN rows, they never crash.

``build_fleet_exposition`` / ``run_metrics_proxy`` — the metrics
federation endpoint (`hq fleet metrics-proxy --port P`): one scrape
fans out to every shard (the ``metrics_render`` RPC over the client
plane — no per-shard --metrics-port wiring needed), re-labels each
exposition with ``shard="K"`` and merges them
(utils/metrics.py relabel/merge helpers), plus a synthesized
``hq_federation_shard_up{shard=...}`` row per shard so a dead shard is
VISIBLE to scrapers instead of silently absent.

``export_fleet_trace`` — `hq fleet trace-export <out.json>`: one
Perfetto timeline with a row group per shard (ticks + solver rows from
each shard's flight recorder, boot/promotion instants from its journal's
``server-uid`` lineage, lending moves from the structured
``lent_to``/``lent_from`` worker events, and elasticity verdicts from
the ``alloc_events`` RPC).

Consumers: `hq top` against a federation root (client/top.py fleet
view), the metrics proxy, and — by design — a future fleet-level
autoscaler/policy loop, which reads exactly this feed.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path

from hyperqueue_tpu_torch.utils import clock, serverdir

logger = logging.getLogger("hq.fleet")

#: how long a dead shard feed waits before re-resolving the access record
RETRY_DELAY_SECS = 1.0


def shard_count_of(root: Path) -> int:
    """The federation's shard count; raises ValueError for a classic
    (non-federated) server dir — fleet surfaces are federation-only."""
    fed = serverdir.load_federation(Path(root))
    if fed is None:
        raise ValueError(
            f"no federation at {root} (fleet commands need a federation "
            "root; against a classic server use the per-server commands)"
        )
    return int(fed["shard_count"])


class FleetFeed:
    """Multi-shard subscribe fan-in: one feed thread per shard, one
    arrival-ordered output queue.

    Emitted frames (all carry ``"shard": k``):

    - ``{"op": "shard-up", "shard": k}`` — the shard's subscribe stream
      is live (emitted on every successful (re)connect, including the
      failover successor coming up).
    - ``{"op": "shard-down", "shard": k, "error": str}`` — the feed
      died; emitted once per transition, then the thread keeps
      re-resolving the access record until the shard (or its successor)
      answers.
    - ``{"op": "sample", "shard": k, ...}`` — the shard's metric sample
      (server/bootstrap.py _build_sample, federation block included).
    - ``{"op": "events", "shard": k, "records": [...]}`` — coalesced
      lifecycle events; each record also gains ``"shard": k`` so flat
      consumers need no frame context.
    """

    def __init__(self, root: Path, sample_interval: float = 1.0,
                 filters: tuple = (), overviews: bool = False,
                 retry_delay: float = RETRY_DELAY_SECS,
                 buffer: int = 65536):
        self.root = Path(root)
        self.shard_count = shard_count_of(self.root)
        self.sample_interval = sample_interval
        self.filters = tuple(filters)
        self.overviews = overviews
        self.retry_delay = retry_delay
        # bounded: a stalled consumer drops the OLDEST frames per shard
        # rather than growing without bound (mirrors the server-side
        # per-subscriber bound; samples are periodic so staleness heals)
        self._queue: queue.Queue = queue.Queue(maxsize=max(buffer, 256))
        self.states: dict[int, str] = {
            k: "connecting" for k in range(self.shard_count)
        }
        self.last_sample: dict[int, dict | None] = {
            k: None for k in range(self.shard_count)
        }
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # per-shard cross-thread cancellers (see connection.subscribe
        # on_connected): stop() fires them to wake feeds parked in the
        # stream's blocking recv
        self._cancellers: dict[int, object] = {}

    # --- feed threads ---------------------------------------------------
    def _put(self, frame: dict) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(frame, timeout=0.2)
                return
            except queue.Full:
                # shed the oldest frame; the feed must never wedge on a
                # slow consumer (the server-side contract, client-side)
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass

    def _feed(self, shard_id: int) -> None:
        from hyperqueue_tpu_torch.client import connection

        shard_dir = serverdir.shard_path(self.root, shard_id)
        while not self._stop.is_set():
            dropped = False
            try:
                for frame in connection.subscribe(
                    shard_dir,
                    filters=self.filters,
                    sample_interval=self.sample_interval,
                    overviews=self.overviews,
                    on_connected=(
                        lambda c: self._cancellers.__setitem__(shard_id, c)
                    ),
                ):
                    if self._stop.is_set():
                        return
                    op = frame.get("op")
                    if op == "sub_live":
                        self.states[shard_id] = "up"
                        self._put({"op": "shard-up", "shard": shard_id})
                        continue
                    if op == "sub_dropped":
                        dropped = True
                        break
                    if op == "sample":
                        frame = dict(frame)
                        frame["shard"] = shard_id
                        self.last_sample[shard_id] = frame
                        self._put(frame)
                        continue
                    if op == "events":
                        records = [
                            {**rec, "shard": shard_id}
                            for rec in frame.get("records") or ()
                        ]
                        self._put({
                            "op": "events", "shard": shard_id,
                            "records": records,
                        })
                error = "stream ended"
            except Exception as e:  # noqa: BLE001 - shard down is routine
                error = str(e) or type(e).__name__
            if self._stop.is_set():
                return
            if dropped:
                # this CONSUMER fell behind the server's bounded queue —
                # the shard is healthy; resubscribe without a (false)
                # DOWN transition
                continue
            if self.states[shard_id] != "down":
                self.states[shard_id] = "down"
                self.last_sample[shard_id] = None
                self._put({
                    "op": "shard-down", "shard": shard_id, "error": error,
                })
            # re-resolve from scratch after a beat: subscribe() re-reads
            # the access record per connect, so a promoted successor's
            # fresh instance dir is picked up here
            self._stop.wait(self.retry_delay)

    # --- lifecycle ------------------------------------------------------
    def start(self) -> "FleetFeed":
        for k in range(self.shard_count):
            t = threading.Thread(
                target=self._feed, args=(k,), daemon=True,
                name=f"hq-fleet-feed-{k}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # wake feed threads parked in the subscribe stream's blocking
        # recv — without this the shard connections (sockets + server
        # subscriber slots) would linger until the next frame arrives
        for cancel in list(self._cancellers.values()):
            try:
                cancel()
            except Exception:  # noqa: BLE001 - loop may already be closed
                pass
        # wake any consumer parked in frames(timeout=None): the feed
        # threads stop producing after the event is set, so without a
        # sentinel a cross-thread stop() would leave the consumer
        # blocked in queue.get() forever
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # a full queue wakes the consumer by itself

    def __enter__(self) -> "FleetFeed":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def frames(self, timeout: float | None = None):
        """Generator over the merged feed (arrival order). With
        ``timeout``, stops yielding after that many seconds of silence
        — the scriptable/testing bound."""
        while not self._stop.is_set():
            try:
                frame = self._queue.get(timeout=timeout)
            except queue.Empty:
                return
            if frame is None:
                return  # stop() sentinel
            yield frame

    def __iter__(self):
        return self.frames()


def fleet_snapshot(root: Path, timeout: float = 10.0,
                   sample_interval: float = 0.5) -> dict[int, dict | None]:
    """One sample per shard (None for a DOWN shard): drives
    ``hq top --once`` against a federation root and the fleet e2e
    asserts. Waits until every shard has either delivered a sample or
    been marked down, bounded by ``timeout``."""
    feed = FleetFeed(root, sample_interval=sample_interval)
    deadline = clock.monotonic() + timeout
    decided: dict[int, dict | None] = {}
    with feed:
        while (
            len(decided) < feed.shard_count
            and clock.monotonic() < deadline
        ):
            try:
                frame = feed._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if frame is None:
                continue  # stop() sentinel
            op = frame.get("op")
            if op == "sample":
                decided[frame["shard"]] = frame
            elif op == "shard-down":
                decided.setdefault(frame["shard"], None)
    for k in range(feed.shard_count):
        decided.setdefault(k, None)
    return decided


# ------------------------------------------------------- metrics federation
def _scrape_shard(root: Path, shard_id: int,
                  retry_window: float = 2.0) -> str:
    """One shard's Prometheus exposition via the metrics_render RPC
    (client plane — works without any per-shard --metrics-port)."""
    from hyperqueue_tpu_torch.client.connection import ClientSession

    shard_dir = serverdir.shard_path(Path(root), shard_id)
    with ClientSession(shard_dir, retry_window=retry_window) as session:
        return session.request({"op": "metrics_render"})["text"]


def _compose_exposition(texts: dict[str, str], up: dict[int, int]) -> str:
    """Merge per-shard expositions under the ``shard`` label and append
    the synthesized ``hq_federation_shard_up`` block. Shards' own copies
    of shard_up (a --failover-watch peer exports shard-labelled rows)
    are excluded — scrape success is the proxy's authoritative signal
    and the injected label must never collide with an existing one."""
    from hyperqueue_tpu_torch.utils.metrics import merge_expositions

    body = merge_expositions(
        texts, exclude=frozenset({"hq_federation_shard_up"})
    ) if texts else ""
    up_lines = [
        "# HELP hq_federation_shard_up 1 when the shard answered the "
        "fleet scrape, 0 when it is down (the proxy synthesizes this "
        "row so dead shards stay visible)",
        "# TYPE hq_federation_shard_up gauge",
    ] + [
        f'hq_federation_shard_up{{shard="{k}"}} {v}'
        for k, v in sorted(up.items())
    ]
    return body + "\n".join(up_lines) + "\n"


def build_fleet_exposition(root: Path, retry_window: float = 2.0) -> str:
    """The federated scrape body: every live shard's exposition under a
    ``shard`` label, merged per metric, plus one synthesized
    ``hq_federation_shard_up{shard=...}`` sample per shard — 0 rows make
    dead shards VISIBLE to scrapers (the per-shard
    ``hq_federation_lease_age_seconds`` gauge vanishes exactly when the
    shard dies, which is when you need the signal)."""
    from concurrent.futures import ThreadPoolExecutor

    n = shard_count_of(root)

    def one(k: int) -> str | None:
        try:
            return _scrape_shard(root, k, retry_window)
        except Exception as e:  # noqa: BLE001 - DOWN shards are the point
            logger.debug("shard %d scrape failed: %s", k, e)
            return None

    # scrapes are blocking client RPCs — run them in parallel so one
    # slow/dead shard costs one retry window, not a serial sum
    with ThreadPoolExecutor(max_workers=max(n, 1)) as pool:
        results = list(pool.map(one, range(n)))
    texts = {str(k): t for k, t in enumerate(results) if t is not None}
    up = {k: int(t is not None) for k, t in enumerate(results)}
    return _compose_exposition(texts, up)


async def start_metrics_proxy(root: Path, port: int,
                              host: str = "0.0.0.0",
                              retry_window: float = 2.0):
    """Serve GET /metrics answering with the merged fleet exposition
    (build_fleet_exposition off-loop — its internal scrape fan-out is
    parallel, so one slow/dead shard costs one retry window, not a
    serial sum). Returns (asyncio server, bound port) — port 0 binds
    ephemeral."""
    import asyncio

    from hyperqueue_tpu_torch.utils.metrics import start_exposition_server

    async def fleet_text() -> str:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, build_fleet_exposition, root, retry_window
        )

    return await start_exposition_server(fleet_text, port, host)


def run_metrics_proxy(root: Path, port: int, host: str = "0.0.0.0") -> None:
    """`hq fleet metrics-proxy`: blocking serve loop (Ctrl-C to stop)."""
    import asyncio

    async def main():
        server, bound = await start_metrics_proxy(root, port, host)
        print(
            f"fleet metrics proxy on http://{host}:{bound}/metrics "
            f"({shard_count_of(root)} shard(s) at {root})",
            flush=True,
        )
        async with server:
            await server.serve_forever()

    asyncio.run(main())


# ----------------------------------------------------------- trace export
#: pid block per shard in the merged Perfetto export: shard k's
#: per-shard export pids (0 = server row, 1 = solver row) land at
#: BASE*k + pid, the fleet annotation row at BASE*k + 90
_PID_STRIDE = 100
_ANNOT_PID = 90


def _shard_trace_events(root: Path, k: int,
                        retry_window: float) -> tuple[list[dict], bool]:
    """One shard's contribution to the fleet timeline: (events, down).
    Runs on an executor thread — every shard collects concurrently, so a
    dead shard costs one retry window, not a serial sum (same contract
    as the metrics proxy)."""
    from hyperqueue_tpu_torch.client.connection import (
        ClientError,
        ClientSession,
        stream_events,
    )

    base = _PID_STRIDE * k
    apid = base + _ANNOT_PID
    events: list[dict] = [{
        "ph": "M", "pid": apid, "tid": 0, "name": "process_name",
        "args": {"name": f"shard {k}: fleet"},
    }]
    shard_dir = serverdir.shard_path(Path(root), k)
    try:
        with ClientSession(
            shard_dir, retry_window=retry_window
        ) as session:
            per_shard = session.request({"op": "trace_export"})
            for ev in per_shard.get("traceEvents") or ():
                ev = dict(ev)
                ev["pid"] = base + int(ev.get("pid", 0))
                if (
                    ev.get("ph") == "M"
                    and ev.get("name") == "process_name"
                ):
                    ev["args"] = {
                        "name": f"shard {k}: "
                        f"{(ev.get('args') or {}).get('name', '')}"
                    }
                events.append(ev)
            stats = session.request({"op": "server_stats"})
            fed = stats.get("federation") or {}
            events.append({
                "ph": "C", "pid": apid, "tid": 0,
                "ts": clock.now() * 1e6, "name": "lease_epoch",
                "args": {"epoch": fed.get("lease_epoch") or 0},
            })
            try:
                decisions = session.request(
                    {"op": "alloc_events"}
                ).get("decisions") or ()
            except ClientError:
                decisions = ()
            for d in decisions:
                events.append({
                    "ph": "i", "pid": apid, "tid": 2, "s": "t",
                    "ts": float(d.get("time", 0.0)) * 1e6,
                    "cat": "elasticity",
                    "name": f"{d.get('verdict')} ({d.get('reason')})",
                    "args": d,
                })
    except Exception as e:  # noqa: BLE001 - a DOWN shard stays a row
        events.append({
            "ph": "i", "pid": apid, "tid": 0, "s": "p",
            "ts": clock.now() * 1e6, "cat": "fleet",
            "name": f"shard {k} DOWN ({e})",
        })
        return events, True
    # journal history: boots/promotions + lending moves (bounded by
    # compaction; replay stops at the live marker)
    boots = 0
    try:
        for frame in stream_events(shard_dir, history=True):
            if frame.get("op") == "stream_live":
                break
            rec = frame.get("record") or {}
            kind = rec.get("event")
            ts = float(rec.get("time", 0.0)) * 1e6
            if kind == "server-uid":
                boots += 1
                events.append({
                    "ph": "i", "pid": apid, "tid": 0, "s": "p",
                    "ts": ts, "cat": "fleet",
                    "name": (
                        f"boot {boots} "
                        f"[{rec.get('server_uid', '')[:8]}]"
                        + (" (restore/promotion)" if boots > 1 else "")
                    ),
                })
            elif kind == "worker-lost" and rec.get("lent_to") is not None:
                events.append({
                    "ph": "i", "pid": apid, "tid": 1, "s": "t",
                    "ts": ts, "cat": "lend",
                    "name": (
                        f"lend worker {rec.get('id')} "
                        f"→ shard {rec['lent_to']}"
                    ),
                    "args": rec,
                })
            elif kind == "worker-connected" and rec.get(
                "lent_from"
            ) is not None:
                events.append({
                    "ph": "i", "pid": apid, "tid": 1, "s": "t",
                    "ts": ts, "cat": "lend",
                    "name": (
                        f"borrow worker {rec.get('id')} "
                        f"← shard {rec['lent_from']}"
                    ),
                    "args": rec,
                })
    except Exception as e:  # noqa: BLE001 - history is best-effort
        logger.debug("shard %d history scan failed: %s", k, e)
    return events, False


def export_fleet_trace(root: Path, retry_window: float = 2.0) -> dict:
    """One Perfetto (Chrome trace-event JSON) timeline for the whole
    fleet: a row group per shard — its scheduler tick row + solver row
    (the per-shard ``trace_export`` verbatim, pid-shifted), a fleet
    annotation row carrying boot/promotion instants (journal
    ``server-uid`` lineage), structured lending moves, and elasticity
    verdicts (``alloc_events``). DOWN shards contribute a named row with
    a DOWN marker instead of failing the export; shards are collected in
    parallel so dead ones cost one retry window, not a serial sum."""
    from concurrent.futures import ThreadPoolExecutor

    n = shard_count_of(root)
    events: list[dict] = []
    down: list[int] = []
    with ThreadPoolExecutor(max_workers=min(n, 16)) as pool:
        futures = [
            pool.submit(_shard_trace_events, root, k, retry_window)
            for k in range(n)
        ]
        for k, future in enumerate(futures):
            shard_events, shard_down = future.result()
            events.extend(shard_events)
            if shard_down:
                down.append(k)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"shards": n, "down": down},
    }
