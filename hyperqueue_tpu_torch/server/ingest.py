"""Decoupled client-connection plane.

Client socket accept, framing, authentication (including the per-frame
ChaCha20-Poly1305 seal/open, which on the pure-python fallback costs ~6 us
per wire byte) and msgpack decode run on a DEDICATED thread with its own
asyncio loop — the first of the pipelined reactor planes. Decoded
messages cross into the scheduler reactor through a
batched handoff deque; responses and stream frames flow back through
per-connection outbound queues drained by a sender coroutine on this
thread. The reactor never touches a client socket, and a storm of
submitting clients costs it only the batched drain work (measured as the
`ingest` plane in the lag tracker).

Backpressure is two-level and applies to the READ side, so a flooding
client is parked on its own TCP connection instead of growing server
memory:

- per-client window: at most `window` handed-off, not-yet-answered
  requests per connection;
- global handoff bound: when the reactor falls behind and the handoff
  deque reaches `handoff_max` items, every reader pauses until the next
  drain.

Both stall events are counted in `hq_ingest_backpressure_stalls_total`.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time

from hyperqueue_tpu_torch.transport.auth import (
    ROLE_CLIENT,
    ROLE_SERVER,
    AuthError,
    do_authentication,
)
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger("hq.ingest")

# ingest-plane telemetry (single-writer per metric: chunk/task counters are
# bumped by the reactor at apply time, the stall counter by the ingest
# thread, depth/client gauges by the metrics collect hook)
INGEST_CHUNKS = REGISTRY.counter(
    "hq_ingest_chunks_total", "submit chunks ingested (streaming submit)"
)
INGEST_TASKS = REGISTRY.counter(
    "hq_ingest_tasks_total", "tasks ingested through the submit plane"
)
INGEST_REQUESTS = REGISTRY.counter(
    "hq_ingest_requests_total",
    "client requests handed from the connection plane to the reactor",
)
INGEST_STALLS = REGISTRY.counter(
    "hq_ingest_backpressure_stalls_total",
    "reads paused by the per-client window or the global handoff bound",
)

_CLOSE = object()  # outbound-queue sentinel: sender exits
# how long a stopping plane lets each connection's sender write the frames
# already queued (the `stop_server` answer among them) before it closes
# the connections
STOP_FLUSH_SECS = 1.0


class ClientChannel:
    """One authenticated client connection, as seen by the reactor.

    Socket-side state (outq, resume event, inflight counter) lives on the
    ingest loop; `reply`/`stream_send`/`kick` are the thread-safe surface
    the reactor uses. `gone` is an Event on the REACTOR loop, set by the
    drain loop when the disconnect notification crosses the handoff — it
    is what terminates streaming RPC handlers.
    """

    _next_id = 0

    def __init__(self, plane: "IngestPlane", conn):
        ClientChannel._next_id += 1
        self.id = ClientChannel._next_id
        self.plane = plane
        self.conn = conn
        # outbound frames; bounded so a dead-slow streaming consumer
        # backpressures the reactor-side streaming task (stream_send
        # awaits space) instead of buffering the whole journal
        self.outq: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self.resume = asyncio.Event()
        self.resume.set()
        self.inflight = 0
        self.closed = False
        self.is_gone = False       # set by the reactor drain loop
        self.gone: asyncio.Event | None = None  # reactor-loop event
        # streaming task (subscribe/stream_events) bound to this channel,
        # cancelled when the disconnect notification arrives
        self.stream_task = None

    # --- reactor-side API ------------------------------------------------
    def reply(self, frame: dict) -> None:
        """Queue a request/response frame (thread-safe, non-blocking).
        Bounded by the inflight window: there can never be more pending
        replies than handed-off requests."""
        try:
            self.plane.loop.call_soon_threadsafe(self._deliver, frame)
        except RuntimeError:
            pass  # ingest loop already shut down

    async def stream_send(self, frame: dict) -> None:
        """Send one streaming frame, awaiting outbound-queue space (used
        by subscribe/stream_events handlers on the reactor loop)."""
        if self.is_gone or self.closed:
            raise ConnectionError("client disconnected")
        try:
            fut = asyncio.run_coroutine_threadsafe(
                self.outq.put(frame), self.plane.loop
            )
        except RuntimeError as e:
            raise ConnectionError("connection plane stopped") from e
        await asyncio.wrap_future(fut)

    def close(self) -> None:
        """Close the connection (thread-safe; used by the reactor after a
        streaming handler finishes — request/response channels are closed
        by the client side)."""
        def _do() -> None:
            self.closed = True
            self.conn.close()

        try:
            self.plane.loop.call_soon_threadsafe(_do)
        except RuntimeError:
            pass

    def reactor_gone_event(self) -> asyncio.Event:
        """The disconnect event, created lazily ON the reactor loop."""
        if self.gone is None:
            self.gone = asyncio.Event()
            if self.is_gone:
                self.gone.set()
        return self.gone

    # --- ingest-loop internals -------------------------------------------
    def _deliver(self, frame: dict) -> None:
        self.inflight -= 1
        self.resume.set()
        if self.closed:
            return
        try:
            self.outq.put_nowait(frame)
        except asyncio.QueueFull:
            # only possible if the peer stopped reading while hammering
            # requests; drop the connection rather than buffer unboundedly
            logger.warning("client %d outbound queue overflow; closing",
                           self.id)
            self.closed = True
            self.conn.close()


class IngestPlane:
    """The client-plane thread: accept/auth/decode + batched handoff."""

    def __init__(self, key_getter, window: int = 64,
                 handoff_max: int = 8192, sendpool=None):
        self.key_getter = key_getter
        # shared fan-out sender pool (server/fanout.py): client response/
        # stream frames (subscriber fan-out included) encode+seal on the
        # pool's threads instead of this plane's loop; None/disabled =
        # inline encode on this thread (still off the reactor)
        self.sendpool = sendpool
        self.window = max(int(window), 1)
        self.handoff_max = max(int(handoff_max), self.window)
        self.handoff: collections.deque = collections.deque()
        self.loop: asyncio.AbstractEventLoop | None = None
        self.port: int | None = None
        self.clients: set[ClientChannel] = set()
        self._thread: threading.Thread | None = None
        self._server = None
        self._drained: asyncio.Event | None = None   # ingest-loop event
        self._reactor_loop: asyncio.AbstractEventLoop | None = None
        self._wake_cb = None
        self._stopping = False

    # --- lifecycle -------------------------------------------------------
    def start(self, host: str, port: int, reactor_loop, wake_cb) -> int:
        """Bind the client listener on the plane thread; returns the bound
        port. `wake_cb` is called (threadsafe, on the reactor loop) after
        every handoff append."""
        self._reactor_loop = reactor_loop
        self._wake_cb = wake_cb
        started = threading.Event()
        boot: dict = {}

        def run() -> None:
            from hyperqueue_tpu_torch.utils import profiler

            # sampling-profiler plane label: connection-plane
            # CPU (framing, decode, backpressure) attributes to `ingest`
            profiler.register_plane("ingest")
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self.loop = loop
            self._drained = asyncio.Event()

            async def bind():
                try:
                    self._server = await asyncio.start_server(
                        self._serve_client, host, port
                    )
                    boot["port"] = (
                        self._server.sockets[0].getsockname()[1]
                    )
                except Exception as e:  # noqa: BLE001 - surfaced to start()
                    boot["error"] = e
                finally:
                    started.set()

            loop.run_until_complete(bind())
            if "error" in boot:
                loop.close()
                profiler.unregister_plane()
                return
            try:
                loop.run_forever()
            finally:
                # cancel leftovers so close doesn't warn
                for task in asyncio.all_tasks(loop):
                    task.cancel()
                try:
                    loop.run_until_complete(
                        loop.shutdown_asyncgens()
                    )
                except Exception:  # noqa: BLE001
                    pass
                loop.close()
                profiler.unregister_plane()

        self._thread = threading.Thread(
            target=run, name="hq-ingest", daemon=True
        )
        self._thread.start()
        started.wait()
        if "error" in boot:
            raise boot["error"]
        self.port = boot["port"]
        return self.port

    def stop(self) -> None:
        self._stopping = True
        loop = self.loop
        if loop is None:
            return

        async def shutdown() -> None:
            if self._server is not None:
                self._server.close()
            # the replies queued before the stop reach their clients
            # first: a client whose `stop_server` answer is lost retries
            # against a server that is gone, and fails
            flushes = [asyncio.ensure_future(channel.outq.join())
                       for channel in self.clients if not channel.closed]
            if flushes:
                _done, late = await asyncio.wait(flushes,
                                                 timeout=STOP_FLUSH_SECS)
                for fut in late:
                    fut.cancel()
            for channel in list(self.clients):
                channel.closed = True
                channel.conn.close()
            loop.stop()

        def begin() -> None:
            asyncio.ensure_future(shutdown())

        try:
            loop.call_soon_threadsafe(begin)
        except RuntimeError:
            return
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # --- reactor-side API ------------------------------------------------
    def pop_batch(self, limit: int) -> list:
        out = []
        while self.handoff and len(out) < limit:
            out.append(self.handoff.popleft())
        return out

    def notify_drained(self) -> None:
        """Reactor drained a batch: lift the global backpressure gate."""
        loop = self.loop
        if loop is None:
            return
        try:
            loop.call_soon_threadsafe(self._drained.set)
        except RuntimeError:
            pass

    # --- ingest-loop internals -------------------------------------------
    def _wake_reactor(self) -> None:
        try:
            self._reactor_loop.call_soon_threadsafe(self._wake_cb)
        except RuntimeError:
            pass

    async def _serve_client(self, reader, writer) -> None:
        channel = None
        try:
            conn = await do_authentication(
                reader, writer, ROLE_SERVER, ROLE_CLIENT, self.key_getter()
            )
            channel = ClientChannel(self, conn)
            self.clients.add(channel)
            sender = asyncio.ensure_future(self._sender(channel))
            try:
                while True:
                    msg = await conn.recv()
                    # backpressure BEFORE the handoff: park this reader
                    # while its window is exhausted or the reactor is
                    # behind on the global queue
                    while channel.inflight >= self.window:
                        INGEST_STALLS.inc()
                        channel.resume.clear()
                        if channel.inflight >= self.window:
                            await channel.resume.wait()
                    while len(self.handoff) >= self.handoff_max:
                        INGEST_STALLS.inc()
                        self._drained.clear()
                        if len(self.handoff) >= self.handoff_max:
                            await self._drained.wait()
                    channel.inflight += 1
                    INGEST_REQUESTS.inc()
                    self.handoff.append((channel, msg))
                    self._wake_reactor()
            finally:
                sender.cancel()
                try:
                    await sender
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
        except (
            AuthError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ) as e:
            logger.debug("client connection ended: %s", e)
        except Exception:  # noqa: BLE001 - one bad client never kills the plane
            logger.exception("client connection crashed")
        finally:
            if channel is not None:
                channel.closed = True
                self.clients.discard(channel)
                if not self._stopping:
                    # tell the reactor so it tears down subscriptions and
                    # sets channel.gone for streaming handlers
                    self.handoff.append((channel, None))
                    self._wake_reactor()
            writer.close()

    async def _sender(self, channel: ClientChannel) -> None:
        conn = channel.conn
        pool = self.sendpool
        while True:
            frame = await channel.outq.get()
            try:
                if frame is _CLOSE:
                    return
                if pool is not None and pool.enabled:
                    t0 = time.perf_counter()
                    data = await pool.encode(self.loop, conn, frame)
                    await conn.send_bytes(data)
                    pool.note_send(1, len(data), time.perf_counter() - t0)
                else:
                    await conn.send(frame)
            except (ConnectionError, OSError):
                channel.closed = True
                conn.close()
                return
            finally:
                # counted out of the queue once written (or dropped), so a
                # stopping plane can wait for what was queued before it
                channel.outq.task_done()
