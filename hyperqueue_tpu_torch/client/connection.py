"""Synchronous client connection for CLI commands.

Each CLI invocation opens one authenticated connection on the client plane
(reference client/mod.rs does the same via its async runtime).

Connection failures get bounded retry with jittered exponential backoff so
CLI commands ride out a server restart window instead of failing on the
first refused connect. The access record is re-read from the server dir on
every attempt — a restarted server publishes a NEW instance dir with fresh
ports and keys, so a cached record would retry against a dead address
forever. The window is HQ_CLIENT_RETRY_SECS (default 15; 0 disables).

Caveat (documented, deliberate): a request whose connection dies after the
send is retried against the new connection, so a non-idempotent request
(submit) can be applied twice if the dying server already processed it —
the at-least-once window every ack-less RPC has.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from pathlib import Path

from hyperqueue_tpu_torch.transport.auth import (
    ROLE_CLIENT,
    ROLE_SERVER,
    do_authentication,
)
from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.utils.retry import jittered_backoff
from hyperqueue_tpu_torch.utils import clock

def _env_retry_secs() -> float:
    raw = os.environ.get("HQ_CLIENT_RETRY_SECS", "15")
    try:
        return float(raw)
    except ValueError:
        import logging

        logging.getLogger("hq.client").warning(
            "ignoring malformed HQ_CLIENT_RETRY_SECS=%r; using 15", raw
        )
        return 15.0


_BACKOFF_BASE = 0.2
_BACKOFF_CAP = 2.0
# per-attempt bound on connect+auth: a wedged-but-listening server (a
# SIGSTOPped federation shard awaiting its fence, a paused VM) accepts
# the TCP handshake and then never answers the auth exchange — without
# this the client hangs forever instead of retrying against the fresh
# access record a failover successor publishes
_HANDSHAKE_TIMEOUT = 10.0

# transient transport failures worth retrying; AuthError and malformed
# access records are NOT here — retrying a bad key never helps.
# asyncio.TimeoutError covers the per-attempt handshake bound above
# (it subclasses OSError on 3.11+, listed explicitly for older runtimes)
_RETRIABLE = (ConnectionError, OSError, asyncio.IncompleteReadError,
              asyncio.TimeoutError)


class ClientError(Exception):
    """Server-reported error. `code`/`owner` carry the machine-readable
    half of coded errors (ISSUE 17): code="wrong-shard" + owner=<shard>
    is the redirect hint a federated client retries on; code="migrating"
    means the job is sealed mid-move — retry shortly."""

    code: str | None = None
    owner: int | None = None


class ClientSession:
    """Sync facade: runs its own event loop for request/response exchanges.

    `retry_window`: seconds to keep retrying transient connection failures
    (None = HQ_CLIENT_RETRY_SECS; 0 = fail on the first error, used by
    callers with their own polling loop like `hq server wait`).
    """

    def __init__(self, server_dir: Path, retry_window: float | None = None):
        self.server_dir = Path(server_dir)
        # env read per session, not at import: long-lived embedders (API
        # client, tests) may set HQ_CLIENT_RETRY_SECS after the module is
        # first imported
        self.retry_window = (
            _env_retry_secs() if retry_window is None else retry_window
        )
        self._rng = random.Random()
        self.access = None
        self._loop = asyncio.new_event_loop()
        try:
            self._conn = self._loop.run_until_complete(
                self._connect_with_retry()
            )
        except BaseException:
            self._loop.close()
            raise

    async def _connect(self):
        # re-load per attempt: a restarted server means a new instance dir
        # (new ports AND new plane keys)
        self.access = serverdir.load_access(self.server_dir)
        if not self.access.client_port:
            raise RuntimeError(
                "access record has no client plane (worker-only split file?)"
            )
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                self.access.host, self.access.client_port
            ),
            timeout=_HANDSHAKE_TIMEOUT,
        )
        try:
            return await asyncio.wait_for(
                do_authentication(
                    reader,
                    writer,
                    ROLE_CLIENT,
                    ROLE_SERVER,
                    self.access.client_key_bytes(),
                ),
                timeout=_HANDSHAKE_TIMEOUT,
            )
        except BaseException:
            # a failed handshake must not leak its socket — the retry loop
            # can make a dozen attempts per CLI call during a restart
            # (BaseException also covers the wait_for cancellation)
            writer.close()
            raise

    def _retries_exhausted(self, deadline: float) -> bool:
        return self.retry_window <= 0 or clock.monotonic() >= deadline

    async def _connect_with_retry(self, deadline: float | None = None):
        # `deadline` lets request() span ONE retry window across its
        # send/reconnect cycles instead of granting each reconnect a fresh
        # window (which would stack to a multiple of HQ_CLIENT_RETRY_SECS)
        if deadline is None:
            deadline = clock.monotonic() + self.retry_window
        delay = _BACKOFF_BASE
        while True:
            try:
                return await self._connect()
            except FileNotFoundError:
                # no access record: distinguish "no server was ever started
                # / it stopped cleanly" (no hq-current symlink — fail fast
                # with the clear message) from "a new instance dir is being
                # published right now" (symlink flipped, access file lands
                # a moment later — a genuine restart window, retry)
                if not (
                    self.server_dir / serverdir.CURRENT_LINK
                ).is_symlink():
                    raise
                if self._retries_exhausted(deadline):
                    raise
            except _RETRIABLE:
                if self._retries_exhausted(deadline):
                    raise
            sleep_for, delay = jittered_backoff(
                delay, _BACKOFF_CAP, self._rng,
                remaining=deadline - clock.monotonic(),
            )
            await asyncio.sleep(sleep_for)

    def request(self, msg: dict, timeout: float | None = None) -> dict:
        async def go():
            await self._conn.send(msg)
            return await self._conn.recv()

        deadline = clock.monotonic() + self.retry_window
        while True:
            coro = asyncio.wait_for(go(), timeout) if timeout else go()
            try:
                response = self._loop.run_until_complete(coro)
                break
            except asyncio.TimeoutError:
                # the caller's per-request deadline — never retried (on
                # 3.11+ TimeoutError subclasses OSError, so this must be
                # caught BEFORE the retriable set)
                raise
            except _RETRIABLE:
                if self._retries_exhausted(deadline):
                    raise
                # server restart window: reconnect (fresh access record)
                # and re-send — the reconnect shares THIS request's
                # deadline, so the whole exchange stays bounded by one
                # retry window
                self._conn.close()
                self._conn = self._loop.run_until_complete(
                    self._connect_with_retry(deadline=deadline)
                )
        if isinstance(response, dict) and response.get("op") == "error":
            err = ClientError(response.get("message", "server error"))
            err.code = response.get("code")
            err.owner = response.get("owner")
            raise err
        return response

    def close(self) -> None:
        self._conn.close()
        self._loop.run_until_complete(self._conn.wait_closed())
        self._loop.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FederatedSession:
    """The federated client session (per-shard routing and fan-out over a
    federation root) comes with the federation plane; the name stays so
    that imports resolve."""

    def __init__(self, server_dir: Path, retry_window: float | None = None,
                 shard_count: int | None = None):
        raise NotImplementedError(
            f"federated sessions come with {serverdir.ITEM_10}"
        )


def open_session(server_dir: Path, retry_window: float | None = None):
    """ClientSession for a classic server dir — the CLI's one entry point.
    A federation root refuses (load_federation names item 10)."""
    serverdir.load_federation(Path(server_dir))
    return ClientSession(server_dir, retry_window=retry_window)


class SubmitStream:
    """Pipelined chunked submit over one ClientSession (ISSUE 10).

    Chunks are tagged with (stream uid, chunk index) and sent without
    waiting for each response; the client keeps a bounded in-flight
    window (HQ_SUBMIT_WINDOW, default 8) and reads per-chunk acks as the
    window fills — so a giant array streams to the server at pipeline
    speed with bounded memory on BOTH ends.

    Exactly-once across failures: on a transport error (server restart
    window) the stream reconnects through the session's retry machinery
    and re-sends every unacked chunk. The server deduplicates on
    (uid, index) — journaled with each chunk — so replayed chunks yield
    idempotent duplicate acks, never duplicate tasks. After the first ack
    the job id is pinned into the header, so chunks replayed against a
    restored server land on the SAME job.

    `n_tasks` is the stream's acknowledged task coverage (counted from
    the chunks themselves, so a chunk whose first ack was lost and whose
    replay acked `dup` still counts once); `dup_chunks` counts acks the
    server deduplicated.
    """

    def __init__(self, session: ClientSession, header: dict,
                 window: int | None = None, uid: str | None = None):
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        self.session = session
        self.header = dict(header)
        if window is None:
            try:
                window = int(os.environ.get("HQ_SUBMIT_WINDOW", "8"))
            except ValueError:
                window = 8
        self.window = max(window, 1)
        self.uid = uid or new_trace_id()
        self.job_id: int | None = None
        self.n_tasks = 0
        self.dup_chunks = 0
        self._next_index = 0
        self._unacked: dict[int, dict] = {}
        self._sealed = False

    # --- wire helpers (session-loop, with reconnect + replay) -----------
    def _replay_unacked(self) -> None:
        for i in sorted(self._unacked):
            frame = self._unacked[i]
            if self.job_id is not None:
                frame["job"]["job_id"] = self.job_id
            self.session._loop.run_until_complete(
                self.session._conn.send(frame)
            )

    def _recover(self, deadline: float) -> None:
        """Reconnect and replay every unacked chunk, retrying the whole
        sequence (a second connection flap mid-replay must keep retrying
        within the SAME window, not abort the stream)."""
        while True:
            if self.session._retries_exhausted(deadline):
                raise ConnectionError(
                    "submit stream: retry window exhausted"
                )
            self.session._conn.close()
            self.session._conn = self.session._loop.run_until_complete(
                self.session._connect_with_retry(deadline=deadline)
            )
            try:
                self._replay_unacked()
                return
            except _RETRIABLE:
                continue

    def _with_retry(self, op) -> dict | None:
        """Run one recv step; on a transport error reconnect + replay the
        unacked chunks, then retry the step. (Sends do NOT use this — a
        replay already re-sends the failed frame, so retrying the send
        itself would put a duplicate on the wire whose extra ack desyncs
        the session's request/response protocol.)"""
        deadline = clock.monotonic() + self.session.retry_window
        while True:
            try:
                return self.session._loop.run_until_complete(op())
            except _RETRIABLE:
                self._recover(deadline)

    def _recv_ack(self) -> None:
        async def step():
            return await self.session._conn.recv()

        ack = self._with_retry(step)
        if not isinstance(ack, dict) or ack.get("op") == "error":
            msg = (ack or {}).get("message", "server error")
            err = ClientError(msg)
            if isinstance(ack, dict):
                err.code = ack.get("code")
                err.owner = ack.get("owner")
            raise err
        index = ack["i"]
        frame = self._unacked.pop(index, None)
        if self.job_id is None:
            self.job_id = ack["job_id"]
            self.header["job_id"] = self.job_id
        if ack.get("dup"):
            self.dup_chunks += 1
        # count tasks from the FRAME on its first ack, not from the
        # server's n_tasks field: a chunk applied before a connection
        # drop acks `dup` (n_tasks=0) on the replay, and the stream's
        # total must still cover it
        if frame is not None:
            self.n_tasks += _frame_task_count(frame)

    def _send_frame(self, frame: dict) -> None:
        while len(self._unacked) >= self.window:
            self._recv_ack()
        self._unacked[frame["i"]] = frame
        try:
            self.session._loop.run_until_complete(
                self.session._conn.send(frame)
            )
        except _RETRIABLE:
            # the frame is already in _unacked: recovery's replay sends
            # it exactly once on the new connection — do NOT also retry
            # the send (the extra duplicate would earn an extra ack that
            # finish() never drains, desyncing the session)
            self._recover(clock.monotonic() + self.session.retry_window)

    # --- public API -------------------------------------------------------
    def send_chunk(self, array: dict | None = None,
                   tasks: list | None = None, last: bool = False) -> None:
        """Queue one chunk: an array description ({"id_range": [lo, hi)}
        or {"ids": [...]} plus shared body/request/...) or a graph task
        list. Blocks only while the in-flight window is full."""
        if self._sealed:
            raise ClientError("submit stream already finished")
        from hyperqueue_tpu_torch.transport.framing import attach_trace
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        frame: dict = {
            "op": "submit_chunk",
            "uid": self.uid,
            "i": self._next_index,
            "rid": self._next_index,
            "job": dict(self.header),
        }
        if array is not None:
            frame["array"] = array
        if tasks is not None:
            frame["tasks"] = tasks
        if last:
            frame["last"] = True
            self._sealed = True
        attach_trace(frame, new_trace_id(), sent_at=clock.now())
        self._next_index += 1
        self._send_frame(frame)

    def finish(self) -> tuple[int, int]:
        """Seal the stream (empty final chunk if none was marked last),
        drain every outstanding ack, and return (job_id, n_tasks)."""
        if not self._sealed:
            self.send_chunk(last=True)
        while self._unacked:
            self._recv_ack()
        return self.job_id, self.n_tasks


def _frame_task_count(frame: dict) -> int:
    """Tasks carried by one submit_chunk frame (client-side count for the
    stream total — independent of whether the server ack was a dup)."""
    array = frame.get("array")
    if array:
        id_range = array.get("id_range")
        if id_range is not None:
            return int(id_range[1]) - int(id_range[0])
        return len(array.get("ids") or ())
    return len(frame.get("tasks") or ())


def _resolve_stream_dir(server_dir: Path, shard: int = 0) -> Path:
    """Streaming surfaces (journal stream, dashboard, subscribe) attach
    to ONE server; a federation root, whose shards each stream their own
    lineage, refuses until the federation plane is ported (item 10)."""
    serverdir.load_federation(Path(server_dir))
    return Path(server_dir)


def _streaming_request(server_dir: Path, request: dict, on_subscribed=None,
                       shard: int = 0, on_connected=None):
    """One authenticated client connection turned into a frame generator:
    send `request`, yield every received frame until the server closes or
    the consumer breaks out. Blocking-recv based (read_frame is not
    cancellation-safe, so no wait_for timeouts may wrap it).
    on_subscribed, when given, is called once the request is on the wire —
    before the first frame is read. on_connected, when given, receives a
    zero-arg CANCELLER safe to call from another thread: it schedules a
    connection close on this generator's loop, waking the blocked recv
    (how FleetFeed.stop() unwedges its feed threads)."""
    server_dir = _resolve_stream_dir(server_dir, shard)

    async def _connect():
        access = serverdir.load_access(Path(server_dir))
        reader, writer = await asyncio.open_connection(
            access.host, access.client_port
        )
        conn = await do_authentication(
            reader, writer, ROLE_CLIENT, ROLE_SERVER, access.client_key_bytes()
        )
        await conn.send(request)
        return conn

    loop = asyncio.new_event_loop()
    conn = None
    try:
        # bound the connect+auth+send preamble like ClientSession does (a
        # wedged server must not hang the stream consumer forever); the
        # recv loop below legitimately blocks between frames
        conn = loop.run_until_complete(
            asyncio.wait_for(_connect(), _HANDSHAKE_TIMEOUT)
        )
        if on_connected is not None:
            on_connected(lambda: loop.call_soon_threadsafe(conn.close))
        if on_subscribed is not None:
            on_subscribed()
        while True:
            yield loop.run_until_complete(conn.recv())
    finally:
        # the consumer may break out of the generator at any point
        # (dashboard quit, Ctrl-C in `hq journal stream`): close the
        # authenticated connection before the loop, or the socket leaks
        if conn is not None:
            try:
                conn.close()
                loop.run_until_complete(conn.wait_closed())
            except Exception:
                pass
        loop.close()


def subscribe(server_dir: Path, filters=(), sample_interval: float = 0.0,
              buffer: int = 4096, overviews: bool = False,
              on_subscribed=None, shard: int = 0, on_connected=None):
    """Generator of frames from the server's `subscribe` RPC: coalesced
    lifecycle-event frames ({"op": "events", "records": [...]}) plus
    periodic metric samples ({"op": "sample", ...}) when sample_interval
    is set. This is the push feed `hq top` and the autoscaler consume —
    no polling; a consumer that falls behind the server's bounded
    per-subscriber queue receives a final {"op": "sub_dropped"} frame."""
    request = {
        "op": "subscribe",
        "filter": list(filters),
        "sample_interval": sample_interval,
        "buffer": buffer,
        "overviews": overviews,
    }
    for msg in _streaming_request(server_dir, request, on_subscribed,
                                  shard=shard, on_connected=on_connected):
        yield msg
        if msg.get("op") == "sub_dropped":
            return


def stream_events(server_dir: Path, history: bool = False, filters=(),
                  on_subscribed=None, overviews: bool = False,
                  shard: int = 0):
    """Generator of event records from the server's client-plane stream;
    shared by `hq journal stream` and the dashboard."""
    request = {
        "op": "stream_events", "history": history,
        "filter": list(filters),
        # ask the server to force worker hw overviews on while this
        # stream is attached (dashboards; SetOverviewIntervalOverride)
        "overviews": overviews,
    }
    yield from _streaming_request(server_dir, request, on_subscribed,
                                  shard=shard)
