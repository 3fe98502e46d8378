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
    half of coded errors: code="wrong-shard" + owner=<shard>
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
    """ClientSession-shaped facade over a federated server dir.

    Routes each request to the shard that owns it — through a cached
    :class:`~hyperqueue_tpu_torch.client.routing.Resolver` over the federation
    root's ownership log (modulo partition until a job migrates), so any
    request naming a job routes directly; a shard that answers
    ``wrong-shard`` (the job migrated since the cache was read) triggers
    one refresh-and-retry toward the owner it names, and ``migrating``
    (the job is mid-move) a short wait-and-retry. Cluster-wide reads
    (job_list, worker_list) fan out to every live shard and merge;
    submits/open_job pick a shard round-robin from a random start (pin
    with HQ_SHARD). Per-shard ClientSessions open lazily and are reused,
    each with the full reconnect/retry machinery — so a request that
    lands during a shard failover rides it out exactly like against a
    restarting standalone server.
    """

    # ops fanned out to every shard, responses merged; a shard with no
    # running server is skipped (a cleanly-stopped shard's jobs are
    # still listed by its siblings)
    _FAN_OUT = frozenset({"job_list", "worker_list", "stop_server"})

    def __init__(self, server_dir: Path, retry_window: float | None = None,
                 shard_count: int | None = None):
        from hyperqueue_tpu_torch.client.routing import Resolver

        self.server_dir = Path(server_dir)
        self.retry_window = retry_window
        if shard_count is None:
            fed = serverdir.load_federation(self.server_dir)
            if fed is None:
                raise ValueError(f"no federation at {server_dir}")
            shard_count = fed["shard_count"]
        # ALL job routing goes through the resolver: ownership
        # map when one exists, the boot-time modulo otherwise. Its shard
        # count folds in shards added online, which the descriptor count
        # the caller read may predate.
        self.resolver = Resolver(self.server_dir, shard_count)
        self.shard_count = self.resolver.shard_count
        self._sessions: dict[int, ClientSession] = {}
        env_shard = os.environ.get("HQ_SHARD")
        self._pin_submits = env_shard not in (None, "")
        if self._pin_submits:
            try:
                self._submit_shard = int(env_shard) % self.shard_count
            except ValueError:
                import logging

                logging.getLogger("hq.client").warning(
                    "ignoring malformed HQ_SHARD=%r; picking randomly",
                    env_shard,
                )
                self._pin_submits = False
        if not self._pin_submits:
            self._submit_shard = random.randrange(self.shard_count)

    # --- shard sessions -------------------------------------------------
    def shard_session(self, shard_id: int) -> ClientSession:
        session = self._sessions.get(shard_id)
        if session is None:
            try:
                session = ClientSession(
                    serverdir.shard_path(self.server_dir, shard_id),
                    retry_window=self.retry_window,
                )
            except FileNotFoundError as e:
                # sessions open lazily INSIDE request(), past the CLI's
                # construction-time FileNotFoundError handling — surface
                # a clean client error, not a raw traceback
                raise ClientError(str(e)) from e
            self._sessions[shard_id] = session
        return session

    def _drop_session(self, shard_id: int) -> None:
        """Forget a shard's cached session, closing its socket + private
        event loop (popping without close would leak both)."""
        session = self._sessions.pop(shard_id, None)
        if session is not None:
            try:
                session.close()
            except Exception:  # noqa: BLE001 - already broken
                pass

    def session_for_job(self, job_id: int) -> ClientSession:
        return self.shard_session(self.resolver.shard_for_job(job_id))

    def _request_routed(self, job_id: int, msg: dict, timeout) -> dict:
        """Job-routed request with ONE wrong-shard redirect: a stale
        route (the job migrated after the resolver's read — or HQ_SHARD
        pinned the old owner) answers code="wrong-shard" with the owner;
        refresh the map and retry there. code="migrating" waits out the
        move's seal window, then routes by the refreshed map."""
        deadline = clock.monotonic() + 10.0
        redirected = False
        while True:
            try:
                return self.session_for_job(job_id).request(msg, timeout)
            except ClientError as e:
                if e.code == "migrating" and clock.monotonic() < deadline:
                    time.sleep(0.2)
                    self.resolver.refresh()
                    continue
                if e.code != "wrong-shard" or redirected:
                    raise
                redirected = True
                self.resolver.refresh()
                if e.owner is not None:
                    return self.shard_session(int(e.owner)).request(
                        msg, timeout
                    )

    def submit_session(self) -> ClientSession:
        """The shard for a NEW job: round-robin from a random start so
        independent clients spread; HQ_SHARD pins it."""
        shard = self._submit_shard
        if not self._pin_submits:
            self._submit_shard = (shard + 1) % self.shard_count
        return self.shard_session(shard)

    # worker-targeted ops: worker ids are allocated PER SHARD and collide
    # across shards, so these must name their shard explicitly — routing
    # a bare id anywhere would silently hit the wrong shard's worker
    _WORKER_OPS = frozenset({"worker_stop", "worker_info"})

    # --- routing --------------------------------------------------------
    def request(self, msg: dict, timeout: float | None = None) -> dict:
        op = msg.get("op")
        if op in self._WORKER_OPS or (
            op == "worker_list" and msg.get("shard") is not None
        ):
            shard = msg.pop("shard", None)
            if shard is None:
                raise ClientError(
                    "federation: worker ids are per shard; pass --shard K"
                )
            return self.shard_session(int(shard)).request(msg, timeout)
        if op in self._FAN_OUT:
            return self._fan_out(msg, timeout)
        if "job_ids" in msg:
            return self._by_job_ids(msg, timeout)
        if "job_id" in msg and msg["job_id"] is not None:
            return self._request_routed(msg["job_id"], msg, timeout)
        if op in ("submit", "open_job"):
            job_id = (msg.get("job") or {}).get("job_id")
            if job_id:
                return self._request_routed(job_id, msg, timeout)
            return self.submit_session().request(msg, timeout)
        shard = msg.pop("shard", None)
        if shard in ("all", -1, "-1") and op in (
            "server_info", "server_stats", "reset_metrics", "alerts",
            "accounting", "profile",
        ):
            # per-shard fan-out: one record per shard (tick latencies and
            # lease states are per-shard facts — never summed; a
            # reset_metrics window must cover every shard's registry)
            records = [
                resp if resp is not None
                else {"op": op, "shard_id": k, "error": str(err)}
                for k, resp, err in self._per_shard(msg, timeout)
            ]
            return {"op": op, "shards": records}
        try:
            shard_id = int(shard) if shard is not None else 0
        except (TypeError, ValueError):
            # a typo'd --shard must not silently answer with shard 0's
            # state (e.g. its lease/promoted flags) labeled as another's
            raise ClientError(
                f"invalid shard selector {shard!r}; pass "
                f"0..{self.shard_count - 1} or 'all'"
            ) from None
        if not (0 <= shard_id < self.shard_count):
            raise ClientError(
                f"shard {shard_id} outside 0..{self.shard_count - 1}"
            )
        return self.shard_session(shard_id).request(msg, timeout)

    def _per_shard(self, msg: dict, timeout):
        """Request every shard in turn, yielding (shard, response, error)
        with error set (and the dead session dropped) instead of raising
        — a down shard must not fail a cluster-wide read."""
        for shard in range(self.shard_count):
            try:
                yield shard, self.shard_session(shard).request(
                    dict(msg), timeout
                ), None
            except (FileNotFoundError, ConnectionError, OSError,
                    ClientError) as e:
                self._drop_session(shard)
                yield shard, None, e

    def _by_job_ids(self, msg: dict, timeout) -> dict:
        if not msg["job_ids"]:
            # empty selector: any shard answers the empty request
            return self.shard_session(0).request(msg, timeout)
        migrating_deadline = clock.monotonic() + 10.0
        for attempt in range(32):
            groups: dict[int, list[int]] = {}
            for job_id in msg["job_ids"]:
                groups.setdefault(
                    self.resolver.shard_for_job(job_id), []
                ).append(job_id)
            responses = []
            try:
                for shard, ids in sorted(groups.items()):
                    sub = dict(msg)
                    sub["job_ids"] = ids
                    responses.append(
                        self.shard_session(shard).request(sub, timeout)
                    )
            except ClientError as e:
                # a group routed to a shard that lost (or is losing)
                # those jobs: refresh the map and re-group. wrong-shard
                # answers each imply a REAL committed migration (a
                # long-blocked `job wait` sees one per rebalancer move,
                # so a single retry is not enough); migrating is a
                # transient seal window and gets a bounded wait instead
                if e.code == "wrong-shard" and attempt < 31:
                    self.resolver.refresh()
                    continue
                if e.code == "migrating" and (
                    clock.monotonic() < migrating_deadline
                ):
                    time.sleep(0.2)
                    self.resolver.refresh()
                    continue
                raise
            return _merge_responses(responses)

    def _fan_out(self, msg: dict, timeout) -> dict:
        responses = []
        errors: list[Exception] = []
        for _shard, resp, err in self._per_shard(msg, timeout):
            # a shard with no running server is skipped (its siblings
            # still answer); errors kept in case ALL are down
            if resp is not None:
                responses.append(resp)
            else:
                errors.append(err)
        if not responses:
            raise errors[0] if errors else ClientError("no live shards")
        return _merge_responses(responses)

    def close(self) -> None:
        for session in self._sessions.values():
            try:
                session.close()
            except Exception:  # noqa: BLE001 - close the rest regardless
                pass
        self._sessions.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _merge_responses(responses: list[dict]) -> dict:
    """Merge per-shard responses of one fan-out op: lists concatenate,
    numbers sum, everything else keeps the first shard's value (`op` and
    friends are identical across shards anyway)."""
    if len(responses) == 1:
        return responses[0]
    merged: dict = dict(responses[0])
    for resp in responses[1:]:
        for key, value in resp.items():
            if key not in merged:
                merged[key] = value
            elif isinstance(value, list) and isinstance(merged[key], list):
                merged[key] = merged[key] + value
            elif isinstance(value, (int, float)) and not isinstance(
                value, bool
            ) and isinstance(merged[key], (int, float)):
                merged[key] = merged[key] + value
    return merged


def open_session(server_dir: Path, retry_window: float | None = None):
    """ClientSession for a classic server dir, FederatedSession when
    `server_dir` is a federation root — the CLI's one entry point."""
    fed = serverdir.load_federation(Path(server_dir))
    if fed is None:
        return ClientSession(server_dir, retry_window=retry_window)
    return FederatedSession(
        server_dir, retry_window=retry_window,
        shard_count=fed["shard_count"],
    )


class SubmitStream:
    """Pipelined chunked submit over one ClientSession.

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

        self._fed: FederatedSession | None = None
        if isinstance(session, FederatedSession):
            # a stream lives on ONE shard at a time: the owning shard for
            # a pinned job id, a submit shard otherwise. The federated
            # session is KEPT: if the job migrates mid-stream
            # the shard answers a coded error and the stream re-resolves,
            # switches shards, and replays its unacked chunks — the
            # destination imported the stream's applied-index set, so the
            # replay dedups exactly-once.
            self._fed = session
            job_id = header.get("job_id")
            session = (
                session.session_for_job(job_id)
                if job_id else session.submit_session()
            )
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
        self._redirects = 0

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
            code = ack.get("code") if isinstance(ack, dict) else None
            if code in ("wrong-shard", "migrating") and (
                self._fed is not None
            ):
                self._follow_migration(ack.get("owner"), code)
                return self._recv_ack()
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

    def _follow_migration(self, owner, code: str) -> None:
        """The stream's job moved (or is moving) mid-stream: switch to
        the owning shard's session and replay every unacked chunk there.
        Bounded — a stream bouncing between shards means routing itself
        is broken, and looping would mask that."""
        self._redirects += 1
        if self._redirects > 8:
            raise ClientError(
                "submit stream redirected too many times; "
                "federation routing is inconsistent"
            )
        fed = self._fed
        # the abandoned session's socket may hold unread error responses
        # for chunks still in flight when the first error arrived; drop
        # it from the cache so no later request reads a stale reply
        for shard_id, cached in list(fed._sessions.items()):
            if cached is self.session:
                fed._drop_session(shard_id)
        fed.resolver.refresh()
        if code == "migrating" or owner is None:
            # mid-move seal window: wait for the commit to land, then
            # route by the refreshed ownership map
            time.sleep(0.25)
            fed.resolver.refresh()
            owner = fed.resolver.shard_for_job(
                self.job_id
                if self.job_id is not None
                else self.header.get("job_id")
            )
        self.session = fed.shard_session(int(owner))
        self._replay_unacked()

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
    to ONE server: against a federation root, resolve to a shard's
    nested dir (default shard 0 — pass `shard`, or the shard dir itself,
    for another; cross-shard event-stream merging is not a thing, each
    shard's journal is its own lineage)."""
    server_dir = Path(server_dir)
    fed = serverdir.load_federation(server_dir)
    if fed is not None:
        return serverdir.shard_path(server_dir, shard)
    return server_dir


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
