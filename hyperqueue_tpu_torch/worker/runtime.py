"""Worker runtime: connect, register, run tasks, report results.

Reference: crates/tako/src/internal/worker/rpc.rs (run_worker) — a select loop
over the server message stream, heartbeat timer, idle timeout and time limit;
plus worker/reactor.rs (compute_tasks -> try_start_task -> launch). Tasks that
cannot allocate resources right now (fractional packing races) sit in a
blocked queue retried after every release.

Fail-safe extensions beyond the reference:

- ``--on-server-lost reconnect``: a lost server connection no longer
  strands the worker — running tasks keep running while the worker retries
  the registration handshake with jittered exponential backoff, re-reading
  the access record each attempt (a restarted server publishes a new
  instance dir with fresh ports and keys). The register message carries
  the still-running (task, instance) set; the server reattaches what its
  journal restore held for exactly those incarnations and orders the rest
  killed (stale incarnations requeued elsewhere).
- Unacked task-state uplinks are never lost to a dead connection: a send
  failure parks the batch in a replay buffer that is re-sent after
  reconnect, and a bounded log of final task messages is replayed too
  (covering completions whose send "succeeded" into a dying socket).
  Replays are safe because every task message carries its instance id and
  the server applies each (task, instance) transition at most once.
- Duplicate compute messages (chaos: duplicated frames, or a replayed
  server queue) are dropped by a bounded (task, instance) dedup set.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from collections import OrderedDict
from pathlib import Path

from hyperqueue_tpu_torch.ids import task_id_job
from hyperqueue_tpu_torch.server.worker import WorkerConfiguration
from hyperqueue_tpu_torch.transport.auth import (
    ROLE_SERVER,
    ROLE_WORKER,
    AuthError,
    Connection,
    do_authentication,
)
from hyperqueue_tpu_torch.transport.framing import read_trace
from hyperqueue_tpu_torch.utils import chaos
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.utils.retry import jittered_backoff
from hyperqueue_tpu_torch.worker.allocator import ResourceAllocator
from hyperqueue_tpu_torch.worker.launcher import (
    LaunchedTask,
    LaunchPlan,
    launch_task,
    poolable,
)
from hyperqueue_tpu_torch.worker.runner_pool import RunnerCrashed, RunnerPool
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.worker")

# worker-side metrics plane (utils/metrics.py). Everything here lives in
# the hq_worker_* namespace: gauge/counter samples piggyback on overview
# messages and the server re-exports them cluster-wide under a `worker`
# label, so the namespace is the fan-out filter.
_SPAWN_SECONDS = REGISTRY.histogram(
    "hq_worker_task_spawn_seconds",
    "compute-message accept to launch latency (runner-pool dispatch on "
    "the hot path, full process spawn on the in-loop path)",
)
_TASKS_DONE = REGISTRY.counter(
    "hq_worker_tasks_done_total",
    "tasks completed on this worker by outcome",
    labels=("outcome",),
)
_RECONNECT_ATTEMPTS = REGISTRY.counter(
    "hq_worker_reconnect_attempts_total",
    "registration attempts while reconnecting to a lost server",
)
_RECONNECTS = REGISTRY.counter(
    "hq_worker_reconnects_total",
    "successful re-registrations after a lost server connection",
)
_REPLAYED = REGISTRY.counter(
    "hq_worker_replayed_messages_total",
    "uplink messages parked by a dead connection and re-sent after "
    "reconnect",
)
_RUNNING = REGISTRY.gauge(
    "hq_worker_running_tasks", "tasks currently executing"
)
_PARKED = REGISTRY.gauge(
    "hq_worker_blocked_tasks",
    "tasks parked waiting for local resources",
)
_SENDQ = REGISTRY.gauge(
    "hq_worker_sendq_depth", "uplink messages awaiting the send drainer"
)
_PLAN_LOOKUPS = REGISTRY.counter(
    "hq_worker_launch_plan_total",
    "launch-plan cache lookups on the runner-pool dispatch path",
    labels=("result",),
)
_UPLINK_BATCH = REGISTRY.histogram(
    "hq_worker_uplink_batch_size",
    "messages coalesced per uplink frame by the send drainer",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
_CPU = REGISTRY.gauge(
    "hq_worker_cpu_percent", "node CPU utilization (HwSampler)"
)
_MEM_TOTAL = REGISTRY.gauge(
    "hq_worker_mem_total_bytes", "node memory total (HwSampler)"
)
_MEM_AVAILABLE = REGISTRY.gauge(
    "hq_worker_mem_available_bytes", "node memory available (HwSampler)"
)
_LOAD = REGISTRY.gauge("hq_worker_loadavg_1m", "node 1-minute load average")
_GPU = REGISTRY.gauge(
    "hq_worker_gpu_percent", "per-GPU utilization (HwSampler)",
    labels=("gpu",),
)
_GPU_MEM = REGISTRY.gauge(
    "hq_worker_gpu_mem_percent", "per-GPU memory utilization (HwSampler)",
    labels=("gpu",),
)
_PLANE_SHARE = REGISTRY.gauge(
    "hq_worker_profile_plane_cpu_share",
    "CPU cores used by each worker plane over the sampling window "
    "(sampling profiler); piggybacks on overview messages so "
    "the server re-exports it fleet-wide under a worker label",
    labels=("plane",), max_series=16,
)


class RunningTask:
    __slots__ = ("msg", "allocation", "launched", "future")

    def __init__(self, msg, allocation, launched, future):
        self.msg = msg
        self.allocation = allocation
        self.launched: LaunchedTask = launched
        self.future: asyncio.Task = future


class WorkerRuntime:
    # reconnect backoff: jittered exponential from BASE, capped at CAP;
    # each handshake attempt gets its own deadline so a blackholed SYN or
    # a wedged server that accepts but never answers cannot stall the
    # retry loop past --reconnect-timeout
    RECONNECT_BACKOFF_BASE = 0.25
    RECONNECT_BACKOFF_CAP = 5.0
    RECONNECT_ATTEMPT_TIMEOUT = 10.0
    # bounded memory for the duplicate-compute guard and the replayed
    # final-message log
    RECENT_TASKS_MAX = 8192
    DONE_LOG_MAX = 4096

    def __init__(
        self,
        host: str,
        port: int,
        secret_key: bytes | None,
        configuration: WorkerConfiguration,
        zero_worker: bool = False,
        server_dir: Path | None = None,
        metrics_port: int | None = None,
        metrics_host: str = "0.0.0.0",
        profile_hz: float = 19.0,
    ):
        self.host = host
        self.port = port
        self.secret_key = secret_key
        self.configuration = configuration
        self.zero_worker = zero_worker
        # where to re-read the access record from on reconnect (a restarted
        # server has a new instance dir: new ports, new keys)
        self.server_dir = Path(server_dir) if server_dir else None
        self.allocator = ResourceAllocator(configuration.descriptor)
        self.worker_id = 0
        self.server_uid = ""
        self.running: dict[int, RunningTask] = {}
        # resource-signature -> list of blocked task messages (FIFO)
        self.blocked: dict[tuple, list[dict]] = {}
        self._n_blocked = 0
        self._streamers: dict[str, object] = {}  # stream dir -> StreamWriter
        # stream dir -> number of RUNNING tasks currently holding the
        # writer: eviction may only close zero-refcount writers (closing an
        # in-use one fails its task's next write_chunk/close_task)
        self._streamer_users: dict[str, int] = {}
        self.last_task_time = clock.monotonic()
        self.started_at = clock.monotonic()
        self._conn: Connection | None = None
        self._send_lock = asyncio.Lock()
        self._sendq: asyncio.Queue = asyncio.Queue()
        # uplinks that could not be handed to a live connection; re-sent
        # (ahead of fresh traffic) after the next successful reconnect
        self._replay: list[dict] = []
        # bounded log of final task messages already handed to a socket:
        # a send into a dying connection can "succeed" without the server
        # ever seeing it, so these replay too (the server drops duplicates
        # by (task, instance)). Keyed by (id, instance, op) so a replayed
        # message passing through the drainer again cannot duplicate its
        # entry; harvested and cleared on reconnect (replayed copies
        # re-enter when their re-send happens), so it only ever holds the
        # last session's finals.
        self._done_log: OrderedDict[tuple, dict] = OrderedDict()
        # (task_id, instance) -> None for every compute accepted: duplicate
        # deliveries (chaos dup, replayed server queues) must not run twice
        self._recent_tasks: OrderedDict[tuple[int, int], None] = OrderedDict()
        # incarnations the server ordered killed at reconnect: their exit
        # must NOT be reported — if the server re-issued the task at the
        # SAME instance (a start it never journaled), a task_failed from
        # the killed copy would pass the fence and fail the live one
        self._discarded: set[int] = set()
        self._stop = asyncio.Event()
        # /readyz input: True only while a registered session is live —
        # flipped off the moment the session winds down, BEFORE the
        # reconnect backoff starts, so a probe during the gap reports the
        # worker unready instead of racing the re-registration
        self._session_live = False
        # federation worker lending: a `redirect` message sets
        # the sibling shard dir to re-register with and fires this event;
        # the session winds down and run() registers fresh over there
        self._redirect = asyncio.Event()
        self._redirect_target: Path | None = None
        # warm runner pool (worker/runner_pool.py): None while disabled
        # (--runner-pool 0, zero-worker mode, or the restart budget blew);
        # plan cache: (job_id, id(body)) -> LaunchPlan, LRU-bounded. Plans
        # hold their body so the id() key stays stable while cached.
        self.runner_pool: RunnerPool | None = None
        self._pool_warmup: asyncio.Task | None = None
        self._plan_cache: OrderedDict[tuple, LaunchPlan] = OrderedDict()
        self._rng = random.Random()
        # server-forced overview cadence (None = use configuration)
        self._overview_override: float | None = None
        self._overview_wake = asyncio.Event()
        self.localcomm = None
        # Prometheus endpoint: None = off (recording still happens; gauges
        # also piggyback on overview messages), 0 = ephemeral. Bind
        # 127.0.0.1 via --metrics-host to keep the (unauthenticated)
        # endpoint off shared networks.
        self.requested_metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.metrics_port: int | None = None
        self._metrics_server = None
        # sampling profiler: 0 disables; the "runtime" plane is
        # this asyncio thread (drainer + overview are tasks on it)
        self.profile_hz = float(profile_hz)
        self._profiler_started = False

    def _publish_plane_shares(self) -> None:
        from hyperqueue_tpu_torch.utils import profiler

        if not profiler.PROFILER.running:
            return
        _PLANE_SHARE.clear()
        for plane, agg in profiler.PROFILER.plane_shares().items():
            _PLANE_SHARE.labels(plane).set(agg["cpu"])

    def _collect_metrics(self) -> None:
        """Scrape-time gauges from live runtime state (collect hook — no
        hot-path bookkeeping needed for queue depths)."""
        _RUNNING.set(len(self.running))
        _PARKED.set(self._n_blocked)
        _SENDQ.set(self._sendq.qsize())
        self._publish_plane_shares()

    async def _send(self, msg: dict) -> None:
        """Enqueue an uplink message; a drainer batches queued messages into
        one frame (one encryption + one syscall for a burst of task events —
        the per-task overhead win analogous to the reference's shared/
        separate compute-message split, messages/worker.rs:28-54)."""
        self._sendq.put_nowait(msg)

    async def _send_drainer(self) -> None:
        # zero-worker mode is a control-plane benchmark instrument: tasks
        # complete in microseconds and the coalescing nap (a latency-for-
        # syscalls trade sized against millisecond process spawns) would
        # dominate the very overhead being measured. Bursts still batch
        # naturally below.
        flush_delay = (
            0.0 if self.zero_worker
            else max(self.configuration.uplink_flush_secs, 0.0)
        )
        while True:
            msg = await self._sendq.get()
            batch = [msg]
            while len(batch) < 512:
                try:
                    batch.append(self._sendq.get_nowait())
                except asyncio.QueueEmpty:
                    break
            if (flush_delay > 0 and len(batch) == 1
                    and msg.get("op") != "task_running"):
                # a lone message with no companions queued: wait the
                # bounded coalescing window so completions landing within
                # it ride the same frame (one encryption + one syscall +
                # one server recv wakeup for the burst) — the uplink half
                # of the batched completion plane. A burst already in the
                # queue skips the nap: the batch has formed by itself. A
                # lone task_running leaves at once: the server stamps a
                # task's start when the message arrives, so a nap would
                # move the start later by up to the window and shorten the
                # run phase of the timeline by as much (the JAX worker
                # naps here too).
                try:
                    await asyncio.sleep(flush_delay)
                except asyncio.CancelledError:
                    self._replay.extend(batch)  # never lose the popped msg
                    raise
                while len(batch) < 512:
                    try:
                        batch.append(self._sendq.get_nowait())
                    except asyncio.QueueEmpty:
                        break
            _UPLINK_BATCH.observe(len(batch))
            if chaos.ACTIVE:
                injected = []
                try:
                    for m in batch:
                        action = await chaos.on_message(
                            "worker.send", op=m.get("op")
                        )
                        if action == "drop":
                            continue
                        injected.append(m)
                        if action == "dup":
                            injected.append(m)
                except asyncio.CancelledError:
                    # teardown caught the drainer mid-injection: nothing was
                    # sent yet, park the whole popped batch
                    self._replay.extend(batch)
                    raise
                batch = injected
                if not batch:
                    continue
            for m in batch:
                if m.get("op") in ("task_finished", "task_failed"):
                    key = (m.get("id"), m.get("instance"), m.get("op"))
                    if key not in self._done_log:
                        self._done_log[key] = m
                        while len(self._done_log) > self.DONE_LOG_MAX:
                            self._done_log.popitem(last=False)
            try:
                async with self._send_lock:
                    if len(batch) == 1:
                        await self._conn.send(batch[0])
                    else:
                        await self._conn.send({"op": "batch", "msgs": batch})
            except (ConnectionError, OSError, asyncio.CancelledError):
                # the server never acked these: park them for replay after
                # the reconnect (CancelledError covers session teardown
                # catching the drainer mid-send — the popped batch must not
                # vanish). Re-sending something the server did receive is
                # safe: every task message is fenced by (task, instance)
                # and applied at most once.
                self._replay.extend(batch)
                raise

    # --- connection lifecycle -------------------------------------------
    async def run(self) -> None:
        await self._initial_connect()
        logger.info("registered as worker %d", self.worker_id,
                    extra={"worker": self.worker_id})

        import tempfile

        from hyperqueue_tpu_torch.worker.localcomm import LocalCommListener

        self.localcomm = LocalCommListener(self, Path(tempfile.gettempdir()))
        await self.localcomm.start()

        if not self.zero_worker and self.configuration.runner_pool != 0:
            size = self.configuration.runner_pool
            if size < 0:
                # auto: bounded by the configured CPUs AND the physical
                # cores minus one (a 4-lane worker on a 2-core box gains
                # nothing from 4 runners — extra processes just add
                # context-switch pressure, and one core must stay with the
                # worker's event loop; each runner supervises any number
                # of concurrent payloads, the width only bounds how many
                # spawn syscalls overlap)
                import os as _os

                size = max(
                    1, min(self._n_cpus(), (_os.cpu_count() or 2) - 1, 8)
                )
            self.runner_pool = RunnerPool(size)
            # warm in the background: tasks arriving in the first ~0.5 s
            # take the in-loop spawn path instead of waiting on N python
            # interpreter startups
            self._pool_warmup = asyncio.create_task(self.runner_pool.start())
            self._pool_warmup.add_done_callback(
                lambda t: logger.info(
                    "runner pool started (%d warm runners)", size
                ) if not t.cancelled() and t.exception() is None
                else logger.error("runner pool failed to start: %s",
                                  t.exception() if not t.cancelled()
                                  else "cancelled")
            )

        REGISTRY.add_collect_hook(self._collect_metrics)
        if self.profile_hz > 0 and not clock.is_simulated():
            from hyperqueue_tpu_torch.utils import profiler

            profiler.register_plane("runtime")
            self._profiler_started = profiler.start_profiler(self.profile_hz)
        if self.requested_metrics_port is not None:
            from hyperqueue_tpu_torch.utils.metrics import start_metrics_server

            self._metrics_server, self.metrics_port = (
                await start_metrics_server(
                    REGISTRY, self.requested_metrics_port,
                    host=self.metrics_host,
                    probes={
                        "/healthz": self._probe_healthz,
                        "/readyz": self._probe_readyz,
                    },
                )
            )
            logger.info(
                "metrics endpoint on http://%s:%d/metrics (+ /healthz "
                "/readyz)",
                self.metrics_host, self.metrics_port,
            )

        try:
            while True:
                outcome = await self._run_session()
                if outcome == "stop":
                    return
                if outcome == "redirect":
                    if self.running or self.blocked:
                        # a compute raced in between the redirect
                        # handler's idle check and the session teardown:
                        # abort the lend — the running task's uplinks
                        # belong to the HOME shard's journal. Reconnect
                        # home with reattach so the race-delivered task
                        # keeps its single execution.
                        logger.warning(
                            "aborting lend: %d task(s) raced in; "
                            "re-registering with the home shard",
                            len(self.running) + self._n_blocked,
                        )
                        self._redirect_target = None
                        self._redirect.clear()
                        self.configuration.lent_from = -1
                        if not await self._reconnect_with_backoff():
                            return
                        continue
                    # lent to a sibling shard: drop the old identity and
                    # register FRESH with the target shard dir (no
                    # reattach — only idle workers are lent). From here
                    # on, server loss/reconnect handling points at the
                    # NEW shard: if the borrower dies mid-task later, the
                    # worker reattaches to the borrower's successor.
                    self.server_dir = self._redirect_target
                    self._redirect_target = None
                    self._redirect.clear()
                    self.worker_id = 0
                    self.server_uid = ""
                    self._clear_launch_plans()
                    if self._conn:
                        self._conn.close()
                    logger.warning(
                        "lent to shard dir %s; re-registering",
                        self.server_dir,
                    )
                    # the borrower may itself be mid-failover when the
                    # redirect lands: register with the reconnect-style
                    # backoff window, never a single brittle attempt
                    # (the server only lends reconnect-policy workers,
                    # so _initial_connect retries here)
                    await self._initial_connect()
                    logger.info(
                        "registered as worker %d", self.worker_id,
                        extra={"worker": self.worker_id},
                    )
                    continue
                # server lost
                policy = self.configuration.on_server_lost
                if policy == "finish-running":
                    logger.warning(
                        "server lost; finishing running tasks then exiting"
                    )
                    await self._finish_running_then_exit()
                    return
                if policy != "reconnect":
                    logger.warning("server lost; stopping")
                    return
                if not await self._reconnect_with_backoff():
                    logger.error(
                        "could not reconnect within the reconnect window; "
                        "stopping"
                    )
                    return
        finally:
            for rt in self.running.values():
                if rt.launched is not None:
                    rt.launched.kill()
            if self._pool_warmup is not None and not self._pool_warmup.done():
                self._pool_warmup.cancel()
            if self.runner_pool is not None:
                # drain AFTER the kills above: the kill frames must reach
                # the runners before their stdin EOF triggers exit
                await self.runner_pool.close()
            if self.localcomm is not None:
                self.localcomm.close()
            if self._metrics_server is not None:
                self._metrics_server.close()
            REGISTRY.remove_collect_hook(self._collect_metrics)
            if self._profiler_started:
                from hyperqueue_tpu_torch.utils import profiler

                profiler.stop_profiler()
                self._profiler_started = False
            if self._conn:
                self._conn.close()

    async def _initial_connect(self) -> None:
        """First registration. Under `--on-server-lost reconnect` an
        unreachable server is retried with the same jittered backoff and
        `--reconnect-timeout` window as a lost session: a worker whose
        policy is to ride out server restarts must also ride out being
        STARTED during one (autoalloc and chaos soaks race worker startup
        against server crashes all the time). Any other policy keeps the
        fail-fast contract: a bad address dies immediately and visibly."""
        if self.configuration.on_server_lost != "reconnect":
            await self._connect(reattach=False)
            return
        window = self.configuration.reconnect_timeout_secs
        deadline = clock.monotonic() + window if window > 0 else None
        delay = self.RECONNECT_BACKOFF_BASE
        while True:
            try:
                if self.server_dir is not None:
                    # re-resolve every attempt: a server that comes (back)
                    # up lives in a fresh instance dir with fresh ports
                    from hyperqueue_tpu_torch.utils import serverdir

                    access = serverdir.load_access(self.server_dir)
                    self.host = access.host_for_workers()
                    self.port = access.worker_port
                    self.secret_key = access.worker_key_bytes()
                await asyncio.wait_for(
                    self._connect(reattach=False),
                    timeout=self.RECONNECT_ATTEMPT_TIMEOUT,
                )
                return
            except (
                ConnectionError,
                OSError,
                RuntimeError,
                ValueError,  # torn/corrupt access record mid-publish
                AuthError,
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
            ) as e:
                now = clock.monotonic()
                limit = self.configuration.time_limit_secs
                if limit > 0 and now - self.started_at >= limit:
                    raise  # same contract as _reconnect_with_backoff
                if deadline is not None and now >= deadline:
                    raise
                sleep_for, delay = jittered_backoff(
                    delay, self.RECONNECT_BACKOFF_CAP, self._rng,
                    remaining=(
                        deadline - now if deadline is not None else None
                    ),
                )
                logger.info(
                    "server unreachable at first registration (%s); "
                    "retrying in %.2fs", e, sleep_for,
                )
                await asyncio.sleep(sleep_for)

    async def _connect(self, reattach: bool) -> None:
        """One connect + register handshake; sets self._conn on success.

        With `reattach`, the register message carries the previous identity
        and the still-running (task, instance) set so the server can
        reattach what it held for us; the `registered` reply then names the
        stale incarnations to kill."""
        host, port, key = self.host, self.port, self.secret_key
        if reattach and self.server_dir is not None:
            # re-resolve from the server dir: a restarted server lives in a
            # NEW instance dir with fresh ports and plane keys
            from hyperqueue_tpu_torch.utils import serverdir

            access = serverdir.load_access(self.server_dir)
            host = access.host_for_workers()
            port = access.worker_port
            key = access.worker_key_bytes()
        reader, writer = await asyncio.open_connection(host, port)
        try:
            conn, registered = await self._handshake(reader, writer, key, reattach)
        except BaseException:
            # covers cancellation by the per-attempt timeout too: never
            # leak a half-authenticated socket per failed attempt
            writer.close()
            raise
        self._apply_registration(registered, host, port, key, conn, reattach)

    async def _handshake(self, reader, writer, key, reattach: bool):
        conn = await do_authentication(
            reader, writer, ROLE_WORKER, ROLE_SERVER, key
        )
        register: dict = {
            "op": "register",
            "config": self.configuration.to_wire(),
        }
        if reattach:
            register["reattach"] = {
                "worker_id": self.worker_id,
                "server_uid": self.server_uid,
                "running": [
                    {"id": task_id, "instance": rt.msg.get("instance", 0),
                     # the variant actually executing: the server needs it
                     # to account the right resource amounts when it never
                     # journaled this task's start
                     "variant": rt.msg.get("variant", 0)}
                    for task_id, rt in self.running.items()
                ],
                # parked-but-never-started tasks must be declared too: the
                # restored server re-issues them (no task-started was ever
                # journaled) and a silently-kept local copy would execute
                # alongside the re-issue under the SAME instance id —
                # invisible to the fence. The server always discards these.
                "blocked": [
                    {"id": t["id"], "instance": t.get("instance", 0)}
                    for group in self.blocked.values()
                    for t in group
                ],
            }
        await conn.send(register)
        registered = await conn.recv()
        if registered.get("op") != "registered":
            raise RuntimeError(f"registration failed: {registered}")
        return conn, registered

    def _apply_registration(
        self, registered: dict, host, port, key, conn, reattach: bool
    ) -> None:
        self.worker_id = registered["worker_id"]
        self.server_uid = registered.get("server_uid", "")
        if self.configuration.idle_timeout_secs < 0:
            # --idle-timeout not given: adopt the server-wide default
            # (reference tako rpc.rs:130 sync_worker_configuration). An
            # explicit --idle-timeout 0 opts out and is left alone.
            self.configuration.idle_timeout_secs = float(
                registered.get("server_idle_timeout") or 0.0
            )
        self.host, self.port, self.secret_key = host, port, key
        self._conn = conn
        self._session_live = True
        if reattach:
            # plans embed the (now stale) worker id and server uid
            self._clear_launch_plans()
            discard = registered.get("discard") or []
            for task_id in discard:
                # the server refused this incarnation (requeued under a
                # newer instance, already terminal, or never held): kill it
                # so a rescheduled copy elsewhere stays the only execution
                logger.warning(
                    "task %d is stale after reconnect; killing it", task_id
                )
                if task_id in self.running:
                    self._discarded.add(task_id)
                self._cancel_task(task_id)
            if discard:
                # forget the discarded incarnations: the restored server
                # may legitimately re-issue one of these (task, instance)
                # pairs (it never saw them start), and the dedup guard
                # must not swallow the re-delivery
                dropped = set(discard)
                self._recent_tasks = OrderedDict(
                    (k, None) for k in self._recent_tasks
                    if k[0] not in dropped
                )
            logger.warning(
                "reconnected as worker %d (%d task(s) reattached, "
                "%d stale discarded)",
                self.worker_id,
                len(registered.get("reattached") or ()),
                len(discard),
            )

    async def _reconnect_with_backoff(self) -> bool:
        """Retry the handshake with jittered exponential backoff; running
        tasks keep executing (and queue their results) throughout. Returns
        False once the reconnect window (`--reconnect-timeout`, 0 = keep
        trying forever) or the worker time limit is exhausted."""
        window = self.configuration.reconnect_timeout_secs
        deadline = clock.monotonic() + window if window > 0 else None
        delay = self.RECONNECT_BACKOFF_BASE
        attempt = 0
        while True:
            attempt += 1
            _RECONNECT_ATTEMPTS.inc()
            try:
                await asyncio.wait_for(
                    self._connect(reattach=True),
                    timeout=self.RECONNECT_ATTEMPT_TIMEOUT,
                )
                _RECONNECTS.inc()
                return True
            except (
                ConnectionError,
                OSError,
                RuntimeError,
                # ValueError covers a torn/corrupt access record mid-publish
                # (json decode errors subclass it)
                ValueError,
                AuthError,
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
            ) as e:
                now = clock.monotonic()
                limit = self.configuration.time_limit_secs
                if limit > 0 and now - self.started_at >= limit:
                    logger.warning("time limit reached while reconnecting")
                    return False
                if deadline is not None and now >= deadline:
                    logger.warning("reconnect attempt %d failed: %s", attempt, e)
                    return False
                sleep_for, delay = jittered_backoff(
                    delay, self.RECONNECT_BACKOFF_CAP, self._rng,
                    remaining=(
                        deadline - now if deadline is not None else None
                    ),
                )
                logger.info(
                    "reconnect attempt %d failed (%s); retrying in %.2fs",
                    attempt, e, sleep_for,
                )
                await asyncio.sleep(sleep_for)

    def _rebuild_sendq(self) -> None:
        """Order the next session's uplink queue: replayed final messages
        first (oldest news), then unsent parked messages, then whatever was
        queued while disconnected. Heartbeats/overviews are dropped — they
        describe a dead connection's moment in time."""
        items: list[dict] = list(self._done_log.values())
        items.extend(self._replay)
        # messages past this index were merely queued while disconnected —
        # they are first sends, not replays, and don't count as such
        n_replay_candidates = len(items)
        self._done_log.clear()
        self._replay = []
        while True:
            try:
                items.append(self._sendq.get_nowait())
            except asyncio.QueueEmpty:
                break
        fresh: asyncio.Queue = asyncio.Queue()
        seen: set[int] = set()
        replayed = 0
        for i, msg in enumerate(items):
            if msg.get("op") in ("heartbeat", "overview"):
                continue
            if id(msg) in seen:
                continue  # same dict parked via both _done_log and _replay
            seen.add(id(msg))
            if i < n_replay_candidates:
                replayed += 1
            fresh.put_nowait(msg)
        # counted HERE — messages actually re-sent after this reconnect —
        # not at park time: a park-then-drop (heartbeat) or a re-park on a
        # flapping connection must not inflate the replay count
        if replayed:
            _REPLAYED.inc(replayed)
        self._sendq = fresh

    async def _run_session(self) -> str:
        """Drive one connected session; returns "stop" (deliberate exit)
        or "lost" (connection failure)."""
        self._rebuild_sendq()
        tasks = [
            asyncio.create_task(self._message_loop()),
            asyncio.create_task(self._send_drainer()),
            asyncio.create_task(self._heartbeat_loop()),
            asyncio.create_task(self._limits_loop()),
        ]
        # always started: the server can force overviews on at any time
        # while a dashboard listens (set_overview_override)
        tasks.append(asyncio.create_task(self._overview_loop()))
        stop_wait = asyncio.create_task(self._stop.wait())
        redirect_wait = asyncio.create_task(self._redirect.wait())
        waiters = (stop_wait, redirect_wait)
        try:
            done, _pending = await asyncio.wait(
                tasks + list(waiters), return_when=asyncio.FIRST_COMPLETED
            )
            for t in done:
                if t not in waiters and t.exception():
                    raise t.exception()
            if self._redirect.is_set() and not self._stop.is_set():
                return "redirect"
            return "stop"
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            logger.warning("server connection lost (%s)", e)
            return "lost"
        finally:
            self._session_live = False
            for t in tasks + list(waiters):
                t.cancel()
            await asyncio.gather(*tasks, *waiters, return_exceptions=True)
            if self._conn:
                self._conn.close()

    async def _finish_running_then_exit(self) -> None:
        while self.running:
            await asyncio.sleep(0.1)

    async def _message_loop(self) -> None:
        while True:
            msg = await self._conn.recv()
            # the server coalesces bursts (assignment batches, retract
            # fan-out) into one batch frame; chaos actions keep applying
            # per LOGICAL message so fault plans targeting e.g. `compute`
            # behave identically under batching
            subs = msg["msgs"] if msg.get("op") == "batch" else (msg,)
            for sub in subs:
                action = None
                if chaos.ACTIVE:
                    action = await chaos.on_message(
                        "worker.recv", op=sub.get("op")
                    )
                    if action == "drop":
                        continue
                if await self._handle_server_message(sub):
                    return
                if action == "dup" and await self._handle_server_message(sub):
                    return

    async def _handle_server_message(self, msg: dict) -> bool:
        """Process one server message; True = stop requested."""
        op = msg.get("op")
        if op == "compute":
            shared = msg.get("shared_bodies")
            shared_tr = msg.get("shared_traces")
            for task_msg in msg["tasks"]:
                if shared is not None and "b" in task_msg:
                    # resolve the shared/separate split; the body dict
                    # stays shared between tasks (read-only downstream)
                    task_msg["body"] = shared[task_msg.pop("b")]
                tr = task_msg.get("trace")
                if (
                    shared_tr is not None
                    and isinstance(tr, list)
                    and tr
                    and isinstance(tr[0], int)
                ):
                    # resolve the frame-level trace-id dedup
                    task_msg["trace"] = [
                        shared_tr[tr[0]], tr[1] if len(tr) > 1 else None,
                    ]
                key = (task_msg["id"], task_msg.get("instance", 0))
                if key in self._recent_tasks:
                    # duplicate delivery of the same incarnation (chaos
                    # dup, or a replayed server send queue): never run a
                    # task twice
                    logger.warning(
                        "dropping duplicate compute for task %d instance %d",
                        key[0], key[1],
                    )
                    continue
                self._recent_tasks[key] = None
                while len(self._recent_tasks) > self.RECENT_TASKS_MAX:
                    self._recent_tasks.popitem(last=False)
                tctx = read_trace(task_msg)
                if tctx is not None:
                    # distributed trace (server-side assembly): normalize
                    # the compact wire header, stamp the accept clock;
                    # launch/spawn clocks follow in _run_task and
                    # everything is echoed on the task_running uplink
                    tctx["accepted_at"] = clock.now()
                    task_msg["trace"] = tctx
                self._try_start(task_msg)
        elif op == "cancel":
            for task_id in msg["task_ids"]:
                self._cancel_task(task_id)
        elif op == "retract":
            for task_id, instance in msg["tasks"]:
                # retract may only reclaim NOT-YET-STARTED tasks: remove
                # from the blocked queue, never touch running ones (the
                # server treats ok=False as "it started, leave it be").
                # The instance is echoed so the server can discard stale
                # answers, like every other task message.
                before = self._n_blocked
                self._remove_blocked(task_id)
                await self._send(
                    {
                        "op": "retract_response",
                        "id": task_id,
                        "instance": instance,
                        "ok": self._n_blocked < before,
                    }
                )
        elif op == "set_overview_override":
            interval = msg.get("interval")
            self._overview_override = (
                float(interval) if interval is not None else None
            )
            self._overview_wake.set()
        elif op == "redirect":
            # federation lending: re-register with a sibling shard. The
            # target is derived from OUR OWN server dir (shard dirs are
            # siblings under the federation root) — the server never
            # dictates filesystem paths across hosts.
            from hyperqueue_tpu_torch.utils import serverdir as _serverdir

            target = int(msg.get("shard", -1))
            if self.server_dir is None or (
                _serverdir.shard_id_of(self.server_dir) is None
            ):
                logger.warning(
                    "ignoring redirect to shard %d: this worker was not "
                    "started against a federation shard dir", target,
                )
            elif self.configuration.on_server_lost != "reconnect":
                # a lent worker must ride out the borrower dying later;
                # the server checks this too — refuse defensively
                logger.warning(
                    "ignoring redirect to shard %d: --on-server-lost is "
                    "not 'reconnect'", target,
                )
            elif self.running or self.blocked:
                # the server only lends idle workers, but a task may have
                # raced in; refuse rather than strand its uplinks
                logger.warning(
                    "ignoring redirect to shard %d: %d task(s) running",
                    target, len(self.running),
                )
            else:
                self._redirect_target = _serverdir.shard_path(
                    self.server_dir.parent, target
                )
                # remember the home shard so the borrower can count its
                # borrowed pool (register config carries it)
                home = _serverdir.shard_id_of(self.server_dir)
                self.configuration.lent_from = int(
                    msg.get("from_shard", home if home is not None else -1)
                )
                self._redirect.set()
        elif op == "stop":
            self._stop.set()
            return True
        else:
            logger.warning("unknown server message %r", op)
        return False

    def _park(self, sig: tuple, task_msg: dict) -> None:
        """Park a task in its signature group, ordered by priority
        (descending, stable): a later high-priority compute message must
        start before earlier low-priority backlog once resources free up —
        the server-side analog is the displacement retract (reference
        test_reactor.rs test_prefill_submit_high_priority)."""
        group = self.blocked.setdefault(sig, [])
        priority = tuple(task_msg.get("priority") or (0, 0))
        idx = len(group)
        while idx > 0 and tuple(group[idx - 1].get("priority") or (0, 0)) < priority:
            idx -= 1
        group.insert(idx, task_msg)
        self._n_blocked += 1

    def _try_start(self, task_msg: dict) -> bool:
        """Returns False if the task was parked in the blocked queue."""
        entries = task_msg.get("entries", [])
        sig = self._entries_sig(task_msg) if entries else ()
        if entries and sig in self.blocked:
            # peers with the same signature are already waiting: the head
            # could not allocate, so this one cannot either — park without
            # probing
            self._park(sig, task_msg)
            return False
        allocation = self.allocator.try_allocate(entries)
        if allocation is None and entries:
            logger.debug("task %d blocked on resources", task_msg["id"],
                         extra={"task": task_msg["id"]})
            self._park(sig, task_msg)
            return False
        self._start_with_allocation(task_msg, allocation)
        return True

    def _start_with_allocation(self, task_msg: dict, allocation) -> None:
        body = task_msg.get("body") or {}
        if (
            self.zero_worker
            and not body.get("stream")
            and not body.get("time_limit")
        ):
            # zero-worker fast path: no process ever exists, so completing
            # inline (two queued uplinks, immediate release) skips the
            # per-task coroutine + future + RunningTask entirely — the
            # worker-side floor of the <0.1 ms/task overhead target
            task_id = task_msg["id"]
            instance = task_msg.get("instance", 0)
            self._sendq.put_nowait(
                {"op": "task_running", "id": task_id, "instance": instance}
            )
            self._sendq.put_nowait(
                {"op": "task_finished", "id": task_id, "instance": instance}
            )
            _TASKS_DONE.labels("finished").inc()
            self.last_task_time = clock.monotonic()
            if allocation is not None:
                self.allocator.release(allocation)
                if self.blocked:
                    # re-probe parked tasks — but via call_soon: this fast
                    # path runs inside _retry_blocked itself, and a direct
                    # call would recurse one frame per blocked task
                    asyncio.get_running_loop().call_soon(self._retry_blocked)
            return
        future = asyncio.create_task(self._run_task(task_msg, allocation))
        self.running[task_msg["id"]] = RunningTask(
            task_msg, allocation, None, future
        )

    async def _run_task(self, task_msg: dict, allocation) -> None:
        task_id = task_msg["id"]
        instance = task_msg.get("instance", 0)
        held_stream_dir = None
        try:
            streamer = None
            body = task_msg.get("body") or {}
            stream_dir = body.get("stream")
            if stream_dir:
                # stream paths carry JOB-scope placeholders (reference
                # test_placeholders.py stream_submit_placeholder); task-
                # scope ones are a hard submit-time error
                # (cli._check_submit_placeholders) — a stream dir is
                # shared by the whole job
                import os as _os

                from hyperqueue_tpu_torch.ids import task_id_job
                from hyperqueue_tpu_torch.utils.placeholders import (
                    fill_placeholders,
                )

                stream_dir = fill_placeholders(stream_dir, {
                    "JOB_ID": str(task_id_job(task_id)),
                    "SUBMIT_DIR": body.get("submit_dir") or _os.getcwd(),
                    "SERVER_UID": self.server_uid,
                })
                streamer = self._acquire_streamer(stream_dir)
                held_stream_dir = stream_dir
            extra_env = {}
            if self.localcomm is not None:
                extra_env["HQ_LOCAL_SOCKET"] = self.localcomm.socket_path
                extra_env["HQ_TOKEN"] = self.localcomm.register_task(task_id)
            tctx = task_msg.get("trace")
            if tctx is not None:
                tctx["launch_at"] = clock.now()
            _t_spawn = time.perf_counter()
            launched = await self._launch(
                task_msg, allocation, streamer, extra_env
            )
            _SPAWN_SECONDS.observe(time.perf_counter() - _t_spawn)
            if tctx is not None:
                # the true spawn clock when the handle recorded one (runner
                # ack / in-loop subprocess); dispatch-complete otherwise
                tctx["spawned_at"] = (
                    getattr(launched, "spawned_wall", 0.0) or clock.now()
                )
            rt = self.running.get(task_id)
            if rt is not None:
                rt.launched = launched
            running_msg = {
                "op": "task_running", "id": task_id, "instance": instance,
            }
            if tctx is not None:
                running_msg["trace"] = {
                    "id": tctx.get("id"),
                    "parent": tctx.get("parent"),
                    "accepted_at": tctx.get("accepted_at"),
                    "launch_at": tctx.get("launch_at"),
                    "spawned_at": tctx.get("spawned_at"),
                }
            await self._send(running_msg)
            # per-task time limit (reference: task futures carry stop
            # reasons; program.rs timeout path): kill and fail on expiry
            time_limit = (task_msg.get("body") or {}).get("time_limit")
            timed_out = False
            if time_limit:
                # arm the limit at the true spawn (the runner acks it for
                # pool launches), not at dispatch: time queued behind other
                # spawns in a backlogged runner is not the task's runtime
                await launched.started()
                try:
                    code, detail = await asyncio.wait_for(
                        launched.wait(), timeout=float(time_limit)
                    )
                except asyncio.TimeoutError:
                    timed_out = True
                    launched.kill()
                    await launched.wait()
                    code, detail = -1, ""
            else:
                code, detail = await launched.wait()
            if tctx is not None:
                tctx["exited_at"] = clock.now()
            if task_id in self._discarded:
                # killed as a stale incarnation at reconnect: exit silently
                # (a report could pass the fence against a re-issued copy
                # running elsewhere under the same instance id)
                if streamer is not None:
                    streamer.close_task(task_id, instance)
                return
            if timed_out:
                if streamer is not None:
                    streamer.close_task(task_id, instance)
                _TASKS_DONE.labels("timeout").inc()
                msg = {
                    "op": "task_failed",
                    "id": task_id,
                    "instance": instance,
                    "error": f"time limit of {time_limit}s exceeded",
                }
                self._attach_finish_trace(msg, tctx)
                await self._send(msg)
                return
            if streamer is not None:
                streamer.close_task(task_id, instance)
            _TASKS_DONE.labels("finished" if code == 0 else "failed").inc()
            if code == 0:
                msg = {
                    "op": "task_finished", "id": task_id, "instance": instance,
                }
                self._attach_finish_trace(msg, tctx)
                await self._send(msg)
            else:
                error = f"program exited with code {code}"
                if detail:
                    error += f"\nstderr (tail):\n{detail}"
                msg = {
                    "op": "task_failed",
                    "id": task_id,
                    "instance": instance,
                    "error": error,
                }
                self._attach_finish_trace(msg, tctx)
                await self._send(msg)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - report, don't kill the worker
            logger.exception("task %d launch failed", task_id,
                             extra={"task": task_id})
            if task_id not in self._discarded:
                try:
                    msg = {
                        "op": "task_failed",
                        "id": task_id,
                        "instance": instance,
                        "error": f"failed to launch: {e}",
                    }
                    self._attach_finish_trace(msg, task_msg.get("trace"))
                    await self._send(msg)
                except (ConnectionError, OSError):
                    pass
        finally:
            self._discarded.discard(task_id)
            self.last_task_time = clock.monotonic()
            if held_stream_dir is not None:
                self._release_streamer(held_stream_dir)
            if self.localcomm is not None:
                self.localcomm.unregister_task(task_id)
            rt = self.running.pop(task_id, None)
            if rt is not None and rt.allocation is not None:
                self.allocator.release(rt.allocation)
            self._retry_blocked()

    @staticmethod
    def _attach_finish_trace(msg: dict, tctx: dict | None) -> None:
        """Echo the trace context + completion clocks on a terminal uplink.

        spawned_at rides AGAIN (it already went out on task_running) so a
        restarted server whose journal lost the start event in its
        unflushed tail can still close the trace with the execution span
        intact; sent_at is the uplink-enqueue clock — the worker-side end
        of the uplink span the server closes at receive time."""
        if tctx is None:
            return
        now = clock.now()
        msg["trace"] = {
            "id": tctx.get("id"),
            "parent": tctx.get("parent"),
            "spawned_at": tctx.get("spawned_at"),
            "exited_at": tctx.get("exited_at") or now,
            "sent_at": now,
        }

    # --- dispatch: runner pool fast path vs in-loop asyncio spawn --------
    MAX_LAUNCH_PLANS = 512

    def _n_cpus(self) -> int:
        from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT
        from hyperqueue_tpu_torch.resources.descriptor import DescriptorKind

        for item in self.configuration.descriptor.items:
            if item.name != "cpus":
                continue
            if item.kind is DescriptorKind.SUM:
                return max(1, item.sum_size // FRACTIONS_PER_UNIT)
            return max(1, sum(len(g) for g in item.index_groups()))
        return 1

    async def _launch(self, task_msg, allocation, streamer, extra_env):
        """Route a launch: warm runner pool for plain process tasks, the
        in-loop asyncio path for stream/stdin/gang tasks, zero-worker mode
        and a broken pool."""
        pool = self.runner_pool
        if (
            pool is not None
            and pool.available
            and not self.zero_worker
            and streamer is None
            and poolable(task_msg)
        ):
            plan = self._launch_plan(task_msg)
            spec = plan.instantiate(task_msg, allocation, extra_env)
            try:
                # no spawn ack on the hot path: the dispatch frame IS the
                # start (the runner spawns in-order), so the exit frame
                # stays the only per-task runner->worker wakeup; a spawn
                # failure surfaces through wait() as SpawnFailed. Tasks
                # with a time limit opt into the ack so the limit timer
                # arms at the real spawn, not at dispatch.
                ack = bool(
                    (task_msg.get("body") or {}).get("time_limit")
                )
                return await pool.launch(plan, spec, ack=ack)
            except RunnerCrashed:
                # pool raced into unavailability between the check and the
                # dispatch: this task still launches, just in-loop
                logger.warning(
                    "runner pool unavailable; task %d falls back to "
                    "in-loop spawn", task_msg["id"],
                )
        return await launch_task(
            task_msg,
            allocation,
            server_uid=self.server_uid,
            worker_id=self.worker_id,
            zero_worker=self.zero_worker,
            streamer=streamer,
            extra_env=extra_env,
        )

    def _launch_plan(self, task_msg) -> LaunchPlan:
        """Get-or-build the launch plan for this task's (program, env
        template, stdio shape). Keyed by the job and the IDENTITY of the
        shared body dict: an array's tasks share one body object on the
        wire, while a task submitted with different env/cwd/stdio carries a
        different body and therefore never reuses a stale plan."""
        key = (task_id_job(task_msg["id"]), id(task_msg.get("body")))
        plan = self._plan_cache.get(key)
        if plan is not None:
            _PLAN_LOOKUPS.labels("hit").inc()
            self._plan_cache.move_to_end(key)
            return plan
        _PLAN_LOOKUPS.labels("miss").inc()
        static_env = {}
        if self.localcomm is not None:
            static_env["HQ_LOCAL_SOCKET"] = self.localcomm.socket_path
        plan = LaunchPlan(
            task_msg, self.server_uid, self.worker_id, static_env=static_env
        )
        self._plan_cache[key] = plan
        while len(self._plan_cache) > self.MAX_LAUNCH_PLANS:
            _, evicted = self._plan_cache.popitem(last=False)
            self._drop_plan(evicted)
        return plan

    def _drop_plan(self, plan: LaunchPlan) -> None:
        if self.runner_pool is None:
            return
        for runner in self.runner_pool.runners:
            if plan.plan_id in runner.known_plans:
                runner.known_plans.discard(plan.plan_id)
                try:
                    runner.send({"op": "drop_plan", "plan": plan.plan_id})
                except (ConnectionError, OSError):
                    pass

    def _clear_launch_plans(self) -> None:
        """Reconnect invalidates every plan: plans embed HQ_WORKER_ID and
        the server uid, both of which change with the new registration."""
        for plan in self._plan_cache.values():
            self._drop_plan(plan)
        self._plan_cache.clear()

    # keep this many stream writers' fds open at most; in-use writers are
    # never closed, so the bound can be exceeded while > MAX distinct
    # stream dirs have running tasks
    MAX_STREAM_WRITERS = 64

    def _acquire_streamer(self, stream_dir: str):
        """Get-or-open the StreamWriter for a stream dir and hold a
        refcount on it for a running task.

        Eviction closes only ZERO-refcount writers (closing one under a
        running task fails that task's next write_chunk/close_task), in
        least-recently-USED order: reused dirs move to the end of the
        dict, so insertion order is true LRU order.  Pair every call with
        _release_streamer."""
        streamer = self._streamers.get(stream_dir)
        if streamer is not None:
            self._streamers.pop(stream_dir)
            self._streamers[stream_dir] = streamer
        else:
            from hyperqueue_tpu_torch.events.outputlog import StreamWriter

            # bound open fds: per-job stream dirs accumulate on a
            # long-lived worker.  If every writer is in use the bound is
            # exceeded rather than an in-flight task's writer closed.
            while len(self._streamers) >= self.MAX_STREAM_WRITERS:
                victim = next(
                    (
                        d for d in self._streamers
                        if not self._streamer_users.get(d)
                    ),
                    None,
                )
                if victim is None:
                    break
                self._streamers.pop(victim).close()
            streamer = StreamWriter(
                stream_dir, self.worker_id, self.server_uid
            )
            self._streamers[stream_dir] = streamer
        self._streamer_users[stream_dir] = (
            self._streamer_users.get(stream_dir, 0) + 1
        )
        return streamer

    def _release_streamer(self, stream_dir: str) -> None:
        remaining = self._streamer_users.get(stream_dir, 1) - 1
        if remaining > 0:
            self._streamer_users[stream_dir] = remaining
        else:
            self._streamer_users.pop(stream_dir, None)

    @staticmethod
    def _entries_sig(task_msg: dict):
        return tuple(
            (e["name"], e["amount"], e.get("policy", "compact"))
            for e in task_msg.get("entries", [])
        )

    def _retry_blocked(self) -> None:
        """Retry blocked tasks after a resource release.

        Blocked tasks are bucketed by resource signature; identical
        signatures fail identically, so each release only probes one head
        per signature group — O(#signatures), not O(#blocked), per release
        (the deep prefill queue made the naive scan the worker's dominant
        cost at 50k+ short tasks).  Signature groups are probed in
        head-priority order so a freed resource goes to the
        highest-priority waiter."""
        for sig in sorted(
            self.blocked,
            key=lambda s: tuple(self.blocked[s][0].get("priority") or (0, 0)),
            reverse=True,
        ):
            group = self.blocked.get(sig)
            while group:
                task_msg = group[0]
                allocation = self.allocator.try_allocate(
                    task_msg.get("entries", [])
                )
                if allocation is None:
                    break
                group.pop(0)
                self._n_blocked -= 1
                self._start_with_allocation(task_msg, allocation)
            if not group:
                self.blocked.pop(sig, None)

    def _remove_blocked(self, task_id: int) -> None:
        for sig, group in list(self.blocked.items()):
            kept = [t for t in group if t["id"] != task_id]
            self._n_blocked -= len(group) - len(kept)
            if kept:
                self.blocked[sig] = kept
            else:
                self.blocked.pop(sig, None)

    def _cancel_task(self, task_id: int) -> None:
        self._remove_blocked(task_id)
        rt = self.running.get(task_id)
        if rt is not None:
            if rt.launched is not None:
                rt.launched.kill()
            else:
                rt.future.cancel()

    async def _overview_loop(self) -> None:
        """Send hw telemetry on the configured cadence — or on the
        server-forced one while a dashboard listens (reference
        SetOverviewIntervalOverride, messages/worker.rs:76-165, applied in
        worker/rpc.rs:394-396)."""
        from hyperqueue_tpu_torch.worker.hwmonitor import HwSampler

        sampler = HwSampler()
        while True:
            interval = (
                self._overview_override
                if self._overview_override is not None
                else self.configuration.overview_interval_secs
            )
            self._overview_wake.clear()
            if interval <= 0:
                # overviews disabled: park until an override arrives
                await self._overview_wake.wait()
                continue
            try:
                # an arriving override interrupts the wait so a dashboard
                # gets telemetry immediately even under a long configured
                # interval (and detach restores the old cadence at once)
                await asyncio.wait_for(
                    self._overview_wake.wait(), timeout=interval
                )
                continue  # re-read the effective interval
            except asyncio.TimeoutError:
                pass  # cadence elapsed: sample and send
            # sampling shells out to nvidia-smi/rocm-smi (blocking, up to
            # seconds on a wedged driver); keep it off the event loop so
            # heartbeats and task messaging never stall
            hw = await asyncio.to_thread(sampler.sample)
            self._fold_hw_gauges(hw)
            await self._send(
                {
                    "op": "overview",
                    "hw": hw,
                    "n_running": len(self.running),
                    # gauge/counter samples ride along so the server can
                    # re-export a cluster-wide view with a `worker` label
                    # (and the dashboard reads gauges, not raw hw dicts)
                    "metrics": REGISTRY.export_samples(prefix="hq_worker_"),
                }
            )

    def _fold_hw_gauges(self, hw: dict) -> None:
        """HwSampler output -> hq_worker_* gauges (labels per GPU)."""
        _CPU.set(hw.get("cpu_usage_percent", 0.0))
        _MEM_TOTAL.set(hw.get("mem_total_bytes", 0))
        _MEM_AVAILABLE.set(hw.get("mem_available_bytes", 0))
        _LOAD.set(hw.get("loadavg_1m", 0.0))
        if "gpus" in hw:
            # clear even on an empty sample (transient nvidia-smi/rocm-smi
            # failure returns []): stale per-GPU series must not keep
            # exporting dead utilization as live
            _GPU.clear()
            _GPU_MEM.clear()
            for gpu in hw["gpus"]:
                gid = str(gpu.get("id", ""))
                _GPU.labels(gid).set(gpu.get("usage_percent", 0.0))
                _GPU_MEM.labels(gid).set(gpu.get("mem_usage_percent", 0.0))

    async def _heartbeat_loop(self) -> None:
        interval = max(self.configuration.heartbeat_secs, 0.5)
        while True:
            await asyncio.sleep(interval)
            await self._send({"op": "heartbeat"})

    # ---- health probes ----------------------------------------------
    # Served by the metrics endpoint on the worker's own event loop: a
    # wedged loop simply cannot answer, so a 200 is evidence the process
    # is actually turning over, not just that a socket is bound.

    def _probe_healthz(self):
        return True, {"role": "worker", "worker_id": self.worker_id}

    def _probe_readyz(self):
        checks = {
            # between sessions (server died, reconnect backoff running)
            # the worker must drop out of rotation: it cannot accept work
            "session": "ok" if self._session_live else "disconnected",
            "stopping": "ok" if not self._stop.is_set() else "stopping",
        }
        ok = all(v == "ok" for v in checks.values())
        return ok, {"role": "worker", "worker_id": self.worker_id,
                    "checks": checks}

    async def _goodbye(self, reason: str) -> None:
        """Tell the server this is a DELIBERATE exit (idle/time limit), so
        requeued tasks don't get charged a crash (reference CrashLimit:
        stops and time limits don't count). Sent directly — the batching
        drainer may never run again once _stop is set."""
        try:
            async with self._send_lock:
                await self._conn.send({"op": "goodbye", "reason": reason})
        except (ConnectionError, OSError):
            pass

    async def _limits_loop(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            now = clock.monotonic()
            limit = self.configuration.time_limit_secs
            if limit > 0 and now - self.started_at >= limit:
                logger.info("time limit reached; stopping")
                await self._goodbye("time limit")
                self._stop.set()
                return
            idle = self.configuration.idle_timeout_secs
            if (
                idle > 0
                and not self.running
                and not self.blocked
                and now - self.last_task_time >= idle
            ):
                logger.info("idle timeout reached; stopping")
                await self._goodbye("idle timeout")
                self._stop.set()
                return


async def run_worker(
    host: str,
    port: int,
    secret_key: bytes | None,
    configuration: WorkerConfiguration,
    zero_worker: bool = False,
    server_dir: Path | None = None,
    metrics_port: int | None = None,
    metrics_host: str = "0.0.0.0",
    profile_hz: float = 19.0,
) -> None:
    runtime = WorkerRuntime(
        host, port, secret_key, configuration, zero_worker=zero_worker,
        server_dir=server_dir, metrics_port=metrics_port,
        metrics_host=metrics_host, profile_hz=profile_hz,
    )
    await runtime.run()
