"""Worker-side manager of warm runner processes (worker/runner.py).

The pool pre-forks N runners at worker start (N sized to the worker's CPU
capacity). Launching a task costs one small frame written to a runner's
stdin — the runner `posix_spawn`s the payload off the worker's event loop
and streams spawn/exit events back. Launch plans (worker/launcher.py) are
replicated to a runner lazily the first time a launch references them, so
a 10k-task array ships its environment once per runner, not once per task.

A runner that dies mid-task is detected by EOF on its stdout: every
in-flight task on it is failed (never hung) and the runner is respawned,
subject to a restart budget so a crash-looping runner degrades the pool
instead of fork-bombing the node.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import struct
import sys
import time

from hyperqueue_tpu_torch.transport import codec
from hyperqueue_tpu_torch.utils.metrics import REGISTRY
from hyperqueue_tpu_torch.worker.launcher import cleanup_task_files
from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.worker.pool")

_LEN = struct.Struct("<I")

_RUNNER_RESTARTS = REGISTRY.counter(
    "hq_worker_runner_restarts_total",
    "runner processes respawned after a crash",
)
_RUNNER_CRASH_FAILS = REGISTRY.counter(
    "hq_worker_runner_crash_failed_tasks_total",
    "in-flight tasks failed because their runner process died",
)


def _runner_argv_env() -> tuple[list[str], dict]:
    """Command line + environment for one runner process, tuned for boot
    speed: run runner.py by PATH under `-S` (skips site/.pth processing —
    ~0.15 s per interpreter on hosts with heavyweight site hooks) with
    PYTHONPATH at the directory that holds this package: the runner's only
    import beyond the standard library is the package's codec
    (`transport/codec`, itself standard library only). Falls back to a
    plain `-m` boot when the file location is unknowable (zipped/namespace
    installs)."""
    env = dict(os.environ)
    from hyperqueue_tpu_torch.worker import runner as _runner_mod

    runner_file = getattr(_runner_mod, "__file__", None)
    codec_file = getattr(codec, "__file__", None)
    if runner_file and codec_file:
        # .../<root>/hyperqueue_tpu_torch/transport/codec.py -> <root>
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(codec_file))))
        return [sys.executable, "-S", runner_file], env
    return [sys.executable, "-m", "hyperqueue_tpu_torch.worker.runner"], env


class RunnerCrashed(Exception):
    """The runner supervising this task died before reporting its exit."""


class SpawnFailed(Exception):
    """The runner could not spawn the payload (bad program, cwd, perms)."""


class PooledProcess:
    """LaunchedTask-compatible handle for a payload supervised by a runner
    (worker/launcher.py LaunchedTask is the asyncio-path twin)."""

    __slots__ = (
        "_runner", "key", "pid", "spawned", "exited",
        "stdout_path", "stderr_path", "rm_if_finished", "cleanup_dirs",
        "spawned_wall",
    )

    def __init__(self, runner: "_Runner", key: int, spec: dict,
                 ack: bool = False):
        self._runner = runner
        self.key = key
        self.pid = 0
        # wall clock of the runner's spawn ack (trace worker/spawn span);
        # stays 0.0 on the no-ack hot path, where the in-order dispatch
        # itself is the spawn and the worker's own stamp stands in
        self.spawned_wall = 0.0
        loop = asyncio.get_running_loop()
        self.spawned: asyncio.Future | None = (
            loop.create_future() if ack else None
        )
        self.exited: asyncio.Future = loop.create_future()
        self.stdout_path = spec.get("stdout")
        self.stderr_path = spec.get("stderr")
        self.rm_if_finished = spec.get("rm_if_finished") or ()
        self.cleanup_dirs = spec.get("cleanup_dirs") or ()

    async def started(self) -> int:
        """With ack=True: resolves to the payload pid once the runner
        spawned it; raises on spawn failure (bad program, unreachable cwd,
        dead runner). Without the ack the dispatch itself is the start."""
        if self.spawned is None:
            return self.pid
        return await asyncio.shield(self.spawned)

    async def wait(self) -> tuple[int, str]:
        try:
            code, detail = await asyncio.shield(self.exited)
        except SpawnFailed:
            # the caller reports a launch failure, not a task exit; the
            # task dir was created at instantiate time and must not leak
            cleanup_task_files(-1, self.rm_if_finished, self.cleanup_dirs)
            raise
        except RunnerCrashed as e:
            # fail, never hang: the payload may or may not still run, but
            # its supervisor is gone — report and let the crash-counter
            # policy decide the task's fate. Scratch dirs go too (same
            # whatever-the-outcome contract as LaunchedTask.wait); an
            # unkillable orphan payload loses its TMPDIR, which is fine —
            # its incarnation is already failed and fenced out.
            cleanup_task_files(-1, self.rm_if_finished, self.cleanup_dirs)
            return -1, str(e)
        cleanup_task_files(code, self.rm_if_finished, self.cleanup_dirs)
        return code, detail

    def kill(self) -> None:
        self._runner.send_kill(self.key)


class _Runner:
    def __init__(self, pool: "RunnerPool", index: int):
        self.pool = pool
        self.index = index
        self.proc: asyncio.subprocess.Process | None = None
        self.known_plans: set[int] = set()
        self.inflight: dict[int, PooledProcess] = {}
        self._reader: asyncio.Task | None = None
        # True from the moment EOF is observed on stdout until the respawn
        # completes. proc.returncode alone is NOT a liveness signal here —
        # the child watcher may not have reaped yet while _on_runner_exit
        # awaits the restart, and dispatching into that window would
        # register a task the replacement process never learns about.
        self.dead = False

    async def start(self) -> None:
        argv, env = _runner_argv_env()
        self.proc = await asyncio.create_subprocess_exec(
            *argv,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=None,  # runner tracebacks land in the worker's log
            env=env,
        )
        self.known_plans = set()
        self.dead = False
        self._reader = asyncio.create_task(self._read_loop())

    def send(self, msg: dict) -> None:
        data = codec.packb(msg)
        self.proc.stdin.write(_LEN.pack(len(data)) + data)

    def send_kill(self, key: int) -> None:
        if self.proc is None or self.proc.stdin.is_closing():
            return
        self.send({"op": "kill", "key": key})

    async def _read_loop(self) -> None:
        reader = self.proc.stdout
        try:
            while True:
                header = await reader.readexactly(_LEN.size)
                (length,) = _LEN.unpack(header)
                msg = codec.unpackb(await reader.readexactly(length))
                self._dispatch(msg)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            # flagged BEFORE failing the in-flight set and with no await in
            # between: a concurrent launch() can never register a task on
            # this runner after its tasks were failed
            self.dead = True
            self._fail_inflight()
            await self.pool._on_runner_exit(self)

    def _dispatch(self, msg: dict) -> None:
        op = msg.get("op")
        task = self.inflight.get(msg.get("key"))
        if task is None:
            return
        if op == "spawned":
            task.pid = msg.get("pid", 0)
            task.spawned_wall = clock.now()
            if task.spawned is not None and not task.spawned.done():
                task.spawned.set_result(task.pid)
        elif op == "spawn_error":
            self.inflight.pop(task.key, None)
            err = SpawnFailed(msg.get("error", "spawn failed"))
            if task.spawned is not None and not task.spawned.done():
                task.spawned.set_exception(err)
                task.spawned.exception()  # wait() may be the only awaiter
            if not task.exited.done():
                task.exited.set_exception(err)
                task.exited.exception()  # started() may be the only awaiter
        elif op == "exit":
            self.inflight.pop(task.key, None)
            if task.spawned is not None and not task.spawned.done():
                task.spawned.set_result(0)
            if not task.exited.done():
                task.exited.set_result(
                    (msg.get("code", -1), msg.get("detail", ""))
                )

    def _fail_inflight(self) -> None:
        if not self.inflight:
            return
        _RUNNER_CRASH_FAILS.inc(len(self.inflight))
        err = RunnerCrashed(
            "runner process died while supervising this task"
        )
        for task in self.inflight.values():
            if task.pid:
                # the dead supervisor can't reap its children: kill the
                # payloads whose pids we know (spawn-acked), so the failed
                # task's re-run never races a live orphan. Un-acked
                # payloads are unkillable from here — they run to their
                # natural exit as orphans.
                try:
                    os.killpg(task.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    try:
                        os.kill(task.pid, signal.SIGKILL)
                    except (ProcessLookupError, OSError):
                        pass
            if task.spawned is not None and not task.spawned.done():
                task.spawned.set_exception(err)
                task.spawned.exception()  # may go unawaited on teardown
            if not task.exited.done():
                task.exited.set_exception(err)
                task.exited.exception()
        self.inflight.clear()

    def close_stdin(self) -> None:
        if self.proc is not None and not self.proc.stdin.is_closing():
            try:
                self.proc.stdin.close()
            except (ConnectionError, OSError):
                pass


class RunnerPool:
    # POOL-WIDE crash budget: more than BUDGET runner deaths within WINDOW
    # seconds permanently disables the pool for this worker's lifetime
    # (launch() raises; the runtime falls back to the in-loop asyncio
    # spawn path). Deliberately conservative: the budget is the fork-bomb
    # guard, the fallback path is fully functional, and a node-wide event
    # that kills several runners at once is exactly when respawn-looping
    # python interpreters would make things worse.
    RESTART_BUDGET = 5
    RESTART_WINDOW = 60.0

    def __init__(self, size: int):
        self.size = max(1, size)
        self.runners: list[_Runner] = []
        self._key_counter = 0
        self._closing = False
        self._restarts: list[float] = []  # monotonic stamps of respawns
        self.broken = False

    async def start(self) -> None:
        """Spawn the runners concurrently; each joins the pool as soon as
        it is up (callers launch through whatever is ready — the runtime
        falls back to in-loop spawn while the pool warms for ~0.5 s)."""
        async def one(i: int) -> None:
            runner = _Runner(self, i)
            await runner.start()
            if self._closing:
                runner.close_stdin()
                return
            self.runners.append(runner)

        await asyncio.gather(
            *(one(i) for i in range(self.size)), return_exceptions=False
        )

    async def _on_runner_exit(self, runner: _Runner) -> None:
        if self._closing or self.broken:
            return
        now = clock.monotonic()
        self._restarts = [
            t for t in self._restarts if now - t < self.RESTART_WINDOW
        ]
        if len(self._restarts) >= self.RESTART_BUDGET:
            logger.error(
                "runner %d exceeded the restart budget (%d in %.0fs); "
                "disabling the pool — tasks fall back to in-loop spawn",
                runner.index, self.RESTART_BUDGET, self.RESTART_WINDOW,
            )
            self.broken = True
            return
        self._restarts.append(now)
        _RUNNER_RESTARTS.inc()
        logger.warning("runner %d died; respawning", runner.index)
        try:
            await runner.start()
        except OSError as e:
            logger.error("runner respawn failed (%s); disabling pool", e)
            self.broken = True

    @property
    def available(self) -> bool:
        return bool(self.runners) and not self.broken and not self._closing

    def ensure_plan(self, runner: _Runner, plan) -> None:
        if plan.plan_id not in runner.known_plans:
            runner.send(
                {"op": "plan", "plan": plan.plan_id, "env": plan.base_env}
            )
            runner.known_plans.add(plan.plan_id)

    async def launch(self, plan, spec: dict, ack: bool = False) -> PooledProcess:
        """Dispatch one payload to the least-loaded live runner. With
        `ack` the runner confirms the spawn (started() resolves to the
        real pid); without it the exit frame is the only per-task reply."""
        if not self.available:
            raise RunnerCrashed("runner pool is unavailable")
        runner = min(
            (
                r for r in self.runners
                if not r.dead and r.proc.returncode is None
            ),
            key=lambda r: len(r.inflight),
            default=None,
        )
        if runner is None:
            raise RunnerCrashed("no live runner")
        self.ensure_plan(runner, plan)
        self._key_counter += 1
        key = self._key_counter
        task = PooledProcess(runner, key, spec, ack=ack)
        runner.inflight[key] = task
        msg = {
            "op": "launch", "key": key, "plan": plan.plan_id,
            "cmd": spec["cmd"],
        }
        if ack:
            msg["ack"] = True
        for field in ("env", "cwd", "stdout", "stderr"):
            if spec.get(field) is not None:
                msg[field] = spec[field]
        runner.send(msg)
        try:
            stdin = runner.proc.stdin
            if stdin.transport.get_write_buffer_size() > 1 << 20:
                await stdin.drain()
        except asyncio.CancelledError:
            # the launch frame is already on its way: a cancellation here
            # (task canceled mid-dispatch) must not leak the payload
            runner.send_kill(key)
            raise
        return task

    async def close(self) -> None:
        """Drain: EOF every runner's stdin (each kills its children and
        exits), then reap with a deadline."""
        self._closing = True
        for runner in self.runners:
            runner.close_stdin()
        for runner in self.runners:
            if runner.proc is None:
                continue
            try:
                await asyncio.wait_for(runner.proc.wait(), timeout=5)
            except asyncio.TimeoutError:
                try:
                    runner.proc.kill()
                except ProcessLookupError:
                    pass
        self.runners = []
