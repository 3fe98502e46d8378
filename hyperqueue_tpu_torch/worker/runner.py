"""Warm runner process: the worker's pre-forked spawn helper.

One runner is a long-lived child of the worker. It reads launch specs over
stdin (u32-LE length-prefixed msgpack frames, through the package's own
codec, `transport/codec`: the runner imports nothing else of the package,
and neither torch nor numpy), `posix_spawn`s the payload,
and reports spawn/exit events back over stdout. This removes the two
dominant per-task costs of the in-loop `asyncio.create_subprocess_exec`
path:

- **fork of the worker interpreter**: asyncio's subprocess machinery
  fork+execs the (large) worker process per task; the runner's
  `posix_spawn` is the vfork-style fast path and never copies the worker.
- **event-loop serialization**: spawn syscalls block whichever process
  issues them; in the runner they overlap with the worker's message loop,
  uplink batching, and the other runners.

Tasks with the same launch *plan* (program + env template + stdio shape,
see worker/launcher.py LaunchPlan) share the plan's prebuilt environment:
the worker sends the plan once per runner and each launch frame carries
only the per-task delta (task id vars, claimed resources, stdio paths).

Protocol (worker -> runner):
  {op: "plan", plan: id, env: {K: V}}           cache a base environment
  {op: "launch", key, plan?, cmd, env?, cwd?,
   stdout?, stderr?}                            spawn one payload
  {op: "kill", key}                             SIGKILL the payload's group
Runner -> worker:
  {op: "spawned", key, pid}
  {op: "spawn_error", key, error}
  {op: "exit", key, code, detail}

EOF on stdin (worker died or pool drain) kills every supervised child and
exits — a runner never outlives its worker.
"""

from __future__ import annotations

import os
import signal
import struct
import sys
import threading
import time

from hyperqueue_tpu_torch.transport import codec

_LEN = struct.Struct("<I")


def _read_exact(fd: int, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class Runner:
    def __init__(self):
        self._plans: dict[int, dict] = {}
        self._lock = threading.Lock()  # children maps + stdout writes
        self._children: dict[int, tuple[int, str | None]] = {}  # pid ->
        self._key_pid: dict[int, int] = {}
        # pid -> wait status for children the reaper collected BEFORE
        # _spawn registered them (a payload like `true` can exit between
        # posix_spawn returning and the bookkeeping below); registration
        # reconciles so the exit frame is never lost
        self._unclaimed: dict[int, int] = {}
        # kills that arrived before (or instead of) their launch frame
        self._pending_kills: set[int] = set()
        self._have_child = threading.Condition(self._lock)
        self._closing = False
        self._devnull = os.open(os.devnull, os.O_RDWR)
        self._cwd = os.getcwd()
        # POSIX_SPAWN_SETSID may be unsupported; fall back to a fresh
        # process group (still killable as a subtree via killpg)
        self._setsid_ok = True

    def _send(self, obj: dict) -> None:
        data = codec.packb(obj)
        try:
            with self._lock:
                os.write(1, _LEN.pack(len(data)) + data)
        except OSError:
            pass  # worker gone mid-shutdown; the exit is moot

    # --- spawn -----------------------------------------------------------
    def _spawn(self, msg: dict) -> None:
        key = msg["key"]
        with self._lock:
            if key in self._pending_kills:
                self._pending_kills.discard(key)
                canceled = True
            else:
                canceled = False
            # keys are monotonic and launches arrive in key order on this
            # stdin: a pending kill below the current key can never match a
            # future launch (its payload already exited before the kill) —
            # prune, or cancel-after-exit races grow the set forever
            if self._pending_kills:
                self._pending_kills = {
                    k for k in self._pending_kills if k > key
                }
        if canceled:
            self._send({"op": "exit", "key": key, "code": -9,
                        "detail": "killed before spawn"})
            return
        plan = self._plans.get(msg.get("plan", -1))
        env = dict(plan["env"]) if plan else {}
        delta = msg.get("env")
        if delta:
            env.update(delta)
        cmd = [str(c) for c in msg["cmd"]]
        cwd = msg.get("cwd")
        stdout_path = msg.get("stdout")
        stderr_path = msg.get("stderr")
        fds: list[int] = []
        try:
            if cwd and cwd != self._cwd:
                # posix_spawn has no cwd parameter; only this thread spawns,
                # so the runner-global cwd is safe to retarget per launch
                try:
                    os.chdir(cwd)
                except FileNotFoundError:
                    # the plan mkdirs cwd once; recreate if deleted mid-array
                    os.makedirs(cwd, exist_ok=True)
                    os.chdir(cwd)
                self._cwd = cwd
            actions = [(os.POSIX_SPAWN_DUP2, self._devnull, 0)]
            for path, target in ((stdout_path, 1), (stderr_path, 2)):
                if path is None:
                    actions.append((os.POSIX_SPAWN_DUP2, self._devnull, target))
                else:
                    fd = self._open_stdio(path)
                    fds.append(fd)
                    actions.append((os.POSIX_SPAWN_DUP2, fd, target))
            if self._setsid_ok:
                try:
                    pid = os.posix_spawnp(
                        cmd[0], cmd, env, file_actions=actions, setsid=True
                    )
                except NotImplementedError:
                    self._setsid_ok = False
                    pid = os.posix_spawnp(
                        cmd[0], cmd, env, file_actions=actions, setpgroup=0
                    )
            else:
                pid = os.posix_spawnp(
                    cmd[0], cmd, env, file_actions=actions, setpgroup=0
                )
        except Exception as e:  # noqa: BLE001 - report, keep the runner alive
            self._send({"op": "spawn_error", "key": key, "error": str(e)})
            return
        finally:
            for fd in fds:
                os.close(fd)
        with self._have_child:
            status = self._unclaimed.pop(pid, None)
            if status is None:
                self._children[pid] = (key, stderr_path)
                self._key_pid[key] = pid
                self._have_child.notify()
        if msg.get("ack"):
            # the spawn ack is opt-in: on the hot path the exit frame is
            # the only per-task uplink, halving runner->worker wakeups
            self._send({"op": "spawned", "key": key, "pid": pid})
        if status is not None:
            # the child already exited and was reaped unclaimed
            self._report_exit(key, stderr_path, status)

    @staticmethod
    def _open_stdio(path: str) -> int:
        flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
        try:
            return os.open(path, flags, 0o644)
        except FileNotFoundError:
            # the worker's LaunchPlan mkdirs stdio parents once per plan;
            # recreate if an external cleanup removed the dir mid-array
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            return os.open(path, flags, 0o644)

    def _kill(self, key: int) -> None:
        with self._lock:
            pid = self._key_pid.get(key)
            if pid is None:
                # launch frame not processed yet (or already exited): mark
                # so a queued launch is refused instead of racing the kill
                self._pending_kills.add(key)
                return
        self._kill_pid(pid)

    @staticmethod
    def _kill_pid(pid: int) -> None:
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, OSError):
                pass

    # --- reap ------------------------------------------------------------
    def _reaper(self) -> None:
        while True:
            with self._have_child:
                while not self._children and not self._closing:
                    self._have_child.wait()
                if self._closing and not self._children:
                    return
            try:
                pid, status = os.waitpid(-1, 0)
            except ChildProcessError:
                # no children despite bookkeeping saying otherwise: yield
                # instead of hot-spinning while the maps catch up
                time.sleep(0.005)
                continue
            with self._lock:
                entry = self._children.pop(pid, None)
                if entry is not None:
                    self._key_pid.pop(entry[0], None)
                else:
                    # exited before _spawn registered it: park the status,
                    # registration sends the exit frame
                    self._unclaimed[pid] = status
            if entry is None:
                continue
            key, stderr_path = entry
            self._report_exit(key, stderr_path, status)

    def _report_exit(self, key: int, stderr_path: str | None,
                     status: int) -> None:
        code = os.waitstatus_to_exitcode(status)
        detail = ""
        if code != 0 and stderr_path:
            try:
                size = os.path.getsize(stderr_path)
                with open(stderr_path, "rb") as f:
                    f.seek(max(0, size - 2048))
                    detail = f.read().decode(errors="replace")
            except OSError:
                pass
        self._send({"op": "exit", "key": key, "code": code,
                    "detail": detail})

    # --- main loop -------------------------------------------------------
    def run(self) -> int:
        reaper = threading.Thread(target=self._reaper, daemon=True)
        reaper.start()
        while True:
            header = _read_exact(0, _LEN.size)
            if header is None:
                break
            (length,) = _LEN.unpack(header)
            payload = _read_exact(0, length)
            if payload is None:
                break
            msg = codec.unpackb(payload)
            op = msg.get("op")
            if op == "launch":
                self._spawn(msg)
            elif op == "kill":
                self._kill(msg["key"])
            elif op == "plan":
                self._plans[msg["plan"]] = msg
            elif op == "drop_plan":
                self._plans.pop(msg["plan"], None)
        # worker gone / drain requested: no payload outlives the worker.
        # The reaper owns waitpid — just kill and let it drain the zombies.
        with self._have_child:
            self._closing = True
            pids = list(self._children)
            self._have_child.notify()
        for pid in pids:
            self._kill_pid(pid)
        reaper.join(timeout=10)
        return 0


def main() -> int:
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # worker decides lifetime
    return Runner().run()


if __name__ == "__main__":
    sys.exit(main())
