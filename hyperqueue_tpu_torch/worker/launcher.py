"""Task launcher: turn a compute message into a supervised OS process.

Reference: crates/hyperqueue/src/worker/start/program.rs (build_program_task)
— placeholder resolution, stdout/stderr redirection, stdin injection, HQ_*
environment, per-resource env vars with the concrete claimed indices, node
files for multi-node gangs, and a zero-cost mode for overhead benchmarking
(program.rs:498,622 `zero_worker`).

Two launch paths share the semantics above:

- `launch_task` — the original in-loop asyncio path, still used for
  stream-mode tasks (output pumps need the pipes in the worker), stdin
  injection, multi-node gangs, and as the fallback when the runner pool is
  unavailable.
- `LaunchPlan` — the amortized hot path. Tasks with identical (program,
  env template, stdio shape) share one plan: the merged environment,
  placeholder-free path prefixes, and directory creation are computed once
  per plan instead of once per task, and `instantiate` emits the small
  per-task spec a warm runner process (worker/runner.py) turns into a
  `posix_spawn`.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import signal
from dataclasses import dataclass
from pathlib import Path

from hyperqueue_tpu_torch.ids import task_id_job, task_id_task
from hyperqueue_tpu_torch.utils.placeholders import fill_placeholders, task_placeholder_map
from hyperqueue_tpu_torch.worker.allocator import Allocation
from hyperqueue_tpu_torch.utils import clock


def stderr_tail(stderr_path: str | None, nbytes: int = 2048) -> str:
    """Last bytes of a task's stderr, the failure detail shown to the user.

    worker/runner.py mirrors this inline (its `-S` boot imports nothing of
    the package beyond the codec); keep the two in sync.
    """
    if not stderr_path:
        return ""
    try:
        with open(stderr_path, "rb") as f:
            f.seek(max(0, os.path.getsize(stderr_path) - nbytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def cleanup_task_files(
    code: int, rm_if_finished: tuple, cleanup_dirs: tuple
) -> None:
    if code == 0:
        # reference FileOnCloseBehavior::RmIfFinished (program.rs)
        for path in rm_if_finished:
            try:
                os.unlink(path)
            except OSError:
                pass
    # task dirs are transient scratch space, deleted when the task
    # completes whatever the outcome (reference program.rs task-dir
    # removal; tests/test_task_cleanup.py)
    for d in cleanup_dirs:
        shutil.rmtree(d, ignore_errors=True)


@dataclass
class LaunchedTask:
    process: asyncio.subprocess.Process | None
    stdout_path: str | None
    stderr_path: str | None
    pumps: tuple = ()  # stream-mode output pump tasks
    rm_if_finished: tuple = ()  # stdio paths removed on successful exit
    cleanup_dirs: tuple = ()  # task dirs removed once the task completes
    # wall clock of the actual process spawn, for the task's distributed
    # trace (worker/spawn span); 0.0 when unknown (zero-worker mode)
    spawned_wall: float = 0.0

    async def started(self) -> int:
        """Parity with PooledProcess.started(): the in-loop path has
        already spawned by the time the handle exists."""
        return self.process.pid if self.process is not None else 0

    async def wait(self) -> tuple[int, str]:
        """Returns (exit_code, error_detail)."""
        if self.process is None:  # zero-worker mode
            return 0, ""
        if self.pumps:
            await asyncio.gather(*self.pumps, return_exceptions=True)
        code = await self.process.wait()
        detail = stderr_tail(self.stderr_path) if code != 0 else ""
        cleanup_task_files(code, self.rm_if_finished, self.cleanup_dirs)
        return code, detail

    def kill(self) -> None:
        if self.process is not None and self.process.returncode is None:
            try:
                os.killpg(self.process.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    self.process.kill()
                except ProcessLookupError:
                    pass


async def launch_task(
    task_msg: dict,
    allocation: Allocation | None,
    server_uid: str,
    worker_id: int,
    zero_worker: bool = False,
    streamer=None,  # events.outputlog.StreamWriter when body["stream"] set
    extra_env: dict | None = None,
) -> LaunchedTask:
    """Spawn the task process described by a compute message.

    task_msg: {id, instance, body{cmd,env,cwd,stdout,stderr,stdin}, entries,
    node_ids?, node_hostnames?}.
    """
    if zero_worker:
        # benchmarking mode: skip process spawn entirely, instant success
        return LaunchedTask(process=None, stdout_path=None, stderr_path=None)

    body = task_msg.get("body") or {}
    task_id = task_msg["id"]
    job_id = task_id_job(task_id)
    job_task_id = task_id_task(task_id)
    submit_dir = body.get("submit_dir") or os.getcwd()
    mapping = task_placeholder_map(
        job_id=job_id,
        job_task_id=job_task_id,
        instance_id=task_msg.get("instance", 0),
        submit_dir=submit_dir,
        server_uid=server_uid,
    )

    cwd = body.get("cwd") or submit_dir
    cwd = fill_placeholders(cwd, mapping)
    mapping["CWD"] = cwd
    Path(cwd).mkdir(parents=True, exist_ok=True)

    env = dict(os.environ)
    env.update({k: str(v) for k, v in (body.get("env") or {}).items()})
    env.update(extra_env or {})
    env["HQ_JOB_ID"] = str(job_id)
    env["HQ_TASK_ID"] = str(job_task_id)
    env["HQ_INSTANCE_ID"] = str(task_msg.get("instance", 0))
    env["HQ_SUBMIT_DIR"] = submit_dir
    env["HQ_SERVER_UID"] = server_uid
    env["HQ_WORKER_ID"] = str(worker_id)
    env["HQ_ENTRY"] = task_msg.get("entry") or body.get("entry", "") or ""
    if not env["HQ_ENTRY"]:
        env.pop("HQ_ENTRY")

    if allocation is not None:
        for claim in allocation.claims:
            name = claim.resource
            value = claim.env_value()
            env[f"HQ_RESOURCE_VALUES_{name}"] = value
            env[f"HQ_RESOURCE_REQUEST_{name}"] = str(claim.amount())
            if name == "cpus":
                env["HQ_CPUS"] = value
                # CPU pinning hint for OpenMP-style programs (reference
                # program.rs:350 additionally taskset-pins; we export the
                # portable subset). A user-supplied --env OMP_NUM_THREADS
                # wins (reference test_do_not_override_set_omp_num_threads)
                if "OMP_NUM_THREADS" not in (body.get("env") or {}):
                    env["OMP_NUM_THREADS"] = str(
                        max(len(claim.indices), 1)
                    )

    cleanup_dirs: list[str] = []

    # optional private task directory (reference program.rs task-dir)
    if body.get("task_dir"):
        task_dir = Path(cwd) / f".hq-task-dir-{job_id}-{job_task_id}-{task_msg.get('instance', 0)}"
        task_dir.mkdir(parents=True, exist_ok=True)
        env["HQ_TASK_DIR"] = str(task_dir)
        env.setdefault("TMPDIR", str(task_dir))
        cleanup_dirs.append(str(task_dir))

    # multi-node gang: write the node file and expose it
    node_hostnames = task_msg.get("node_hostnames")
    if node_hostnames:
        # instance-suffixed like the private task dir: on a shared FS a dying
        # prior instance's cleanup must not delete the rescheduled
        # instance's node file
        task_dir = (
            Path(cwd)
            / f".hq-task-{job_id}-{job_task_id}-{task_msg.get('instance', 0)}"
        )
        task_dir.mkdir(parents=True, exist_ok=True)
        node_file = task_dir / "hq_nodes"
        node_file.write_text("\n".join(node_hostnames) + "\n")
        cleanup_dirs.append(str(task_dir))
        env["HQ_NODE_FILE"] = str(node_file)
        env["HQ_HOST_FILE"] = str(node_file)
        env["HQ_NUM_NODES"] = str(len(node_hostnames))

    stream_mode = streamer is not None and body.get("stream")

    rm_paths: list[str] = []

    def open_stdio(key: str):
        if stream_mode:
            return asyncio.subprocess.PIPE, None
        spec = body.get(key)
        if spec == "none":
            return asyncio.subprocess.DEVNULL, None
        # `<path>:rm-if-finished` / `:rm-if-finished` (default path): remove
        # the file when the task exits successfully (reference StdioDefInput)
        rm_on_ok = False
        if spec and spec.endswith(":rm-if-finished"):
            rm_on_ok = True
            spec = spec[: -len(":rm-if-finished")]
        if not spec:
            spec = f"%{{SUBMIT_DIR}}/job-%{{JOB_ID}}/%{{TASK_ID}}.{key}"
        path = fill_placeholders(spec, mapping)
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if rm_on_ok:
            rm_paths.append(path)
        return open(path, "wb"), path

    stdout_f, stdout_path = open_stdio("stdout")
    stderr_f, stderr_path = open_stdio("stderr")

    stdin_data = body.get("stdin")
    cmd = [fill_placeholders(str(c), mapping) for c in body["cmd"]]
    # CPU pinning (reference program.rs:350): taskset with the claimed cpu
    # indices, or OMP env pinning
    pin_mode = body.get("pin")
    if pin_mode and allocation is not None:
        cpu_claim = allocation.claim_for("cpus")
        if cpu_claim is not None and cpu_claim.indices:
            cpu_list = ",".join(cpu_claim.indices)
            env["HQ_PIN"] = pin_mode  # reference program.rs sets HQ_PIN
            if pin_mode == "taskset":
                cmd = ["taskset", "-c", cpu_list, *cmd]
            elif pin_mode == "omp":
                env["OMP_PLACES"] = "{" + "},{".join(cpu_claim.indices) + "}"
                env["OMP_PROC_BIND"] = "close"
    try:
        process = await asyncio.create_subprocess_exec(
            *cmd,
            cwd=cwd,
            env=env,
            stdin=asyncio.subprocess.PIPE if stdin_data else asyncio.subprocess.DEVNULL,
            stdout=stdout_f,
            stderr=stderr_f,
            start_new_session=True,  # own process group => killable subtree
        )
    finally:
        for f in (stdout_f, stderr_f):
            if hasattr(f, "close"):
                f.close()
    if stdin_data:
        process.stdin.write(stdin_data)
        process.stdin.write_eof()

    pumps = ()
    if stream_mode:
        from hyperqueue_tpu_torch.events.outputlog import STDERR, STDOUT

        instance = task_msg.get("instance", 0)

        async def pump(reader, channel):
            while True:
                chunk = await reader.read(64 * 1024)
                if not chunk:
                    break
                streamer.write_chunk(task_id, instance, channel, chunk)

        pumps = (
            asyncio.create_task(pump(process.stdout, STDOUT)),
            asyncio.create_task(pump(process.stderr, STDERR)),
        )
    return LaunchedTask(
        process=process,
        stdout_path=stdout_path,
        stderr_path=stderr_path,
        pumps=pumps,
        rm_if_finished=tuple(rm_paths),
        cleanup_dirs=tuple(cleanup_dirs),
        spawned_wall=clock.now(),
    )


# ---------------------------------------------------------------------------
# Amortized launch plans for the warm runner pool
# ---------------------------------------------------------------------------

_DEFAULT_STDIO = "%{SUBMIT_DIR}/job-%{JOB_ID}/%{TASK_ID}.{key}"


def _absolute(path: str) -> str:
    """Resolve a relative spec against the worker's cwd — matching the
    in-loop path above. Runners chdir per task (posix_spawn has no cwd
    parameter), so every path shipped to one must be absolute or it would
    resolve against whatever directory the previous task left behind."""
    return path if os.path.isabs(path) else os.path.abspath(path)


def poolable(task_msg: dict) -> bool:
    """Can this compute message go through the runner pool?

    Stream mode needs the output pipes in the worker process (pump tasks),
    stdin injection needs a writable pipe, and multi-node gangs write node
    files with gang-level context — all three stay on the in-loop
    `launch_task` path.
    """
    body = task_msg.get("body") or {}
    return not (
        body.get("stream")
        or body.get("stdin")
        or task_msg.get("node_hostnames")
    )


class LaunchPlan:
    """Per-(program, env template, stdio shape) launch setup, built once.

    The plan owns everything identical across an array's tasks: the merged
    base environment (os.environ + submit env + job-level HQ_* vars), the
    filled-or-template cwd and stdio specs, and a memo of directories
    already created. `instantiate` does only the per-task work: task-id
    placeholder fills (skipped entirely for placeholder-free templates),
    claimed-resource env vars, and stdio paths.
    """

    _id_counter = 0

    __slots__ = (
        "plan_id", "body", "job_id", "submit_dir", "base_env", "base_mapping",
        "cmd", "cmd_has_ph", "cwd_spec", "cwd_has_ph", "cwd_static",
        "stdout_spec", "stdout_rm", "stderr_spec", "stderr_rm",
        "pin_mode", "task_dir", "omp_default", "tmpdir_default",
        "_made_dirs",
    )

    def __init__(
        self,
        task_msg: dict,
        server_uid: str,
        worker_id: int,
        static_env: dict | None = None,
    ):
        LaunchPlan._id_counter += 1
        self.plan_id = LaunchPlan._id_counter
        body = task_msg.get("body") or {}
        # the body dict is SHARED between an array's tasks (wire
        # shared/separate split); holding it keeps id(body) — the cache
        # key component — stable for the plan's lifetime
        self.body = body
        task_id = task_msg["id"]
        self.job_id = task_id_job(task_id)
        self.submit_dir = body.get("submit_dir") or os.getcwd()
        self.base_mapping = {
            "JOB_ID": str(self.job_id),
            "SUBMIT_DIR": self.submit_dir,
            "SERVER_UID": server_uid,
        }

        env = dict(os.environ)
        body_env = body.get("env") or {}
        env.update({k: str(v) for k, v in body_env.items()})
        env.update(static_env or {})
        env["HQ_JOB_ID"] = str(self.job_id)
        env["HQ_SUBMIT_DIR"] = self.submit_dir
        env["HQ_SERVER_UID"] = server_uid
        env["HQ_WORKER_ID"] = str(worker_id)
        self.base_env = env
        # a user-supplied OMP_NUM_THREADS wins over the per-claim default
        self.omp_default = "OMP_NUM_THREADS" not in body_env
        self.tmpdir_default = "TMPDIR" not in env

        self.cmd = [str(c) for c in body["cmd"]]
        self.cmd_has_ph = any("%{" in c for c in self.cmd)
        self.cwd_spec = body.get("cwd") or self.submit_dir
        self.cwd_has_ph = "%{" in self.cwd_spec
        self._made_dirs: set[str] = set()
        if not self.cwd_has_ph:
            self.cwd_static = _absolute(fill_placeholders(
                self.cwd_spec, self.base_mapping
            ))
            self._mkdir(self.cwd_static)
        else:
            self.cwd_static = None
        self.stdout_spec, self.stdout_rm = self._stdio_spec(body, "stdout")
        self.stderr_spec, self.stderr_rm = self._stdio_spec(body, "stderr")
        self.pin_mode = body.get("pin")
        self.task_dir = bool(body.get("task_dir"))

    @staticmethod
    def _stdio_spec(body: dict, key: str) -> tuple[str | None, bool]:
        """Returns (path template | None for devnull, rm-if-finished)."""
        spec = body.get(key)
        if spec == "none":
            return None, False
        rm_on_ok = False
        if spec and spec.endswith(":rm-if-finished"):
            rm_on_ok = True
            spec = spec[: -len(":rm-if-finished")]
        if not spec:
            spec = _DEFAULT_STDIO.replace("{key}", key)
        return spec, rm_on_ok

    def _mkdir(self, path: str) -> None:
        if path not in self._made_dirs:
            Path(path).mkdir(parents=True, exist_ok=True)
            self._made_dirs.add(path)

    def instantiate(
        self,
        task_msg: dict,
        allocation: Allocation | None,
        extra_env: dict | None = None,
    ) -> dict:
        """Per-task launch spec for the runner pool: cmd, env delta over the
        plan's base env, cwd, stdio paths, cleanup lists."""
        task_id = task_msg["id"]
        job_task_id = task_id_task(task_id)
        instance = task_msg.get("instance", 0)
        mapping = dict(self.base_mapping)
        mapping["TASK_ID"] = str(job_task_id)
        mapping["INSTANCE_ID"] = str(instance)
        if self.cwd_has_ph:
            cwd = _absolute(fill_placeholders(self.cwd_spec, mapping))
            self._mkdir(cwd)
        else:
            cwd = self.cwd_static
        mapping["CWD"] = cwd

        delta: dict[str, str] = {
            "HQ_TASK_ID": str(job_task_id),
            "HQ_INSTANCE_ID": str(instance),
        }
        if extra_env:
            delta.update(extra_env)
        entry = task_msg.get("entry") or self.body.get("entry", "") or ""
        if entry:
            delta["HQ_ENTRY"] = entry

        cmd = (
            [fill_placeholders(c, mapping) for c in self.cmd]
            if self.cmd_has_ph
            else self.cmd
        )
        if allocation is not None:
            for claim in allocation.claims:
                name = claim.resource
                value = claim.env_value()
                delta[f"HQ_RESOURCE_VALUES_{name}"] = value
                delta[f"HQ_RESOURCE_REQUEST_{name}"] = str(claim.amount())
                if name == "cpus":
                    delta["HQ_CPUS"] = value
                    if self.omp_default:
                        delta["OMP_NUM_THREADS"] = str(
                            max(len(claim.indices), 1)
                        )
            if self.pin_mode:
                cpu_claim = allocation.claim_for("cpus")
                if cpu_claim is not None and cpu_claim.indices:
                    delta["HQ_PIN"] = self.pin_mode
                    if self.pin_mode == "taskset":
                        cmd = [
                            "taskset", "-c", ",".join(cpu_claim.indices),
                            *cmd,
                        ]
                    elif self.pin_mode == "omp":
                        delta["OMP_PLACES"] = (
                            "{" + "},{".join(cpu_claim.indices) + "}"
                        )
                        delta["OMP_PROC_BIND"] = "close"

        cleanup_dirs: list[str] = []
        if self.task_dir:
            task_dir = (
                Path(cwd)
                / f".hq-task-dir-{self.job_id}-{job_task_id}-{instance}"
            )
            task_dir.mkdir(parents=True, exist_ok=True)
            delta["HQ_TASK_DIR"] = str(task_dir)
            if self.tmpdir_default:
                delta["TMPDIR"] = str(task_dir)
            cleanup_dirs.append(str(task_dir))

        rm_paths: list[str] = []

        def stdio_path(spec: str | None, rm: bool) -> str | None:
            if spec is None:
                return None
            path = fill_placeholders(spec, mapping) if "%{" in spec else spec
            path = _absolute(path)
            parent = os.path.dirname(path)
            if parent:
                self._mkdir(parent)
            if rm:
                rm_paths.append(path)
            return path

        return {
            "cmd": cmd,
            "env": delta,
            "cwd": cwd,
            "stdout": stdio_path(self.stdout_spec, self.stdout_rm),
            "stderr": stdio_path(self.stderr_spec, self.stderr_rm),
            "rm_if_finished": tuple(rm_paths),
            "cleanup_dirs": tuple(cleanup_dirs),
        }
