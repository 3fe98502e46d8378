"""Queue handlers: build and submit PBS/Slurm/local allocations.

Reference: crates/hyperqueue/src/server/autoalloc/queue/{pbs,slurm,common}.rs —
a QueueHandler trait with qsub/sbatch script builders and qstat/sacct status
refresh. External binaries are resolved via PATH, which is also how the test
mock takes over (reference tests/autoalloc/mock; ours: fake executables on
PATH writing their argv to files).

Beyond the reference:

- every external queue-manager subprocess is bounded by a hard timeout +
  kill (`HQ_AUTOALLOC_MANAGER_TIMEOUT`, default 30 s): a hung
  `sbatch`/`qstat` is a submit/refresh FAILURE, never a wedged autoalloc
  tick loop (counted in ``hq_autoalloc_manager_timeouts_total``);
- a ``local`` handler that spawns real worker processes on the server's
  host — the whole autoscaling loop runs in CI without a batch scheduler,
  and doubles as the FaultPlan chaos surface (submit fails, allocation
  stuck queued, worker boots then dies, worker never registers);
- submit scripts write their pid to ``<workdir>/pid`` so a crash between
  the submit and its journal record leaves an adoptable trail instead of a
  leaked allocation (events/restore.py + service reconciliation).
"""

from __future__ import annotations

import asyncio
import json
import os
import shlex
import signal
import sys
from pathlib import Path

from hyperqueue_tpu_torch.autoalloc.state import QueueParams
from hyperqueue_tpu_torch.utils import chaos
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

# hard ceiling on any single qsub/sbatch/qstat/sacct/qdel/scancel call
MANAGER_TIMEOUT_SECS = float(
    os.environ.get("HQ_AUTOALLOC_MANAGER_TIMEOUT", "30.0")
)

_MANAGER_TIMEOUTS = REGISTRY.counter(
    "hq_autoalloc_manager_timeouts_total",
    "external queue-manager calls (qsub/sbatch/qstat/sacct/...) killed "
    "after the hard timeout; counted as submit/refresh failures",
)


class SubmitError(Exception):
    pass


class ManagerTimeout(SubmitError):
    """An external manager binary exceeded the hard call timeout."""


def _format_walltime(secs: float) -> str:
    secs = int(secs)
    return f"{secs // 3600:02d}:{(secs % 3600) // 60:02d}:{secs % 60:02d}"


def _worker_command(server_dir: str, queue_id: int, params: QueueParams) -> str:
    # the elasticity controller owns scale-down: it DRAINS a worker once it
    # has idled for the queue's idle timeout (masked from the solve, so no
    # assignment can race its departure). The worker's own idle timeout is
    # kept as a 4x fallback for when the server is unreachable and cannot
    # drive the drain.
    args = [
        sys.executable,
        "-m",
        "hyperqueue_tpu_torch",
        "worker",
        "start",
        "--server-dir",
        server_dir,
        "--idle-timeout",
        str(params.idle_timeout_secs * 4),
        "--time-limit",
        str(params.worker_time_limit_secs or params.time_limit_secs),
        "--on-server-lost",
        params.on_server_lost or "finish-running",
        *params.worker_args,
    ]
    cmd = " ".join(shlex.quote(a) for a in args)
    if params.worker_wrap_cmd:
        # reference worker_wrap_cmd: `<wrap> hq worker start ...`
        cmd = f"{params.worker_wrap_cmd} {cmd}"
    return cmd


def _node_command(params: QueueParams, worker_cmd: str) -> str:
    """Per-node shell line: start hook, (wrapped) worker, stop hook.
    The stop hook runs regardless of the worker's exit status
    (reference worker_start_cmd/worker_stop_cmd, best-effort)."""
    parts = []
    if params.worker_start_cmd:
        parts.append(params.worker_start_cmd)
    parts.append(worker_cmd)
    if params.worker_stop_cmd:
        parts.append(params.worker_stop_cmd)
    return " ; ".join(parts)


class QueueHandler:
    """Common machinery; subclasses define submit/status binaries + script."""

    manager = "none"
    submit_binary = "true"

    def __init__(self, server_dir: str, work_dir: Path):
        self.server_dir = server_dir
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)

    def build_script(
        self, queue_id: int, params: QueueParams, workdir: Path | None = None
    ) -> str:
        raise NotImplementedError

    def parse_submit_output(self, stdout: str) -> str:
        raise NotImplementedError

    def _create_allocation_dir(self, queue_id: int, params: QueueParams) -> Path:
        """Per-allocation working directory holding the submit script and the
        manager-captured stdout/stderr (reference queue/common.rs
        create_allocation_dir: <server_dir>/autoalloc/<id>[-name]/<n>)."""
        name = str(queue_id) + (f"-{params.name}" if params.name else "")
        parent = self.work_dir / name
        parent.mkdir(parents=True, exist_ok=True)
        n = len(list(parent.iterdir()))
        while True:
            n += 1
            workdir = parent / f"{n:03d}"
            try:
                workdir.mkdir()
                return workdir
            except FileExistsError:
                continue

    async def submit_allocation(
        self, queue_id: int, params: QueueParams, dry_run: bool = False
    ) -> tuple[str, str]:
        """Run qsub/sbatch on a generated script; returns
        (allocation id, allocation working directory)."""
        workdir = self._create_allocation_dir(queue_id, params)
        script = self.build_script(queue_id, params, workdir)
        path = workdir / "hq-submit.sh"
        path.write_text(script)
        os.chmod(path, 0o755)
        cmd = [self.submit_binary, *params.additional_args, str(path)]
        if dry_run:
            return f"dry-run:{path}", str(workdir)
        if chaos.ACTIVE and chaos.decide(
            "autoalloc.submit", op=self.manager
        ) == "raise":
            raise SubmitError("chaos: injected submit failure")
        process = await asyncio.create_subprocess_exec(
            *cmd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            start_new_session=True,  # timeout kill covers the whole tree
        )
        stdout, stderr = await self._communicate_bounded(process, cmd[0])
        if process.returncode != 0:
            raise SubmitError(
                f"{self.submit_binary} failed "
                f"(exit {process.returncode}): {stderr.decode(errors='replace')}"
            )
        return self.parse_submit_output(stdout.decode()), str(workdir)

    async def refresh_statuses(self, allocation_ids: list[str]) -> dict[str, str]:
        """allocation_id -> queued|running|finished|failed."""
        raise NotImplementedError

    async def remove_allocation(self, allocation_id: str) -> None:
        raise NotImplementedError

    @staticmethod
    async def _communicate_bounded(process, binary: str):
        """communicate() with the hard manager timeout: on expiry the
        process group is killed and ManagerTimeout propagates — a hung
        manager binary becomes a failed call, never a hung autoalloc tick
        loop (the caller's existing failure handling takes over)."""
        try:
            return await asyncio.wait_for(
                process.communicate(), timeout=MANAGER_TIMEOUT_SECS
            )
        except asyncio.TimeoutError:
            _MANAGER_TIMEOUTS.inc()
            # kill the whole session: a child of the manager binary (e.g.
            # a helper the site wrapped around sbatch) inheriting the
            # output pipe would otherwise keep the reaping communicate()
            # blocked until IT exits
            try:
                os.killpg(process.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                try:
                    process.kill()
                except ProcessLookupError:
                    pass
            # reap so the transport doesn't leak; the group was KILLed,
            # so this returns promptly
            await process.communicate()
            raise ManagerTimeout(
                f"{binary} did not answer within {MANAGER_TIMEOUT_SECS:.0f}s"
                " (killed)"
            ) from None

    async def _run(self, *cmd) -> tuple[int, str]:
        process = await asyncio.create_subprocess_exec(
            *cmd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT,
            start_new_session=True,
        )
        stdout, _ = await self._communicate_bounded(process, cmd[0])
        return process.returncode, stdout.decode(errors="replace")


class PbsHandler(QueueHandler):
    manager = "pbs"
    submit_binary = "qsub"

    def build_script(
        self, queue_id: int, params: QueueParams, workdir: Path | None = None
    ) -> str:
        worker_cmd = _worker_command(self.server_dir, queue_id, params)
        lines = [
            "#!/bin/bash",
            f"#PBS -N hq-alloc-{queue_id}",
            f"#PBS -l select={params.workers_per_alloc}",
            f"#PBS -l walltime={_format_walltime(params.time_limit_secs)}",
        ]
        if workdir is not None:
            lines += [
                f"#PBS -o {workdir / 'stdout'}",
                f"#PBS -e {workdir / 'stderr'}",
            ]
        lines += [
            "export HQ_ALLOC_QUEUE=%d" % queue_id,
            'export HQ_ALLOC_ID="$PBS_JOBID"',
        ]
        if workdir is not None:
            # adoption trail: a crash between submit and its journal
            # record can find (and reconcile) this allocation by workdir
            lines.append(f"echo $$ > {shlex.quote(str(workdir / 'pid'))}")
        node_cmd = _node_command(params, worker_cmd)
        if params.workers_per_alloc > 1:
            lines.append(
                f"pbsdsh -- bash -l -c {shlex.quote(node_cmd)}"
            )
        else:
            lines.append(node_cmd)
        return "\n".join(lines) + "\n"

    def parse_submit_output(self, stdout: str) -> str:
        allocation_id = stdout.strip().splitlines()[-1].strip()
        if not allocation_id:
            raise SubmitError("qsub returned no job id")
        return allocation_id

    async def refresh_statuses(self, allocation_ids):
        out: dict[str, str] = {}
        if not allocation_ids:
            return out
        code, text = await self._run("qstat", "-f", *allocation_ids)
        current = None
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("Job Id:"):
                current = line.split(":", 1)[1].strip()
            elif line.startswith("job_state") and current:
                state = line.split("=")[-1].strip()
                out[current] = {
                    "Q": "queued", "H": "queued", "R": "running",
                    "F": "finished", "E": "running",
                }.get(state, "failed")
        for aid in allocation_ids:
            out.setdefault(aid, "finished")  # vanished from qstat
        return out

    async def remove_allocation(self, allocation_id: str) -> None:
        await self._run("qdel", allocation_id)


class SlurmHandler(QueueHandler):
    manager = "slurm"
    submit_binary = "sbatch"

    def build_script(
        self, queue_id: int, params: QueueParams, workdir: Path | None = None
    ) -> str:
        worker_cmd = _worker_command(self.server_dir, queue_id, params)
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name=hq-alloc-{queue_id}",
            f"#SBATCH --nodes={params.workers_per_alloc}",
            f"#SBATCH --time={_format_walltime(params.time_limit_secs)}",
        ]
        if workdir is not None:
            lines += [
                f"#SBATCH --output={workdir / 'stdout'}",
                f"#SBATCH --error={workdir / 'stderr'}",
            ]
        lines += [
            "export HQ_ALLOC_QUEUE=%d" % queue_id,
            'export HQ_ALLOC_ID="$SLURM_JOB_ID"',
        ]
        if workdir is not None:
            lines.append(f"echo $$ > {shlex.quote(str(workdir / 'pid'))}")
        node_cmd = _node_command(params, worker_cmd)
        if params.workers_per_alloc > 1:
            lines.append(f"srun --overlap bash -c {shlex.quote(node_cmd)}")
        else:
            lines.append(node_cmd)
        return "\n".join(lines) + "\n"

    def parse_submit_output(self, stdout: str) -> str:
        # "Submitted batch job 12345"
        for token in reversed(stdout.split()):
            if token.isdigit():
                return token
        raise SubmitError(f"cannot parse sbatch output: {stdout!r}")

    async def refresh_statuses(self, allocation_ids):
        out: dict[str, str] = {}
        if not allocation_ids:
            return out
        code, text = await self._run(
            "sacct", "-j", ",".join(allocation_ids), "-o", "JobID,State",
            "--noheader", "--parsable2",
        )
        for line in text.splitlines():
            parts = line.strip().split("|")
            if len(parts) < 2 or "." in parts[0]:
                continue
            jid, state = parts[0], parts[1].split()[0] if parts[1] else ""
            out[jid] = {
                "PENDING": "queued",
                "RUNNING": "running",
                "COMPLETED": "finished",
                "COMPLETING": "running",
                "CANCELLED": "failed",
                "FAILED": "failed",
                "TIMEOUT": "finished",
            }.get(state, "failed" if state else "queued")
        for aid in allocation_ids:
            out.setdefault(aid, "finished")
        return out

    async def remove_allocation(self, allocation_id: str) -> None:
        await self._run("scancel", allocation_id)


# fault plan injected into a chaos-"raise" local spawn: the worker boots,
# registers, then SIGKILLs itself on its first heartbeat send — the
# deterministic "worker boots then dies" crash-loop surface
_BOOT_DIE_PLAN = json.dumps({
    "rules": [
        {"site": "worker.send", "op": "heartbeat", "at": 1, "action": "kill"}
    ]
})


class LocalHandler(QueueHandler):
    """Spawn real worker processes on the server's own host.

    The whole elasticity loop (demand query -> submit -> worker register ->
    drain -> cancel) runs without PBS/Slurm — in tests and on single-node
    deployments. Each "allocation"
    is one detached process group running `workers_per_alloc` workers; the
    allocation id is ``local-<pgid>``, so liveness/cancellation work by
    pid across server restarts (allocation-exact restore reconciles
    against `os.kill(pid, 0)` exactly like qstat/sacct).

    FaultPlan chaos surface (site ``autoalloc.spawn``, see utils/chaos.py):
    ``drop`` = allocation recorded but never spawned (stuck queued),
    ``hang`` = the process runs but no worker ever starts (zombie:
    reaches `running`, never registers), ``raise`` = the worker registers
    then dies (crash loop). Site ``autoalloc.submit`` (all managers):
    ``raise`` fails the submit.
    """

    manager = "local"
    submit_binary = "bash"

    def __init__(self, server_dir: str, work_dir: Path):
        super().__init__(server_dir, work_dir)
        self._procs: dict[str, asyncio.subprocess.Process] = {}
        self._reapers: set[asyncio.Task] = set()
        self._stuck_seq = 0

    def build_script(
        self, queue_id: int, params: QueueParams, workdir: Path | None = None,
        spawn_action: str | None = None,
    ) -> str:
        worker_cmd = _worker_command(self.server_dir, queue_id, params)
        lines = ["#!/bin/bash"]
        if workdir is not None:
            lines.append(f"echo $$ > {shlex.quote(str(workdir / 'pid'))}")
        lines += [
            "export HQ_ALLOC_QUEUE=%d" % queue_id,
            'export HQ_ALLOC_ID="local-$$"',
        ]
        if spawn_action == "hang":
            # allocation "runs" but no worker ever registers: the zombie
            # reaper's prey
            lines.append("exec sleep 100000")
            return "\n".join(lines) + "\n"
        if spawn_action == "raise":
            lines.append(
                f"export HQ_FAULT_PLAN={shlex.quote(_BOOT_DIE_PLAN)}"
            )
            # fast heartbeat so the boot-die fires right after registration
            worker_cmd = worker_cmd + " --heartbeat 0.5"
        node_cmd = _node_command(params, worker_cmd)
        for _ in range(max(params.workers_per_alloc, 1)):
            lines.append(f"( {node_cmd} ) &")
        lines.append("wait")
        return "\n".join(lines) + "\n"

    def parse_submit_output(self, stdout: str) -> str:  # pragma: no cover
        raise SubmitError("local allocations are spawned, not submitted")

    def _worker_env(self) -> dict:
        """Environment for spawned workers: the server's own fault plan
        must NOT leak into them (each process loads its own plan);
        HQ_LOCAL_WORKER_FAULT_PLAN explicitly opts workers into one."""
        env = dict(os.environ)
        env.pop("HQ_FAULT_PLAN", None)
        worker_plan = env.pop("HQ_LOCAL_WORKER_FAULT_PLAN", None)
        if worker_plan:
            env["HQ_FAULT_PLAN"] = worker_plan
        return env

    async def submit_allocation(
        self, queue_id: int, params: QueueParams, dry_run: bool = False
    ) -> tuple[str, str]:
        workdir = self._create_allocation_dir(queue_id, params)
        if chaos.ACTIVE and chaos.decide(
            "autoalloc.submit", op=self.manager
        ) == "raise":
            raise SubmitError("chaos: injected local submit failure")
        spawn_action = (
            chaos.decide("autoalloc.spawn", op=self.manager)
            if chaos.ACTIVE else None
        )
        script = self.build_script(
            queue_id, params, workdir, spawn_action=spawn_action
        )
        path = workdir / "hq-submit.sh"
        path.write_text(script)
        os.chmod(path, 0o755)
        if dry_run:
            return f"dry-run:{path}", str(workdir)
        if spawn_action == "drop":
            # recorded but never spawned: stuck queued forever (models a
            # batch queue that accepts the job and never schedules it)
            self._stuck_seq += 1
            return f"local-q{self._stuck_seq}", str(workdir)
        with open(workdir / "stdout", "wb") as out, \
                open(workdir / "stderr", "wb") as err:
            process = await asyncio.create_subprocess_exec(
                "/bin/bash", str(path),
                stdout=out, stderr=err,
                start_new_session=True,  # killpg covers workers + hooks
                env=self._worker_env(),
            )
        allocation_id = f"local-{process.pid}"
        self._procs[allocation_id] = process
        # reap on exit so finished allocations never linger as OS
        # zombies; the strong ref keeps the reaper from being GC'd
        # before it runs (the loop holds tasks weakly)
        task = asyncio.ensure_future(process.wait())
        self._reapers.add(task)
        task.add_done_callback(self._reapers.discard)
        return allocation_id, str(workdir)

    @staticmethod
    def _pid_of(allocation_id: str) -> int | None:
        if not allocation_id.startswith("local-"):
            return None
        tail = allocation_id[len("local-"):]
        return int(tail) if tail.isdigit() else None

    async def refresh_statuses(self, allocation_ids):
        out: dict[str, str] = {}
        for allocation_id in allocation_ids:
            pid = self._pid_of(allocation_id)
            if pid is None:
                # a chaos-stuck (never-spawned) allocation stays queued
                out[allocation_id] = "queued"
                continue
            process = self._procs.get(allocation_id)
            if process is not None and process.returncode is not None:
                out[allocation_id] = (
                    "finished" if process.returncode == 0 else "failed"
                )
                # terminal: drop the Process ref, or allocation churn on a
                # long-lived server grows _procs without bound
                self._procs.pop(allocation_id, None)
                continue
            if process is not None:
                out[allocation_id] = "running"
                continue
            # adopted/restored allocation: pid liveness is the manager
            try:
                os.kill(pid, 0)
                out[allocation_id] = "running"
            except ProcessLookupError:
                out[allocation_id] = "finished"
            except PermissionError:
                out[allocation_id] = "running"
        return out

    async def remove_allocation(self, allocation_id: str) -> None:
        pid = self._pid_of(allocation_id)
        self._procs.pop(allocation_id, None)
        if pid is None:
            return
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def make_handler(manager: str, server_dir: str, work_dir: Path) -> QueueHandler:
    if manager == "pbs":
        return PbsHandler(server_dir, work_dir)
    if manager == "slurm":
        return SlurmHandler(server_dir, work_dir)
    if manager == "local":
        return LocalHandler(server_dir, work_dir)
    raise ValueError(
        f"unknown manager {manager!r} (expected pbs, slurm or local)"
    )
