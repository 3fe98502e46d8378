"""Python user API: Client, Job, tasks (programs and Python functions).

Reference: crates/pyhq/python/hyperqueue/ — Client.submit/wait_for_jobs/
get_failed_tasks/forget (client.py:24-125), Job.program/function with deps
(job.py:14-161), cloudpickle-wrapped Python functions executed by a spawned
interpreter (task/function/), and LocalCluster (cluster/__init__.py:20-73).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from hyperqueue_tpu_torch.utils import clock


class FailedJobsException(Exception):
    def __init__(self, failed: dict):
        self.failed = failed
        super().__init__(f"jobs failed: {failed}")


class Task:
    def __init__(self, task_id: int, spec: dict):
        self.task_id = task_id
        self.spec = spec


class Job:
    """A job under construction: add tasks, then Client.submit(job)."""

    def __init__(self, name: str = "python-job", max_fails: int | None = None):
        self.name = name
        self.max_fails = max_fails
        self._tasks: list[Task] = []

    def _next_id(self) -> int:
        return len(self._tasks)

    def program(
        self,
        args: list[str],
        *,
        env: dict | None = None,
        cwd: str | None = None,
        stdout: str | None = None,
        stderr: str | None = None,
        stdin: bytes | None = None,
        deps: list[Task] | None = None,
        priority: int = 0,
        resources: dict | None = None,
        nodes: int = 0,
        time_request: float = 0.0,
        weight: float = 1.0,
    ) -> Task:
        """Add a program task. resources: {"cpus": "2", "gpus": "0.5"}."""
        from hyperqueue_tpu_torch.resources.amount import amount_from_str

        entries = []
        for name, amount in (resources or {}).items():
            if amount == "all":
                entries.append({"name": name, "amount": 0, "policy": "all"})
            else:
                entries.append(
                    {"name": name, "amount": amount_from_str(str(amount)),
                     "policy": "compact"}
                )
        body = {
            "cmd": [str(a) for a in args],
            "env": {str(k): str(v) for k, v in (env or {}).items()},
            "cwd": cwd,
            "stdout": stdout,
            "stderr": stderr,
            "submit_dir": os.getcwd(),
        }
        if stdin is not None:
            body["stdin"] = stdin
        spec = {
            "id": self._next_id(),
            "body": body,
            "request": {
                "variants": [
                    {"n_nodes": nodes, "min_time": time_request,
                     "weight": weight, "entries": entries}
                ]
            },
            "deps": [t.task_id for t in (deps or [])],
            "priority": priority,
        }
        task = Task(spec["id"], spec)
        self._tasks.append(task)
        return task

    def function(
        self,
        fn,
        *,
        args: tuple = (),
        kwargs: dict | None = None,
        deps: list[Task] | None = None,
        priority: int = 0,
        resources: dict | None = None,
        stdout: str | None = None,
        stderr: str | None = None,
    ) -> Task:
        """Add a Python function task (cloudpickle-shipped, reference
        task/function/wrapper.py CloudWrapper)."""
        import cloudpickle

        payload = cloudpickle.dumps((fn, args, kwargs or {}))
        return self.program(
            [sys.executable, "-m",
             "hyperqueue_tpu_torch.api.function_runner"],
            stdin=payload,
            deps=deps,
            priority=priority,
            resources=resources,
            stdout=stdout,
            stderr=stderr,
        )

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "submit_dir": os.getcwd(),
            "max_fails": self.max_fails,
            "tasks": [t.spec for t in self._tasks],
        }


class Client:
    """Synchronous client to a running server."""

    def __init__(self, server_dir: str | Path | None = None):
        from hyperqueue_tpu_torch.client.connection import open_session
        from hyperqueue_tpu_torch.utils.serverdir import default_server_dir

        # a classic dir gets a ClientSession, a federation root a
        # FederatedSession
        self._session = open_session(
            Path(server_dir) if server_dir else default_server_dir()
        )

    def submit(self, job: Job) -> int:
        response = self._session.request(
            {"op": "submit", "job": job.to_wire()}
        )
        return response["job_id"]

    def submit_stream(self, name: str, body: dict, entries,
                      chunk_size: int = 16384, request: dict | None = None,
                      max_fails: int | None = None,
                      window: int | None = None) -> tuple[int, int]:
        """Streaming chunked array submit (ISSUE 10): one task per entry
        (HQ_ENTRY), pipelined to the server in `chunk_size` chunks over
        the chunked ingest plane. `entries` may be any iterable — a
        generator is never buffered beyond one chunk plus the in-flight
        window, so arbitrarily long streams submit in bounded memory.
        Returns (job_id, n_tasks)."""
        from hyperqueue_tpu_torch.client.connection import SubmitStream

        stream = SubmitStream(
            self._session,
            {"name": name, "submit_dir": os.getcwd(),
             "max_fails": max_fails},
            window=window,
        )
        base = {"body": body, "request": request or {}}
        next_id = 0
        buf: list = []
        for entry in entries:
            buf.append(entry if isinstance(entry, str) else str(entry))
            if len(buf) >= max(chunk_size, 1):
                stream.send_chunk(array={
                    **base, "id_range": [next_id, next_id + len(buf)],
                    "entries": buf,
                })
                next_id += len(buf)
                buf = []
        if buf:
            stream.send_chunk(array={
                **base, "id_range": [next_id, next_id + len(buf)],
                "entries": buf,
            })
        return stream.finish()

    def wait_for_jobs(self, job_ids: list[int], raise_on_fail: bool = True,
                      progress=None):
        """progress: optional callback(done, total) polled while waiting
        (reference pyhq wait_for_jobs progress callback)."""
        if progress is None:
            response = self._session.request(
                {"op": "job_wait", "job_ids": list(job_ids)}
            )
            jobs = response["jobs"]
        else:
            while True:
                jobs = self._session.request(
                    {"op": "job_info", "job_ids": list(job_ids)}
                )["jobs"]
                total = sum(j["n_tasks"] for j in jobs)
                done = sum(
                    j["counters"]["finished"]
                    + j["counters"]["failed"]
                    + j["counters"]["canceled"]
                    for j in jobs
                )
                progress(done, total)
                if done >= total and all(
                    not j["counters"]["running"] for j in jobs
                ):
                    break
                time.sleep(0.25)
        failed = self.get_failed_tasks(job_ids)
        if failed and raise_on_fail:
            raise FailedJobsException(failed)
        return jobs

    def get_failed_tasks(self, job_ids: list[int]) -> dict:
        response = self._session.request(
            {"op": "job_info", "job_ids": list(job_ids)}
        )
        failed: dict[int, dict[int, str]] = {}
        for job in response["jobs"]:
            for task in job["tasks"]:
                if task["status"] == "failed":
                    failed.setdefault(job["id"], {})[task["id"]] = task["error"]
        return failed

    def forget(self, job_ids: list[int]) -> int:
        response = self._session.request(
            {"op": "job_forget", "job_ids": list(job_ids)}
        )
        return response["forgotten"]

    def job_info(self, job_ids: list[int]) -> list[dict]:
        return self._session.request(
            {"op": "job_info", "job_ids": list(job_ids)}
        )["jobs"]

    def close(self) -> None:
        self._session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LocalCluster:
    """In-process-managed local server + N workers for scripts and tests.

    Reference: pyhq cluster/__init__.py:20-73 (embedded server); here the
    server/workers are child processes sharing a private server dir.
    """

    def __init__(self, n_workers: int = 1, cpus_per_worker: int = 4,
                 server_dir: str | None = None):
        import subprocess
        import tempfile

        self._dir = Path(server_dir or tempfile.mkdtemp(prefix="hq-local-"))
        self._dir.mkdir(parents=True, exist_ok=True)
        # the server solves on the card unless HQ_LOCAL_CLUSTER_DEVICE=cpu
        # asks for the CPU (`--scheduler cpu`)
        scheduler = (["--scheduler", "cpu"]
                     if os.environ.get("HQ_LOCAL_CLUSTER_DEVICE") == "cpu"
                     else [])
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-m", "hyperqueue_tpu_torch", "server",
                 "start", "--server-dir", str(self._dir), *scheduler],
                stdout=open(self._dir / "server.log", "wb"),
                stderr=subprocess.STDOUT,
            )
        ]
        deadline = clock.now() + 30
        while clock.now() < deadline:
            if (self._dir / "hq-current" / "access.json").exists():
                break
            if self._procs[0].poll() is not None:
                raise RuntimeError(
                    "local server died: "
                    + (self._dir / "server.log").read_text()[-2000:]
                )
            time.sleep(0.05)
        else:
            raise TimeoutError("local server did not start")
        for i in range(n_workers):
            self.add_worker(cpus=cpus_per_worker)

    def add_worker(self, cpus: int = 4) -> None:
        import subprocess

        self._procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "hyperqueue_tpu_torch", "worker",
                 "start", "--server-dir", str(self._dir), "--cpus",
                 str(cpus)],
                stdout=open(self._dir / f"worker{len(self._procs)}.log", "wb"),
                stderr=subprocess.STDOUT,
            )
        )

    def client(self) -> Client:
        return Client(self._dir)

    def stop(self) -> None:
        for p in reversed(self._procs):
            if p.poll() is None:
                p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except Exception:
                p.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
