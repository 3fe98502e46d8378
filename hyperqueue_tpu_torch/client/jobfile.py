"""TOML Job Definition Files.

Reference: crates/hyperqueue/src/client/commands/submit/{jobfile,defs}.rs +
docs/jobs/jobfile.md — jobs with task graphs, per-task resource requests and
OR-variants, described declaratively:

    name = "my-job"
    max_fails = 1

    [[task]]
    id = 0
    command = ["python", "prepare.py"]

    [[task]]
    id = 1
    command = ["python", "train.py"]
    deps = [0]
    [[task.request]]
    resources = { "cpus" = "8", "gpus" = "1" }
    time_request = 60.0

    [[task.request]]          # second entry = OR-variant
    resources = { "cpus" = "16" }
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the API-compatible backport
    import tomli as tomllib
from pathlib import Path

from hyperqueue_tpu_torch.resources.amount import amount_from_str
from hyperqueue_tpu_torch.utils.parsing import parse_crash_limit


class JobFileError(ValueError):
    pass


def _parse_crash_limit(value) -> int:
    return parse_crash_limit(value, exc_type=JobFileError)


def _request_to_wire(requests: list[dict]) -> dict:
    variants = []
    for req in requests:
        entries = []
        for name, amount in (req.get("resources") or {}).items():
            if amount == "all":
                entries.append({"name": name, "amount": 0, "policy": "all"})
            else:
                entries.append(
                    {
                        "name": name,
                        "amount": amount_from_str(str(amount)),
                        "policy": req.get("policy", "compact"),
                    }
                )
        variants.append(
            {
                "n_nodes": int(req.get("nodes", 0)),
                "min_time": float(req.get("time_request", 0.0)),
                "entries": entries,
            }
        )
    return {"variants": variants} if variants else {}


def load_job_file(path: str | Path, submit_dir: str) -> dict:
    """Parse a TOML job file into a submit message job description."""
    with open(path, "rb") as f:
        data = tomllib.load(f)

    tasks = []
    seen_ids: set[int] = set()
    for i, t in enumerate(data.get("task", [])):
        task_id = int(t.get("id", i))
        if task_id in seen_ids:
            raise JobFileError(f"duplicate task id {task_id}")
        seen_ids.add(task_id)
        command = t.get("command")
        if not command or not isinstance(command, list):
            raise JobFileError(f"task {task_id}: 'command' array is required")
        body = {
            "cmd": [str(c) for c in command],
            "env": {str(k): str(v) for k, v in (t.get("env") or {}).items()},
            "cwd": t.get("cwd"),
            "stdout": t.get("stdout"),
            "stderr": t.get("stderr"),
            "submit_dir": submit_dir,
        }
        deps = [int(d) for d in t.get("deps", [])]
        for d in deps:
            if d not in seen_ids:
                raise JobFileError(
                    f"task {task_id} depends on {d} which is not defined above it"
                )
        tasks.append(
            {
                "id": task_id,
                "body": body,
                "request": _request_to_wire(t.get("request", [])),
                "deps": deps,
                "priority": int(t.get("priority", 0)),
                "crash_limit": _parse_crash_limit(t.get("crash_limit", 5)),
            }
        )
    if not tasks:
        raise JobFileError("job file defines no tasks")

    return {
        "name": data.get("name", Path(path).stem),
        "submit_dir": submit_dir,
        "max_fails": data.get("max_fails"),
        "tasks": tasks,
    }
