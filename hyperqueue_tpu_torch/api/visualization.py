"""DAG visualization of a Job.

Reference: crates/pyhq/python/hyperqueue/visualization.py — renders the task
graph; here as Graphviz DOT text (render with `dot -Tsvg`) plus a terse
ASCII topological listing for terminals.
"""

from __future__ import annotations

from hyperqueue_tpu_torch.api.client import Job


def job_to_dot(job: Job) -> str:
    lines = [f'digraph "{job.name}" {{', "  rankdir=LR;"]
    for task in job._tasks:
        cmd = " ".join(task.spec["body"]["cmd"][:3])
        label = f"{task.task_id}: {cmd[:40]}"
        lines.append(f'  t{task.task_id} [label="{label}", shape=box];')
    for task in job._tasks:
        for dep in task.spec.get("deps", []):
            lines.append(f"  t{dep} -> t{task.task_id};")
    lines.append("}")
    return "\n".join(lines)


def job_to_text(job: Job) -> str:
    out = [f"job {job.name!r}: {len(job._tasks)} task(s)"]
    for task in job._tasks:
        deps = task.spec.get("deps", [])
        arrow = f" <- {deps}" if deps else ""
        cmd = " ".join(task.spec["body"]["cmd"][:4])
        out.append(f"  [{task.task_id}] {cmd}{arrow}")
    return "\n".join(out)
