"""Batch-manager detection on the worker host.

Reference: crates/hyperqueue/src/common/manager/{pbs,slurm,info,common}.rs —
detect PBS/Slurm from the environment (PBS_JOBID / SLURM_JOB_ID), look up the
remaining walltime (qstat / scontrol) so the worker can set its own time
limit, and expose the manager + job id to the server.
"""

from __future__ import annotations

import os
import re
import subprocess
from dataclasses import dataclass


@dataclass
class ManagerInfo:
    manager: str  # "pbs" | "slurm" | "none"
    job_id: str = ""
    remaining_secs: float = 0.0  # 0 = unknown


def _parse_walltime(text: str) -> float:
    """'HH:MM:SS' or 'D-HH:MM:SS' -> seconds."""
    days = 0
    if "-" in text:
        d, text = text.split("-", 1)
        days = int(d)
    parts = [int(p) for p in text.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, s = parts[-3:]
    return days * 86400 + h * 3600 + m * 60 + s


def _pbs_remaining(job_id: str) -> float:
    try:
        out = subprocess.run(
            ["qstat", "-f", job_id],
            capture_output=True,
            text=True,
            timeout=10,
        ).stdout
    except (OSError, subprocess.TimeoutExpired):
        return 0.0
    walltime = used = None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Resource_List.walltime"):
            walltime = _parse_walltime(line.split("=", 1)[1].strip())
        elif line.startswith("resources_used.walltime"):
            used = _parse_walltime(line.split("=", 1)[1].strip())
    if walltime is None:
        return 0.0
    return max(walltime - (used or 0.0), 0.0)


def _slurm_remaining(job_id: str) -> float:
    try:
        out = subprocess.run(
            ["scontrol", "show", "job", job_id],
            capture_output=True,
            text=True,
            timeout=10,
        ).stdout
    except (OSError, subprocess.TimeoutExpired):
        return 0.0
    m = re.search(r"TimeLeft=(\S+)", out)
    if m and m.group(1) not in ("UNLIMITED", "NOT_SET"):
        return _parse_walltime(m.group(1))
    # older scontrol prints RunTime/TimeLimit instead of TimeLeft
    # (reference common/manager/slurm.rs parse_slurm_duration)
    limit = re.search(r"TimeLimit=(\S+)", out)
    run = re.search(r"RunTime=(\S+)", out)
    if limit and limit.group(1) not in ("UNLIMITED", "NOT_SET"):
        used = _parse_walltime(run.group(1)) if run else 0.0
        return max(_parse_walltime(limit.group(1)) - used, 0.0)
    return 0.0


def detect_manager(mode: str = "auto") -> ManagerInfo:
    """mode: auto | pbs | slurm | none."""
    if mode == "none":
        return ManagerInfo(manager="none")
    pbs_id = os.environ.get("PBS_JOBID", "")
    slurm_id = os.environ.get("SLURM_JOB_ID", "")
    if mode in ("auto", "pbs") and pbs_id:
        return ManagerInfo(
            manager="pbs", job_id=pbs_id, remaining_secs=_pbs_remaining(pbs_id)
        )
    if mode in ("auto", "slurm") and slurm_id:
        return ManagerInfo(
            manager="slurm",
            job_id=slurm_id,
            remaining_secs=_slurm_remaining(slurm_id),
        )
    if mode in ("pbs", "slurm"):
        raise RuntimeError(f"--manager {mode} requested but not detected in env")
    return ManagerInfo(manager="none")
