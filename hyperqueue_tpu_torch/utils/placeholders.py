"""%{NAME} placeholder resolution in paths.

Reference: crates/hyperqueue/src/common/placeholders.rs:16-21,58-105 —
%{JOB_ID}, %{TASK_ID}, %{INSTANCE_ID}, %{SUBMIT_DIR}, %{SERVER_UID}, %{CWD}
resolved in cwd/stdout/stderr/stream paths. Unknown placeholders are left
intact (the reference warns; we do the same at debug level).
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__name__)

_PATTERN = re.compile(r"%\{([A-Z_]+)\}")


def fill_placeholders(template: str, mapping: dict[str, str]) -> str:
    def sub(match: re.Match) -> str:
        key = match.group(1)
        if key in mapping:
            return str(mapping[key])
        logger.debug("unknown placeholder %%{%s} left as-is", key)
        return match.group(0)

    return _PATTERN.sub(sub, template)


def task_placeholder_map(
    job_id: int,
    job_task_id: int,
    instance_id: int,
    submit_dir: str,
    server_uid: str,
    cwd: str | None = None,
) -> dict[str, str]:
    mapping = {
        "JOB_ID": str(job_id),
        "TASK_ID": str(job_task_id),
        "INSTANCE_ID": str(instance_id),
        "SUBMIT_DIR": submit_dir,
        "SERVER_UID": server_uid,
    }
    if cwd is not None:
        mapping["CWD"] = cwd
    return mapping
