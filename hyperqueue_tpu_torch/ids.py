"""Core identifier types.

A task id packs (job_id << 32) | job_task_id into one int, so a task id is a
single int64-compatible scalar (reference crates/tako/src/internal/common/
ids.rs:5-60).
"""

from __future__ import annotations

TASK_ID_BITS = 32
TASK_ID_MASK = (1 << TASK_ID_BITS) - 1


def make_task_id(job_id: int, job_task_id: int) -> int:
    if not (0 <= job_task_id <= TASK_ID_MASK and 0 <= job_id <= TASK_ID_MASK):
        raise ValueError(f"task id out of range: {job_id}@{job_task_id}")
    return (job_id << TASK_ID_BITS) | job_task_id


def task_id_job(task_id: int) -> int:
    return task_id >> TASK_ID_BITS


def task_id_task(task_id: int) -> int:
    return task_id & TASK_ID_MASK


class IdCounter:
    """Monotonic id allocator (1-based, 0 reserved as 'none').

    With ``stride > 1`` the counter allocates only ids congruent to
    ``start`` modulo ``stride`` (a static partition of the id space between
    allocators that must not coordinate).
    """

    __slots__ = ("_next", "_stride")

    def __init__(self, start: int = 1, stride: int = 1):
        self._next = start
        self._stride = max(int(stride), 1)

    def next(self) -> int:
        value = self._next
        self._next += self._stride
        return value

    def peek(self) -> int:
        return self._next

    def ensure_above(self, used: int) -> None:
        """Advance past `used` (an id taken elsewhere, e.g. a job created
        with an explicit id) while keeping the congruence class."""
        if used >= self._next:
            steps = (used - self._next) // self._stride + 1
            self._next += steps * self._stride
