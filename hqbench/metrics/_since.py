"""Helpers of the readers of what the program records apart from a tick's
phases: each tick's `since_ms` and `since_n` (the workers' answers, the
collector's passes by where they fell), which the program keeps while a
torch profiler records, as the traced run's does. A program without them
gives the readers nothing to read.

Each tick's entries cover the time since the tick before: the first
tick of the window also carries the answers to the last tick before it,
and the answers to the window's last tick fall after it, so a sum over
the window's ticks is off by about one tick's answers."""


def since(view, table="since_ms"):
    """The window's ticks' `table` dicts (ticks without one left out)."""
    return [t.phases[table] for t in view.ticks if table in t.phases]


def answers_on(view) -> bool:
    """Whether any tick of the window carries the answers' time (the
    timeline was on)."""
    return any("answers" in s for s in since(view))
