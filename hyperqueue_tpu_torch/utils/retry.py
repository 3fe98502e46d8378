"""Jittered exponential backoff, shared by every reconnect/retry loop.

One implementation (worker reconnect, client connect/request retry) so the
jitter range and deadline floor are tuned in one place. Full jitter over
[0.5, 1.0] x delay: enough spread to de-thundering-herd a fleet of workers
reconnecting to one restarted server, while keeping the worst-case wait
predictable (reference AWS architecture blog "exponential backoff and
jitter"; decorrelated jitter buys little at these scales).
"""

from __future__ import annotations

import random


def jittered_backoff(
    delay: float,
    cap: float,
    rng: random.Random,
    remaining: float | None = None,
) -> tuple[float, float]:
    """Returns (seconds_to_sleep_now, next_delay).

    `remaining` clamps the sleep so the last attempt lands at the deadline
    instead of overshooting it (floored at 50 ms so a nearly-expired
    deadline still yields one real wait, not a busy-loop)."""
    sleep_for = delay * rng.uniform(0.5, 1.0)
    if remaining is not None:
        sleep_for = min(sleep_for, max(remaining, 0.05))
    return sleep_for, min(delay * 2, cap)
