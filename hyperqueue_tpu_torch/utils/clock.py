"""Process-wide clock provider: every wall/monotonic read behind one seam.

Server and scheduler code reads time through this module, never through
``time.time()`` / ``time.monotonic()`` directly, so that a run can install
a virtual clock (a deterministic simulation, or a test that ages a sync
probe without sleeping) and every timestamp and staleness comparison
follows it.

Production pays one extra function call per read (the provider defaults to
the stdlib clocks); ``perf_counter`` is deliberately NOT routed — it
measures real CPU work for telemetry (tick phase latencies) and
virtualizing it would make a simulation lie about its own overhead.

Usage::

    from hyperqueue_tpu_torch.utils import clock
    stamp = clock.now()        # wall clock (time.time)
    t0 = clock.monotonic()     # monotonic clock (time.monotonic)

A run installs its provider for its duration::

    previous = clock.install(fake_clock)  # needs .time() and .monotonic()
    try: ...
    finally: clock.install(previous)
"""

from __future__ import annotations

import time as _time


class SystemClock:
    """The default provider: the stdlib clocks, no indirection beyond the
    method lookup."""

    __slots__ = ()

    time = staticmethod(_time.time)
    monotonic = staticmethod(_time.monotonic)


SYSTEM = SystemClock()
_provider = SYSTEM


def now() -> float:
    """Wall-clock seconds (``time.time`` under the active provider)."""
    return _provider.time()


def monotonic() -> float:
    """Monotonic seconds (``time.monotonic`` under the active provider)."""
    return _provider.monotonic()


def get() -> object:
    """The active provider."""
    return _provider


def install(provider) -> object:
    """Swap the process-wide provider; returns the previous one so the
    caller can restore it.  ``provider`` needs ``time()`` and
    ``monotonic()`` methods."""
    global _provider
    previous = _provider
    _provider = provider
    return previous


def reset() -> None:
    """Back to the stdlib clocks."""
    install(SYSTEM)


def is_simulated() -> bool:
    """True while a non-system provider is installed."""
    return _provider is not SYSTEM
