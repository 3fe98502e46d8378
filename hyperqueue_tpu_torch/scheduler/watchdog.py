"""Solver watchdog: the scheduling loop must survive a misbehaving solver.

A single exception or hang inside the per-tick solve (a kernel that fails
to launch, a device that stops answering) must not kill the scheduler loop:
the server would keep accepting submits but never schedule again. Dynamic
schedulers must degrade gracefully rather than stop scheduling when the
optimizer misbehaves (arXiv:1106.4985).

The watchdog wraps any scheduling model:

- every primary solve runs on a dedicated daemon thread with a wall-clock
  deadline (``timeout_s``); a hang strands that thread (abandoned, daemon)
  and the tick proceeds without it;
- an exception or timeout degrades the tick to the fallback model and
  benches the primary. A primary on the CPU gets a host-side greedy
  fallback (GreedyCutScanModel on the CPU, numpy backend) by default; a
  primary on the card gets none unless the caller passes one; without
  one, each failure or timeout is counted and raised, so that a kernel
  fault never turns into host solves nobody asked for;
- after ``rearm_ticks`` clean fallback ticks the primary is re-armed and
  tried again — a transient failure self-heals, a persistent one keeps the
  server scheduling on the fallback indefinitely;
- if the fallback ALSO fails, the tick assigns nothing (zero counts) and
  the server stays alive to try again next tick.

Degradation is visible: counters (failures, timeouts, degraded ticks,
re-arms, skipped ticks) in ``stats()``. This is the one place of the solve
path that may degrade: the model itself raises when a device solve fails.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time

import numpy as np

from hyperqueue_tpu_torch.utils import chaos

logger = logging.getLogger("hq.watchdog")

DEFAULT_TIMEOUT_S = 5.0
DEFAULT_REARM_TICKS = 20


class SolveTimeout(RuntimeError):
    pass


class _SolveWorker:
    """One daemon thread executing solves so a hang cannot wedge the server
    event loop. A timed-out solve strands the thread mid-call; the watchdog
    abandons the whole worker (daemon threads never block process exit) and
    builds a fresh one for the next primary attempt. A late result from an
    abandoned thread lands in a result box nobody reads — solves are pure,
    so discarding it is safe. On the card the solve's kernel, copies and
    event go to this thread's current stream."""

    def __init__(self):
        self._requests: _queue.Queue = _queue.Queue()
        # done-event of the most recent request: after a timeout it tells
        # whether the stranded thread is STILL inside the solve
        self.last_done: threading.Event | None = None
        self._thread = threading.Thread(
            target=self._loop, name="hq-solve-watchdog", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        from hyperqueue_tpu_torch.utils import profiler

        # sampling-profiler plane label: deadlined solves run here, so
        # solver CPU attributes to the `solve` plane even while the
        # reactor thread is parked in done.wait(). The label is not
        # unregistered when a worker is abandoned — a stranded worker
        # keeps soaking CPU inside the solve, and THAT is what the
        # profile must show; the thread-name prefix fallback re-labels any
        # replacement worker anyway. A stopped worker drops its label.
        profiler.register_plane("solve")
        while True:
            request = self._requests.get()
            if request is None:
                profiler.unregister_plane()
                return
            fn, box, done = request
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 - ferried to the caller
                box["error"] = e
            done.set()

    def run(self, fn, timeout: float):
        box: dict = {}
        done = threading.Event()
        self.last_done = done
        self._requests.put((fn, box, done))
        if not done.wait(timeout):
            raise SolveTimeout(
                f"solve exceeded the {timeout:g}s watchdog deadline"
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def stop(self, timeout: float = 5.0) -> None:
        """End the thread after the solve it runs, if any (a thread
        wedged inside a solve stays abandoned, as a daemon)."""
        self._requests.put(None)
        self._thread.join(timeout)


class SolverWatchdog:
    """Wraps a scheduling model with an exception guard + solve deadline.

    Drop-in for the model protocol the tick uses (solve / solve_async /
    last_backend / last_phases ...); unknown attributes delegate to
    whichever model ran the last solve, so telemetry (shape_allocations,
    last_phases) stays truthful in degraded mode.

    `fallback=None` means the host numpy model for a primary off the card
    and no fallback for a primary on it (`model.device` of type cuda).
    """

    def __init__(
        self,
        model,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        rearm_ticks: int = DEFAULT_REARM_TICKS,
        fallback=None,
    ):
        # set _last_ran FIRST: __getattr__ delegates through it
        self._last_ran = model
        self.model = model
        device = getattr(model, "device", None)
        if fallback is None and getattr(device, "type", None) != "cuda":
            from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

            fallback = GreedyCutScanModel(device="cpu", backend="numpy")
        self.fallback = fallback
        self.timeout_s = timeout_s
        self.rearm_ticks = max(int(rearm_ticks), 1)
        self._bench_remaining = 0  # fallback ticks left before re-arming
        # bench window elapsed but a stranded solve blocked the re-arm:
        # count/log the re-arm at the first primary attempt after it drains
        self._rearm_pending = False
        self._worker: _SolveWorker | None = None
        # done-events of timed-out solves whose threads may still be
        # executing inside the (stateful) primary model
        self._abandoned: list = []
        self.failures = 0
        self.timeouts = 0
        self.degraded_ticks = 0
        self.rearms = 0
        self.skipped_ticks = 0
        self.last_error = ""
        # per-solve verdict of the MOST RECENT solve() call, read into the
        # tick's `decision` (scheduler/tick.py): degraded = the fallback
        # ran this tick, skipped = even the fallback failed
        self.last_solve_degraded = False
        self.last_solve_skipped = False

    # --- model protocol -------------------------------------------------
    def _abandoned_busy(self) -> bool:
        """Is a timed-out solve still executing inside the primary model?
        Its thread shares the model's persistent buffers, so the primary
        may not run again until it drains."""
        if self._abandoned:
            self._abandoned = [e for e in self._abandoned if not e.is_set()]
        return bool(self._abandoned)

    @property
    def armed(self) -> bool:
        return self._bench_remaining == 0 and not self._abandoned_busy()

    @property
    def supports_cpu_floor(self) -> bool:
        # while benched, the fallback runs the tick; it cannot express the
        # joint min-utilization floor, so the tick takes the carve-out
        return self.armed and getattr(self.model, "supports_cpu_floor", False)

    def reset_stats(self) -> None:
        """Zero the telemetry counters (a metrics reset) without touching
        the armed/bench state machine."""
        self.failures = 0
        self.timeouts = 0
        self.degraded_ticks = 0
        self.rearms = 0
        self.skipped_ticks = 0

    def close(self) -> None:
        """Stop the solve thread (the server's shutdown); a later solve
        starts a fresh one."""
        if self._worker is not None:
            self._worker.stop()
            self._worker = None

    def __getattr__(self, name):
        # only reached for attributes not set on the watchdog itself
        return getattr(object.__getattribute__(self, "_last_ran"), name)

    def stats(self) -> dict:
        return {
            "armed": self.armed,
            "bench_remaining": self._bench_remaining,
            "failures": self.failures,
            "timeouts": self.timeouts,
            "degraded_ticks": self.degraded_ticks,
            "rearms": self.rearms,
            "skipped_ticks": self.skipped_ticks,
            "timeout_s": self.timeout_s,
            "rearm_ticks": self.rearm_ticks,
            "last_error": self.last_error,
        }

    # --- solve ----------------------------------------------------------
    def solve(self, **kwargs) -> np.ndarray:
        self.last_solve_degraded = False
        self.last_solve_skipped = False
        return self._guarded(self.model.solve, kwargs)

    def _guarded(self, solve, kwargs) -> np.ndarray:
        """`solve(**kwargs)` on the primary under the deadline; a failure
        or timeout benches the primary (or raises, without a fallback) and
        the fallback solves."""
        # not armed (benched, or a stranded solve still runs) falls through
        # to _run_fallback below
        if self.armed:
            if self._rearm_pending:
                self._rearm_pending = False
                self.rearms += 1
                logger.warning(
                    "re-arming the primary solver (stranded solve drained)"
                )
            try:
                result = self._run_deadlined(self._poisonable(solve, kwargs))
                self._last_ran = self.model
                return result
            except SolveTimeout as e:
                self.timeouts += 1
                self._degrade(e)
            except Exception as e:  # noqa: BLE001 - the guard IS the point
                self._raise_if_paranoid(e)
                self.failures += 1
                self._degrade(e)
        return self._run_fallback(kwargs)

    @staticmethod
    def _raise_if_paranoid(error: BaseException) -> None:
        """--paranoid-tick contract violations must be LOUD, like
        tick_cache.paranoid_check: degrading would both hide the bug and
        destroy the evidence (the degrade path invalidates the resident
        state the divergence lives in)."""
        from hyperqueue_tpu_torch.models.greedy import ResidentParanoidError

        if isinstance(error, ResidentParanoidError):
            raise error

    def _degrade(self, error: BaseException) -> None:
        """Bench the primary after a counted failure or timeout, or raise
        `error` when there is no fallback to degrade to."""
        self.last_error = f"{type(error).__name__}: {error}"
        # a failed/abandoned solve may have consumed (donated) or half-
        # updated the primary's device-resident tick state: drop it so the
        # next primary attempt starts from a clean full upload
        invalidate = getattr(self.model, "invalidate_resident", None)
        if invalidate is not None:
            try:
                invalidate()
            except Exception:  # noqa: BLE001 - never raise out of degrade
                pass
        if self.fallback is None:
            raise error
        self._bench_remaining = self.rearm_ticks
        logger.critical(
            "solver failed (%s); degrading to the host greedy fallback for "
            "%d ticks",
            self.last_error, self.rearm_ticks,
            exc_info=not isinstance(error, SolveTimeout),
        )

    @staticmethod
    def _poisonable(solve, kwargs):
        """`solve(**kwargs)` behind the chaos site `solve`: the poisoned-
        solve injection runs INSIDE the guarded call so a "hang" exercises
        the deadline machinery, not the loop."""
        def call():
            if chaos.ACTIVE:
                chaos.fire("solve")
            return solve(**kwargs)

        return call

    def _run_deadlined(self, call):
        """Run `call` on the watchdog thread under the solve deadline."""
        if self.timeout_s <= 0:
            return call()  # exception guard only
        if self._worker is None:
            self._worker = _SolveWorker()
        try:
            return self._worker.run(call, self.timeout_s)
        except SolveTimeout:
            # the thread is wedged inside the solve: abandon it (daemon)
            if self._worker.last_done is not None:
                self._abandoned.append(self._worker.last_done)
            self._worker = None
            raise

    # --- async solve (the pipelined tick, scheduler/pipeline.py) ---------
    def solve_async(self, **kwargs):
        """Guarded async dispatch: returns a handle whose `.result()` is
        ALSO guarded — an exception or deadline overrun while materializing
        the pending counts degrades exactly like a synchronous failure
        (bench the primary, drop its resident device state, and solve the
        SAME snapshot on the host fallback), so a pipelined tick can never
        lose a solve: the pipeline's pending handle always resolves to a
        valid counts array."""
        self.last_solve_degraded = False
        self.last_solve_skipped = False
        if self.armed and hasattr(self.model, "solve_async"):
            if self._rearm_pending:
                self._rearm_pending = False
                self.rearms += 1
                logger.warning(
                    "re-arming the primary solver (stranded solve drained)"
                )

            try:
                inner = self._run_deadlined(
                    self._poisonable(self.model.solve_async, kwargs))
                self._last_ran = self.model
                return _WatchdogHandle(self, inner, kwargs)
            except SolveTimeout as e:
                self.timeouts += 1
                self._degrade(e)
            except Exception as e:  # noqa: BLE001 - the guard IS the point
                self._raise_if_paranoid(e)
                self.failures += 1
                self._degrade(e)
        # not armed / no async support / dispatch failed: solve NOW on
        # whatever solve() would have used and box the counts
        return _ReadyHandle(self.solve(**kwargs))

    # --- the autoalloc demand query (autoalloc/query.py) -----------------
    def solve_query(self, **kwargs) -> np.ndarray:
        """The demand query's solve, guarded as `solve` guards a tick's:
        the chaos site `solve` counts it, a failure or timeout benches the
        primary (or raises, without a fallback), and a benched watchdog
        answers from the fallback. It runs the model's `solve_query`,
        which leaves the tick's resident state alone, and keeps the
        tick's per-solve verdict (`last_solve_degraded`,
        `last_solve_skipped`, the model that ran last) as it was, so a
        query between a pipelined tick's dispatch and its take changes
        nothing the tick reads."""
        verdict = (self.last_solve_degraded, self.last_solve_skipped,
                   self._last_ran)
        try:
            return self._guarded(self.model.solve_query, kwargs)
        finally:
            (self.last_solve_degraded, self.last_solve_skipped,
             self._last_ran) = verdict

    def _run_fallback(self, kwargs) -> np.ndarray:
        if self.fallback is None:
            # only reached while a timed-out solve still runs in the primary
            raise SolveTimeout(
                "a timed-out solve still runs in the primary and the "
                "watchdog has no fallback"
            )
        self.last_solve_degraded = True
        fb_kwargs = dict(kwargs)
        # the fallback cannot express the joint min-utilization floor: on a
        # degraded tick the floored workers WAIT (their rows are zeroed, so
        # they receive nothing) rather than take work below their floor
        cpu_floor = fb_kwargs.pop("cpu_floor", None)
        if cpu_floor is not None:
            floored = np.asarray(cpu_floor) > 0
            if floored.any():
                free = np.array(fb_kwargs["free"], copy=True)
                free[floored] = 0
                nt_free = np.array(fb_kwargs["nt_free"], copy=True)
                nt_free[floored] = 0
                fb_kwargs["free"] = free
                fb_kwargs["nt_free"] = nt_free
        try:
            result = self.fallback.solve(**fb_kwargs)
        except Exception:  # noqa: BLE001 - never kill the scheduling loop
            self.skipped_ticks += 1
            self.last_solve_skipped = True
            logger.critical(
                "fallback solve failed too; assigning nothing this tick",
                exc_info=True,
            )
            n_b, n_v, _ = kwargs["needs"].shape
            self._last_ran = self.fallback
            return np.zeros((n_b, n_v, kwargs["free"].shape[0]),
                            dtype=np.int32)
        self.degraded_ticks += 1
        if self._bench_remaining > 0:
            self._bench_remaining -= 1
            if self._bench_remaining == 0:
                if self._abandoned_busy():
                    self._rearm_pending = True
                    logger.warning(
                        "bench window elapsed but a timed-out solve still "
                        "runs; staying on the fallback until it drains"
                    )
                else:
                    self.rearms += 1
                    logger.warning(
                        "re-arming the primary solver after %d clean "
                        "fallback ticks", self.rearm_ticks,
                    )
        self._last_ran = self.fallback
        return result


class _ReadyHandle:
    """Async-solve handle whose counts are already materialized."""

    __slots__ = ("_counts",)

    def __init__(self, counts):
        self._counts = counts

    def result(self):
        return self._counts


class _WatchdogHandle:
    """Deadline + exception guard around a primary model's pending solve.

    `result()` materializes the inner handle on the watchdog thread with
    the solve deadline; a timeout or exception degrades the watchdog
    (bench + resident-state invalidation, exactly like a synchronous
    failure) and re-solves the SAME dispatched snapshot on the host
    fallback — the captured kwargs are the assemble output of that tick,
    which stays untouched until the pipeline maps this handle."""

    __slots__ = ("_wd", "_inner", "_kwargs")

    def __init__(self, wd: "SolverWatchdog", inner, kwargs):
        self._wd = wd
        self._inner = inner
        self._kwargs = kwargs

    def result(self):
        wd = self._wd
        inner = self._inner
        try:
            out = wd._run_deadlined(inner.result)
            wd._last_ran = wd.model
            return out
        except SolveTimeout as e:
            wd.timeouts += 1
            wd._degrade(e)
        except Exception as e:  # noqa: BLE001 - the guard IS the point
            wd._raise_if_paranoid(e)
            wd.failures += 1
            wd._degrade(e)
        return wd._run_fallback(self._kwargs)
