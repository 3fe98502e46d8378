"""Deterministic fault injection (the chaos harness).

A FaultPlan is a seeded list of rules loaded from the HQ_FAULT_PLAN
environment variable (inline JSON, or `@/path/to/plan.json`). Each process
— server, worker, client — loads its own plan from its own environment, so
a test can fault exactly one side of a connection. Rules fire
deterministically: `at` fires on the Nth matching call only, `times` caps
total fires, `prob` draws from a per-rule RNG seeded by (plan seed, rule
index) — the same plan against the same message sequence always injects
the same faults.

Rule schema (all keys except site/action optional)::

    {"site": "worker.send",            # injection point, see below
     "op": "task_finished",            # match only this message op
     "event": "task-finished",         # match only this event kind (server.event)
     "action": "drop",                 # drop | dup | delay | kill | raise | hang
     "at": 3,                          # fire on the 3rd match only
     "at_t": 42.5,                     # gate: match only at/after this clock time
     "times": 2,                       # fire at most twice
     "prob": 0.25,                     # else fire per-match with this probability
     "delay_ms": 50,                   # for action=delay
     "hang_s": 30}                     # for action=hang

Schedule-driven mode: ``at``/``at_t`` triggers make a plan a
deterministic SCHEDULE rather than a sieve — the same plan object fires
the same faults regardless of what else raced through the site counters.
``at_t`` reads :mod:`hyperqueue_tpu_torch.utils.clock`, so under the simulator's
virtual clock a rule pinned to t=600 fires at 600 virtual seconds even
when the whole run takes milliseconds of wall time; ``at`` counts matches
only once the ``at_t`` gate has opened, so "the 3rd journal event after
t=42" composes the two.  Prefer these over ``prob`` rules whenever the
run must be seed-reproducible: a ``prob`` draw consumes the per-rule RNG
in ARRIVAL order, so two runs that interleave messages differently
diverge, while an occurrence/time schedule does not.

In-process harnesses (the simulator, tests) install plans directly with
:func:`install_plan` / :func:`clear_plan` instead of the environment
variable, and may replace the ``kill`` action's process-SIGKILL with
:func:`set_kill_handler` (the simulator maps "kill" onto dropping the
in-process server's state and restoring from the journal).

Sites threaded through the control plane:

- ``worker.send`` / ``worker.recv`` — the worker's uplink messages (before
  batching) and downlink messages;
- ``server.send`` / ``server.recv`` — the server's worker-plane messages
  (recv is per logical message, after batch unpacking);
- ``solve`` — the per-tick scheduler solve (actions raise/hang, guarded by
  the solver watchdog, scheduler/watchdog.py);
- ``server.event`` — Server.emit_event, AFTER the journal write+flush (so
  ``kill`` at event K proves exactly what the flush policy persisted);
- ``server.compact`` — the journal compaction phases (match on ``event``:
  ``mid-snapshot-write`` / ``pre-rename`` / ``post-rename`` / ``mid-gc`` /
  ``pre-swap`` / ``post-swap``), so kill -9 can land inside every window
  of the snapshot+GC crash matrix (docs/fault_tolerance.md);
- ``autoalloc.submit`` — one queue-manager submit attempt (raise = the
  submit fails, kill = server death mid-submit);
- ``autoalloc.spawn`` — the local allocation handler's worker spawn,
  consulted via :func:`decide` with caller-defined action semantics
  (autoalloc/handlers.py LocalHandler: ``drop`` = allocation stuck queued,
  ``hang`` = allocation runs but the worker never registers,
  ``raise`` = the worker boots, registers, then dies).

Faults are injected at the MESSAGE level, not the raw frame level: the
encrypted transport seals frames with counter nonces (transport/auth.py),
so dropping a sealed frame would desynchronize the stream rather than
model a lost message. Dropping/duplicating the message before sealing (or
after opening) exercises the same recovery paths without breaking the
cipher.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import signal
import threading
import time

from hyperqueue_tpu_torch.utils import clock

logger = logging.getLogger("hq.chaos")


class ChaosInjectedError(RuntimeError):
    """Raised by an action="raise" rule (e.g. a poisoned solve)."""


class _Rule:
    __slots__ = (
        "site", "op", "event", "shard", "action", "prob", "at", "at_t",
        "times", "delay_ms", "hang_s", "_matches", "_fired", "_rng",
    )

    def __init__(self, spec: dict, index: int, seed: int):
        self.site = spec["site"]
        self.op = spec.get("op")
        self.event = spec.get("event")
        # scope to one federation shard: sites fired from a
        # shard server pass shard=<id>, the migration driver passes
        # shard=-1 ("the coordinator"); rules without the key match all
        self.shard = spec.get("shard")
        self.action = spec["action"]
        self.prob = spec.get("prob")
        self.at = spec.get("at")
        # time gate (wall clock under the active utils/clock provider —
        # virtual time in the simulator): the rule matches nothing before
        # this instant, and `at` counts occurrences only after it
        self.at_t = spec.get("at_t")
        self.times = spec.get("times")
        self.delay_ms = float(spec.get("delay_ms", 25.0))
        self.hang_s = float(spec.get("hang_s", 30.0))
        self._matches = 0
        self._fired = 0
        self._rng = random.Random(f"{seed}:{index}")

    def check(self, site: str, op, event, shard=None) -> bool:
        if site != self.site:
            return False
        if self.op is not None and op != self.op:
            return False
        if self.event is not None and event != self.event:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        if self.at_t is not None and clock.now() < self.at_t:
            return False
        self._matches += 1
        if self.times is not None and self._fired >= self.times:
            return False
        if self.at is not None and self._matches != self.at:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self._fired += 1
        return True


class FaultPlan:
    def __init__(self, spec: dict):
        self.seed = int(spec.get("seed", 0))
        self.rules = [
            _Rule(r, i, self.seed) for i, r in enumerate(spec.get("rules", ()))
        ]
        # counters are bumped from the event loop AND the solve thread
        self._lock = threading.Lock()

    def match(self, site: str, op=None, event=None, shard=None) -> _Rule | None:
        with self._lock:
            for rule in self.rules:
                if rule.check(site, op, event, shard):
                    logger.warning(
                        "chaos: %s at site=%s op=%s event=%s shard=%s",
                        rule.action, site, op, event, shard,
                    )
                    return rule
        return None


_PLAN: FaultPlan | None = None
# cheap guard for hot paths: `if chaos.ACTIVE:` costs one global load when
# no plan is configured (the overwhelmingly common case)
ACTIVE = False


def _load() -> None:
    global _PLAN, ACTIVE
    raw = os.environ.get("HQ_FAULT_PLAN")
    if not raw:
        return
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    _PLAN = FaultPlan(json.loads(raw))
    ACTIVE = True
    logger.warning(
        "chaos harness active: %d rule(s), seed %d",
        len(_PLAN.rules), _PLAN.seed,
    )


_load()


def install_plan(plan: "FaultPlan | dict | None") -> None:
    """Install a plan programmatically (simulator / in-process tests).

    Replaces whatever HQ_FAULT_PLAN loaded at import.  Passing a dict
    builds a fresh FaultPlan (fresh rule counters); passing None is
    equivalent to :func:`clear_plan`."""
    global _PLAN, ACTIVE
    if isinstance(plan, dict):
        plan = FaultPlan(plan)
    _PLAN = plan
    ACTIVE = plan is not None


def clear_plan() -> None:
    """Remove the active plan (and with it all rule state)."""
    install_plan(None)


def _kill_self() -> None:
    logging.shutdown()
    os.kill(os.getpid(), signal.SIGKILL)


# action="kill" handler: SIGKILL of the process by default.  The simulator
# replaces it with an in-process equivalent (drop the server's in-memory
# state, lose the unflushed journal tail, restore from the journal) so
# kill-at-site rules exercise the same crash choreography without taking
# the test process down.  The handler must not return normally: a real
# kill -9 never does, and code after the injection point must not run.
_KILL_HANDLER = _kill_self


def set_kill_handler(handler) -> None:
    """Replace the action="kill" behavior; None restores SIGKILL-self.
    The handler must unwind the caller (raise) or end the process."""
    global _KILL_HANDLER
    _KILL_HANDLER = handler if handler is not None else _kill_self


# context of the most recent fire() that reached the kill handler: a
# multi-server harness (the federated simulator) installs ONE global kill
# handler but must know WHICH server (or "the coordinator") hit the rule.
# Set just before the handler runs; the handler reads it synchronously.
_LAST_CTX = None


def last_ctx():
    """Context object passed to the fire() that last triggered a kill."""
    return _LAST_CTX


def fire(site: str, op=None, event=None, shard=None, ctx=None) -> None:
    """Synchronous injection point (solve, server.event).

    Applies kill/raise/hang/delay inline (delay and hang are BLOCKING
    sleeps — at server.event that stalls the whole event loop, which is
    the point of injecting them there). drop/dup have no meaning at a
    sync site (there is no message to drop); such rules are rejected
    loudly rather than silently matching and doing nothing. `shard`
    scopes rule matching; `ctx` is recorded for the kill handler (see
    :func:`last_ctx`)."""
    global _LAST_CTX
    if _PLAN is None:
        return
    rule = _PLAN.match(site, op=op, event=event, shard=shard)
    if rule is None:
        return
    if rule.action == "kill":
        _LAST_CTX = ctx
        _KILL_HANDLER()
    if rule.action == "raise":
        raise ChaosInjectedError(f"injected failure at {site}")
    if rule.action == "hang":
        time.sleep(rule.hang_s)
    elif rule.action == "delay":
        time.sleep(rule.delay_ms / 1000.0)
    elif rule.action in ("drop", "dup"):
        logger.error(
            "chaos: action %r is not applicable at sync site %s; ignored",
            rule.action, site,
        )


def decide(site: str, op=None, event=None) -> str | None:
    """Matching injection point whose ACTION the caller interprets.

    For sites where drop/dup/hang model domain behavior rather than a
    message-plane fault (e.g. the local allocation handler's spawn step).
    kill is still applied inline — "die here" means the same everywhere;
    every other action name is returned for the caller to map onto its own
    failure mode."""
    if _PLAN is None:
        return None
    rule = _PLAN.match(site, op=op, event=event)
    if rule is None:
        return None
    if rule.action == "kill":
        _KILL_HANDLER()
    return rule.action


async def on_message(site: str, op=None) -> str | None:
    """Async injection point for message-plane sites.

    Returns "drop" or "dup" for the caller to apply; applies delay (async
    sleep) and kill inline; action=raise raises ChaosInjectedError into
    the connection loop (modeling a poisoned/undecodable message)."""
    if _PLAN is None:
        return None
    rule = _PLAN.match(site, op=op)
    if rule is None:
        return None
    if rule.action == "kill":
        _KILL_HANDLER()
    if rule.action == "raise":
        raise ChaosInjectedError(f"injected failure at {site}")
    if rule.action == "delay":
        await asyncio.sleep(rule.delay_ms / 1000.0)
        return None
    if rule.action == "hang":
        # a hung peer = the message (and everything after it on this
        # plane) stalls for hang_s; async so the rest of the process lives
        await asyncio.sleep(rule.hang_s)
        return None
    if rule.action in ("drop", "dup"):
        return rule.action
    return None
