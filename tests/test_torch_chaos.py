"""tests/test_chaos.py against the port's server, worker and command line,
on the CPU (`test_torch_cli_e2e.run_scenario`).

The fault plans reach the port's chaos sites: the server's `server.event`
(after the journal write and flush), `server.send` and `server.recv`, the
watchdog's `solve` and the worker's `worker.send`/`worker.recv`. The
server runs `--scheduler cpu`, whose watchdog degrades a poisoned or hung
solve to the host fallback as the JAX server's does; a server on the card
has no fallback and raises instead (ROADMAP Queue 3).
"""

from __future__ import annotations

import pytest
import torch

import test_chaos
from test_torch_autoalloc import jax_cases
from test_torch_cli_e2e import run_scenario

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ENV_CASES = [
    "test_server_kill9_reattach_zero_duplicates",
    "test_reattach_window_expiry_requeues_with_fencing",
    "test_solver_watchdog_exception_degrades_and_rearms",
    "test_solver_watchdog_hang_falls_back_within_deadline",
    "test_fsync_always_event_survives_kill9_at_event",
    "test_duplicated_messages_no_duplicate_execution",
    "test_heartbeat_timeout_structured_event_and_reconnect",
    "test_client_request_rides_out_server_restart",
    "test_client_retry_is_bounded",
    "test_two_kill_restart_cycles_complete_all_work",
]


def test_every_case_is_twinned():
    assert jax_cases(test_chaos) == set(ENV_CASES)


@pytest.mark.parametrize("case", ENV_CASES)
def test_chaos_e2e_on_the_port(case, tmp_path, monkeypatch):
    run_scenario(test_chaos, getattr(test_chaos, case), tmp_path,
                 monkeypatch)


def test_solve_rule_raises_on_a_card_model(monkeypatch):
    """A `solve` rule on a server whose model is on the card: the watchdog
    has no fallback there, so the injected failure is counted, the
    residency dropped and the error raised out of the tick (the server's
    scheduler loop logs it and restarts), never a host solve; the demand
    query's solve is matched at the same site."""
    import types

    import numpy as np

    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
    from hyperqueue_tpu_torch.utils import chaos

    class CardModel:
        device = types.SimpleNamespace(type="cuda")

        def __init__(self):
            self.solves = []
            self.invalidated = 0

        def solve(self, **kwargs):
            self.solves.append("tick")
            return np.zeros((1, 1, 2), dtype=np.int32)

        def solve_query(self, **kwargs):
            self.solves.append("query")
            return np.zeros((1, 1, 2), dtype=np.int32)

        def invalidate_resident(self):
            self.invalidated += 1

    model = CardModel()
    watchdog = SolverWatchdog(model, timeout_s=0)
    assert watchdog.fallback is None
    # the second rule counts the matches the first let pass: its second
    # is the query's
    monkeypatch.setattr(chaos, "_PLAN", chaos.FaultPlan({"rules": [
        {"site": "solve", "action": "raise", "at": 1},
        {"site": "solve", "action": "raise", "at": 2}]}))
    monkeypatch.setattr(chaos, "ACTIVE", True)
    with pytest.raises(chaos.ChaosInjectedError):
        watchdog.solve()
    assert (watchdog.failures, watchdog.degraded_ticks) == (1, 0)
    assert model.solves == [] and model.invalidated == 1
    assert watchdog.solve().shape == (1, 1, 2)
    with pytest.raises(chaos.ChaosInjectedError):
        watchdog.solve_query()
    assert model.solves == ["tick"] and watchdog.failures == 2
    assert watchdog.armed
