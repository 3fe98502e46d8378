"""tests/test_elasticity.py against the port, on the CPU.

The e2e cases run unchanged against the port's server, its local
allocation handler (which starts `python -m hyperqueue_tpu_torch worker
start`), its worker and its command line (`test_torch_cli_e2e.
run_scenario`); their fault plans reach the port's chaos sites
(`autoalloc.spawn`, `autoalloc.submit`, `autoalloc.post-spawn`,
`server.event`). The unit cases run the JAX module's functions on the
port's `autoalloc/` (`test_torch_autoalloc.use_port_module`).
"""

from __future__ import annotations

import pytest
import torch

import test_elasticity
from test_torch_autoalloc import call_case, jax_cases, use_port_module
from test_torch_cli_e2e import run_scenario

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ENV_CASES = [
    "test_local_elasticity_loop",
    "test_worker_stop_drain_and_escalation",
    "test_zombie_allocation_reaped",
    "test_crash_loop_quarantine_and_release",
    "test_kill9_at_alloc_queued_restore_reconciles",
    "test_kill9_in_adoption_window",
    "test_submit_failure_backoff_with_chaos",
]

UNIT_CASES = [
    "test_crash_loop_quarantine_state",
    "test_manager_timeout_kills_hung_sbatch",
    "test_allocation_restore_round_trip",
]


def test_every_case_is_twinned():
    assert jax_cases(test_elasticity) == set(ENV_CASES + UNIT_CASES)


@pytest.mark.parametrize("case", ENV_CASES)
def test_elasticity_e2e_on_the_port(case, tmp_path, monkeypatch):
    run_scenario(test_elasticity, getattr(test_elasticity, case), tmp_path,
                 monkeypatch)


@pytest.mark.parametrize("case", UNIT_CASES)
def test_elasticity_unit_on_the_port(case, tmp_path, monkeypatch):
    fn = getattr(test_elasticity, case)
    use_port_module(test_elasticity, fn, monkeypatch)
    call_case(fn, tmp_path, monkeypatch)


def test_local_allocation_starts_the_ports_worker(tmp_path):
    """The local handler's script starts the port's worker, never the JAX
    package's."""
    from hyperqueue_tpu_torch.autoalloc.handlers import LocalHandler
    from hyperqueue_tpu_torch.autoalloc.state import QueueParams

    script = LocalHandler("/srv", tmp_path).build_script(
        1, QueueParams(manager="local", workers_per_alloc=2))
    lines = [line for line in script.splitlines() if "worker start" in line]
    assert len(lines) == 2
    assert all("-m hyperqueue_tpu_torch worker start" in line
               for line in lines)
