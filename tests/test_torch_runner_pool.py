"""The e2e cases of tests/test_runner_pool.py with the port's worker and
its warm runner pool, against the JAX package's server and the port's.

Each case is the JAX module's own function, handed an environment whose
`start_worker` runs the port's worker (`test_torch_worker_e2e.
with_port_workers`); the client commands are the JAX package's CLI. The
pool's runners boot by path under `-S` and speak the port's codec, so
`_runner_pids` finds them by `worker/runner.py` as it finds the JAX
package's. The unit cases (the launch plan) run in tests/test_torch_worker.py.
"""

from __future__ import annotations

import inspect

import pytest
import torch

import test_runner_pool
from test_torch_worker_e2e import SERVERS, with_port_workers

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

E2E_CASES = [
    "test_differing_env_submits_never_share_a_stale_plan",
    "test_runner_crash_fails_task_and_pool_respawns",
    "test_worker_stop_drains_runner_pool",
    "test_pool_spawn_failure_reports_task_error",
    "test_timeline_phase_sum_identity_with_batched_uplinks",
    "test_runner_pool_disabled_falls_back_to_inloop_spawn",
    "test_pool_task_time_limit_still_kills",
]


def test_every_e2e_case_is_twinned():
    every = {n for n, f in vars(test_runner_pool).items()
             if n.startswith("test_") and inspect.isfunction(f)
             and "env" in inspect.signature(f).parameters}
    assert every == set(E2E_CASES)


@pytest.mark.parametrize("case", E2E_CASES)
@pytest.mark.parametrize("server", sorted(SERVERS))
def test_runner_pool_case_with_a_port_worker(tmp_path, server, case):
    with with_port_workers(SERVERS[server])(tmp_path) as env:
        getattr(test_runner_pool, case)(env)
        worker_logs = [env.read_log(name) for name, _ in env.processes
                       if name.startswith("worker")]
        assert worker_logs and all("codec backend native" in log
                                   for log in worker_logs)
