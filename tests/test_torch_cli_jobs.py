"""The JAX package's job and worker feature scenarios
(tests/test_job_features.py, tests/test_worker_features.py), run unchanged
against the port's server, worker and command line on the CPU
(test_torch_cli_e2e.run_scenario): JSON entries, stdin, max-fails,
priorities, cancel reasons, array subsets and steps; `task notify`, the
worker's overview and info, the debug dump, pinning and task dirs, time
limits.

Two scenarios spawn the JAX CLI themselves: `test_stdin_forwarding` runs
`python -m hyperqueue_tpu submit --stdin`, and
`test_task_notify_reaches_event_stream` runs `python -m hyperqueue_tpu
task notify` inside its task. Those steps stay the JAX CLI's; the two
tests below are their port twins.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import test_job_features as jax_job_features
import test_worker_features as jax_worker_features
from test_torch_cli_e2e import (
    PortCliEnv,
    port_env_base,
    run_scenario,
    scenarios,
)

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("scenario", scenarios(jax_job_features))
def test_job_feature_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_job_features, scenario, tmp_path, monkeypatch)


@pytest.mark.parametrize("scenario", scenarios(jax_worker_features))
def test_worker_feature_scenario_on_the_port(scenario, tmp_path,
                                             monkeypatch):
    run_scenario(jax_worker_features, scenario, tmp_path, monkeypatch)


def test_stdin_forwarding_through_the_port(tmp_path):
    """`python -m hyperqueue_tpu_torch submit --stdin` hands its stdin to
    the task."""
    with PortCliEnv(tmp_path) as env:
        env.start_server()
        env.start_worker()
        env.wait_workers(1)
        result = subprocess.run(
            [sys.executable, "-m", "hyperqueue_tpu_torch", "submit",
             "--stdin", "--wait", "--", "wc", "-c"],
            input=b"hello stdin!",
            env={**port_env_base(), "HQ_SERVER_DIR": str(env.server_dir)},
            cwd=env.work_dir, capture_output=True, timeout=60)
        assert result.returncode == 0, result.stdout
        out = env.command(["job", "cat", "1", "stdout"])
        assert out.strip() == "12"


def test_task_notify_through_the_port(tmp_path):
    """`python -m hyperqueue_tpu_torch task notify` inside a task reaches
    the journal's event stream as a task-notify record."""
    with PortCliEnv(tmp_path) as env:
        env.start_server("--journal", str(tmp_path / "j.bin"))
        env.start_worker()
        env.wait_workers(1)
        env.command(
            ["submit", "--wait", "--", "bash", "-c",
             "python -m hyperqueue_tpu_torch task notify 'progress 50%'"])
        out = env.command(["journal", "stream", "--history"])
        notifications = [
            json.loads(line) for line in out.splitlines()
            if json.loads(line)["event"] == "task-notify"
        ]
        assert notifications
        assert notifications[0]["payload"] == "progress 50%"
