"""A worker whose server went away before it read its `stop` frame acts
by its `on_server_lost`, in both packages.

The server's shutdown sends `stop` to each worker and closes the
connections 50 ms later; a worker behind a busy fan-out can miss its frame
and sees only the closed connection. Here the port's server is killed
(SIGKILL: no `stop` frame at all) while a worker of either package runs a
task: `stop` exits at once, `finish-running` finishes the running task
first, `reconnect` retries for its `--reconnect-timeout` window and then
exits.
"""

from __future__ import annotations

import time

import pytest
import torch

from test_torch_server_e2e import PortServerEnv
from test_torch_worker_e2e import (
    _assert_port_worker_log,
    _jobs,
    with_port_workers,
)
from utils_e2e import wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["stop", "finish-running", "reconnect"])
@pytest.mark.parametrize("worker_pkg", ["jax", "port"])
def test_worker_without_its_stop_frame_acts_by_on_server_lost(
        tmp_path, worker_pkg, mode):
    """The port's server is killed (no `stop` frame reaches the worker, as
    for a worker behind a busy fan-out whose connection closes first)
    while the worker runs a 2 s task. `stop`: the worker exits at once and
    the task never finishes. `finish-running`: it exits once the task
    finished. `reconnect` (window 2 s): it is still up after 1.5 s and
    exits after its window."""
    env_class = PortServerEnv if worker_pkg == "jax" \
        else with_port_workers(PortServerEnv)
    with env_class(tmp_path) as env:
        marker = env.work_dir / "done.txt"
        env.start_server()
        extra = ["--on-server-lost", mode, "--runner-pool", "1"]
        if mode == "reconnect":
            extra += ["--reconnect-timeout", "2"]
        worker = env.start_worker(*extra, cpus=1)
        env.wait_workers(1)
        env.command(["submit", "--", "bash", "-c",
                     f"sleep 2 && echo done > {marker}"])
        wait_until(lambda: _jobs(env)[0]["counters"]["running"] == 1,
                   timeout=30, message="task running")
        env.kill_process("server")
        lost = time.monotonic()
        if mode == "stop":
            wait_until(lambda: worker.poll() is not None, timeout=10,
                       message="worker exited on server loss")
            time.sleep(2.5)
            assert not marker.exists()
        elif mode == "finish-running":
            wait_until(lambda: worker.poll() is not None, timeout=30,
                       message="worker exited after its task")
            assert marker.read_text().strip() == "done"
        else:
            time.sleep(1.5)
            assert worker.poll() is None, "reconnect gave up early"
            wait_until(lambda: worker.poll() is not None, timeout=30,
                       message="worker gave up after its window")
            assert time.monotonic() - lost >= 2.0
        log = env.read_log("worker0")
        if worker_pkg == "port":
            _assert_port_worker_log(env)
        if mode == "reconnect":
            assert "reconnect" in log.lower(), log
