"""The JAX package's CLI feature scenarios (tests/test_cli_features.py),
run unchanged against the port's server, worker and command line on the
CPU (test_torch_cli_e2e.run_scenario): selectors, placeholders, resource
definitions, directives, TOML job files, `task explain`, a pre-shared
access file, `job task-ids`, `task info`, `job submit`, stdio `none` and
`rm-if-finished`, progress and `--on-notify`, `job list` filters and
`job summary`.

One scenario spawns `python -m hyperqueue_tpu worker hw-detect` itself;
that step stays the JAX CLI's, and
`test_worker_hw_detect_through_the_port` is its port twin.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import test_cli_features as jax_cli_features
from test_torch_cli_e2e import port_env_base, run_scenario, scenarios

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("scenario", scenarios(jax_cli_features))
def test_cli_feature_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_cli_features, scenario, tmp_path, monkeypatch)


def test_worker_hw_detect_through_the_port():
    """`python -m hyperqueue_tpu_torch worker hw-detect` needs no server
    and prints what the JAX CLI prints for the same machine."""
    outs = []
    for package in ("hyperqueue_tpu_torch", "hyperqueue_tpu"):
        outs.append(json.loads(subprocess.run(
            [sys.executable, "-m", package, "worker", "hw-detect",
             "--output-mode", "json"],
            capture_output=True, text=True, timeout=60, check=True,
            env=port_env_base()).stdout))
    names = [item["name"] for item in outs[0]["items"]]
    assert "cpus" in names and "mem" in names
    assert outs[0] == outs[1]
