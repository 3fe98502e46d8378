"""The JAX package's JSON and quiet output scenarios
(tests/test_output_stability.py), run unchanged against the port's server,
worker and command line on the CPU (test_torch_cli_e2e.run_scenario):
the field names and types of every major command's `--output-mode json`
and the bare ids of `--output-mode quiet`.

The allocation commands run too, and the last test of this file holds
their JSON equal through the JAX package's CLI and server and the port's
(until the allocation service was ported it held the port's refusal of
them, hence its name).
"""

from __future__ import annotations

import json

import pytest
import torch

import test_output_stability as jax_output
from test_torch_cli_e2e import PortCliEnv, run_scenario, scenarios
from utils_e2e import HqEnv, wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

@pytest.mark.parametrize("scenario", scenarios(jax_output))
def test_output_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_output, scenario, tmp_path, monkeypatch)


def test_alloc_commands_refuse_naming_item_10(tmp_path):
    """`hq alloc add/list/events --output-mode json` print the same JSON
    through the JAX CLI against a JAX server as through the port's CLI
    against the port's server (the decision records without their clock
    fields). Until the allocation service was ported, this test held the
    port's refusal of the same commands."""
    outs = {}
    for name, env_class in (("jax", HqEnv), ("port", PortCliEnv)):
        with env_class(tmp_path / name) as env:
            env.start_server(env_extra={"HQ_AUTOALLOC_INTERVAL": "0.2"})
            add = env.command(["alloc", "add", "slurm", "--no-dry-run",
                               "--name", "q", "--output-mode", "json"],
                              with_stderr=True)
            listed = env.command(["alloc", "list", "--output-mode", "json"],
                                 with_stderr=True)

            def events():
                return json.loads(env.command(
                    ["alloc", "events", "--output-mode", "json"]))

            wait_until(events, timeout=30, message="a decision record")
            decision = {k: v for k, v in events()[0].items()
                        if k not in ("time", "last_time", "ticks")}
            outs[name] = (json.loads(add), json.loads(listed), decision)
    assert outs["port"] == outs["jax"]
    add, listed, decision = outs["port"]
    assert listed[0]["params"]["name"] == "q"
    assert decision["verdict"] == "hold" and decision["queue"] == 1
