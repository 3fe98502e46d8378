"""The JAX package's JSON and quiet output scenarios
(tests/test_output_stability.py), run unchanged against the port's server,
worker and command line on the CPU (test_torch_cli_e2e.run_scenario):
the field names and types of every major command's `--output-mode json`
and the bare ids of `--output-mode quiet`.

Left out, with the reason: `test_json_alloc_schema` and
`test_alloc_add_json_clean_stdout` need allocation queues, which come with
ROADMAP Queue 1 item 10; the port's server answers the alloc RPCs with an
error naming that item, and `test_alloc_commands_refuse_naming_item_10`
holds the CLI to it.
"""

from __future__ import annotations

import pytest
import torch

import test_output_stability as jax_output
from test_torch_cli_e2e import PortCliEnv, run_scenario, scenarios

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ITEM_10 = {
    "test_json_alloc_schema": "allocation queues come with item 10",
    "test_alloc_add_json_clean_stdout": "allocation queues come with "
                                        "item 10",
}


@pytest.mark.parametrize("scenario", scenarios(jax_output, skip=ITEM_10))
def test_output_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_output, scenario, tmp_path, monkeypatch)


def test_alloc_commands_refuse_naming_item_10(tmp_path):
    """`hq alloc add/list/events` against the port's server exit non-zero
    with one line naming item 10, and print nothing on stdout."""
    with PortCliEnv(tmp_path) as env:
        env.start_server()
        for args in (["alloc", "add", "slurm", "--no-dry-run",
                      "--output-mode", "json"],
                     ["alloc", "list", "--output-mode", "json"],
                     ["alloc", "events"]):
            out = env.command(args, expect_fail=True, with_stderr=True)
            assert "item 10" in out and out.startswith("error: "), out
            assert len(out.strip().splitlines()) == 1
