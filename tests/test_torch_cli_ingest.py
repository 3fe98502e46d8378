"""The JAX package's streamed-submit scenarios (tests/test_ingest.py), run
unchanged against the port's server and command line on the CPU
(test_torch_cli_e2e.run_scenario; the scenarios' `ClientSession` and
`SubmitStream` are the port's `client/connection` for the call): chunked
CLI submits over lazy chunks, their cancel, completion, pause and resume,
per-chunk stamps, concurrent streams, duplicate chunks, a kill -9 mid
stream, trace continuity, `--from-stdin`, malformed frames, a rejected
chunk, restores that keep chunks lazy and the reactor-plane escape hatch.

Left out, with the reason: `test_lazy_store_take_materializes_with_chunk_
stamps` and `test_lazy_store_ids_list_and_drop` are units of the server's
lazy store, not CLI cases; tests/test_torch_lazy.py twins them.

`test_from_stdin_e2e` spawns `python -m hyperqueue_tpu submit
--from-stdin` itself; that step stays the JAX CLI's, and
`test_from_stdin_through_the_port` is its port twin.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import test_ingest as jax_ingest
from test_torch_cli_e2e import (
    PortCliEnv,
    port_env_base,
    run_scenario,
    scenarios,
)

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.ingest

NOT_CLI = {
    "test_lazy_store_take_materializes_with_chunk_stamps":
        "a unit of the lazy store (tests/test_torch_lazy.py)",
    "test_lazy_store_ids_list_and_drop":
        "a unit of the lazy store (tests/test_torch_lazy.py)",
}


@pytest.mark.parametrize("scenario", scenarios(jax_ingest, skip=NOT_CLI))
def test_ingest_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_ingest, scenario, tmp_path, monkeypatch)


def test_from_stdin_through_the_port(tmp_path):
    """`python -m hyperqueue_tpu_torch submit --from-stdin` streams one
    task a line in chunks."""
    with PortCliEnv(tmp_path) as env:
        env.start_server("--lazy-array-threshold", "10")
        payload = "".join(f"item{i}\n" for i in range(100))
        r = subprocess.run(
            [sys.executable, "-m", "hyperqueue_tpu_torch", "submit",
             "--from-stdin", "--chunk-size", "30", "--",
             "bash", "-c", "echo $HQ_ENTRY"],
            input=payload, capture_output=True, text=True,
            env={**port_env_base(), "HQ_SERVER_DIR": str(env.server_dir)},
            cwd=env.work_dir, timeout=60)
        assert r.returncode == 0, r.stderr
        assert "(100 tasks)" in r.stdout
        info = json.loads(env.command(
            ["job", "info", "1", "--output-mode", "json"]))[0]
        assert info["n_tasks"] == 100
        stats = json.loads(env.command(
            ["server", "stats", "--output-mode", "json"]))
        assert stats["ingest"]["chunks_total"] >= 4
