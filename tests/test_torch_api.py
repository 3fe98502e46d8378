"""The port's Python API (`hyperqueue_tpu_torch.api`) against the JAX
package's own API tests, on the CPU: every scenario of tests/test_pyapi.py
and tests/test_stream_api.py runs unchanged with the port in place of the
JAX package (test_torch_cli_e2e.run_scenario: the scenarios' in-body
`from hyperqueue_tpu.api import ...` read the port's `api`, and their
`env` is a PortCliEnv). `LocalCluster` starts `python -m
hyperqueue_tpu_torch`; `HQ_LOCAL_CLUSTER_DEVICE=cpu` asks its server for
the CPU (`--scheduler cpu`), as the JAX package's
`HQ_LOCAL_CLUSTER_JAX_PLATFORM` asks for a platform.
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest
import torch

import test_pyapi as jax_pyapi
import test_stream_api as jax_stream_api
from test_torch_cli_e2e import run_scenario, scenarios

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

REPO_ROOT = str(Path(__file__).resolve().parent.parent)


@pytest.fixture
def on_cpu(monkeypatch):
    """LocalCluster's server on the CPU, with one OpenMP thread."""
    monkeypatch.setenv("HQ_LOCAL_CLUSTER_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(
        "PYTHONPATH", REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                               ""))


@pytest.fixture
def cluster(tmp_path, monkeypatch, on_cpu):
    """tests/test_pyapi.py's fixture over the port's LocalCluster."""
    from hyperqueue_tpu_torch.api import LocalCluster

    monkeypatch.chdir(tmp_path)
    with LocalCluster(n_workers=1, cpus_per_worker=4,
                      server_dir=str(tmp_path / "cluster")) as lc:
        yield lc


@pytest.mark.parametrize("scenario", scenarios(jax_pyapi))
def test_pyapi_scenario_on_the_port(scenario, cluster, tmp_path,
                                    monkeypatch):
    run_scenario(jax_pyapi, scenario, tmp_path, monkeypatch,
                 cluster=cluster)


@pytest.mark.parametrize("scenario", scenarios(jax_stream_api))
def test_stream_api_scenario_on_the_port(scenario, tmp_path, monkeypatch,
                                         on_cpu):
    run_scenario(jax_stream_api, scenario, tmp_path, monkeypatch)


def test_local_cluster_runs_the_port(tmp_path, monkeypatch, on_cpu):
    """LocalCluster's processes are `python -m hyperqueue_tpu_torch`, and
    HQ_LOCAL_CLUSTER_DEVICE=cpu starts its server with `--scheduler cpu`
    (without it the server solves on the card)."""
    from hyperqueue_tpu_torch.api import LocalCluster

    monkeypatch.chdir(tmp_path)
    with LocalCluster(n_workers=1, cpus_per_worker=1,
                      server_dir=str(tmp_path / "c1")) as lc:
        argvs = [p.args for p in lc._procs]
        assert all(a[1:3] == ["-m", "hyperqueue_tpu_torch"] for a in argvs)
        assert argvs[0][-2:] == ["--scheduler", "cpu"]
        assert "--scheduler" not in argvs[1]
        with lc.client() as client:
            assert client._session.request(
                {"op": "server_info"})["scheduler"] == "cpu"
