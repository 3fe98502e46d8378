"""The JAX package's fleet observability tests (tests/test_fleet.py), run
against the port on the CPU, and the port's fan-in held against the JAX
package's.

Every case of tests/test_fleet.py runs with the port swapped in
(`test_torch_cli_e2e.run_scenario`); its failover scenario starts the
port's shards, standby and worker as `python -m hyperqueue_tpu_torch`
processes with `--scheduler cpu`. The cross-package cases feed seeded
inputs through both packages' pure merge functions (`_merge_responses`
of the federated session and `_compose_exposition` of the metrics proxy)
and require equal outputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import test_fleet as jax_fleet
from test_torch_cli_e2e import run_scenario, scenarios

from hyperqueue_tpu.client import connection as jax_connection
from hyperqueue_tpu.client import fleet as jax_fleet_mod
from hyperqueue_tpu_torch.client import connection as port_connection
from hyperqueue_tpu_torch.client import fleet as port_fleet_mod

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.federation


@pytest.mark.parametrize("scenario", scenarios(jax_fleet))
def test_fleet_case_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_fleet, scenario, tmp_path, monkeypatch)


def _random_response(rng: np.random.Generator, shard: int) -> dict:
    """One shard's answer to a fan-out op: lists, counters, flags,
    nested records and strings, some keys only on some shards."""
    resp = {"op": "job_list"}
    if rng.random() < 0.9:
        resp["jobs"] = [{"id": int(rng.integers(1, 99)), "shard": shard}
                        for _ in range(int(rng.integers(0, 4)))]
    if rng.random() < 0.7:
        resp["n_total"] = int(rng.integers(0, 1000))
    if rng.random() < 0.5:
        resp["rate"] = float(np.round(rng.random() * 10, 3))
    if rng.random() < 0.5:
        resp["paused"] = bool(rng.random() < 0.5)
    if rng.random() < 0.3:
        resp["server"] = {"shard": shard}
    if rng.random() < 0.3:
        resp[f"only_{shard}"] = "x"
    return resp


@pytest.mark.parametrize("seed", range(6))
def test_merge_responses_agrees_with_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        responses = [_random_response(rng, k)
                     for k in range(int(rng.integers(1, 5)))]
        expected = jax_connection._merge_responses(
            [dict(r) for r in responses])
        got = port_connection._merge_responses([dict(r) for r in responses])
        assert got == expected
        assert type(got.get("n_total")) is type(expected.get("n_total"))


def _random_exposition(rng: np.random.Generator) -> str:
    lines = []
    for name, kind in (("hq_tasks_total", "counter"),
                       ("hq_workers", "gauge"),
                       ("hq_federation_shard_up", "gauge")):
        if rng.random() < 0.2:
            continue
        lines.append(f"# HELP {name} a metric")
        lines.append(f"# TYPE {name} {kind}")
        for label in rng.choice(["a", "b", "c"],
                                size=int(rng.integers(1, 3)),
                                replace=False):
            lines.append(f'{name}{{queue="{label}"}} '
                         f"{int(rng.integers(0, 500))}")
    return "\n".join(lines) + ("\n" if lines else "")


@pytest.mark.parametrize("seed", range(4))
def test_compose_exposition_agrees_with_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 5))
        up = {k: int(rng.random() < 0.8) for k in range(n)}
        texts = {str(k): _random_exposition(rng)
                 for k in range(n) if up[k]}
        expected = jax_fleet_mod._compose_exposition(texts, up)
        got = port_fleet_mod._compose_exposition(texts, up)
        assert got == expected
        assert got.count("hq_federation_shard_up{") == n
