"""tests/test_autoalloc.py against the port's `autoalloc/`, on the CPU.

The e2e cases run unchanged against the port's server, worker and
command line (`test_torch_cli_e2e.run_scenario`, with the stub `sbatch`,
`sacct` and `scancel` the JAX module puts on PATH). The unit cases run
the JAX module's own functions with every `hyperqueue_tpu` module they
reach read as the port's, and the module's `_StubServer` replaced by
`PortStubServer`: the port's Core and the server's model shape, a
`SolverWatchdog` over `GreedyCutScanModel(device="cpu")`, so each demand
query solves through `solve_query` and K1's plain version at its
`alloc_query` site.

Every `test_query_*` and `test_*_demand_*` case also runs once on the JAX
package and once on the port, and every `WorkerQueryResponse` (and every
multi-node demand split) the two compute must be equal.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import sys
from pathlib import Path

import pytest
import torch

import test_autoalloc
from test_torch_cli_e2e import _port_name, run_scenario, use_port

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ENV_CASES = [
    "test_autoalloc_submits_on_demand",
    "test_autoalloc_backoff_pauses_queue",
    "test_alloc_dry_run",
    "test_autoalloc_worker_links_to_allocation",
    "test_autoalloc_mn_gang_triggers_submit",
    "test_alloc_log_e2e",
]

UNIT_CASES = [
    "test_slurm_script_and_parse",
    "test_pbs_script_and_parse",
    "test_queue_backoff_pauses",
    "test_script_worker_hooks_wrap_and_limits",
]

# the cases that plan demand: twinned, and held equal to the JAX package
DEMAND_CASES = [
    "test_demand_uses_queue_declared_resources",
    "test_demand_counts_all_policy_tasks",
    "test_mn_demand_counts_unhostable_gangs",
    "test_mn_demand_respects_time_limit",
    "test_queued_allocations_absorb_demand",
    "test_mn_demand_skips_resource_impossible_gangs",
    "test_mn_demand_dedups_gang_across_queues",
    "test_query_enough_workers",
    "test_query_not_enough_workers",
    "test_query_busy_worker_no_ready",
    "test_query_busy_worker_with_ready",
    "test_query_many_workers_needed",
    "test_query_no_tasks",
    "test_query_min_utilization1",
    "test_query_min_utilization2",
    "test_real_mu_worker_does_not_absorb_demand",
    "test_query_min_utilization_counts_all_policy_cpu",
    "test_query_min_utilization3",
    "test_query_min_utilization_vs_partial",
    "test_query_min_utilization_vs_partial2",
    "test_query_min_time2",
    "test_query_min_time1",
    "test_query_sn_leftovers1",
    "test_query_sn_leftovers2",
    "test_query_sn_leftovers3",
    "test_query_partial_query_cpus",
    "test_query_partial_query_gpus1",
    "test_query_padding_covers_only_known_resources",
    "test_query_partial_oversized_request",
    "test_query_partial_demand_above_task_cap",
    "test_query_after_task_cancel",
]


def jax_cases(module) -> set[str]:
    return {n for n, f in vars(module).items()
            if n.startswith("test_") and inspect.isfunction(f)
            and f.__module__ == module.__name__}


def test_every_case_is_twinned():
    assert jax_cases(test_autoalloc) == set(
        ENV_CASES + UNIT_CASES + DEMAND_CASES)


class PortStubServer:
    """The JAX module's `_StubServer` on the port: a Core, the model a
    port server solves with (on the CPU) and a server directory."""

    def __init__(self):
        from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
        from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
        from hyperqueue_tpu_torch.server.core import Core

        self.core = Core()
        # no deadline: the solves run inline, with no solve thread to stop
        self.model = SolverWatchdog(GreedyCutScanModel(device="cpu"),
                                    timeout_s=0)
        self.server_dir = Path("/tmp/stub")


def _module_imports(module) -> set[str]:
    """The `hyperqueue_tpu` modules imported anywhere in `module`."""
    tree = ast.parse(inspect.getsource(module))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "hyperqueue_tpu":
            found.add(node.module)
        elif isinstance(node, ast.Import):
            found.update(a.name for a in node.names
                         if a.name.split(".")[0] == "hyperqueue_tpu")
    return found


def use_port_module(module, fn, monkeypatch) -> None:
    """`use_port` for unit cases: the modules the helpers import in their
    bodies resolve to the port's too, and a `_StubServer` becomes
    PortStubServer."""
    use_port(module, fn, monkeypatch)
    for name in _module_imports(module):
        monkeypatch.setitem(sys.modules, name,
                            importlib.import_module(_port_name(name)))
    if hasattr(module, "_StubServer"):
        monkeypatch.setattr(module, "_StubServer", PortStubServer)


def call_case(fn, tmp_path, monkeypatch) -> None:
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{name: given[name] for name in inspect.signature(fn).parameters})


def record_demand(pkg: str, monkeypatch) -> list:
    """Records, in order, every WorkerQueryResponse the package's
    autoalloc computes (as a dict) and every multi-node demand split (per
    queue, in the queues' order)."""
    query = importlib.import_module(f"{pkg}.autoalloc.query")
    service = importlib.import_module(f"{pkg}.autoalloc.service")
    calls: list = []
    compute = query.compute_new_worker_query
    mn_joint = service.AutoAllocService._mn_demand_joint

    def recording_query(core, model, queries):
        response = compute(core, model, queries)
        calls.append(("query", dataclasses.asdict(response)))
        return response

    def recording_mn(self, queues):
        out = mn_joint(self, queues)
        calls.append(("mn", [out[q.queue_id] for q in queues]))
        return out

    monkeypatch.setattr(query, "compute_new_worker_query", recording_query)
    monkeypatch.setattr(service, "compute_new_worker_query", recording_query)
    monkeypatch.setattr(service.AutoAllocService, "_mn_demand_joint",
                        recording_mn)
    return calls


@pytest.mark.parametrize("case", ENV_CASES)
def test_autoalloc_e2e_on_the_port(case, tmp_path, monkeypatch):
    run_scenario(test_autoalloc, getattr(test_autoalloc, case), tmp_path,
                 monkeypatch)


@pytest.mark.parametrize("case", UNIT_CASES)
def test_autoalloc_unit_on_the_port(case, tmp_path, monkeypatch):
    fn = getattr(test_autoalloc, case)
    use_port_module(test_autoalloc, fn, monkeypatch)
    call_case(fn, tmp_path, monkeypatch)


@pytest.mark.parametrize("case", DEMAND_CASES)
def test_demand_equals_the_jax_package(case, tmp_path, monkeypatch):
    """The case passes on both packages, over Cores built by the same
    code, and the port's demand answers equal the JAX package's."""
    fn = getattr(test_autoalloc, case)
    jax_calls = record_demand("hyperqueue_tpu", monkeypatch)
    (tmp_path / "jax").mkdir()
    call_case(fn, tmp_path / "jax", monkeypatch)
    port_calls = record_demand("hyperqueue_tpu_torch", monkeypatch)
    use_port_module(test_autoalloc, fn, monkeypatch)
    (tmp_path / "port").mkdir()
    call_case(fn, tmp_path / "port", monkeypatch)
    assert jax_calls, "the case planned no demand"
    assert port_calls == jax_calls
