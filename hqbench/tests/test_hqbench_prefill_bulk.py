"""The reader of prefill's counts by path, on hand-worked ticks and on a
small cell run on the CPU."""

import importlib
from types import SimpleNamespace

import pytest

from hqbench.harness import cell as cell_mod
from hqbench.harness.cell import TickRecord
from hqbench.harness.main import run_cell

read = importlib.import_module("hqbench.metrics.prefill_bulk_share").read


def tick(t0, since_n=None):
    phases = {"total": 10.0}
    if since_n is not None:
        phases["since_n"] = dict(since_n, gc_gen0=0, gc_gen1=0, gc_gen2=0)
    return TickRecord(t0, t0 + 0.01, phases, 0.0, 0, False)


def view(ticks):
    return SimpleNamespace(ticks=ticks, window=(10.0, 12.0), window_s=2.0,
                           trace=None)


def test_the_window_s_bulk_over_all_it_prefilled():
    ticks = [tick(10.0, {"prefill_bulk": 8256, "prefill_each": 0}),
             tick(10.5, {"prefill_bulk": 700, "prefill_each": 44}),
             # a tick that prefilled nothing
             tick(11.0, {"prefill_bulk": 0, "prefill_each": 0})]
    assert read(view(ticks)) == pytest.approx(100.0 * 8956 / 9000)


def test_nothing_to_read_without_the_counts_or_without_prefill():
    """A program without the counts (the parent's records only the
    collector's in `since_n`) gives nothing, and raises nothing."""
    assert read(view([tick(10.0), tick(10.5)])) is None
    parent = [tick(10.0, {}), tick(10.5, {"answers": 3})]
    assert read(view(parent)) is None
    idle = [tick(10.0, {"prefill_bulk": 0, "prefill_each": 0})]
    assert read(view(idle)) is None


@pytest.mark.parametrize("workload",
                         [w["name"] for w in cell_mod.load_bench()["workloads"]])
def test_a_traced_cell_prefills_in_bulk(monkeypatch, workload):
    load_config, load_mix = cell_mod.load_config, cell_mod.load_mix

    def config(name):
        c = load_config(name)
        c["workers"]["count"] = 8
        return c

    def mix(name):
        m = load_mix(name)
        m["backlog"]["tasks"] = 8000
        return m

    monkeypatch.setattr(cell_mod, "load_config", config)
    monkeypatch.setattr(cell_mod, "load_mix", mix)
    result, _info = run_cell(workload, 2**31 + 13, 1.0, True, device="cpu",
                             bench=cell_mod.load_bench())
    assert result["correct"], result["checks"]
    share = result["metrics"]["prefill_bulk_share"]
    assert share["unit"] == "%" and share["value"] >= 99.0
