"""Each cell's code at a tiny size on the CPU: the traffic mix drives the
port's `reactor.schedule` (K1's plain version in place of the kernel), the
reference replays the run and finds every tick as it should be, and every
metric the cell names reads a number. With a fault planted under the
solve, or the control's broken priority order, `correct` comes out
false."""

import json
import math

import pytest

from hqbench import control
from hqbench.harness import cell as cell_mod
from hqbench.harness.main import metrics_of, run_cell

BENCH = cell_mod.load_bench()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
# workers, backlog tasks at the tests' size
SMALL = (24, 30000)


@pytest.fixture
def small(monkeypatch):
    load_config, load_mix = cell_mod.load_config, cell_mod.load_mix

    def config(name):
        c = load_config(name)
        c["workers"]["count"] = SMALL[0]
        return c

    def mix(name):
        m = load_mix(name)
        m["backlog"]["tasks"] = SMALL[1]
        return m

    monkeypatch.setattr(cell_mod, "load_config", config)
    monkeypatch.setattr(cell_mod, "load_mix", mix)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "layers"])
def test_cell_runs_correct_and_reads_its_metrics(small, workload, trace):
    result, info = run_cell(workload, 2**31 + 7, 1.0, trace, device="cpu",
                            bench=BENCH)
    assert result["correct"], result["checks"]
    assert info["ticks_checked"] >= 2
    names, units = metrics_of(BENCH, workload, trace)
    got = result["metrics"]
    if not trace:
        assert set(got) == set(names)
        for v in got.values():
            assert v["value"] > 0 and math.isfinite(v["value"])
    else:
        # the device's readers find nothing on the CPU
        assert set(names) - set(got) <= {"k1_roofline", "device_idle_share"}
    for name, v in got.items():
        assert v["unit"] == units[name]
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_not_correct(small, workload, fault):
    result, _info = run_cell(workload, 5, 1.0, False, device="cpu",
                             model_hook=control._wrap(fault), bench=BENCH)
    assert not result["correct"], (fault, result["checks"])


MIXED = {
    "resources": ["cpus", "gpus"],
    "workers": {"count": 12, "shape_seed": 1,
                "choices": {"cpus": [4, 8, 16], "gpus": [0, 2]},
                "task_slots_cap": 512},
    "requests": {"classes": [[{"cpus": 1}], [{"cpus": 2, "gpus": 1}],
                             [{"cpus": 4}, {"cpus": 2, "gpus": 1}]]},
}
MIXED_MIX = {"loop": "closed", "duration_s": 0.01, "warmup_ticks": 2,
             "backlog": {"tasks": 4000, "jobs": 2, "user_priorities": 3,
                         "shape_seed": 2}}


def test_same_seed_same_inputs():
    from hqbench.harness.plain import make_plain

    pa, pb, pc = (make_plain(MIXED, MIXED_MIX, s) for s in (3, 3, 4))
    assert pa.workers == pb.workers
    assert all((g1[3] == g2[3]).all() for g1, g2 in zip(pa.backlog,
                                                         pb.backlog))
    # another seed permutes the same shapes
    assert pa.workers != pc.workers
    assert sorted(x[1] for x in pa.workers) == sorted(x[1]
                                                      for x in pc.workers)
    # the same tasks of each class and priority, over the jobs
    def totals(plain):
        out = {}
        for _job, cls, prio, ids in plain.backlog:
            out[cls, prio] = out.get((cls, prio), 0) + len(ids)
        return out

    assert totals(pa) == totals(pc)


@pytest.mark.parametrize("fault", ("none",) + control.FAULTS)
def test_mixed_classes_and_priorities(monkeypatch, fault):
    """Several classes, variants, priorities and jobs on workers of several
    sizes: the reference follows the program, and each fault is found."""
    monkeypatch.setattr(cell_mod, "load_config", lambda n: dict(MIXED))
    monkeypatch.setattr(cell_mod, "load_mix", lambda n: dict(MIXED_MIX))
    hook = None if fault == "none" else control._wrap(fault)
    result, info = run_cell(WORKLOADS[0], 11, 0.5, False, device="cpu",
                            model_hook=hook, bench=BENCH)
    assert result["correct"] == (fault == "none"), result["checks"]
    if fault == "none":
        assert info["ticks_checked"] >= 3


def test_resubmits_when_the_array_is_done():
    """A resubmitted array: every task of the first job finishes, the next
    job comes through the server's submit path, and the reference follows
    the run across the jobs."""
    import time

    from hqbench.harness.main import end_state
    from hqbench.reference.check import replay

    config = cell_mod.load_config("pto_w16")
    config["workers"]["count"] = 4
    mix = cell_mod.load_mix("array_sleep0")
    mix["backlog"]["tasks"] = 3000
    cell = cell_mod.Cell(config, mix, 5, device="cpu")
    cell.setup()
    try:
        cell.warm_up()
        cell.run_until(time.perf_counter() + 60.0,
                       lambda: cell.traffic.workers.finished >= 7000)
    finally:
        cell.close()
    submits = [e for e in cell.log if e[0] == "submit"]
    assert len(submits) >= 2 and all(e[4] == 3000 for e in submits)
    end = end_state(cell.core, cell.jobs)
    out = replay(cell.plain, cell.log, end)
    assert out.pop("ticks") >= 3
    assert set(out.values()) == {0}, out
