"""The reference on the port's retracts (rebalance and displacement), and
its answer to a run whose log was altered: each difference is counted."""

import time

import pytest

from hqbench.harness import cell as cell_mod
from hqbench.harness.main import end_state
from hqbench.reference.check import replay
from hqbench.reference.cut_scan import cut_scan


def _retracts(cell):
    return [(i, w, r) for i, e in enumerate(cell.log) if e[0] == "tick"
            for w, r in e[2]]


def _quiet_cell(workers, tasks):
    """A cell on `workers` 4-cpu workers whose tasks never finish by
    themselves: the test finishes them."""
    config = cell_mod.load_config("pto_w16")
    config["workers"]["count"] = workers
    mix = cell_mod.load_mix("array_sleep0")
    mix["resubmit"] = False
    mix["duration_s"] = 1e6
    if tasks:
        mix["backlog"]["tasks"] = tasks
    else:
        mix["backlog"] = None
    return cell_mod.Cell(config, mix, 3, device="cpu")


def rebalance_run():
    """Four 4-cpu workers, 60 tasks, two of the workers finishing what they
    run after each tick: backlogs drain unevenly and the idle workers take
    retracted tasks."""
    cell = _quiet_cell(4, 60)
    cell.setup()
    cell.last_tick_end = time.perf_counter()
    w = cell.traffic.workers
    for _ in range(12):
        cell.tick()
        w.start_backlog(w.finish([tid for wid in (1, 2)
                                  for tid in list(w.running[wid])]))
    cell.close()
    return cell


def displacement_run():
    """Every backlog full of user priority 0, then a job of priority 5
    whose tasks find no budget left: lower backlog goes back."""
    cell = _quiet_cell(4, 0)
    cell.setup()
    cell.last_tick_end = time.perf_counter()
    cell.submit_array(0, 0, 4 * 512 + 40)
    cell.tick()
    cell.submit_array(0, 5, 30)
    for _ in range(3):
        cell.tick()
    cell.close()
    return cell


@pytest.mark.parametrize("make", [rebalance_run, displacement_run],
                         ids=["rebalance", "displacement"])
def test_retracts_agree_and_an_altered_one_is_counted(make):
    cell = make()
    got = _retracts(cell)
    assert got, "the scenario sent no retract"
    end = end_state(cell.core, cell.jobs)
    assert replay(cell.plain, cell.log, end) == dict(
        counts_off=0, map_off=0, prefill_off=0, retract_off=0, out_of_turn=0,
        state_off=0, ticks=sum(1 for e in cell.log if e[0] == "tick"))
    log = list(cell.log)
    i, wid, refs = got[0]
    tid, inst = refs[0]
    # the retract names the task's instance wrongly
    kind, sent, retracts = log[i]
    log[i] = (kind, sent, tuple(
        (w, ((tid, inst + 1),) + r[1:]) if w == wid else (w, r)
        for w, r in retracts))
    assert replay(cell.plain, log, end)["retract_off"] > 0


def test_altered_message_is_counted():
    cell = rebalance_run()
    end = end_state(cell.core, cell.jobs)
    log = list(cell.log)
    for i, e in enumerate(log):
        if e[0] == "tick" and e[1]:
            (wid, rows), *rest = e[1]
            tid, inst, variant, flag = rows[0]
            log[i] = (e[0], [(wid, ((tid, inst, variant + 1, flag),)
                              + rows[1:])] + rest, e[2])
            break
    out = replay(cell.plain, log, end)
    assert out["map_off"] + out["prefill_off"] > 0


def test_cut_scan_by_hand():
    import numpy as np

    # two workers of 4 cpus, the second with a gpu; batch 0 asks 1 cpu x 5,
    # batch 1 asks 1 cpu + 1 gpu x 2: batch 0 fills the worker without
    # the gpu first (less waste), then the other; batch 1 finds one cpu
    free = np.array([[4, 0], [4, 1]])
    nt = np.array([8, 8])
    needs = np.array([[[1, 0]], [[1, 1]]])
    counts = cut_scan(free, nt, needs, np.array([5, 2]))
    assert counts[:, 0, :].tolist() == [[4, 1], [0, 1]]
