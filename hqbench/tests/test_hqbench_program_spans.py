"""The readers of the program's own spans on hand-worked ticks, and on a
small cell run on the CPU under a CPU torch profiler, which turns the
program's timeline on as the traced run's profiler does on the card."""

import importlib
from types import SimpleNamespace

import pytest

from hqbench.harness import cell as cell_mod
from hqbench.harness.cell import TickRecord
from hqbench.harness.main import metrics_of, run_cell

NEW = ("answers_ms", "prefill_fill_ms", "prefill_retract_ms", "gc_full_ms",
       "gc_share", "untraced_share")


def tick(t0, t1, **phases):
    return TickRecord(t0, t1, phases, 0.0, 0, "solve_dispatch" in phases)


def view(ticks, window=(10.0, 12.0)):
    return SimpleNamespace(ticks=ticks, window=window,
                           window_s=window[1] - window[0], trace=None)


def read(name, v):
    return importlib.import_module(f"hqbench.metrics.{name}").read(v)


def since(answers=None, n=0, gc_tick=0.0, gc_answers=0.0, gc_other=0.0,
          gen_ms=(0.0, 0.0, 0.0), gen_n=(0, 0, 0)):
    ms = {"gc_tick": gc_tick, "gc_answers": gc_answers, "gc_other": gc_other,
          "gc_gen0": gen_ms[0], "gc_gen1": gen_ms[1], "gc_gen2": gen_ms[2]}
    count = {"gc_gen0": gen_n[0], "gc_gen1": gen_n[1], "gc_gen2": gen_n[2]}
    if answers is not None:
        ms["answers"] = answers
        count["answers"] = n
    return {"since_ms": ms, "since_n": count}


def test_readers_on_hand_worked_ticks():
    # a 2 s window, two ticks of 300 and 200 ms
    ticks = [
        tick(10.0, 10.3, total=300.0, prefill=120.0, prefill_fill=90.0,
             prefill_retract=30.0,
             **since(answers=500.0, n=1000, gc_tick=10.0, gc_answers=40.0,
                     gc_other=20.0, gen_ms=(70.0, 0.0, 0.0),
                     gen_n=(4, 0, 0))),
        # no answers since the tick before: a tick with 0
        tick(11.0, 11.2, total=200.0, prefill=80.0, prefill_fill=50.0,
             prefill_retract=30.0,
             **since(gc_tick=5.0, gc_other=700.0, gen_ms=(5.0, 700.0, 0.0),
                     gen_n=(1, 1, 0))),
    ]
    v = view(ticks)
    assert read("prefill_fill_ms", v) == pytest.approx(70.0)
    assert read("prefill_retract_ms", v) == pytest.approx(30.0)
    # 500 ms of answers over two ticks
    assert read("answers_ms", v) == pytest.approx(250.0)
    # one gen-1 pass of 700 ms
    assert read("gc_full_ms", v) == pytest.approx(700.0)
    # 10 + 40 + 20 + 5 + 700 = 775 ms of 2,000
    assert read("gc_share", v) == pytest.approx(38.75)
    # traced: ticks 500 + answers 500 (their 40 ms of collection inside)
    # + collection elsewhere 720 = 1,720 ms of 2,000
    assert read("untraced_share", v) == pytest.approx(14.0)


def test_passes_over_the_older_generations_average():
    # gen-0 passes do not count; a gen-1 of 400 ms, then a gen-1 and a
    # gen-2 of 1,000 ms together
    ticks = [tick(10.0, 10.1, total=100.0,
                  **since(answers=1.0, n=2, gen_ms=(50.0, 400.0, 0.0),
                          gen_n=(9, 1, 0), gc_other=450.0)),
             tick(10.5, 10.6, total=100.0,
                  **since(answers=1.0, n=2, gen_ms=(20.0, 300.0, 700.0),
                          gen_n=(3, 1, 1), gc_tick=1020.0))]
    assert read("gc_full_ms", view(ticks)) == pytest.approx(1400.0 / 3)


def test_nothing_to_read_without_the_program_s_entries():
    """The parent's program records none of these: every reader returns
    nothing, and none raises."""
    ticks = [tick(10.0, 10.5, total=500.0, prefill=400.0)]
    for name in NEW:
        assert read(name, view(ticks)) is None, name
    # the timeline off: the collector's entries only
    ticks = [tick(10.0, 10.5, total=500.0, prefill=400.0,
                  prefill_fill=300.0, prefill_retract=100.0,
                  **since(gc_other=5.0))]
    v = view(ticks)
    assert read("answers_ms", v) is None
    assert read("untraced_share", v) is None
    assert read("gc_full_ms", v) is None  # no pass beyond gen 0
    assert read("gc_share", v) == pytest.approx(0.25)
    assert read("prefill_fill_ms", v) == pytest.approx(300.0)


@pytest.mark.parametrize("workload",
                         [w["name"] for w in cell_mod.load_bench()["workloads"]])
def test_a_profiled_cell_reports_the_program_s_spans(monkeypatch, workload):
    import torch

    bench = cell_mod.load_bench()
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
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        result, _info = run_cell(workload, 2**31 + 11, 1.0, True,
                                 device="cpu", bench=bench)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    names, _units = metrics_of(bench, workload, True)
    # a second's window may hold no pass beyond gen 0
    assert set(NEW) - {"gc_full_ms"} <= set(got) and set(NEW) <= set(names)
    assert got["prefill_fill_ms"] + got["prefill_retract_ms"] == \
        pytest.approx(got["prefill_ms"], rel=1e-6)
    assert 0 < got["answers_ms"] < got["harness_ms"]
    assert 0 < got["untraced_share"] < 100
    assert 0 <= got["gc_share"] < 100
