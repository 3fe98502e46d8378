"""The metric readers and K1's roofline on hand-worked inputs."""

import importlib
import math
from types import SimpleNamespace

import pytest

from hqbench.harness.cell import TickRecord, load_bench
from hqbench.roofline import k1

BENCH = load_bench()
ALL = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def tick(t0, t1, ready=0, gc_ms=0.0, harness_ms=0.0, **phases):
    rec = TickRecord(t0, t1, phases, gc_ms, ready, "solve_dispatch" in phases)
    rec.harness_ms = harness_ms
    return rec


def view(ticks, window=(10.0, 12.0), trace=None, traffic=None, **cell):
    return SimpleNamespace(
        ticks=ticks, window=window, window_s=window[1] - window[0],
        trace=trace, traffic=traffic or SimpleNamespace(),
        cell=SimpleNamespace(**cell), setup_s=41.5)


@pytest.mark.parametrize("name", ALL)
def test_every_metric_has_a_reader(name):
    mod = importlib.import_module(f"hqbench.metrics.{name}")
    assert callable(mod.read)


def test_tick_phase_readers():
    ticks = [tick(10.0, 10.5, gc_ms=4.0, harness_ms=20.0, batches=1.0,
                  assemble=2.0, solve_host_prep=0.5, solve_dispatch=1.0,
                  device_sync=0.25, mapping=3.0, prefill=400.0),
             tick(11.0, 11.5, gc_ms=0.0, harness_ms=10.0, prefill=200.0)]
    v = view(ticks, window_started=3000)
    read = {n: importlib.import_module(f"hqbench.metrics.{n}").read
            for n in ALL}
    assert read["tick_ms_mean"](v) == pytest.approx(1000.0)
    assert read["tasks_started_per_s"](v) == pytest.approx(1500.0)
    assert read["setup_s"](v) == 41.5
    assert read["prefill_ms"](v) == pytest.approx(300.0)
    assert read["tick_gc_ms"](v) == pytest.approx(2.0)
    assert read["harness_ms"](v) == pytest.approx(15.0)
    # phases of the ticks that solved only
    assert read["assemble_ms"](v) == pytest.approx(3.0)
    assert read["solve_ms"](v) == pytest.approx(1.75)
    assert read["mapping_ms"](v) == pytest.approx(3.0)
    # nothing to read: no trace
    assert read["k1_roofline"](v) is None
    assert read["device_idle_share"](v) is None


def test_trace_readers():
    # two launches of 0.5 ms at B=200, V=2, W=1024, R=3, M=4
    trace = {"k1": [((200, 2, 1024, 4), 0.5), ((200, 2, 1024, 4), 0.5)],
             "busy_s": 0.004, "window_s": 2.0, "n_resources": 3}
    v = view([], trace=trace)
    roof = importlib.import_module("hqbench.metrics.k1_roofline").read(v)
    least = k1.least_ms(200, 2, 1024, 3, 4)
    assert roof == pytest.approx(100.0 * least / 0.5)
    idle = importlib.import_module("hqbench.metrics.device_idle_share")
    assert idle.read(v) == pytest.approx(99.8)


def test_k1_counts_a_small_case_by_hand():
    # B=2, V=1, W=3, R=2, M=1
    # read: free 6 + nt 3 + life 3 + needs 4 + sizes 2 + min_time 2
    #       + order_ids 2 + class_m 3 = 25 words
    # write: counts 6 + free 6 + nt 3 = 15 words
    assert k1.bytes_moved(2, 1, 3, 2, 1) == 4 * 40
    # per batch and worker 4 R + 6 = 14 operations: 2 x 3 x 14
    assert k1.operations(2, 1, 3, 2, 1) == 84
    assert k1.least_ms(2, 1, 3, 2, 1) == pytest.approx(
        1e3 * max(160 / 3.35e12, 84 / 67e12))


def test_k1_share_never_passes_100_at_the_fastest_time():
    least = k1.least_ms(256, 2, 1024, 3, 8)
    assert least > 0 and math.isfinite(least)


def test_busy_gaps_and_the_clock_offset():
    from hqbench.harness.trace import busy_and_breakdown, clock_offset_s

    # device (us, profiler clock): two K1 kernels and a copy; host spans
    # (s, host clock) 1,000 s behind the profiler's
    intervals = [("cut_scan_kernel", 1_000_010_000.0, 1_000_010_500.0),
                 ("Memcpy DtoH", 1_000_010_400.0, 1_000_010_600.0),
                 ("cut_scan_kernel", 1_000_030_600.0, 1_000_031_000.0)]
    launches = [0.009990, 0.030580]
    offset = clock_offset_s(intervals, launches)
    assert offset == pytest.approx(1000.00002)
    spans = [("hq.schedule", 0.0095, 0.0107), ("hq.workers", 0.0107, 0.020),
             ("hq.wait", 0.020, 0.0305)]
    busy, ops, gaps = busy_and_breakdown(intervals, spans, offset)
    assert busy == pytest.approx(0.0010)
    assert ops[0][0] == "cut_scan_kernel"
    assert ops[0][1] == pytest.approx(0.0009)
    # one gap, 10.6 to 30.6 ms, whose middle (20.6 ms) the wait covers
    assert len(gaps) == 1 and gaps[0][0] == "hq.wait"
    assert gaps[0][1] == pytest.approx(0.020)
    assert clock_offset_s(intervals, launches[:1]) is None


def test_trace_summary_cuts_to_the_window():
    from types import SimpleNamespace

    from hqbench.harness.main import trace_summary

    # three K1 launches on the host's clock at 1.0, 10.0 and 30.0 s, the
    # window 5-25 s; the profiler's clock 100 s ahead of the host's
    events = SimpleNamespace(
        launches=[(8, 1, 16, 2, None, None, t)
                  for t in (1.0, 10.0, 30.0)],
        times_ms=lambda: [0.5, 0.6, 0.7])
    us = 1e6
    intervals = [("cut_scan_kernel", (101.0 + 1e-5) * us, (101.0 + 5e-4) * us),
                 ("cut_scan_kernel", (110.0 + 1e-5) * us, (110.0 + 4e-4) * us),
                 ("Memcpy DtoH", (110.001) * us, (110.002) * us),
                 ("cut_scan_kernel", (130.0 + 1e-5) * us, (130.0 + 3e-4) * us)]
    prof = SimpleNamespace(device_intervals=lambda: intervals,
                           spans=[("hq.schedule", 9.9, 10.1)])
    info, breakdown = trace_summary((5.0, 25.0), events, prof)
    assert info["busy_source"] == "profiler"
    # the window's launch only, with the profiler's time for it
    assert [s for s, _t in info["k1"]] == [(8, 1, 16, 2)]
    assert info["k1"][0][1] == pytest.approx(0.39, abs=1e-6)
    assert info["busy_s"] == pytest.approx(0.00039 + 0.001, abs=1e-9)
    assert info["window_s"] == 20.0
    assert breakdown["device_ops"][0][0] == "Memcpy DtoH"
    # a lost launch: the events stand in, for the window's launch
    info, _b = trace_summary((5.0, 25.0), events, SimpleNamespace(
        device_intervals=lambda: intervals[1:], spans=[]))
    assert info["busy_source"] == "k1_events"
    assert info["busy_s"] == pytest.approx(0.0006)


def test_chunk_rates_by_hand():
    from hqbench.harness.main import chunk_rates

    ticks = []
    for t1, started in ((2.0, 100), (4.5, 300), (6.0, 400), (9.0, 700),
                        (10.5, 800)):
        rec = tick(t1 - 0.5, t1)
        rec.started = started
        ticks.append(rec)
    cell = SimpleNamespace(window=(0.0, 11.0), window_started0=0,
                           window_ticks=ticks)
    # edges at 5 and 10: the last ticks before them end at 4.5 and 9.0
    assert chunk_rates(cell) == pytest.approx([300 / 4.5, 400 / 4.5])
