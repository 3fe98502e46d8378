"""A run of one cell: set-up, the window, the reference check, the result.

`run_cell` returns the result line's object and the numbers compared; the
command line (hqbench/run.py) prints them. Metrics are read by the readers
under hqbench/metrics/, one file per metric, found by the metric's name.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time

from hqbench.harness import cell as cell_mod
from hqbench.harness.trace import (
    K1Events,
    Profiled,
    busy_and_breakdown,
    clock_offset_s,
)

# top-level module names that may not be loaded in the run's process
BARRED = ("jax", "jaxlib", "flax", "hyperqueue_tpu")


def barred_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(BARRED))


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc has no answer)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def chunk_rates(cell, chunk_s=5.0) -> list:
    """Tasks started a second in each `chunk_s` of the window, from the end
    of the last tick before each edge to the end of the last before the
    next (ticks whose answers were read)."""
    t0, t1 = cell.window
    points = [(t0, cell.window_started0)] + [
        (r.t1, r.started) for r in cell.window_ticks]
    marks, i = [], 0
    for k in range(1, int((t1 - t0) // chunk_s) + 1):
        edge = t0 + k * chunk_s
        while i + 1 < len(points) and points[i + 1][0] <= edge:
            i += 1
        marks.append(points[i])
    marks = [points[0]] + marks
    return [(n1 - n0) / (b - a) for (a, n0), (b, n1)
            in zip(marks, marks[1:]) if b > a]


class RunView:
    """What a metric reader reads."""

    def __init__(self, cell, setup_s, trace):
        self.cell = cell
        self.setup_s = setup_s
        self.window = cell.window
        self.ticks = cell.window_ticks
        self.trace = trace  # dict or None
        self.traffic = cell.traffic

    @property
    def window_s(self):
        return self.window[1] - self.window[0]


def read_metrics(names, units, view):
    out = {}
    for name in names:
        reader = importlib.import_module(f"hqbench.metrics.{name}")
        value = reader.read(view)
        if value is None:
            continue
        out[name] = {"value": float(value), "unit": units[name]}
    return out


def end_state(core, jobs) -> dict:
    return {
        "ready": core.queues.total_ready(),
        "finished": sum(j.counters["finished"] for j in jobs.jobs.values()),
        "workers": {wid: {"free": list(w.free), "nt": w.nt_free,
                          "assigned": set(w.assigned_tasks),
                          "prefilled": set(w.prefilled_tasks)}
                    for wid, w in core.workers.items()},
    }


def metrics_of(bench, workload, trace):
    """(names, units) of the metrics a run of this cell reports."""
    kind = "per_layer" if trace else "end_to_end"
    names, units = [], {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        names.append(m["name"])
        units[m["name"]] = m["unit"]
    return names, units


def run_cell(workload, seed, seconds, trace, device="cuda", model_hook=None,
             t_process=None, bench=None):
    """One run. Returns (result dict, checks dict)."""
    # the process's start on the perf_counter clock
    t_start = (time.perf_counter() - process_age_s() if t_process is None
               else t_process)
    bench = bench or cell_mod.load_bench()
    w = cell_mod.find_workload(bench, workload)
    config = cell_mod.load_config(w["config"])
    mix = cell_mod.load_mix(w["traffic"])
    cuda = device == "cuda"
    if cuda:
        import torch

        torch.cuda.reset_peak_memory_stats()
    cell = cell_mod.Cell(config, mix, seed, device=device,
                         model_hook=model_hook)
    t_setup = time.perf_counter()
    cell.setup()
    events = K1Events(cell.base_model) if (trace and cuda) else None
    t_warm = time.perf_counter()
    cell.warm_up()
    prof = None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    setup_parts = {"start_s": t_setup - t_start, "build_s": t_warm - t_setup,
                   "warm_up_s": t_window - t_warm,
                   "warm_up_ticks": len(cell.ticks)}
    try:
        if trace and cuda:
            prof = Profiled()
            cell.spans = prof.span
            events.recording = True
            # the pads keep the server's loop running, so that the
            # window starts in the loop's steady state
            with prof.window(lambda s: cell.run_until(time.perf_counter()
                                                      + s)):
                cell.measure(seconds)
            events.recording = False
            cell.spans = None
        else:
            cell.measure(seconds)
    finally:
        cell.close()
    rates = chunk_rates(cell)
    peak = 0
    kind = device
    if cuda:
        import torch

        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    trace_info = breakdown = None
    if trace:
        trace_info, breakdown = trace_summary(cell.window, events, prof)
        trace_info["n_resources"] = len(cell.plain.resources)
    view = RunView(cell, setup_s, trace_info)
    names, units = metrics_of(bench, workload, trace)
    metrics = read_metrics(names, units, view)
    attempted, failed = cell.traffic.attempts(cell)
    # the program's state, read once; then freed before the reference runs
    end = end_state(cell.core, cell.jobs)
    launches, solves = cell.launches, cell.solves
    loop_kind = cell.traffic.kind
    submits = sum(1 for e in cell.log if e[0] == "submit")
    plain, log = cell.plain, cell.log
    del view, cell
    gc.collect()
    from hqbench.reference.check import replay

    t_ref = time.perf_counter()
    checks = replay(plain, log, end)
    ref_s = time.perf_counter() - t_ref
    numbers = {k: checks[k] for k in ("counts_off", "map_off", "prefill_off",
                                      "retract_off", "out_of_turn", "state_off")}
    if cuda:
        numbers["k1_launch_gap"] = abs(launches - solves)
    compared = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    device_info = {"platform": "gpu" if cuda else device, "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    if trace and trace_info is not None and trace_info["busy_s"] is not None:
        device_info["busy_s"] = trace_info["busy_s"]
        device_info["window_s"] = trace_info["window_s"]
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    info = {"ticks_checked": checks["ticks"], "reference_s": ref_s,
            "k1_launches": launches, "solves": solves, "loop": loop_kind,
            "submits": submits, **setup_parts, "chunk_rates": rates}
    if trace_info is not None:
        info["busy_source"] = trace_info["busy_source"]
    return result, info


def trace_summary(window, events, prof):
    """(trace info, breakdown) of a traced window: K1's launches in it with
    their device ms (the profiler's, where its trace holds every launch,
    else the CUDA events'), the device's busy seconds (the union of the
    profiler's device intervals cut to the window, else K1's time), the
    window's seconds, and the profiler's top device ops and idle gaps."""
    w0, w1 = window
    info = {"k1": [], "busy_s": None, "window_s": w1 - w0,
            "busy_source": None}
    breakdown = None
    busy = 0.0
    # K1's launches: (shape, device ms, host launch s)
    k1_runs = []
    if events is not None:
        k1_runs = [(s[:4], t, s[6])
                   for s, t in zip(events.launches, events.times_ms())]
    if prof is not None:
        intervals = prof.device_intervals()
        offset = clock_offset_s(intervals, [h for _s, _t, h in k1_runs])
        ops, gaps = [], []
        if offset is not None:
            k1 = sorted((s, e) for n, s, e in intervals if "cut_scan" in n)
            k1_runs = [(shape, (e - s) * 1e-3, h)
                       for (shape, _t, h), (s, e) in zip(k1_runs, k1)]
            lo, hi = (w0 + offset) * 1e6, (w1 + offset) * 1e6
            cut = [(n, max(s, lo), min(e, hi)) for n, s, e in intervals
                   if e > lo and s < hi]
            busy, ops, gaps = busy_and_breakdown(cut, prof.spans, offset)
            info["busy_source"] = "profiler"
        breakdown = {"device_ops": ops, "idle_gaps": gaps}
    info["k1"] = [(shape, t) for shape, t, h in k1_runs if w0 <= h < w1]
    if info["busy_source"] is None or busy <= 0:
        # the profiler's trace lost a launch: K1's events stand in
        busy = sum(t for _s, t in info["k1"]) * 1e-3
        info["busy_source"] = "k1_events"
    info["busy_s"] = busy if busy > 0 else None
    return info, breakdown
