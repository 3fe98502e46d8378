"""The traced run's instruments, all from the benchmark's side.

- K1's launches: CUDA events around each launch of the cut-scan kernel
  (the model's `_kernel_dispatch`, wrapped on the instance), with the live
  extents of its solve, for `k1_roofline`.
- The device's busy time: `torch.profiler`, device activity only, from
  2 s before the window to 0.5 s after it, the server's loop running
  throughout (the profiler's device clock drifts from the host's and
  drops kernels it places outside its window; the margins keep them in;
  its start stalls the host, and the 2 s let the loop settle before the
  window), then cut to the window. Where the profiler
  holds fewer cut-scan kernels than were launched, its window is not
  whole: busy time then falls back to the events' K1 time, and the run
  says so.
- Host spans (`hq.schedule`, `hq.workers`, `hq.wait`) on the host's clock,
  which name what the host was doing in each idle gap; the profiler's
  clock is mapped onto the host's by the launches: the least distance
  from a K1 launch on the host to its kernel's start.
"""

from __future__ import annotations

import contextlib
import time

PAD_S = 0.5
PRE_PAD_S = 2.0


class K1Events:
    """CUDA events around each K1 launch of one model instance."""

    def __init__(self, model):
        import torch

        self.torch = torch
        # (n_b, n_v, n_w, n_m, start event, end event, host launch s)
        self.launches = []
        self.recording = False
        self._prep = None
        solve = model._device_solve
        dispatch = model._kernel_dispatch

        def device_solve(prep):
            self._prep = prep
            return solve(prep)

        def kernel_dispatch(*args, **kwargs):
            if not self.recording:
                return dispatch(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()
            out = dispatch(*args, **kwargs)
            e1.record()
            prep = self._prep
            n_b, n_v, n_w = prep["extents"]
            self.launches.append((n_b, n_v, n_w, prep["class_m"].shape[0],
                                  e0, e1, t))
            return out

        model._device_solve = device_solve
        model._kernel_dispatch = kernel_dispatch

    def times_ms(self):
        self.torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for *_s, e0, e1, _t in self.launches]


class Profiled:
    """torch.profiler's device activity over the window, and the host's
    spans inside it."""

    def __init__(self):
        import torch

        self.torch = torch
        self.prof = None
        self.spans = []  # (name, start s, end s) on perf_counter

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def window(self, pad):
        """The profiler around the window, `pad(seconds)` on each side:
        PRE_PAD_S before (the profiler's start stalls the host), PAD_S
        after."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pad(PRE_PAD_S)
            yield self
            torch.cuda.synchronize()
            pad(PAD_S)
            torch.cuda.synchronize()
        self.prof = prof

    def device_intervals(self):
        """[(name, start us, end us)] of every device op in the trace, on
        the profiler's clock."""
        out = []
        for ev in self.prof.events():
            dev = getattr(ev, "device_type", None)
            if dev is None or "CUDA" not in str(dev):
                continue
            tr = ev.time_range
            out.append((ev.name, float(tr.start), float(tr.end)))
        return out


def clock_offset_s(intervals, launch_times):
    """Profiler seconds minus host seconds: the least distance from each K1
    launch on the host (perf_counter s) to the start of its kernel, the
    kernels taken in order."""
    starts = sorted(s for n, s, _e in intervals if "cut_scan" in n)
    if not starts or len(starts) != len(launch_times):
        return None
    return min(s * 1e-6 - t for s, t in zip(starts, launch_times))


def busy_and_breakdown(intervals, spans, offset, top=10):
    """(busy seconds, device_ops, idle_gaps) from device intervals (us, on
    the profiler's clock), host spans (s, on the host's) and the offset
    between the clocks (s; None labels every gap "host"); busy is the
    union of the intervals."""
    if not intervals:
        return 0.0, [], []
    by_name = {}
    for name, s, e in intervals:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    merged = []
    for _n, s, e in sorted(intervals, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = []
    spans = sorted(spans, key=lambda x: x[1])
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        label = "host"
        if offset is not None:
            mid = 0.5 * (e0 + s1) * 1e-6 - offset
            for name, a, b in spans:
                if a <= mid <= b:
                    label = name
                    break
                if a > mid:
                    break
        gaps.append((label, (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, [[n, v] for n, v in ops], [[n, v] for n, v in gaps[:top]]
