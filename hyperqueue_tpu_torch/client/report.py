"""`hq journal report` — static HTML analytics from a journal file.

Reference: crates/hyperqueue/src/client/commands/journal/report.rs — traces
of running tasks and connected workers over time (global and per resource
config, report.rs running_workers/ResCount), per-request-class duration
box plots and finished/failed counts with a T1..Tn legend
(durationsChart/countsChart), queue-wait distributions per class, per-job
task-duration statistics, per-worker utilization, failure breakdowns,
allocation-queue economics, and a time window (--start-time/--end-time
offsets) — rendered as one self-contained HTML page. Charts are inline
SVG (the reference uses a plotly CDN; this environment has zero egress so
the page must carry its own pixels).

State reduction reuses the dashboard's event-sourced reducer
(client/dashboard_data.py) so the report and the TUI agree on semantics.
"""

from __future__ import annotations

import html
import statistics
import time
from collections import Counter
from pathlib import Path

from hyperqueue_tpu_torch.client.dashboard_data import DashboardData
from hyperqueue_tpu_torch.events.journal import Journal


def _fmt(ts: float) -> str:
    return (
        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)) if ts else "-"
    )


def _svg_line(series: list[tuple[float, float]], width=640, height=120,
              color="#36c") -> str:
    """Step-line SVG chart for a (t, value) series."""
    if not series:
        return "<p>(no data)</p>"
    t0, t1 = series[0][0], series[-1][0]
    span = max(t1 - t0, 1e-9)
    vmax = max((v for _, v in series), default=1.0) or 1.0
    points = []
    prev_y = None
    for t, v in series:
        x = (t - t0) / span * (width - 2) + 1
        y = height - 1 - (v / vmax) * (height - 20)
        if prev_y is not None:
            points.append(f"{x:.1f},{prev_y:.1f}")
        points.append(f"{x:.1f},{y:.1f}")
        prev_y = y
    return (
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" style="background:#f8f8f8;border:1px solid #ddd">'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
        f'points="{" ".join(points)}"/>'
        f'<text x="4" y="12" font-size="11">max {vmax:g}</text></svg>'
    )


def _request_sig(request: dict | None) -> str:
    """Human request-class key (reference report.rs resource_rq_to_string:
    durations/counts are grouped per distinct ResourceRequest T1..Tn)."""
    parts = []
    for v in (request or {}).get("variants") or [{}]:
        if v.get("n_nodes"):
            parts.append(f"nodes: {v['n_nodes']}")
            continue
        entries = v.get("entries") or []
        if not entries:
            parts.append("cpus: 1")
            continue
        parts.append(", ".join(
            f"{e['name']}: all" if e.get("policy") == "all"
            else f"{e['name']}: {int(e['amount']) / 10_000:g}"
            for e in entries
        ))
    return " | ".join(parts)


def _config_key(resources: dict) -> str:
    """One string per worker resource config — the grouping key shared by
    the running-workers sections and the utilization traces (they must
    agree or traces silently vanish from the report)."""
    return ", ".join(
        f"{name}: {units:g}" for name, units in sorted(resources.items())
    ) or "(no resources)"


def _collect(journal_path: Path, start_time: float | None,
             end_time: float | None):
    """Reduce the journal into DashboardData + report-only traces.

    start/end are OFFSETS in seconds from the first record (reference
    report.rs --start-time / --end-time)."""
    data = DashboardData()
    running_trace: list[tuple[float, float]] = []
    per_minute: Counter = Counter()
    running = 0
    first_ts = None
    # request-class machinery (reference report.rs JournalStats.durations):
    # job -> shared request sig, (job, task) -> per-task sig override
    job_sig: dict[int, str] = {}
    task_sig: dict[tuple[int, int], str] = {}
    classes: dict[str, dict] = {}  # sig -> {finished: [], failed: [], waits: []}
    task_started_at: dict[tuple[int, int], float] = {}
    job_submitted_at: dict[int, float] = {}
    # open jobs accrete tasks over multiple submits: waits are measured
    # from the task's OWN submit event, not the job's first
    task_submitted_at: dict[tuple[int, int], float] = {}

    def class_of(job_id: int, task_id: int) -> dict:
        sig = task_sig.get((job_id, task_id)) or job_sig.get(job_id, "cpus: 1")
        cls = classes.get(sig)
        if cls is None:
            cls = classes[sig] = {"finished": [], "failed": [], "waits": []}
        return cls

    # normalized per-resource utilization per worker config over time
    # (reference report.rs w_utilization traces: 1.0 = fully allocated)
    job_request: dict[int, dict] = {}
    task_request: dict[tuple[int, int], dict] = {}
    cfg_of_worker: dict[int, str] = {}
    wres_of_worker: dict[int, dict] = {}
    cfg_totals: dict[str, Counter] = {}
    cfg_alloc: dict[str, Counter] = {}
    util_traces: dict[tuple[str, str], list] = {}
    # (job, task) -> [(wid, cfg, name, units)] charges to undo on release
    task_alloc: dict[tuple[int, int], list] = {}

    def _mark_util(cfg: str, name: str, t: float) -> None:
        total = cfg_totals.get(cfg, Counter())[name]
        if total > 0:
            util_traces.setdefault((cfg, name), []).append(
                (t, cfg_alloc[cfg][name] / total)
            )

    def _chosen_variant(job_id: int, tid: int, variant: int) -> dict:
        request = task_request.get((job_id, tid)) or job_request.get(job_id)
        variants = (request or {}).get("variants") or []
        if not variants:
            return {}
        return variants[min(variant, len(variants) - 1)]

    def _charge(key, wid: int, entries: list, t: float) -> None:
        cfg = cfg_of_worker.get(wid)
        if cfg is None:
            return
        for name, units in entries:
            cfg_alloc[cfg][name] += units
            task_alloc.setdefault(key, []).append((wid, cfg, name, units))
            _mark_util(cfg, name, t)

    def _release(key, t: float, only_wid: int | None = None) -> None:
        remaining = []
        for wid, cfg, name, units in task_alloc.pop(key, ()):
            if only_wid is not None and wid != only_wid:
                remaining.append((wid, cfg, name, units))
                continue
            cfg_alloc[cfg][name] -= units
            _mark_util(cfg, name, t)
        if remaining:
            task_alloc[key] = remaining

    for rec in Journal.read_all(journal_path):
        ts = float(rec.get("time", 0.0))
        if first_ts is None:
            first_ts = ts
        offset = ts - first_ts
        if start_time is not None and offset < start_time:
            continue
        if end_time is not None and offset > end_time:
            continue
        data.add_event(rec)
        kind = rec.get("event", "")
        if kind == "job-submitted":
            job_id = rec.get("job", 0)
            job_submitted_at.setdefault(job_id, ts)
            desc = rec.get("desc") or {}
            array = desc.get("array")
            if array is not None:
                job_sig[job_id] = _request_sig(array.get("request"))
                job_request[job_id] = array.get("request") or {}
                for tid in array.get("ids") or ():
                    task_submitted_at[(job_id, tid)] = ts
            for t in desc.get("tasks") or ():
                tid = t.get("id", 0)
                task_sig[(job_id, tid)] = _request_sig(t.get("request"))
                task_request[(job_id, tid)] = t.get("request") or {}
                task_submitted_at[(job_id, tid)] = ts
        elif kind == "worker-connected":
            wid = rec.get("id", 0)
            wres = rec.get("resources") or {}
            cfg = _config_key(wres)
            cfg_of_worker[wid] = cfg
            wres_of_worker[wid] = wres
            totals = cfg_totals.setdefault(cfg, Counter())
            cfg_alloc.setdefault(cfg, Counter())
            for name, units in wres.items():
                totals[name] += units
                _mark_util(cfg, name, ts)
        elif kind == "worker-lost":
            wid = rec.get("id", 0)
            # release the lost worker's task charges FIRST, then shrink
            # the pool — the other order records >100% utilization spikes
            for key in list(task_alloc):
                _release(key, ts, only_wid=wid)
            cfg = cfg_of_worker.pop(wid, None)
            if cfg is not None:
                for name, units in wres_of_worker.pop(wid, {}).items():
                    cfg_totals[cfg][name] -= units
                    _mark_util(cfg, name, ts)
        elif kind == "task-started":
            running += 1
            running_trace.append((ts, float(running)))
            key = (rec.get("job", 0), rec.get("task", 0))
            task_started_at[key] = ts
            submitted = task_submitted_at.get(
                key, job_submitted_at.get(key[0])
            )
            if submitted is not None:
                class_of(*key)["waits"].append(ts - submitted)
            workers = rec.get("workers") or ()
            if workers:
                v = _chosen_variant(*key, rec.get("variant", 0))
                if v.get("n_nodes"):
                    # a gang occupies each member worker WHOLE
                    for wid in workers:
                        pools = wres_of_worker.get(wid, {})
                        _charge(key, wid, list(pools.items()), ts)
                else:
                    wid = workers[0]
                    pools = wres_of_worker.get(wid, {})
                    entries = []
                    for e in v.get("entries") or [{"name": "cpus",
                                                   "amount": 10_000}]:
                        if e.get("policy") == "all":
                            # ALL-policy drains the worker's whole pool
                            entries.append(
                                (e["name"], pools.get(e["name"], 0.0))
                            )
                        else:
                            entries.append(
                                (e["name"], int(e["amount"]) / 10_000)
                            )
                    _charge(key, wid, entries, ts)
        elif kind in ("task-finished", "task-failed", "task-canceled",
                      "task-restarted"):
            key = (rec.get("job", 0), rec.get("task", 0))
            started = task_started_at.pop(key, None)
            # only tasks that actually STARTED decrement the running trace
            # (canceling a waiting task must not push the chart below the
            # true running count)
            if started is not None and running > 0:
                running -= 1
                running_trace.append((ts, float(running)))
            if kind == "task-finished":
                per_minute[int(ts // 60)] += 1
                if started is not None:
                    class_of(*key)["finished"].append(ts - started)
            elif kind == "task-failed" and started is not None:
                class_of(*key)["failed"].append(ts - started)
            _release(key, ts)
    return data, running_trace, per_minute, classes, util_traces


def _percentile(values: list[float], p: int) -> str:
    if not values:
        return "-"
    vs = sorted(values)
    idx = min(len(vs) - 1, int(round(p / 100 * (len(vs) - 1))))
    return f"{vs[idx]:.2f}s"


def _quartiles(values: list[float]) -> tuple[float, float, float, float, float]:
    vs = sorted(values)
    q = statistics.quantiles(vs, n=4) if len(vs) >= 2 else [vs[0]] * 3
    return (vs[0], q[0], q[1], q[2], vs[-1])


def _svg_boxes(groups: list[tuple[str, list[float]]], width=640) -> str:
    """Horizontal box plots (min, q1, median, q3, max) — the reference's
    plotly box traces (report.rs durationsChart) rendered as inline SVG."""
    groups = [(label, vs) for label, vs in groups if vs]
    if not groups:
        return "<p>(no data)</p>"
    vmax = max(max(vs) for _, vs in groups) or 1.0
    row_h, pad_l = 34, 110
    height = row_h * len(groups) + 24
    scale = (width - pad_l - 16) / vmax
    out = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" style="background:#f8f8f8;border:1px solid #ddd">'
    ]
    for i, (label, vs) in enumerate(groups):
        lo, q1, med, q3, hi = _quartiles(vs)
        y = i * row_h + 20
        x = lambda v: pad_l + v * scale  # noqa: E731
        out.append(
            f'<text x="4" y="{y + 4}" font-size="11">'
            f'{html.escape(label)} (n={len(vs)})</text>'
            f'<line x1="{x(lo):.1f}" y1="{y}" x2="{x(hi):.1f}" y2="{y}" '
            f'stroke="#888"/>'
            f'<rect x="{x(q1):.1f}" y="{y - 8}" '
            f'width="{max(x(q3) - x(q1), 1):.1f}" height="16" '
            f'fill="#9cf" stroke="#36c"/>'
            f'<line x1="{x(med):.1f}" y1="{y - 8}" x2="{x(med):.1f}" '
            f'y2="{y + 8}" stroke="#036" stroke-width="2"/>'
        )
    out.append(
        f'<text x="{pad_l}" y="{height - 6}" font-size="10">0s</text>'
        f'<text x="{width - 60}" y="{height - 6}" font-size="10">'
        f'{vmax:.2f}s</text></svg>'
    )
    return "".join(out)


def build_report(journal_path: str | Path, start_time: float | None = None,
                 end_time: float | None = None) -> str:
    data, running_trace, per_minute, classes, util_traces = _collect(
        Path(journal_path), start_time, end_time
    )
    lo, hi = data.time_span()
    span = hi - lo

    # ---- per-job rows with duration statistics -------------------------
    job_rows = []
    for job_id, job in sorted(data.jobs.items()):
        durations = [
            t.finished_at - t.started_at
            for t in job.tasks.values()
            if t.started_at and t.finished_at and t.status == "finished"
        ]
        c = job.counters()
        stats = (
            f"{min(durations):.2f} / {statistics.median(durations):.2f} / "
            f"{statistics.mean(durations):.2f} / {max(durations):.2f}"
            if durations
            else "-"
        )
        makespan = (
            f"{job.completed_at - job.submitted_at:.1f}s"
            if job.completed_at and job.submitted_at
            else "-"
        )
        job_rows.append(
            f"<tr><td>{job_id}</td><td>{html.escape(job.name)}</td>"
            f"<td>{job.n_tasks}</td><td>{job.status()}</td>"
            f"<td>{c['finished']}</td><td>{c['failed']}</td>"
            f"<td>{c['canceled']}</td>"
            f"<td>{_fmt(job.submitted_at)}</td><td>{makespan}</td>"
            f"<td>{stats}</td></tr>"
        )

    # ---- per-worker utilization (one pass over all tasks) --------------
    online_until = {
        wid: (w.lost_at if w.lost_at else hi)
        for wid, w in data.workers.items()
    }
    busy_by_worker: dict[int, float] = {}
    for job in data.jobs.values():
        for t in job.tasks.values():
            if not t.started_at:
                continue
            # a restarted task keeps started_at with finished_at=0 but is
            # no longer running; only terminal or still-running spans count
            if not t.finished_at and t.status != "running":
                continue
            for wid in t.workers:
                end = t.finished_at or online_until.get(wid, hi)
                busy_by_worker[wid] = busy_by_worker.get(wid, 0.0) + max(
                    end - t.started_at, 0.0
                )
    worker_rows = []
    for wid, w in sorted(data.workers.items()):
        online = max(online_until[wid] - w.connected_at, 0.0)
        busy = busy_by_worker.get(wid, 0.0)
        util = f"{busy / online * 100:.0f}%" if online > 0 else "-"
        worker_rows.append(
            f"<tr><td>{wid}</td><td>{html.escape(w.hostname)}</td>"
            f"<td>{html.escape(w.group)}</td>"
            f"<td>{_fmt(w.connected_at)}</td>"
            f"<td>{_fmt(w.lost_at) if w.lost_at else 'online'}"
            f"{' (' + html.escape(w.lost_reason) + ')' if w.lost_reason else ''}</td>"
            f"<td>{w.tasks_done}</td><td>{online:.0f}s</td>"
            f"<td>{busy:.0f}s</td><td>{util}</td></tr>"
        )

    # ---- failures ------------------------------------------------------
    failure_rows = []
    for job_id, job in sorted(data.jobs.items()):
        for task_id, t in sorted(job.tasks.items()):
            if t.status == "failed":
                failure_rows.append(
                    f"<tr><td>{job_id}</td><td>{task_id}</td>"
                    f"<td>{html.escape(t.error[:120])}</td></tr>"
                )
    failures = (
        "<table><tr><th>job</th><th>task</th><th>error</th></tr>"
        + "".join(failure_rows[:200])
        + "</table>"
        if failure_rows
        else "<p>none</p>"
    )

    # ---- allocation-queue economics (reference report.rs tracks the
    # queued→running worker traces; here per queue: counts, manager-queue
    # latency, lifetime, and worker-seconds actually provisioned) ----------
    alloc_rows = []
    for qid, q in sorted(data.queues.items()):
        by_status = Counter(a.status for a in q.allocations.values())
        latencies = [
            a.started_at - a.queued_at
            for a in q.allocations.values()
            if a.started_at and a.queued_at
        ]
        lifetimes = [
            a.ended_at - a.started_at
            for a in q.allocations.values()
            if a.started_at and a.ended_at
        ]
        provisioned = sum(
            (a.ended_at - a.started_at) * a.worker_count
            for a in q.allocations.values()
            if a.started_at and a.ended_at
        )
        mean_latency = (
            f"{statistics.mean(latencies):.1f}s" if latencies else "-"
        )
        mean_lifetime = (
            f"{statistics.mean(lifetimes):.1f}s" if lifetimes else "-"
        )
        statuses = " ".join(
            f"{k}={v}" for k, v in sorted(by_status.items())
        ) or "-"
        alloc_rows.append(
            f"<tr><td>{qid}</td><td>{html.escape(q.manager)}</td>"
            f"<td>{q.state}</td><td>{statuses}</td>"
            f"<td>{mean_latency}</td><td>{mean_lifetime}</td>"
            f"<td>{provisioned:.0f}s</td></tr>"
        )

    # ---- charts --------------------------------------------------------
    worker_chart = _svg_line(
        [(t, float(n)) for t, n in data.worker_series], color="#383"
    )
    running_chart = _svg_line(running_trace)
    throughput_chart = _svg_line(
        [(m * 60.0, float(per_minute[m])) for m in sorted(per_minute)],
        color="#a44",
    )

    # running workers grouped by resource config (reference report.rs
    # running_workers traces keyed on ResCount)
    config_events: dict[str, list[tuple[float, int]]] = {}
    for w in data.workers.values():
        key = _config_key(w.resources)
        config_events.setdefault(key, []).append((w.connected_at, +1))
        if w.lost_at:
            config_events[key].append((w.lost_at, -1))
    config_sections = []
    for key in sorted(config_events):
        series, n = [], 0
        for t, delta in sorted(config_events[key]):
            n += delta
            series.append((t, float(n)))
        section = (
            f"<h3>workers [{html.escape(key)}]</h3>"
            + _svg_line(series, height=80, color="#383")
        )
        # normalized per-resource utilization on this config (reference
        # report.rs "<RESOURCE> alloc on <RESOURCES>" traces; 1.0 = full)
        for (cfg, name), trace in sorted(util_traces.items()):
            if cfg != key:
                continue
            section += (
                f"<h4>{html.escape(name)} utilization "
                f"(% of the config's pool)</h4>"
                + _svg_line([(t, v * 100.0) for t, v in trace],
                            height=70, color="#66a")
            )
        config_sections.append(section)

    # per-request-class duration boxes + counts + queue waits (reference
    # report.rs durationsChart/countsChart T1..Tn legend)
    class_names = {sig: f"T{i + 1}" for i, sig in enumerate(sorted(classes))}
    duration_boxes = _svg_boxes(
        [(f"{class_names[sig]} finished", cls["finished"])
         for sig, cls in sorted(classes.items())]
        + [(f"{class_names[sig]} failed", cls["failed"])
           for sig, cls in sorted(classes.items())]
    )
    wait_boxes = _svg_boxes(
        [(class_names[sig], cls["waits"])
         for sig, cls in sorted(classes.items())]
    )
    class_count_rows = "".join(
        f"<tr><td>{class_names[sig]}</td><td>{html.escape(sig)}</td>"
        f"<td>{len(cls['finished'])}</td><td>{len(cls['failed'])}</td>"
        f"<td>{_percentile(cls['waits'], 50)}</td>"
        f"<td>{_percentile(cls['waits'], 90)}</td>"
        f"<td>{_percentile(cls['waits'], 99)}</td></tr>"
        for sig, cls in sorted(classes.items())
    )

    task_totals = Counter()
    for job in data.jobs.values():
        for status, n in job.counters().items():
            task_totals[status] += n
    totals = " ".join(f"{k}={v}" for k, v in sorted(task_totals.items()) if v)
    window = ""
    if start_time is not None or end_time is not None:
        window = (
            f" window [{start_time if start_time is not None else 0:g}s, "
            f"{end_time if end_time is not None else span:g}s]"
        )

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>HyperQueue-TPU report</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; max-width: 72rem; }}
table {{ border-collapse: collapse; margin: 1rem 0; font-size: 0.9rem; }}
td, th {{ border: 1px solid #ccc; padding: 4px 10px; text-align: left; }}
h2 {{ margin-top: 2rem; }}
</style></head><body>
<h1>HyperQueue-TPU journal report</h1>
<p>{len(data.jobs)} job(s), {len(data.workers)} worker(s), tasks: {totals}
over {span:.0f}s{window} &mdash; {html.escape(str(journal_path))}</p>
<h2>Connected workers over time</h2>{worker_chart}
<h2>Running workers by resource config</h2>{"".join(config_sections) or "<p>(no data)</p>"}
<h2>Running tasks over time</h2>{running_chart}
<h2>Throughput (finished tasks per minute)</h2>{throughput_chart}
<h2>Task classes</h2>
<table><tr><th>class</th><th>request</th><th>finished</th><th>failed</th>
<th>wait p50</th><th>wait p90</th><th>wait p99</th></tr>
{class_count_rows or "<tr><td colspan=7>none</td></tr>"}</table>
<h2>Task durations per class</h2>{duration_boxes}
<h2>Queue wait per class (submit &rarr; start)</h2>{wait_boxes}
<h2>Jobs</h2>
<table><tr><th>id</th><th>name</th><th>tasks</th><th>status</th>
<th>finished</th><th>failed</th><th>canceled</th><th>submitted</th>
<th>makespan</th><th>duration min/med/mean/max (s)</th></tr>
{"".join(job_rows)}</table>
<h2>Workers</h2>
<table><tr><th>id</th><th>hostname</th><th>group</th><th>connected</th>
<th>until</th><th>tasks done</th><th>online</th><th>busy</th><th>util</th></tr>
{"".join(worker_rows)}</table>
<h2>Failed tasks</h2>{failures}
<h2>Allocation queues</h2>
<table><tr><th>queue</th><th>manager</th><th>state</th><th>allocations</th>
<th>mean queue latency</th><th>mean lifetime</th><th>worker-seconds</th></tr>
{"".join(alloc_rows) or "<tr><td colspan=7>none</td></tr>"}</table>
</body></html>"""
