"""Terminal dashboard: cluster / jobs / autoalloc screens over event-sourced
state, live or replayed from a journal.

Reference: crates/hyperqueue/src/dashboard/ — a ratatui TUI with a root
screen switching between cluster overview (worker table + count chart),
worker detail (config + per-CPU utilization), jobs (table + task chart), and
autoalloc (queues + allocations) screens, fed by DashboardData timelines
built from the event stream; `--replay` scrubs a finished journal offline
(ui/screens/*, data/fetch.rs).

Rendering is split into pure line-producing functions (unit-testable) and a
thin curses loop (keyboard: 1/2/3 or Tab screens, j/k select, Enter worker
detail, left/right time scrub in replay, space jumps back to the end, q
quit).
"""

from __future__ import annotations

import time

from hyperqueue_tpu_torch.client.dashboard_data import DashboardData
from hyperqueue_tpu_torch.utils import clock

SCREENS = ("cluster", "jobs", "autoalloc")


def _bar(frac: float, width: int = 16) -> str:
    filled = int(max(0.0, min(frac, 1.0)) * width)
    return "[" + "#" * filled + "-" * (width - filled) + f"]{frac * 100:4.0f}%"


def _fmt_t(t: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(t)) if t else "-"


def _sparkline(series: list[tuple[float, float]], width: int,
               maximum: float | None = None) -> str:
    """One-line unicode chart (reference worker_count_chart / utilization
    charts condensed to a sparkline)."""
    if not series:
        return ""
    ticks = "▁▂▃▄▅▆▇█"
    values = [v for _, v in series[-max(width, 1):]]
    top = maximum if maximum is not None else max(values) or 1.0
    return "".join(
        ticks[min(int(v / top * (len(ticks) - 1)), len(ticks) - 1)]
        for v in values
    )


# ---------------------------------------------------------------------------
# screens (pure)
# ---------------------------------------------------------------------------

def render_header(data: DashboardData, screen: str, now: float,
                  mode: str, width: int = 78) -> list[str]:
    tabs = " ".join(
        f"[{i + 1}:{name.upper()}]" if name == screen else f" {i + 1}:{name} "
        for i, name in enumerate(SCREENS)
    )
    n_workers = sum(1 for w in data.workers.values() if w.is_connected)
    line = (
        f"hq dashboard ({mode})  {_fmt_t(now)}  workers={n_workers} "
        f"jobs={len(data.jobs)}  {tabs}"
    )
    return [line[:width], "=" * width]


def render_cluster(data: DashboardData, selected: int, width: int = 78,
                   height: int = 30) -> list[str]:
    lines = ["WORKERS  (Enter: detail, j/k: select)"]
    workers = sorted(data.workers.values(), key=lambda w: w.worker_id)
    count_chart = _sparkline(
        [(t, float(n)) for t, n in data.worker_series], 40
    )
    if count_chart:
        lines.append(f"  connected over time: {count_chart}")
    if not workers:
        lines.append("  (no workers seen)")
    for i, w in enumerate(workers[: height - 4]):
        cpu = w.last_hw.get("cpu_usage_percent")
        cpu_s = _bar(cpu / 100.0, 10) if cpu is not None else ""
        state = "up" if w.is_connected else f"lost({w.lost_reason[:12]})"
        marker = ">" if i == selected else " "
        lines.append(
            f" {marker}#{w.worker_id:<4} {w.hostname[:20]:<20} "
            f"{w.group[:10]:<10} {state:<18} run={len(w.running):<4} "
            f"done={w.tasks_done:<5} {cpu_s}"[:width]
        )
    return lines


def render_worker_detail(data: DashboardData, worker_id: int,
                         width: int = 78, height: int = 30) -> list[str]:
    w = data.workers.get(worker_id)
    if w is None:
        return [f"worker {worker_id}: unknown"]
    lines = [
        f"WORKER #{w.worker_id} {w.hostname}  group={w.group}  "
        f"{'connected ' + _fmt_t(w.connected_at) if w.is_connected else 'LOST ' + _fmt_t(w.lost_at) + ' ' + w.lost_reason}",
        "-" * width,
        f"running tasks: {len(w.running)}   finished here: {w.tasks_done}",
    ]
    for job_id, task_id in sorted(w.running)[:8]:
        lines.append(f"   job {job_id} task {task_id}")
    # task timeline: concurrent running tasks over time + recent spans
    # (reference dashboard worker screen timeline charts)
    series = w.running_series()
    if series:
        lines.append(
            "task timeline: " + _sparkline(series, width - 17)
        )
        recent_spans = list(w.task_history)[-6:]
        for span in reversed(recent_spans):
            end = span.ended_at or data.last_time
            lines.append(
                f"   {span.job_id}@{span.task_id:<6} {span.status:<9} "
                f"{end - span.started_at:6.1f}s"
            )
    hw = w.last_hw
    if hw:
        mem_total = hw.get("mem_total_bytes", 0)
        mem_avail = hw.get("mem_available_bytes", 0)
        if mem_total:
            used = 1.0 - mem_avail / mem_total
            lines.append(f"mem  {_bar(used)}  of {mem_total / 2**30:.1f} GiB")
        cpu = hw.get("cpu_usage_percent")
        if cpu is not None:
            lines.append(f"cpu  {_bar(cpu / 100.0)}")
        lines.append(
            "util history: "
            + _sparkline(list(w.cpu_history), width - 16, maximum=100.0)
        )
        per_core = hw.get("cpu_per_core_percent") or []
        if per_core:
            lines.append("PER-CPU UTILIZATION")
            # grid of per-core bars, 4 per row (reference cpu_util_table.rs)
            row = []
            for i, pct in enumerate(per_core):
                row.append(f"cpu{i:<3}{_bar(pct / 100.0, 8)}")
                if len(row) == 4:
                    lines.append("  " + "  ".join(row))
                    row = []
            if row:
                lines.append("  " + "  ".join(row))
        gpus = hw.get("gpus") or []
        if gpus:
            lines.append("GPUS")
            for g in gpus:
                lines.append(
                    f"  {g.get('vendor', '?'):<7}{str(g.get('id', ''))[:16]:<16}"
                    f" util {_bar(g.get('usage_percent', 0) / 100.0, 8)}"
                    f" mem {_bar(g.get('mem_usage_percent', 0) / 100.0, 8)}"
                )
    return [ln[:width] for ln in lines[:height]]


def render_jobs(data: DashboardData, selected: int, width: int = 78,
                height: int = 30) -> list[str]:
    lines = ["JOBS  (j/k: select)"]
    jobs = sorted(data.jobs.values(), key=lambda j: -j.job_id)
    if not jobs:
        lines.append("  (no jobs)")
    table_rows = max(4, (height - 4) // 2)
    for i, job in enumerate(jobs[:table_rows]):
        c = job.counters()
        marker = ">" if i == selected else " "
        lines.append(
            f" {marker}#{job.job_id:<4} {job.name[:18]:<18} "
            f"{job.status():<9} {_bar(job.progress())} "
            f"run={c['running']:<4} fail={c['failed']:<4} "
            f"open={'y' if job.is_open else 'n'}"[:width]
        )
    if jobs and 0 <= selected < len(jobs):
        job = jobs[selected]
        c = job.counters()
        lines.append("-" * width)
        lines.append(
            f"JOB #{job.job_id} {job.name}  submitted {_fmt_t(job.submitted_at)}"
            + (f"  completed {_fmt_t(job.completed_at)}" if job.completed_at
               else "")
        )
        lines.append(
            f"  tasks {job.n_tasks}: " + "  ".join(
                f"{k}={v}" for k, v in c.items() if v
            )
        )
        # running-task timeline for the job (reference job timeline
        # chart), from the data layer's span history so restarted
        # instances count like on the worker-detail screen
        series = data.job_running_series(job.job_id)
        if series:
            lines.append(
                "  running over time: " + _sparkline(series, width - 22)
            )
        recent = sorted(
            job.tasks.items(),
            key=lambda kv: -(kv[1].finished_at or kv[1].started_at),
        )[: height - len(lines) - 1]
        for task_id, tv in recent:
            dur = ""
            if tv.started_at:
                end = tv.finished_at or data.last_time
                dur = f" {end - tv.started_at:6.1f}s"
            err = f" {tv.error[:24]}" if tv.error else ""
            lines.append(
                f"   task {task_id:<6} {tv.status:<9}{dur} "
                f"on {list(tv.workers)}{err}"[:width]
            )
    return lines[:height]


def render_autoalloc(data: DashboardData, selected: int, width: int = 78,
                     height: int = 30) -> list[str]:
    lines = ["AUTOALLOC QUEUES"]
    queues = sorted(data.queues.values(), key=lambda q: q.queue_id)
    if not queues:
        lines.append("  (no allocation queues)")
    for i, q in enumerate(queues):
        by_status: dict[str, int] = {}
        for a in q.allocations.values():
            by_status[a.status] = by_status.get(a.status, 0) + 1
        marker = ">" if i == selected else " "
        stat = " ".join(f"{k}={v}" for k, v in sorted(by_status.items()))
        lines.append(
            f" {marker}queue {q.queue_id:<3} {q.manager:<6} "
            f"state={q.state:<7} allocs: {stat or '-'}"[:width]
        )
    if queues and 0 <= selected < len(queues):
        q = queues[selected]
        lines.append("-" * width)
        lines.append(f"ALLOCATIONS of queue {q.queue_id}")
        # per-allocation drill-down: member workers joined via HQ_ALLOC_ID
        # (reference dashboard allocation detail screen)
        members: dict[str, list] = {}
        for w in data.workers.values():
            if w.alloc_id:
                members.setdefault(w.alloc_id, []).append(w)
        allocs = sorted(q.allocations.values(), key=lambda a: -a.queued_at)
        for a in allocs[: max(height - len(lines) - 1, 0)]:
            span = ""
            if a.started_at:
                end = a.ended_at or data.last_time
                span = (f" waited {a.started_at - a.queued_at:5.0f}s"
                        f" ran {end - a.started_at:6.0f}s")
            lines.append(
                f"   {a.allocation_id[:20]:<20} {a.status:<9} "
                f"workers={a.worker_count} queued {_fmt_t(a.queued_at)}{span}"
            )
            for w in members.get(a.allocation_id, ()):
                state = "up" if w.is_connected else "lost"
                lines.append(
                    f"      worker #{w.worker_id} {w.hostname[:16]:<16} "
                    f"{state:<5} running={len(w.running)} "
                    f"done={w.tasks_done}"
                )
    return lines[:height]


def render_screen(data: DashboardData, ui: dict, width: int = 78,
                  height: int = 30) -> list[str]:
    """Full frame for the current UI state (pure; curses loop just blits)."""
    mode = ui.get("mode", "live")
    now = ui.get("now", data.last_time)
    lines = render_header(data, ui.get("screen", "cluster"), now, mode, width)
    if ui.get("detail_worker") is not None:
        lines += render_worker_detail(
            data, ui["detail_worker"], width, height - len(lines)
        )
    elif ui.get("screen") == "jobs":
        lines += render_jobs(data, ui.get("selected", 0), width,
                             height - len(lines))
    elif ui.get("screen") == "autoalloc":
        lines += render_autoalloc(data, ui.get("selected", 0), width,
                                  height - len(lines))
    else:
        lines += render_cluster(data, ui.get("selected", 0), width,
                                height - len(lines))
    if mode == "replay":
        lo, hi = ui.get("span", (0.0, 0.0))
        frac = 0.0 if hi <= lo else (now - lo) / (hi - lo)
        lines.append(
            f"replay {_fmt_t(lo)} {_bar(frac, width - 30)} {_fmt_t(hi)}"
        )
    return lines[:height]


# ---------------------------------------------------------------------------
# event intake
# ---------------------------------------------------------------------------

def _stream_events_into(server_dir, data: DashboardData, lock,
                        subscribed) -> None:
    """Background daemon thread: live event stream feeding the reducer.

    Subscribes FIRST and signals `subscribed`, so the snapshot seed taken
    afterwards cannot race with events emitted in between — anything in the
    gap is both in the snapshot and (re-)applied from the stream, which the
    reducer tolerates. Uses the shared blocking stream client (read_frame is
    not cancellation-safe); the thread is a daemon and dies with the
    process."""
    from hyperqueue_tpu_torch.client.connection import stream_events

    try:
        for msg in stream_events(
            server_dir, history=False, on_subscribed=subscribed.set,
            overviews=True,
        ):
            if msg.get("op") == "event":
                with lock:
                    data.add_event(msg["record"])
    except (ConnectionError, OSError, EOFError):
        pass


# ---------------------------------------------------------------------------
# curses loop
# ---------------------------------------------------------------------------

def _curses_loop(stdscr, data: DashboardData, lock, mode: str,
                 interval: float) -> None:
    import curses

    curses.curs_set(0)
    stdscr.nodelay(True)
    ui = {"screen": "cluster", "selected": 0, "detail_worker": None,
          "mode": mode}
    view_cache: tuple[float, DashboardData] | None = None  # (now, view)

    while True:
        with lock:
            span = data.time_span()
            if mode == "replay":
                ui.setdefault("now", span[1])
                ui["span"] = span
                if ui["now"] >= span[1]:
                    view = data
                else:
                    # rebuild the prefix view only on seek, never per frame
                    if view_cache is None or view_cache[0] != ui["now"]:
                        view_cache = (ui["now"], data.at(ui["now"]))
                    view = view_cache[1]
            else:
                ui["now"] = data.last_time or clock.now()
                view = data
            # clamp selection to the current screen's list
            if ui["screen"] == "jobs":
                n_rows = len(view.jobs)
            elif ui["screen"] == "autoalloc":
                n_rows = len(view.queues)
            else:
                n_rows = len(view.workers)
            ui["selected"] = max(0, min(ui["selected"], max(n_rows - 1, 0)))
            height, width = stdscr.getmaxyx()
            lines = render_screen(
                view, ui, max(width - 1, 40), max(height - 1, 10)
            )
        stdscr.erase()
        for y, line in enumerate(lines[: height - 1]):
            try:
                stdscr.addstr(y, 0, line[: width - 1])
            except Exception:  # noqa: BLE001 - last-cell writes can raise
                pass
        stdscr.refresh()

        key = stdscr.getch()
        if key == -1:
            time.sleep(interval if mode == "live" else 0.05)
            continue
        ch = chr(key) if 0 <= key < 256 else ""
        import curses as _c

        if ch in ("q", "Q"):
            return
        if ch in ("1", "2", "3"):
            ui["screen"] = SCREENS[int(ch) - 1]
            ui["selected"] = 0
            ui["detail_worker"] = None
        elif ch == "\t":
            idx = (SCREENS.index(ui["screen"]) + 1) % len(SCREENS)
            ui["screen"] = SCREENS[idx]
            ui["selected"] = 0
            ui["detail_worker"] = None
        elif ch == "j" or key == _c.KEY_DOWN:
            ui["selected"] += 1
        elif ch == "k" or key == _c.KEY_UP:
            ui["selected"] = max(0, ui["selected"] - 1)
        elif ch == "\n" and ui["screen"] == "cluster":
            with lock:
                workers = sorted(data.workers)
            if workers:
                sel = min(ui["selected"], len(workers) - 1)
                ui["detail_worker"] = workers[sel]
        elif key == 27 or ch == "b":  # esc: back from detail
            ui["detail_worker"] = None
        elif mode == "replay" and (key in (_c.KEY_LEFT, _c.KEY_RIGHT)
                                   or ch in ("h", "l")):
            lo, hi = span
            step = max((hi - lo) / 50.0, 0.5)
            direction = 1 if (key == _c.KEY_RIGHT or ch == "l") else -1
            ui["now"] = min(max(ui.get("now", hi) + direction * step, lo), hi)
        elif ch == " " and mode == "replay":
            ui["now"] = span[1]


def run_dashboard(server_dir, interval: float = 1.0, replay=None,
                  stream=None) -> None:
    """Entry: live against a server (default) or offline journal replay.

    stream: test/plain hook — when stdout is not a tty, render one frame as
    plain text per refresh instead of entering curses.
    """
    import sys
    import threading

    lock = threading.Lock()
    if replay is not None:
        from hyperqueue_tpu_torch.client.dashboard_data import load_journal

        data = load_journal(replay)
        mode = "replay"
        stop = None
    else:
        from hyperqueue_tpu_torch.client.connection import ClientSession
        from hyperqueue_tpu_torch.client.dashboard_data import seed_from_server

        # live events are reduced into state only; the raw record log is a
        # replay-mode concern and would grow without bound on a long-lived
        # dashboard (one overview event per worker per second)
        data = DashboardData(retain_events=False)
        mode = "live"
        stop = None
        subscribed = threading.Event()
        thread = threading.Thread(
            target=_stream_events_into,
            args=(server_dir, data, lock, subscribed),
            daemon=True,
        )
        thread.start()
        # subscribe-then-seed closes the lost-event window: the snapshot is
        # taken strictly after the stream subscription is on the wire
        subscribed.wait(timeout=10.0)
        with ClientSession(server_dir) as session, lock:
            seed_from_server(data, session)

    if stream is not None or not sys.stdout.isatty():
        # plain mode: print frames (used by tests and piped invocations)
        out = stream or sys.stdout
        try:
            for _ in range(3 if mode == "live" else 1):
                if mode == "live":
                    time.sleep(interval)
                with lock:
                    ui = {"screen": "cluster", "selected": 0, "mode": mode,
                          "now": data.last_time, "span": data.time_span()}
                    frame = render_screen(data, ui)
                print("\n".join(frame), file=out, flush=True)
        finally:
            if stop is not None:
                stop.set()
        return

    import curses

    try:
        curses.wrapper(_curses_loop, data, lock, mode, interval)
    finally:
        if stop is not None:
            stop.set()
