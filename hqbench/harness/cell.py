"""One cell: set-up, the measured window, and the record of both.

The cell builds the server's state as `hq server start --scheduler greedy`
holds it (a `Core` from `convert.lazy_core_from_plain`, the backlog as
lazy array chunks; the model `SolverWatchdog(GreedyCutScanModel(device))`,
no paranoid checks; the collector's thresholds as `Server.start` sets
them, `gc.collect(); gc.freeze()` after start-up), then
calls `reactor.schedule(core, comm, events, model)` as
`Server._scheduler_loop` calls it: a tick when a pass was asked for, no
sooner than `SCHEDULE_MIN_DELAY` after the ask (or after the last tick,
whichever is later), prefill at its default. The workers' answers and the
submits come from the traffic mix's loop (hqbench/loops/).
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path

from hqbench.harness.plain import INF_TIME, make_plain
from hqbench.harness.sinks import Comm, JobSink
from hqbench.harness.traffic import make_traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
# the collector's thresholds that Server.start sets for a server with a
# real transport (server/bootstrap.py)
GC_THRESHOLD = (100_000, 50, 25)


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def load_mix(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


class TickRecord:
    """One tick: its start and end (perf_counter s), the phases schedule()
    recorded (ms), collection inside it (ms), the worker model's time
    since the tick before (ms), the ready count after it, whether it
    solved, and the tasks started by the end of the workers' answers."""

    __slots__ = ("t0", "t1", "phases", "gc_ms", "harness_ms", "ready",
                 "solved", "started")

    def __init__(self, t0, t1, phases, gc_ms, ready, solved):
        self.t0, self.t1 = t0, t1
        self.phases = phases
        self.gc_ms = gc_ms
        self.harness_ms = 0.0
        self.ready = ready
        self.solved = solved
        self.started = 0


class Cell:
    """A cell's run. `device` is "cuda" for a run and "cpu" in the tests;
    `model_hook(model)` may replace the model (the control runs)."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: str = "cuda", model_hook=None):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = device
        self.model_hook = model_hook
        self.log: list = []
        self.ticks: list = []
        self.window = None       # (t0, t1) of the measured window
        self.gc_ms = 0.0
        self.due_ms = 0.0        # the worker model's time between ticks
        self._gc_t0 = None
        self.spans = None        # set by the tracer: callable(name) -> ctx
        self._last_phases = None
        self._gc_threshold = None

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from hyperqueue_tpu_torch.convert import lazy_core_from_plain
        from hyperqueue_tpu_torch.ids import make_task_id, task_id_job
        from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
        from hyperqueue_tpu_torch.ops import assign
        from hyperqueue_tpu_torch.scheduler.queues import (
            encode_sched_priority,
        )
        from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
        from hyperqueue_tpu_torch.server import bootstrap, reactor

        self.reactor = reactor
        # as Server.start does before it loads its state
        self._gc_threshold = gc.get_threshold()
        gc.set_threshold(*GC_THRESHOLD)
        self.min_delay = bootstrap.SCHEDULE_MIN_DELAY
        self.make_task_id = make_task_id
        self.encode_sched = encode_sched_priority
        plain = self.plain = make_plain(self.config, self.mix, self.seed)
        classes = [[{"entries": [(name, amount, "compact")
                                 for name, amount in variant]}
                    for variant in variants] for variants in plain.classes]
        tasks = []
        for job, cls, prio, ids in plain.backlog:
            sched = encode_sched_priority(job)
            tasks.extend((make_task_id(job, i), cls, (prio, sched))
                         for i in ids.tolist())
        workers = [(wid, list(amounts), slots, INF_TIME, list(amounts),
                    "default") for wid, amounts, slots in plain.workers]
        core, jobs = lazy_core_from_plain(plain.resources, classes, tasks,
                                          workers)
        del tasks
        self.core, self.jobs = core, jobs
        self.next_job = plain.n_jobs + 1
        base = GreedyCutScanModel(device=self.device)
        if self.model_hook is not None:
            base = self.model_hook(base)
        self.base_model = base
        self.model = SolverWatchdog(base)
        self.comm = Comm()
        self.events = JobSink(jobs, task_id_job)
        self.traffic = make_traffic(self, self.mix, plain, self.seed)
        # the phases of each tick, as schedule() hands them to tick_stats
        record = core.tick_stats.record

        def capture(phases):
            self._last_phases = phases
            record(phases)

        core.tick_stats.record = capture
        self.launches0 = assign.greedy_cut_scan.site_launches["tick"]
        # as the server does once it has started
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._on_gc)

    def close(self):
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        gc.unfreeze()
        if self._gc_threshold is not None:
            gc.set_threshold(*self._gc_threshold)
            self._gc_threshold = None

    def _on_gc(self, stage, _info):
        if stage == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_ms += (time.perf_counter() - self._gc_t0) * 1e3
            self._gc_t0 = None

    def submit_array(self, cls, user_priority, n):
        """An array submit of n tasks (ids 1..n) of one class, registered as
        the server registers a chunked array submit."""
        from hyperqueue_tpu_torch.server.lazy import ArrayChunk
        from hyperqueue_tpu_torch.utils import clock

        job = self.next_job
        self.next_job += 1
        self.jobs.create_job(name=f"job{job}", submit_dir="", job_id=job)
        now = clock.now()
        self.core.lazy.register(self.core, ArrayChunk(
            job_id=job, rq_id=cls,
            priority=(user_priority, self.encode_sched(job)),
            body={}, crash_limit=5, id_range=(1, n + 1),
            submitted_at=now, ready_at=now))
        self.log.append(("submit", job, cls, user_priority, n))
        self.comm.ask_for_scheduling()
        return job, n

    # -- ticks -------------------------------------------------------------
    def tick(self):
        core, comm = self.core, self.comm
        comm.asked = False  # the loop clears its event right before a tick
        self._last_phases = None
        self.gc_ms = 0.0
        spans = self.spans
        t0 = time.perf_counter()
        if spans is None:
            self.reactor.schedule(core, comm, self.events, self.model)
        else:
            with spans("hq.schedule"):
                self.reactor.schedule(core, comm, self.events, self.model)
        t1 = time.perf_counter()
        gc_ms = self.gc_ms
        compute, retracts = comm.take()
        # the log keeps tuples of ints, which the collector stops tracking:
        # holding the messages themselves would add to every collection
        # the program makes
        tasks = core.tasks
        prefilled = set()
        sent = []
        for wid, msgs in compute:
            rows = []
            for m in msgs:
                tid = m["id"]
                flag = tasks[tid].prefilled
                if flag:
                    prefilled.add(tid)
                rows.append((tid, m["instance"], m["variant"], flag))
            sent.append((wid, tuple(rows)))
        phases = self._last_phases or {}
        rec = TickRecord(t0, t1, phases, gc_ms, core.queues.total_ready(),
                         "solve_dispatch" in phases)
        self.ticks.append(rec)
        self.log.append(("tick", sent, tuple(
            (wid, tuple(map(tuple, refs))) for wid, refs in retracts)))
        h0 = time.perf_counter()
        if spans is None:
            self.traffic.after_tick(compute, retracts, prefilled, t1)
        else:
            with spans("hq.workers"):
                self.traffic.after_tick(compute, retracts, prefilled, t1)
        rec.harness_ms = (time.perf_counter() - h0) * 1e3 + self.due_ms
        rec.started = self.traffic.workers.started
        self.due_ms = 0.0
        self.last_tick_end = t1
        return rec

    def run_until(self, t_stop, done=None):
        """The server's scheduler loop until t_stop (or until done(), or
        until nothing is left to happen): the traffic's finishes and
        submits as they fall due, a tick MIN_DELAY after a pass was asked
        for (counted from the end of the last tick where that is later)."""
        comm, traffic = self.comm, self.traffic
        spans = self.spans
        asked_at = None
        while True:
            now = time.perf_counter()
            if now >= t_stop or (done is not None and done()):
                return
            nxt = traffic.next_due()
            if nxt is not None and nxt <= now:
                if spans is None:
                    traffic.due(now)
                else:
                    with spans("hq.workers"):
                        traffic.due(now)
                self.due_ms += (time.perf_counter() - now) * 1e3
            if comm.asked and asked_at is None:
                asked_at = max(now, self.last_tick_end)
            if comm.asked:
                t_next = max(asked_at, self.last_tick_end) + self.min_delay
                if now >= t_next:
                    self.tick()
                    asked_at = self.last_tick_end if comm.asked else None
                    continue
                wake = t_next
            else:
                wake = t_stop
            nxt = traffic.next_due()
            if nxt is None and not comm.asked and done is not None:
                return  # nothing will happen that done() could wait for
            if nxt is not None:
                wake = min(wake, nxt)
            wake = min(wake, t_stop)
            if wake > now:
                if spans is None:
                    time.sleep(wake - now)
                else:
                    with spans("hq.wait"):
                        time.sleep(wake - now)

    def warm_up(self):
        """The ticks the traffic needs before the window."""
        self.last_tick_end = time.perf_counter() - self.min_delay
        self.traffic.warm_up(self)

    def measure(self, seconds: float):
        """The window: `seconds` of the server's loop; it ends with the
        answers to the last tick that started in it."""
        t0 = time.perf_counter()
        n0 = len(self.ticks)
        started0 = self.window_started0 = self.traffic.workers.started
        self.run_until(t0 + seconds)
        t1 = time.perf_counter()
        self.window = (t0, t1)
        self.window_ticks = self.ticks[n0:]
        self.window_started = self.traffic.workers.started - started0
        from hyperqueue_tpu_torch.ops import assign

        self.launches = (assign.greedy_cut_scan.site_launches["tick"]
                         - self.launches0)
        self.solves = sum(1 for r in self.ticks if r.solved)
