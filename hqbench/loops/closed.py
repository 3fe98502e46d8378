"""The closed loop: the backlog is submitted at set-up; every task runs for
a wall-clock duration, and its worker then starts backlog into the room it
freed.

A mix of this loop (`hqbench/traffic/<mix>.json`) gives:

- `backlog`: {tasks, jobs, user_priorities, shape_seed}, the backlog the
  set-up submits (hqbench/harness/plain.backlog_groups);
- `duration_s`: how long each task runs, in seconds of wall time (0: a
  task ends as it starts, as on a zero-worker build);
- `resubmit` (optional, default false): once every task submitted has
  finished, the same array is submitted again as a new job, as a client
  that runs `hq submit --array ... --wait` over and over; the backlog
  must then be one class at one priority;
- `warmup_ticks`: the ticks before the window (the first one prefills
  the workers' backlogs).

After each tick the workers answer its messages (a task sent to run
starts, a prefilled one joins its worker's FIFO backlog), then its
retracts, then finish every task whose time is up.
"""

from __future__ import annotations

import heapq
import time

from hqbench.harness.traffic import Workers


class Loop:
    kind = "closed"

    def __init__(self, cell, mix, plain, seed):
        self.cell = cell
        self.workers = Workers(cell, plain)
        self.warmup_ticks = int(mix["warmup_ticks"])
        self.duration = float(mix["duration_s"])
        self.finishes = []  # heap of (due, task id)
        self.outstanding = sum(len(ids) for *_k, ids in plain.backlog)
        self.resubmit = None
        if mix.get("resubmit"):
            if len(plain.backlog) != 1:
                raise ValueError("a resubmitted backlog has to be one class "
                                 "at one priority in one job")
            _job, cls, prio, ids = plain.backlog[0]
            self.resubmit = (cls, prio, len(ids))

    def _time_fresh(self, t):
        """Gives the tasks started since the last call their finish."""
        w, due = self.workers, t + self.duration
        for tid in w.fresh:
            heapq.heappush(self.finishes, (due, tid))
        w.fresh.clear()

    def next_due(self):
        return self.finishes[0][0] if self.finishes else None

    def due(self, now):
        fin, w = self.finishes, self.workers
        while fin and fin[0][0] <= now:
            done = []
            while fin and fin[0][0] <= now:
                done.append(heapq.heappop(fin)[1])
            w.start_backlog(w.finish(done))
            self.outstanding -= len(done)
            self._time_fresh(now)
        if self.resubmit is not None and self.outstanding == 0:
            cls, prio, n = self.resubmit
            self.cell.submit_array(cls, prio, n)
            self.outstanding = n

    def after_tick(self, compute, retracts, prefilled, t):
        w = self.workers
        w.answer_compute(compute, prefilled)
        self._time_fresh(t)
        w.answer_retracts(retracts)
        self.due(t)

    def warm_up(self, cell):
        cell.tick()
        cell.run_until(time.perf_counter() + 600.0,
                       lambda: len(cell.ticks) >= self.warmup_ticks)

    def attempts(self, cell):
        """Every task started in the window; a closed loop has nothing
        that can come too late."""
        return cell.window_started, 0
