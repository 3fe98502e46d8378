"""The workers' side of a cell, and the loader of its traffic loop.

A traffic mix is a data file, `hqbench/traffic/<mix>.json`. Its `loop`
names the generator that reads it: the module `hqbench/loops/<loop>.py`,
whose `Loop(cell, mix, plain, seed)` drives the cell's workers and
submits. A loop offers:

- `kind`, and `workers` (a `Workers`);
- `due(now)`: whatever falls due by `now` (finishes, submits);
- `next_due()`: when the next thing falls due, or None;
- `after_tick(compute, retracts, prefilled, t)`: the workers' answers to
  a tick that ended at `t`;
- `warm_up(cell)`: the ticks the traffic needs before the window;
- `attempts(cell)`: (attempted, failed) of the window.

Every action on the program is appended to the run's log, which the
reference replays once the window has closed.
"""

from __future__ import annotations

import importlib


class Workers:
    """The workers' side: what each runs, holds in backlog and has free,
    by the benchmark's own count (the program's is not read). The worker
    model of chip_smoke's `ReactorHarness`, rewritten."""

    def __init__(self, cell, plain):
        self.cell = cell
        self.res_index = {name: i for i, name in enumerate(plain.resources)}
        self.free = {wid: list(amounts) for wid, amounts, _s in plain.workers}
        self.slots = {wid: slots for wid, _a, slots in plain.workers}
        self.running = {wid: {} for wid, _a, _s in plain.workers}
        self.backlog = {wid: {} for wid, _a, _s in plain.workers}
        self.held = {}      # task id -> (worker, amounts) while running
        self.queued = {}    # task id -> (worker, instance, amounts)
        self.started = 0    # tasks started
        self.finished = 0   # tasks finished
        self.fresh = []     # task ids started and not yet timed

    def amounts(self, msg):
        index = self.res_index
        return tuple((index[e["name"]], e["amount"]) for e in msg["entries"])

    def answer_compute(self, compute, prefilled):
        """A task sent to run starts; a prefilled one joins its worker's
        FIFO backlog."""
        for wid, msgs in compute:
            for m in msgs:
                tid = m["id"]
                if tid in prefilled:
                    self.backlog[wid][tid] = None
                    self.queued[tid] = (wid, m["instance"], self.amounts(m))
                else:
                    self.run(wid, tid, m["instance"], self.amounts(m))

    def run(self, wid, tid, instance, amounts):
        cell = self.cell
        cell.reactor.on_task_running(cell.core, cell.events, tid, instance)
        cell.log.append(("run", tid))
        free = self.free[wid]
        for rid, a in amounts:
            free[rid] -= a
        self.slots[wid] -= 1
        self.running[wid][tid] = None
        self.held[tid] = (wid, amounts)
        self.started += 1
        self.fresh.append(tid)

    def finish(self, tids):
        """Finishes the tasks; returns worker -> [room freed, slots]."""
        cell = self.cell
        released = {}
        for tid in tids:
            wid, amounts = self.held.pop(tid)
            del self.running[wid][tid]
            got = released.get(wid)
            if got is None:
                got = released[wid] = [[0] * len(self.free[wid]), 0]
            free = self.free[wid]
            for rid, a in amounts:
                free[rid] += a
                got[0][rid] += a
            got[1] += 1
            self.slots[wid] += 1
            task = cell.core.tasks[tid]
            cell.reactor.on_task_finished(cell.core, cell.comm, cell.events,
                                          tid, task.instance_id)
            cell.log.append(("finish", tid))
        self.finished += len(tids)
        return released

    def start_backlog(self, released):
        """Each worker starts its backlog in FIFO order while the next task
        fits the room its finished tasks freed (and its free resources and
        slots)."""
        for wid, (room, slots) in released.items():
            queued = self.backlog[wid]
            free = self.free[wid]
            while queued and slots > 0 and self.slots[wid] > 0:
                tid = next(iter(queued))
                _w, instance, amounts = self.queued[tid]
                if any(min(free[rid], room[rid]) < a for rid, a in amounts):
                    break
                for rid, a in amounts:
                    room[rid] -= a
                slots -= 1
                del queued[tid]
                del self.queued[tid]
                self.run(wid, tid, instance, amounts)

    def answer_retracts(self, retracts):
        """Ok while the task is still in the worker's backlog."""
        cell = self.cell
        for wid, refs in retracts:
            queued = self.backlog[wid]
            for tid, instance in refs:
                ok = tid in queued
                if ok:
                    del queued[tid]
                    del self.queued[tid]
                cell.reactor.on_retract_response(cell.core, cell.comm, tid,
                                                 ok, instance)
                cell.log.append(("answer", tid, ok))


def make_traffic(cell, mix, plain, seed):
    loop = importlib.import_module(f"hqbench.loops.{mix['loop']}")
    return loop.Loop(cell, mix, plain, seed)
