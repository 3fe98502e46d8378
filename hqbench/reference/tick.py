"""The server's tick in plain Python and NumPy: what one call of the
scheduler must decide, worked out again from the benchmark's own record of
the cluster (each worker's resources, what it runs and holds in backlog,
the ready tasks of each request class and priority in submission order).

The semantics, tick by tick (the port's `server/reactor.schedule`, its
`scheduler/tick` and its `ops/assign` solve, without gangs, policies,
pipelining and min-utilization workers, which the cells do not use):

1. Batches: per request class, each user/scheduler priority level with
   ready tasks is a batch, at most 32 a class (the tail merged into the
   32nd, which takes from its own level only); batches go in descending
   priority, then ascending class.
2. The solve: every worker is a row, in id order. Batches are solved in
   descending priority, within one priority the most constrained class
   first (the largest scarcity of its least scarce variant), then the
   largest achievable share of the cluster, then the smaller per-task
   share; amounts of 2**23 or more are shifted down (needs rounded up,
   free rounded down). The counts come from the cut-scan
   (reference/cut_scan.py).
3. The mapping: counts in (batch, variant, worker) order take tasks from
   the front of their level, first those that came back from a worker,
   then the submitted ones in order.
4. Prefill: workers that run or hold something get up to 512 queued tasks
   of the leftover batches (descending priority, then ascending class),
   each batch split fairly over the workers that can run it, least
   backlog first; each leftover class reserves the first capable worker
   for tasks of its priority or higher.
5. Retracts: while ready tasks remain, each worker gives back up to twice
   the tasks of a higher user priority batch it could run at once, from
   its lowest-priority backlog (displacement); where a worker is idle, the
   fullest backlogs give back up to half, oldest first, as far as the idle
   workers' slots take them (rebalance).
"""

from __future__ import annotations

import numpy as np

from hqbench.reference.cut_scan import cut_scan, scarcity_weights

TASK_ID_BITS = 32
TASK_ID_MASK = (1 << TASK_ID_BITS) - 1
MAX_CUTS_PER_QUEUE = 32
PREFILL_MAX = 512
MAX_SAFE_AMOUNT = 2**23
BLEVEL_STRIDE = 1 << 20
BLEVEL_MAX = 1 << 16
FRACTIONS_PER_UNIT = 10_000
TASK_MAX_COUNT_CAP = 1_000_000

READY, ASSIGNED, PREFILLED, RUNNING, FINISHED = range(5)


def sched_priority(job: int) -> int:
    """The scheduler part of a task's priority: older jobs first."""
    return -(job * BLEVEL_STRIDE + BLEVEL_MAX)


class Level:
    """One (class, priority) FIFO: tasks given back first, then the
    submitted ones in order. `gone` holds ids taken out of order."""

    __slots__ = ("back", "lazy", "pos", "gone", "count")

    def __init__(self):
        self.back = []
        self.lazy = []
        self.pos = 0
        self.gone = set()
        self.count = 0

    def extend(self, ids):
        self.lazy.extend(ids)
        self.count += len(ids)

    def peek(self, start: int, n: int) -> list:
        """Up to n ids from position `start` of the FIFO."""
        out = []
        if n <= 0:
            return out
        gone = self.gone
        skip = start
        for tid in self.back:
            if tid in gone:
                continue
            if skip:
                skip -= 1
                continue
            out.append(tid)
            if len(out) == n:
                return out
        i = self.pos
        lazy = self.lazy
        if not gone:
            i += skip
            return out + lazy[i:i + n - len(out)]
        while i < len(lazy) and len(out) < n:
            tid = lazy[i]
            i += 1
            if tid in gone:
                continue
            if skip:
                skip -= 1
                continue
            out.append(tid)
        return out

    def pop_front(self, n: int) -> None:
        """Takes the first n ids out (none of them taken out of order)."""
        k = min(n, len(self.back))
        del self.back[:k]
        self.pos += n - k
        self.count -= n

    def remove(self, tid: int) -> None:
        """Takes one id out (from the front, where a sound tick takes)."""
        if self.back and self.back[0] == tid:
            self.back.pop(0)
        elif (not self.back and self.pos < len(self.lazy)
              and self.lazy[self.pos] == tid):
            self.pos += 1
            while (self.gone and self.pos < len(self.lazy)
                   and self.lazy[self.pos] in self.gone):
                self.gone.discard(self.lazy[self.pos])
                self.pos += 1
        else:
            self.gone.add(tid)
        self.count -= 1


class Decision:
    """A tick's decision: `msgs` {worker: [(task, instance, variant,
    prefilled)]} in the order sent, the solve's `counts` {(class,
    priority, variant, worker): n}, the `leftover` batches [class,
    priority, size] after prefill, and the ids `taken` from each level
    with each id's level (`keys`)."""

    __slots__ = ("msgs", "counts", "leftover", "taken", "keys")

    def __init__(self, msgs, counts, leftover, taken, keys):
        self.msgs, self.counts, self.leftover = msgs, counts, leftover
        self.taken, self.keys = taken, keys


class Worker:
    __slots__ = ("wid", "total", "free", "nt", "assigned", "prefilled",
                 "users", "row")

    def __init__(self, wid, total, slots, row):
        self.wid = wid
        self.total = list(total)
        self.free = list(total)
        self.nt = slots
        self.assigned = set()
        self.prefilled = set()
        self.users = {}  # user priority -> backlog tasks of it
        self.row = row

    def hold(self, tid, user):
        self.prefilled.add(tid)
        self.users[user] = self.users.get(user, 0) + 1

    def drop(self, tid, user):
        if tid in self.prefilled:
            self.prefilled.discard(tid)
            self.users[user] -= 1
            if not self.users[user]:
                del self.users[user]


class State:
    """The benchmark's record of the cluster, advanced by the run's log."""

    def __init__(self, plain):
        self.resources = plain.resources
        self.n_r = len(plain.resources)
        rid = {name: i for i, name in enumerate(plain.resources)}
        # per class, per variant: [(resource id, amount)]
        self.classes = [[[(rid[name], int(a)) for name, a in variant]
                         for variant in variants]
                        for variants in plain.classes]
        self.n_v = max(len(v) for v in self.classes)
        self.workers = [Worker(wid, total, slots, row) for row, (
            wid, total, slots) in enumerate(plain.workers)]
        self.by_id = {w.wid: w for w in self.workers}
        totals = np.array([w.total for w in self.workers], dtype=np.int64)
        self.capable = []      # per class: (W,) first capable variant or -1
        self.fit = []          # per class: (W,) tasks it runs at once
        slots_cap = np.minimum(
            (np.maximum(totals, 0) // FRACTIONS_PER_UNIT).sum(axis=1),
            TASK_MAX_COUNT_CAP)
        for variants in self.classes:
            first = np.full(len(self.workers), -1, dtype=np.int64)
            best = np.zeros(len(self.workers), dtype=np.int64)
            for vi, variant in enumerate(variants):
                ok = np.ones(len(self.workers), dtype=bool)
                fit = None
                for r, a in variant:
                    ok &= totals[:, r] >= a
                    c = totals[:, r] // a
                    fit = c if fit is None else np.minimum(fit, c)
                if fit is None:
                    fit = np.maximum(slots_cap, 1)
                first[(first < 0) & ok] = vi
                best = np.maximum(best, fit)
            self.capable.append(first)
            self.fit.append(np.maximum(best, 1))
        self.levels: dict = {}   # (class, (user, sched)) -> Level
        self.by_class: dict = {}  # class -> set of priorities with a Level
        # task id -> [class, priority, state, worker, variant, instance,
        #             retract pending]
        self.tasks: dict = {}
        self.ready = 0
        self.submitted = 0
        # job -> its (class, priority), or per local id (class, user) arrays
        self.job_keys: dict = {}

    # -- submits -----------------------------------------------------------
    def level(self, cls, prio):
        key = (cls, prio)
        lv = self.levels.get(key)
        if lv is None:
            lv = self.levels[key] = Level()
            self.by_class.setdefault(cls, set()).add(prio)
        return lv

    def submit(self, job, cls, user, ids, n_local=None):
        """Tasks `ids` (job-local, ascending) of one class and user
        priority join the back of their level. A job of several classes
        gives `n_local`, its largest local id."""
        prio = (int(user), sched_priority(job))
        ids = np.asarray(ids, dtype=np.int64)
        self.level(cls, prio).extend(((job << TASK_ID_BITS) | ids).tolist())
        self.ready += len(ids)
        self.submitted += len(ids)
        if n_local is None:
            self.job_keys[job] = (cls, prio)
            return
        keys = self.job_keys.get(job)
        if keys is None:
            keys = self.job_keys[job] = (
                np.full(n_local + 1, -1, dtype=np.int64),
                np.zeros(n_local + 1, dtype=np.int64))
        keys[0][ids] = cls
        keys[1][ids] = user

    def key_of(self, tid):
        t = self.tasks.get(tid)
        if t is not None:
            return t[0], t[1]
        job, local = tid >> TASK_ID_BITS, tid & TASK_ID_MASK
        keys = self.job_keys.get(job)
        if keys is None:
            raise KeyError(f"task {tid} was never submitted")
        if isinstance(keys[0], int):
            return keys
        if local >= len(keys[0]) or keys[0][local] < 0:
            raise KeyError(f"task {tid} was never submitted")
        return (int(keys[0][local]),
                (int(keys[1][local]), sched_priority(job)))

    # -- what a tick must decide -------------------------------------------
    def batches(self):
        """[(class, priority, size)] in descending priority, then ascending
        class; at most 32 cuts a class."""
        out = []
        for cls, prios in self.by_class.items():
            sizes = sorted(((p, self.levels[(cls, p)].count) for p in prios
                            if self.levels[(cls, p)].count > 0),
                           reverse=True)
            if len(sizes) > MAX_CUTS_PER_QUEUE:
                head = sizes[:MAX_CUTS_PER_QUEUE - 1]
                tail = sum(n for _p, n in sizes[MAX_CUTS_PER_QUEUE - 1:])
                sizes = head + [(sizes[MAX_CUTS_PER_QUEUE - 1][0], tail)]
            out.extend((cls, p, n) for p, n in sizes)
        out.sort(key=lambda b: (b[1], -b[0]), reverse=True)
        return out

    def solve_order(self, batches, free):
        """The batches in the solve's order (a stable sort of `batches`)."""
        n_w = len(self.workers)
        tot = np.maximum(free, 0).sum(axis=0)
        weights = scarcity_weights(tot)
        totals = tot.tolist()
        keys = {}
        for cls in {b[0] for b in batches}:
            scarcity = float("inf")
            per_variant = []
            for variant in self.classes[cls]:
                v_score = 0.0
                share = 0.0
                fit = float("inf")
                for r, a in variant:
                    s = float(weights[r])
                    if s > v_score:
                        v_score = s
                for r, a in variant:
                    if totals[r] <= 0:
                        fit = 0.0
                        break
                    share += a / totals[r]
                    fit = min(fit, totals[r] // a)
                if fit == float("inf"):
                    fit = 0.0
                per_variant.append((1.0 * share, fit))
                scarcity = min(scarcity, v_score)
            keys[cls] = (0.0 if scarcity == float("inf") else scarcity,
                         per_variant)
        del n_w

        def key(b):
            cls, prio, size = b
            scarcity, per_variant = keys[cls]
            best = (0.0, 0.0)
            for value, fit in per_variant:
                cand = (value * (size if size < fit else fit), -value)
                if cand > best:
                    best = cand
            return ((prio[0], 0, prio[1]), scarcity, best)

        return sorted(batches, key=key, reverse=True)

    def decide(self):
        """What the next tick must send (a Decision). Reads the state
        only."""
        workers = self.workers
        n_w, n_r = len(workers), self.n_r
        free = np.array([w.free for w in workers], dtype=np.int64)
        nt = np.array([max(w.nt, 0) for w in workers], dtype=np.int64)
        msgs: dict = {}
        taken: dict = {}   # level key -> ids taken this tick (peek offset)
        keys: dict = {}    # task id -> its level key
        assigned_n = [len(w.assigned) for w in workers]
        batches = self.batches()
        solve_counts = {}
        leftover = None
        if batches and self.ready:
            order = self.solve_order(batches, free)
            needs = np.zeros((len(order), self.n_v, n_r), dtype=np.int64)
            for bi, (cls, _p, _n) in enumerate(order):
                for vi, variant in enumerate(self.classes[cls]):
                    for r, a in variant:
                        needs[bi, vi, r] = a
            sizes = np.array([min(n, 2**30) for _c, _p, n in order],
                             dtype=np.int64)
            sfree = free.copy()
            for r in range(n_r):
                peak = max(int(sfree[:, r].max(initial=0)),
                           int(needs[:, :, r].max(initial=0)))
                shift = 0
                while (peak >> shift) >= MAX_SAFE_AMOUNT:
                    shift += 1
                if shift:
                    nz = needs[:, :, r] > 0
                    needs[:, :, r] = np.where(
                        nz, np.maximum((needs[:, :, r] + (1 << shift) - 1)
                                       >> shift, 1), 0)
                    sfree[:, r] >>= shift
            counts = cut_scan(sfree, nt, needs, sizes)
            bs, vs, ws = np.nonzero(counts)
            for bi, vi, wi in zip(bs.tolist(), vs.tolist(), ws.tolist()):
                n = int(counts[bi, vi, wi])
                cls, prio, _size = order[bi]
                key = (cls, prio)
                lv = self.levels[key]
                off = taken.get(key, 0)
                ids = lv.peek(off, n)
                taken[key] = off + len(ids)
                keys.update(dict.fromkeys(ids, key))
                w = workers[wi]
                if not ids:
                    continue
                solve_counts[(cls, prio, vi, w.wid)] = len(ids)
                out = msgs.setdefault(w.wid, [])
                for tid in ids:
                    out.append((tid, self.instance(tid), vi, False))
                for r, a in self.classes[cls][vi]:
                    free[wi, r] -= a * len(ids)
                nt[wi] -= len(ids)
                assigned_n[wi] += len(ids)
            leftover = [[cls, prio, n - taken.get((cls, prio), 0)]
                        for cls, prio, n in batches]
            leftover = [b for b in leftover if b[2] > 0]
        ready_left = self.ready - sum(taken.values())
        prefill_n = [len(w.prefilled) for w in workers]
        if ready_left:
            if leftover is None:
                leftover = [list(b) for b in batches]
            self._prefill(leftover, msgs, taken, keys, assigned_n, prefill_n)
            ready_left = self.ready - sum(taken.values())
        return Decision(msgs, solve_counts, leftover, taken, keys)

    def instance(self, tid):
        t = self.tasks.get(tid)
        return 0 if t is None else t[5]

    def _prefill(self, leftover, msgs, taken, keys, assigned_n, prefill_n):
        workers = self.workers
        budgets = {}
        for i, w in enumerate(workers):
            if (assigned_n[i] or prefill_n[i]) and prefill_n[i] < PREFILL_MAX:
                budgets[i] = PREFILL_MAX - prefill_n[i]
        reservations = {}
        for cls, prio, _n in leftover:
            capable = self.capable[cls]
            for i in range(len(workers)):
                if i in reservations:
                    continue
                if capable[i] >= 0:
                    reservations[i] = prio
                    break
        by_backlog = sorted(range(len(workers)), key=lambda i: (
            prefill_n[i] + assigned_n[i], workers[i].wid))
        for batch in leftover:
            cls, prio, size = batch
            key = (cls, prio)
            lv = self.levels[key]
            capable = self.capable[cls]
            eligible = []
            for i in by_backlog:
                if budgets.get(i, 0) <= 0:
                    continue
                blocking = reservations.get(i)
                if blocking is not None and prio < blocking:
                    continue
                if capable[i] < 0:
                    continue
                eligible.append(i)
            if not eligible:
                continue
            fair = max(-(-size // len(eligible)), 1)
            progress = True
            while progress:
                progress = False
                for i in eligible:
                    budget = budgets.get(i, 0)
                    if budget <= 0:
                        continue
                    off = taken.get(key, 0)
                    ids = lv.peek(off, min(budget, fair))
                    if not ids:
                        break
                    progress = True
                    taken[key] = off + len(ids)
                    keys.update(dict.fromkeys(ids, key))
                    batch[2] -= len(ids)
                    budgets[i] -= len(ids)
                    prefill_n[i] += len(ids)
                    v = int(capable[i])
                    out = msgs.setdefault(workers[i].wid, [])
                    for tid in ids:
                        out.append((tid, self.instance(tid), v, True))

    def displacement(self, leftover, msgs):
        """Per worker the user priorities of the backlog it must give back,
        lowest first, and the tasks it may give: ({worker: [user
        priority]}, {worker: {task: user priority}}), with this tick's
        messages applied to the state. Which of the tasks of one priority
        goes back is not prescribed. Reads the state only."""
        victims = {}
        may = {}
        top = max((prio[0] for _c, prio, size in leftover if size > 0),
                  default=None)
        if top is None:
            return {}, may
        for w in self.workers:
            # a task of the highest leftover user priority or above is
            # never given back: skip a backlog that holds no other
            if not w.users or min(w.users) >= top:
                continue
            sent = {m[0] for m in msgs.get(w.wid, ())}
            tasks = self.tasks
            cand = {tid: tasks[tid][1][0] for tid in w.prefilled
                    if tasks[tid][1][0] < top and tid not in sent
                    and not tasks[tid][6]}
            if cand:
                may[w.wid] = cand
                victims[w.wid] = sorted(
                    (self.tasks[tid][1] for tid in cand), reverse=True)
        out = {}
        if not victims:
            return out, may
        budget = dict.fromkeys(victims, PREFILL_MAX)
        row = {w.wid: w.row for w in self.workers}
        for cls, prio, size in leftover:
            if size <= 0:
                continue
            need = size
            capable, fit = self.capable[cls], self.fit[cls]
            for wid, vs in victims.items():
                if need <= 0:
                    break
                if not vs or budget[wid] <= 0:
                    continue
                i = row[wid]
                if capable[i] < 0:
                    continue
                allowance = min(budget[wid], 2 * int(fit[i]))
                while vs and need > 0 and allowance > 0:
                    if vs[-1][0] >= prio[0]:
                        break
                    out.setdefault(wid, []).append(vs.pop()[0])
                    need -= 1
                    allowance -= 1
                    budget[wid] -= 1
        return out, may

    def rebalance(self, msgs):
        """[(worker, [(task, instance)])] of the rebalance retracts, with
        this tick's messages and displacement applied to the state. Reads
        the state only."""
        workers = self.workers
        idle = [w for w in workers
                if not w.assigned and not w.prefilled and w.wid not in msgs]
        out = []
        if not idle:
            return out
        donors = sorted((w for w in workers if w.prefilled),
                        key=lambda w: -len(w.prefilled))
        class_slots = {}

        def slots_for(cls):
            s = class_slots.get(cls)
            if s is None:
                capable = self.capable[cls]
                s = class_slots[cls] = sum(
                    w.nt for w in idle if capable[w.row] >= 0)
            return s

        for donor in donors:
            sent = {m[0] for m in msgs.get(donor.wid, ())}
            victims = []
            budget = len(donor.prefilled) // 2
            for tid in sorted(donor.prefilled):
                if len(victims) >= budget:
                    break
                t = self.tasks[tid]
                if tid in sent or t[6]:
                    continue
                if slots_for(t[0]) <= 0:
                    continue
                class_slots[t[0]] -= 1
                victims.append((tid, t[5]))
            if victims:
                out.append((donor.wid, victims))
        return out

    # -- what happened -----------------------------------------------------
    def apply_decision(self, d: Decision):
        """Advances the state by a tick that sent exactly `d.msgs`."""
        for key, n in d.taken.items():
            lv = self.levels[key]
            if lv.gone:
                for tid in lv.peek(0, n):
                    lv.remove(tid)
            else:
                lv.pop_front(n)
            self.ready -= n
        tasks, keys = self.tasks, d.keys
        for wid, lst in d.msgs.items():
            w = self.by_id[wid]
            for tid, _inst, variant, prefilled in lst:
                cls, prio = keys[tid]
                t = tasks.get(tid)
                if t is None:
                    t = tasks[tid] = [cls, prio, READY, 0, 0, 0, False]
                t[3], t[4] = wid, variant
                if prefilled:
                    t[2] = PREFILLED
                    w.hold(tid, prio[0])
                else:
                    t[2] = ASSIGNED
                    self._assign(w, tid, cls, variant)

    def apply_message(self, wid, tid, variant, prefilled):
        cls, prio = self.key_of(tid)
        self.levels[(cls, prio)].remove(tid)
        self.ready -= 1
        t = self.tasks.get(tid)
        if t is None:
            t = self.tasks[tid] = [cls, prio, READY, 0, 0, 0, False]
        w = self.by_id[wid]
        t[3], t[4] = wid, variant
        if prefilled:
            t[2] = PREFILLED
            w.hold(tid, prio[0])
        else:
            t[2] = ASSIGNED
            self._assign(w, tid, cls, variant)

    def _assign(self, w, tid, cls, variant):
        for r, a in self.classes[cls][variant]:
            w.free[r] -= a
        w.nt -= 1
        w.assigned.add(tid)

    def run(self, tid):
        """A task starts; returns False where it had started before or was
        never placed."""
        t = self.tasks.get(tid)
        if t is None or t[2] in (READY, RUNNING, FINISHED):
            return False
        w = self.by_id[t[3]]
        if t[2] == PREFILLED:
            w.drop(tid, t[1][0])
            self._assign(w, tid, t[0], t[4])
            t[6] = False
        t[2] = RUNNING
        return True

    def finish(self, tid):
        """A task finishes; returns False where the record does not hold
        it as placed."""
        t = self.tasks.get(tid)
        if t is None or t[2] not in (ASSIGNED, PREFILLED, RUNNING):
            return False
        w = self.by_id[t[3]]
        if t[2] == PREFILLED:
            w.drop(tid, t[1][0])
        elif tid in w.assigned:
            w.assigned.discard(tid)
            for r, a in self.classes[t[0]][t[4]]:
                w.free[r] += a
            w.nt += 1
        t[2] = FINISHED
        return True

    def answer(self, tid, ok):
        t = self.tasks.get(tid)
        if t is None or t[2] != PREFILLED or not t[6]:
            return
        t[6] = False
        if not ok:
            return
        self.by_id[t[3]].drop(tid, t[1][0])
        t[2], t[3] = READY, 0
        t[5] += 1
        self.level(t[0], t[1]).back.append(tid)
        self.levels[(t[0], t[1])].count += 1
        self.ready += 1

