"""Replays a run's log against the reference and counts every difference.

The log holds, in order, what the benchmark did to the program and what
the program answered: each tick's compute messages, per worker (task,
instance, variant, whether the task went to the worker's backlog), and
its retracts, per worker (task, instance),
each task the workers started or finished, each retract answered, each
submit. The reference starts from the generated inputs, works out every
tick's decision again from its own record (reference/tick.py), compares,
then advances its record by what the program did, so that one wrong tick
is counted once and the ticks after it are still judged on their own.

Where the reference follows the program step by step: which of a
worker's backlog tasks of one priority a displacement gives back is not
prescribed, so the reference checks that count, priorities and candidates
agree and then takes the program's choice.

Numbers (each must be 0):
  counts_off   solve counts (class, priority, variant, worker) off
  map_off      solve-assigned tasks not the front of their queue
  prefill_off  prefilled tasks off (which task, worker, variant)
  retract_off  retracts off (displacement and rebalance)
  out_of_turn  tasks started twice, or started or finished unplaced
  state_off    end-state differences: each worker's free resources, slots,
               running and backlog sets, the ready count, and tasks lost
"""

from __future__ import annotations

from collections import Counter

from hqbench.reference.tick import READY, State


def _mismatches(a, b) -> int:
    n = max(len(a), len(b))
    return sum(1 for i in range(n)
               if i >= len(a) or i >= len(b) or a[i] != b[i])


def initial_state(plain) -> State:
    st = State(plain)
    n_local = {}
    for job, _cls, _prio, ids in plain.backlog:
        n_local[job] = max(n_local.get(job, 0), int(ids.max()))
    for job, cls, prio, ids in plain.backlog:
        st.submit(job, cls, prio, ids, n_local=n_local[job])
    return st


def replay(plain, log, end=None) -> dict:
    st = initial_state(plain)
    out = dict(counts_off=0, map_off=0, prefill_off=0, retract_off=0,
               out_of_turn=0, state_off=0, ticks=0)
    for entry in log:
        kind = entry[0]
        if kind == "tick":
            _tick(st, entry[1], entry[2], out)
        elif kind == "run":
            if not st.run(entry[1]):
                out["out_of_turn"] += 1
        elif kind == "finish":
            if not st.finish(entry[1]):
                out["out_of_turn"] += 1
        elif kind == "answer":
            st.answer(entry[1], entry[2])
        elif kind == "submit":
            _k, job, cls, user, n = entry
            st.submit(job, cls, user, range(1, n + 1))
    if end is not None:
        out["state_off"] = _end_state(st, end)
    return out


def _tick(st, sent, retracts, out):
    out["ticks"] += 1
    d = st.decide()
    ref, ref_counts, leftover = d.msgs, d.counts, d.leftover
    prog, prog_counts = {}, Counter()
    for wid, rows in sent:
        prog.setdefault(wid, []).extend(rows)
        for tid, _inst, variant, flag in rows:
            if not flag:
                try:
                    cls, prio = st.key_of(tid)
                except KeyError:
                    out["counts_off"] += 1
                    continue
                prog_counts[(cls, prio, variant, wid)] += 1
    keys = set(ref_counts) | set(prog_counts)
    out["counts_off"] += sum(abs(ref_counts.get(k, 0) - prog_counts.get(k, 0))
                             for k in keys)
    for wid in set(ref) | set(prog):
        a, b = prog.get(wid, []), ref.get(wid, [])
        out["map_off"] += _mismatches([x for x in a if not x[3]],
                                      [x for x in b if not x[3]])
        out["prefill_off"] += _mismatches([x for x in a if x[3]],
                                          [x for x in b if x[3]])
    if prog == ref:
        st.apply_decision(d)
    else:
        for wid, lst in prog.items():
            for tid, _inst, variant, flag in lst:
                t = st.tasks.get(tid)
                try:
                    cls, _prio = st.key_of(tid)
                    if ((t is not None and t[2] != READY)
                            or wid not in st.by_id
                            or not 0 <= variant < len(st.classes[cls])):
                        raise KeyError(tid)
                except KeyError:
                    # never submitted, not ready, or no such worker or
                    # variant: counted, and the record is left as it was
                    out["map_off"] += 1
                    continue
                st.apply_message(wid, tid, variant, flag)
    if st.ready > 0:
        disp, may = st.displacement(leftover, prog)
    else:
        disp, may = {}, {}
    k = len(disp)
    for wid, refs in retracts[:k]:
        want = list(disp.get(wid, ()))
        cand = may.get(wid, {})
        got = []
        for tid, inst in refs:
            t = st.tasks.get(tid)
            if tid not in cand or t is None or t[5] != inst:
                out["retract_off"] += 1
                continue
            got.append(cand.pop(tid))
            t[6] = True
        out["retract_off"] += sum(((Counter(want) - Counter(got))
                                   + (Counter(got) - Counter(want))).values())
    seen = {wid for wid, _r in retracts[:k]}
    out["retract_off"] += sum(len(v) for w, v in disp.items()
                              if w not in seen)
    want = st.rebalance(prog)
    got = retracts[k:]
    out["retract_off"] += _mismatches(
        [(w, r) for w, refs in want for r in refs],
        [(w, r) for w, refs in got for r in refs])
    for _wid, refs in got:
        for tid, _inst in refs:
            t = st.tasks.get(tid)
            if t is not None:
                t[6] = True


def _end_state(st, end) -> int:
    """Differences between the record and the program's state after the
    run: per worker free resources, slots, running and backlog sets; the
    ready count; and tasks neither ready, placed nor finished."""
    off = 0
    for w in st.workers:
        pw = end["workers"][w.wid]
        off += int(list(pw["free"]) != w.free)
        off += int(pw["nt"] != w.nt)
        off += len(set(pw["assigned"]) ^ w.assigned)
        off += len(set(pw["prefilled"]) ^ w.prefilled)
    off += abs(end["ready"] - st.ready)
    placed = sum(len(pw["assigned"]) + len(pw["prefilled"])
                 for pw in end["workers"].values())
    off += abs(st.submitted - (end["ready"] + placed + end["finished"]))
    return off
