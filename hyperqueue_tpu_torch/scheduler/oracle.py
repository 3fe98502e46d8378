"""Pure-Python reference implementation of the tick assignment semantics.

An independent, loop-based implementation of exactly the semantics the
cut-scan kernel (ops/assign.py) must satisfy. It is the executable spec for
golden tests (mirroring how the reference's tier-1 Rust tests encode
scheduler semantics) and is deliberately written in the dumbest possible
style — no vectorization — so a human can audit it against the reference's
solver behavior.
"""

from __future__ import annotations

from hyperqueue_tpu_torch.scheduler.decision import (
    REASON_GANG_GROUP_DEFERRED,
    REASON_GANG_INCOMPLETE,
    REASON_INSUFFICIENT_CAPACITY,
    REASON_NO_MATCHING_WORKER,
    REASON_SOLVER_DEFERRED,
    REASON_WORKER_LIFETIME,
)


def solve_oracle(free, nt_free, lifetime, needs, sizes, min_time, scarcity,
                 gang_nodes=None, gang_ok=None, group_ids=None,
                 affinity=None):
    """Same contract as ops.assign.greedy_cut_scan, lists/nested lists in,
    counts[b][v][w] out. Mutates nothing.

    Gang rows (all-or-nothing column groups, ops/assign.py scan_batches):
    gang_nodes[b] > 0 marks batch b as one multi-node gang; gang_ok[w] is
    host idleness and group_ids[w] the worker's group index. A gang row
    takes the first group with >= n still-untouched eligible members (the
    n lowest-index ones) and emits n counts in variant 0; feasible or not,
    the selected members are held (free/nt zeroed) for the rest of the
    scan, and any single-node assignment makes a worker ineligible for
    later gangs.

    affinity[b][w] (optional) is the policy weight matrix row per batch
    (scheduler/policy.py): workers are visited in (-affinity, waste, index)
    order — the same lexicographic key host_visit_classes encodes into
    visit classes — and a zero weight is a hard exclusion (the worker
    contributes no capacity and no gang membership for that batch).
    """
    n_w = len(free)
    n_r = len(free[0]) if n_w else 0
    free0 = [list(row) for row in free]  # visit order derives from this
    free = [list(row) for row in free]
    nt_free = list(nt_free)
    n_b = len(needs)
    n_v = len(needs[0]) if n_b else 0
    counts = [[[0] * n_w for _ in range(n_v)] for _ in range(n_b)]
    gang_avail = list(gang_ok) if gang_ok is not None else [0] * n_w
    n_g = (max(group_ids) + 1) if group_ids else 1

    for b in range(n_b):
        remaining = sizes[b]
        if gang_nodes is not None and gang_nodes[b] > 0:
            n = gang_nodes[b]
            per_group = [0] * n_g
            members: list[list[int]] = [[] for _ in range(n_g)]
            for w in range(n_w):
                if (
                    gang_avail[w]
                    and min_time[b][0] <= lifetime[w]
                    and nt_free[w] >= 1
                    and (affinity is None or affinity[b][w] > 0)
                ):
                    per_group[group_ids[w]] += 1
                    members[group_ids[w]].append(w)
            feasible = [g for g in range(n_g) if per_group[g] >= n]
            if feasible:
                chosen = feasible[0]
            else:
                chosen = per_group.index(max(per_group))
            for w in members[chosen][:n]:
                if feasible:
                    counts[b][0][w] = 1
                free[w] = [0] * n_r
                nt_free[w] = 0
                gang_avail[w] = 0
            continue
        for v in range(n_v):
            need = needs[b][v]
            if not any(x > 0 for x in need):
                continue  # absent variant
            # capacity per worker
            caps = []
            for w in range(n_w):
                if min_time[b][v] > lifetime[w]:
                    caps.append(0)
                    continue
                cap = nt_free[w]
                for r in range(n_r):
                    if need[r] > 0:
                        cap = min(cap, free[w][r] // need[r])
                caps.append(max(cap, 0))
            # worker order: policy affinity descending first (when active),
            # then scarcity-weighted waste of unrequested resources
            # (computed from the tick's INITIAL free state, like the kernel's
            # precomputed visit orders), then index
            def key(w):
                waste = sum(
                    scarcity[r]
                    for r in range(n_r)
                    if free0[w][r] > 0 and need[r] == 0
                )
                aff_q = (
                    0 if affinity is None
                    else round(affinity[b][w] * 65536)
                )
                return (-aff_q, round(waste * 65536), w)

            for w in sorted(range(n_w), key=key):
                if remaining <= 0:
                    break
                if affinity is not None and affinity[b][w] <= 0:
                    continue  # zero weight = hard exclusion
                take = min(caps[w], remaining)
                if take <= 0:
                    continue
                counts[b][v][w] = take
                remaining -= take
                nt_free[w] -= take
                gang_avail[w] = 0
                for r in range(n_r):
                    free[w][r] -= take * need[r]
    return counts


def explain_unplaced(
    free, nt_free, lifetime, needs, sizes, min_time, counts, total=None,
    gang_nodes=None, gang_ok=None, group_ids=None,
):
    """Reference classifier for WHY each batch's remainder stayed unplaced.

    The executable spec for scheduler/decision.classify_class, in the same
    deliberately dumb loop style as solve_oracle: given the tick's dense
    inputs and the solver's counts, return one reason string per batch
    (None for fully placed batches). `total` is the worker TOTAL capacity
    matrix (defaults to the tick-start `free`, which equals totals on an
    empty cluster snapshot). Gang rows (gang_nodes[b] > 0) classify as
    gang-incomplete when NO group could ever muster n lifetime-capable
    members, else gang-group-deferred (members exist but were busy or held
    this tick). Mutates nothing.
    """
    n_w = len(free)
    n_r = len(free[0]) if n_w else 0
    n_b = len(needs)
    n_v = len(needs[0]) if n_b else 0
    if total is None:
        total = free
    # replay the assignments onto a scratch copy: the post-solve free state
    # decides insufficient-capacity vs solver-deferred
    post_free = [list(row) for row in free]
    post_nt = list(nt_free)
    for b in range(n_b):
        for v in range(n_v):
            for w in range(n_w):
                take = counts[b][v][w]
                if take > 0:
                    post_nt[w] -= take
                    for r in range(n_r):
                        post_free[w][r] -= take * needs[b][v][r]

    reasons = []
    n_g = (max(group_ids) + 1) if group_ids else 1
    for b in range(n_b):
        placed = sum(
            counts[b][v][w] for v in range(n_v) for w in range(n_w)
        )
        if gang_nodes is not None and gang_nodes[b] > 0:
            # all-or-nothing: the kernel emits either n counts or none
            if placed > 0:
                reasons.append(None)
                continue
            n = gang_nodes[b]
            per_group = [0] * n_g
            for w in range(n_w):
                if min_time[b][0] <= lifetime[w]:
                    per_group[group_ids[w]] += 1
            reasons.append(
                REASON_GANG_GROUP_DEFERRED
                if max(per_group, default=0) >= n
                else REASON_GANG_INCOMPLETE
            )
            continue
        if placed >= sizes[b]:
            reasons.append(None)
            continue
        present = [
            v for v in range(n_v) if any(x > 0 for x in needs[b][v])
        ]
        amount_capable = False
        lifetime_capable = False
        fits_now = False
        for w in range(n_w):
            for v in present:
                if all(
                    total[w][r] >= needs[b][v][r] for r in range(n_r)
                ):
                    amount_capable = True
                    if min_time[b][v] <= lifetime[w]:
                        lifetime_capable = True
                        if post_nt[w] >= 1 and all(
                            post_free[w][r] >= needs[b][v][r]
                            for r in range(n_r)
                        ):
                            fits_now = True
        if not amount_capable:
            reasons.append(REASON_NO_MATCHING_WORKER)
        elif not lifetime_capable:
            reasons.append(REASON_WORKER_LIFETIME)
        elif fits_now:
            reasons.append(REASON_SOLVER_DEFERRED)
        else:
            reasons.append(REASON_INSUFFICIENT_CAPACITY)
    return reasons
