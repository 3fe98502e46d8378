"""Worker-side resource pools and allocator.

Reference: crates/tako/src/internal/worker/resources/{pool.rs,allocator.rs} —
pools hold concrete indices (non-fungible), possibly partitioned into NUMA
groups, or a fungible sum; allocations claim whole indices plus at most one
fractional share, and the claimed indices surface to tasks as
HQ_RESOURCE_VALUES_<name> env vars.

Policies (reference pool.rs:164-456):
  compact  — prefer few groups (best effort)
  compact! — must use the minimal possible number of groups
  tight    — prefer the groups that end up most fully used
  tight!   — strict version of tight
  scatter  — spread across groups round-robin
  all      — claim every free index of the resource
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT
from hyperqueue_tpu_torch.resources.descriptor import (
    DescriptorKind,
    ResourceDescriptor,
)
from hyperqueue_tpu_torch.resources.request import AllocationPolicy

# Policies whose group choice participates in the joint group solve
# (reference request.rs:64 is_relevant_for_coupling: scatter and all are not).
_COUPLING_POLICIES = frozenset(
    {
        AllocationPolicy.COMPACT,
        AllocationPolicy.FORCE_COMPACT,
        AllocationPolicy.TIGHT,
        AllocationPolicy.FORCE_TIGHT,
    }
)
_FORCED_POLICIES = frozenset(
    {AllocationPolicy.FORCE_COMPACT, AllocationPolicy.FORCE_TIGHT}
)

# Keep the exhaustive subset enumeration bounded (reference caps the fast
# path at FAST_MAX_GROUPS=8 groups and 3 coupled resources, pool.rs:57-58).
_MAX_SOLVER_GROUPS = 12


def group_solver(
    states: list[list[tuple[int, int]]],
    requests: list[tuple[int, int]],
    weights: list[tuple[int, int, int, int, float]],
) -> tuple[list[list[int]], float] | None:
    """Exact NUMA group selection: which groups each coupled resource draws
    from, maximizing the reference's MILP objective via depth-first
    branch-and-bound (the reference solves the identical model with an LP
    solver, worker/resources/groups.rs:19-61).

    states[i]   per group j of resource i: (whole_free_units f_ij,
                max_partial_fraction g_ij)
    requests[i] (whole_units r_i, fraction z_i) requested of resource i
    weights     (i1, j1, i2, j2, w): affinity bonus if group j1 of resource
                i1 AND group j2 of resource i2 are both selected

    Objective per selected group (groups.rs:59-62): -1024 tax per group (so
    group count is minimized first), minus f/32 for whole-unit requests
    (prefer emptier-tail groups), plus g/(U/16) when the group holds a
    partial index large enough to donate the fractional part; plus the
    coupling weights of co-selected pairs.

    Returns (selected group indices per resource, objective) or None if
    infeasible / too large for exact search.
    """
    n = len(states)
    subsets: list[list[tuple[float, int]]] = []  # per resource: (value, mask)
    for state, (units, fraction) in zip(states, requests):
        n_groups = len(state)
        if n_groups > _MAX_SOLVER_GROUPS:
            return None
        vals = []
        for f, g in state:
            if fraction == 0:
                vals.append(-1024.0 - f / 32.0)
            elif g >= fraction:
                vals.append(-1024.0 + g / (FRACTIONS_PER_UNIT / 16.0))
            else:
                vals.append(-1024.0)
        feasible: list[tuple[float, int]] = []
        for mask in range(1, 1 << n_groups):
            whole = 0
            eff = 0  # whole units + donor bonus (groups.rs:105-112)
            value = 0.0
            for j in range(n_groups):
                if mask >> j & 1:
                    f, g = state[j]
                    whole += f
                    eff += f + (1 if fraction and g >= fraction else 0)
                    value += vals[j]
            if fraction == 0:
                ok = whole >= units
            else:
                ok = eff >= units + 1 and whole >= units
            if ok:
                feasible.append((value, mask))
        if not feasible:
            return None
        # best value first; ties broken toward lower group indices
        feasible.sort(key=lambda t: (-t[0], t[1]))
        subsets.append(feasible)

    # bound: best subset value for the remaining resources plus every weight
    # that could still apply
    best_tail = [0.0] * (n + 1)
    for i in range(n - 1, -1, -1):
        best_tail[i] = best_tail[i + 1] + subsets[i][0][0]
    weight_by_hi = [0.0] * n  # weights whose higher resource index is i
    for i1, _j1, i2, _j2, w in weights:
        if w > 0:
            weight_by_hi[max(i1, i2)] += w
    weight_tail = [0.0] * (n + 1)
    for i in range(n - 1, -1, -1):
        weight_tail[i] = weight_tail[i + 1] + weight_by_hi[i]

    best_obj = -float("inf")
    best_masks: list[int] | None = None
    chosen = [0] * n

    def dfs(i: int, acc: float) -> None:
        nonlocal best_obj, best_masks
        if i == n:
            if acc > best_obj:
                best_obj = acc
                best_masks = chosen[:]
            return
        if acc + best_tail[i] + weight_tail[i] <= best_obj:
            return
        for value, mask in subsets[i]:
            bonus = 0.0
            for i1, j1, i2, j2, w in weights:
                hi, lo = (i1, i2) if i1 > i2 else (i2, i1)
                hj, lj = (j1, j2) if i1 > i2 else (j2, j1)
                if hi == i and lo <= i:
                    sel_lo = mask if lo == i else chosen[lo]
                    sel_hi = mask
                    if sel_hi >> hj & 1 and sel_lo >> lj & 1:
                        bonus += w
            chosen[i] = mask
            dfs(i + 1, acc + value + bonus)
        chosen[i] = 0

    dfs(0, 0.0)
    if best_masks is None:
        return None
    return (
        [
            [j for j in range(len(states[i])) if best_masks[i] >> j & 1]
            for i in range(n)
        ],
        best_obj,
    )


@dataclass
class ResourceClaim:
    resource: str
    indices: list[str]                       # fully claimed indices
    fraction_index: str | None = None        # index claimed fractionally
    fraction: int = 0
    sum_amount: int = 0                      # for SUM pools

    def amount(self) -> int:
        return (
            len(self.indices) * FRACTIONS_PER_UNIT
            + self.fraction
            + self.sum_amount
        )

    def env_value(self) -> str:
        labels = list(self.indices)
        if self.fraction_index is not None:
            labels.append(self.fraction_index)
        return ",".join(labels)


@dataclass
class Allocation:
    claims: list[ResourceClaim] = field(default_factory=list)

    def claim_for(self, resource: str) -> ResourceClaim | None:
        for claim in self.claims:
            if claim.resource == resource:
                return claim
        return None


class _IndexPool:
    """Pool of concrete indices in groups; tracks full and fractional use."""

    def __init__(self, groups: list[list[str]]):
        self.groups = groups
        self.group_of: dict[str, int] = {}
        for gi, group in enumerate(groups):
            for label in group:
                self.group_of[label] = gi
        self.free: list[str] = [label for group in groups for label in group]
        # partially claimed: label -> remaining fraction (0..FRACTIONS)
        self.partial: dict[str, int] = {}

    def total_free(self) -> int:
        return len(self.free) * FRACTIONS_PER_UNIT + sum(self.partial.values())

    def capacity(self) -> int:
        return sum(len(g) for g in self.groups) * FRACTIONS_PER_UNIT

    def group_free_state(self) -> list[tuple[int, int]]:
        """(whole_free_units, max_partial_fraction) per group — the f/g
        columns of the group solver (reference concise.rs amount_max_per_group)."""
        whole = [0] * len(self.groups)
        for label in self.free:
            whole[self.group_of[label]] += 1
        frac = [0] * len(self.groups)
        for label, remaining in self.partial.items():
            gi = self.group_of[label]
            if remaining > frac[gi]:
                frac[gi] = remaining
        return list(zip(whole, frac))

    def group_full_state(self) -> list[tuple[int, int]]:
        """Group state of a completely empty worker (for the forced-policy
        optimality baseline, reference allocator.rs:152-166)."""
        return [(len(g), 0) for g in self.groups]

    def _group_free_count(self) -> dict[int, int]:
        counts = {gi: 0 for gi in range(len(self.groups))}
        for label in self.free:
            counts[self.group_of[label]] += 1
        return counts

    def _ordered_free(
        self,
        policy: AllocationPolicy,
        n_units: int,
        preferred_groups: set[int] | None = None,
    ) -> list[str]:
        """Free indices ordered so the first n_units match the policy.

        preferred_groups (coupling, reference descriptor.rs:249-295 +
        worker groups.rs): groups already used by coupled resources of the
        same allocation sort first, so e.g. the claimed cpus land on the NUMA
        node of the claimed gpu.
        """
        counts = self._group_free_count()
        if preferred_groups:
            pref = lambda l: 0 if self.group_of[l] in preferred_groups else 1  # noqa: E731
        else:
            pref = lambda l: 0  # noqa: E731
        if policy in (AllocationPolicy.SCATTER,):
            # round-robin across groups
            by_group: dict[int, list[str]] = {}
            for label in self.free:
                by_group.setdefault(self.group_of[label], []).append(label)
            out: list[str] = []
            while any(by_group.values()):
                for gi in sorted(by_group):
                    if by_group[gi]:
                        out.append(by_group[gi].pop(0))
            return out
        if policy in (
            AllocationPolicy.TIGHT,
            AllocationPolicy.FORCE_TIGHT,
        ):
            # prefer groups with the FEWEST free indices (fill them up)
            return sorted(
                self.free,
                key=lambda l: (pref(l), counts[self.group_of[l]],
                               self.group_of[l], l),
            )
        # compact/default: when some group can hold the whole request,
        # BEST-FIT — the tightest such group first, preserving large holes
        # for future big requests (reference test_pool_compact1: two 3-cpu
        # tasks share one socket while an untouched one stays whole).
        # When no group fits, span as few groups as possible by taking
        # the fullest-free groups first.
        fits = any(c >= n_units for c in counts.values())

        def group_key(gi: int) -> tuple:
            c = counts[gi]
            if fits:
                # groups that fit, tightest first; too-small groups last
                return (0, c) if c >= n_units else (1, -c)
            return (0, -c)

        return sorted(
            self.free,
            key=lambda l: (pref(l), group_key(self.group_of[l]),
                           self.group_of[l], l),
        )

    def allocate(
        self,
        amount: int,
        policy: AllocationPolicy,
        preferred_groups: set[int] | None = None,
        group_mask: set[int] | None = None,
    ) -> ResourceClaim | None:
        """group_mask: restrict the claim to these groups — the group solver
        already made the group decision (reference pool.rs
        claim_resources_with_group_mask)."""
        if policy is AllocationPolicy.ALL:
            if self.partial or not self.free:
                return None
            claim = ResourceClaim(resource="", indices=list(self.free))
            self.free.clear()
            return claim
        units, fraction = divmod(amount, FRACTIONS_PER_UNIT)
        if group_mask is not None:
            in_mask = lambda l: self.group_of[l] in group_mask  # noqa: E731
        else:
            in_mask = lambda l: True  # noqa: E731
        has_partial_donor = bool(fraction) and any(
            f >= fraction for l, f in self.partial.items() if in_mask(l)
        )
        need = units + (1 if fraction and not has_partial_donor else 0)
        if sum(1 for l in self.free if in_mask(l)) < need:
            return None
        # best-fit group choice must count the fresh index a fractional
        # remainder will break (`need`, not `units`) — otherwise a 2.5-unit
        # request picks a 2-free group and splits the donor into another
        ordered = [
            l
            for l in self._ordered_free(policy, need, preferred_groups)
            if in_mask(l)
        ]
        if group_mask is None and policy is AllocationPolicy.FORCE_COMPACT:
            # all units must come from the minimal number of groups (the
            # masked path skips this: the group solver already enforced it)
            counts = self._group_free_count()
            fc_need = units + (1 if fraction else 0)
            best = sorted(counts.values(), reverse=True)
            got, n_groups = 0, 0
            for c in best:
                if got >= fc_need:
                    break
                got += c
                n_groups += 1
            # verify the ordered prefix uses exactly n_groups groups
            prefix = ordered[:fc_need]
            if len({self.group_of[l] for l in prefix}) > max(n_groups, 1):
                return None
        taken = ordered[:units]
        claim = ResourceClaim(resource="", indices=taken)
        for label in taken:
            self.free.remove(label)
        if fraction:
            # prefer an already-partial index with enough remaining, in a
            # group the whole units already use (compactness)
            taken_groups = {self.group_of[l] for l in taken}
            donor = None
            for label, remaining in sorted(
                self.partial.items(),
                key=lambda kv: (self.group_of[kv[0]] not in taken_groups,
                                kv[0]),
            ):
                if in_mask(label) and remaining >= fraction:
                    donor = label
                    break
            if donor is not None:
                self.partial[donor] -= fraction
                if self.partial[donor] == 0:
                    del self.partial[donor]
            else:
                # break a fresh free index (prefer same ordering)
                rest = [l for l in ordered[units:] if l in self.free]
                if not rest:
                    # roll back
                    self.free.extend(taken)
                    return None
                donor = rest[0]
                self.free.remove(donor)
                self.partial[donor] = FRACTIONS_PER_UNIT - fraction
            claim.fraction_index = donor
            claim.fraction = fraction
        return claim

    def release(self, claim: ResourceClaim) -> None:
        self.free.extend(claim.indices)
        if claim.fraction_index is not None:
            remaining = self.partial.get(claim.fraction_index, 0) + claim.fraction
            if remaining >= FRACTIONS_PER_UNIT:
                self.partial.pop(claim.fraction_index, None)
                self.free.append(claim.fraction_index)
            else:
                self.partial[claim.fraction_index] = remaining


class _SumPool:
    def capacity(self) -> int:
        return self.size

    def __init__(self, size: int):
        self.size = size
        self.free = size

    def total_free(self) -> int:
        return self.free

    def allocate(self, amount: int, policy: AllocationPolicy) -> ResourceClaim | None:
        if policy is AllocationPolicy.ALL:
            if self.free == 0:
                return None
            claim = ResourceClaim(resource="", indices=[], sum_amount=self.free)
            self.free = 0
            return claim
        if self.free < amount:
            return None
        self.free -= amount
        return ResourceClaim(resource="", indices=[], sum_amount=amount)

    def release(self, claim: ResourceClaim) -> None:
        self.free += claim.sum_amount


class ResourceAllocator:
    """All pools of one worker; try_allocate is all-or-nothing.

    Reference allocator.rs:215 (try_allocate) — on failure the request waits;
    the server should rarely over-assign because its dense view mirrors these
    pools, but races on fractional packing are possible and handled by
    queueing on the worker (worker/runtime.py blocked queue).
    """

    def __init__(self, descriptor: ResourceDescriptor):
        self.pools: dict[str, _IndexPool | _SumPool] = {}
        for item in descriptor.items:
            if item.kind is DescriptorKind.SUM:
                self.pools[item.name] = _SumPool(item.sum_size)
            else:
                self.pools[item.name] = _IndexPool(item.index_groups())
        n_groups_of = {
            name: len(pool.groups)
            for name, pool in self.pools.items()
            if isinstance(pool, _IndexPool)
        }
        self.coupling_weights = (
            descriptor.coupling.expand_weights(n_groups_of)
            if descriptor.coupling
            else []
        )
        # forced-policy optimality baseline: objective achievable on an
        # EMPTY worker, cached per request shape (reference allocator.rs
        # optional_objectives)
        self._optimal_cache: dict[tuple, float] = {}
        # memoized group solves keyed on (request shape, pool free-state
        # fingerprint): the exact subset enumeration is up to 2^12-1 subsets
        # per coupled resource and re-runs on every blocked-queue retry of a
        # saturated worker, where the free state usually hasn't changed
        self._solve_cache: dict[
            tuple, tuple[list[list[int]], float] | None
        ] = {}

    def _solve_groups(
        self, coupled: list[tuple[dict, "_IndexPool"]], empty: bool
    ) -> tuple[list[list[int]], float] | None:
        states = []
        requests = []
        index_of = {entry["name"]: i for i, (entry, _) in enumerate(coupled)}
        for entry, pool in coupled:
            states.append(
                pool.group_full_state() if empty else pool.group_free_state()
            )
            requests.append(divmod(int(entry["amount"]), FRACTIONS_PER_UNIT))
        # (request shape, free-state fingerprint) fully determines the solve
        # (weights are fixed per worker); memoize so blocked-queue retries on
        # an unchanged worker skip the exponential enumeration
        key = (
            tuple((e["name"], int(e["amount"])) for e, _ in coupled),
            tuple(tuple(s) for s in states),
            empty,
        )
        if key in self._solve_cache:
            return self._solve_cache[key]
        weights = [
            (
                index_of[w.resource1],
                w.group1,
                index_of[w.resource2],
                w.group2,
                float(w.weight),
            )
            for w in self.coupling_weights
            if w.resource1 in index_of and w.resource2 in index_of
        ]
        solved = group_solver(states, requests, weights)
        if len(self._solve_cache) >= 1024:
            self._solve_cache.pop(next(iter(self._solve_cache)))
        self._solve_cache[key] = solved
        return solved

    def try_allocate(self, entries: list[dict]) -> Allocation | None:
        """entries: [{name, amount, policy}] from the compute message.

        Multi-group (NUMA) resources with coupling-relevant policies are
        group-decided JOINTLY by the exact group solver — minimal group
        count, maximal coupling weight — and then claimed within the chosen
        group masks (reference allocator.rs:115-205 has_resources_for_request
        + claim_resources). Forced policies additionally require the solve to
        be as good as on an empty worker, else the task waits."""
        coupled: list[tuple[dict, _IndexPool]] = []
        any_forced = False
        plan = []  # (entry, pool, policy): parse once, reuse in the claims
        for entry in entries:
            pool = self.pools.get(entry["name"])
            if pool is None:
                return None
            policy = AllocationPolicy.parse(entry.get("policy", "compact"))
            # cheap infeasibility gate — failed attempts dominate on
            # saturated workers (every release retries the blocked queue).
            # ALL ignores the amount and takes the ENTIRE pool, which must
            # be untouched (reference test_allocator.rs:260-280: after one
            # cpu is taken an `all` request fails; the scheduler kernel's
            # free == total check mirrors this).
            if policy is AllocationPolicy.ALL:
                if pool.total_free() < pool.capacity():
                    return None
            elif pool.total_free() < int(entry["amount"]):
                return None
            plan.append((entry, pool, policy))
            if (
                isinstance(pool, _IndexPool)
                and 1 < len(pool.groups) <= _MAX_SOLVER_GROUPS
                and policy in _COUPLING_POLICIES
            ):
                coupled.append((entry, pool))
                any_forced = any_forced or policy in _FORCED_POLICIES
        # run the solver only when it can change the outcome: a forced
        # policy needs the optimality check, or coupling weights tie at
        # least two of the requested resources together; plain compact/tight
        # without weights is served by the cheap per-pool ordering (the
        # solver's per-group objective agrees with it)
        if coupled:
            names = {e["name"] for e, _ in coupled}
            weights_apply = any(
                w.resource1 in names and w.resource2 in names
                for w in self.coupling_weights
            )
            if not any_forced and not weights_apply:
                coupled = []

        masks: dict[str, set[int]] = {}
        if coupled:
            solved = self._solve_groups(coupled, empty=False)
            if solved is None:
                # genuinely infeasible right now (pools over the size guard
                # were never admitted into `coupled`)
                if any_forced:
                    return None
                # non-forced: fall through, unmasked claims will fail cleanly
            else:
                groups_sel, objective = solved
                if any_forced:
                    key = tuple(
                        (e["name"], int(e["amount"])) for e, _ in coupled
                    )
                    optimal = self._optimal_cache.get(key)
                    if optimal is None:
                        empty_solved = self._solve_groups(coupled, empty=True)
                        if empty_solved is None:
                            return None
                        optimal = empty_solved[1] - 0.1
                        if len(self._optimal_cache) >= 1024:
                            self._optimal_cache.pop(
                                next(iter(self._optimal_cache))
                            )
                        self._optimal_cache[key] = optimal
                    if objective < optimal:
                        return None  # a better-shaped moment will come
                for (entry, _pool), sel in zip(coupled, groups_sel):
                    masks[entry["name"]] = set(sel)

        allocation = Allocation()
        for entry, pool, policy in plan:
            if isinstance(pool, _IndexPool):
                claim = pool.allocate(
                    int(entry["amount"]),
                    policy,
                    group_mask=masks.get(entry["name"]),
                )
            else:
                claim = pool.allocate(int(entry["amount"]), policy)
            if claim is None:
                self._rollback(allocation)
                return None
            claim.resource = entry["name"]
            allocation.claims.append(claim)
        return allocation

    def _rollback(self, allocation: Allocation) -> None:
        for claim in allocation.claims:
            self.pools[claim.resource].release(claim)

    def release(self, allocation: Allocation) -> None:
        self._rollback(allocation)
