"""Server-side dense view of a worker's resources.

Reference semantics: crates/tako/src/internal/server/workerload.rs — a dense
per-resource amount vector plus `task_max_count` (how many simultaneous tasks
the worker can ever run, bounded by its smallest meaningful pool). Stored as a
plain list[int] aligned to the global ResourceIdMap so a tick snapshot is a
row-copy into the (W, R) matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT
from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor
from hyperqueue_tpu_torch.resources.map import ResourceIdMap
from hyperqueue_tpu_torch.resources.request import (
    AllocationPolicy,
    ResourceRequest,
    ResourceRequestVariants,
)

# Upper bound on concurrent tasks per worker regardless of resources
# (reference workerload.rs caps similarly to bound solver variables).
TASK_MAX_COUNT_CAP = 512


@dataclass
class WorkerResources:
    # amounts[resource_id] = total capacity in fractions; resources the worker
    # does not provide are 0. The list grows as the global map grows.
    amounts: list[int] = field(default_factory=list)
    # n_groups[resource_id] for multi-group (NUMA) resources, else 1.
    n_groups: list[int] = field(default_factory=list)
    # rids of per-group mask subcolumns this worker registered; they alias
    # capacity already counted under the parent resource, so capacity-derived
    # bounds (task_max_count) must not double-count them.
    masked: set = field(default_factory=set)

    @classmethod
    def from_descriptor(
        cls, descriptor: ResourceDescriptor, resource_map: ResourceIdMap
    ) -> "WorkerResources":
        wr = cls()
        for item in descriptor.items:
            rid = resource_map.get_or_create(item.name)
            wr._ensure_len(rid + 1)
            wr.amounts[rid] = item.total_amount()
            wr.n_groups[rid] = item.n_groups()
            if item.n_groups() > 1:
                # multi-group (NUMA) resource: register per-group mask
                # subcolumns so "group k of <name>" requests are one dense
                # constraint row in the batched solve (resources/map.py)
                for k, group in enumerate(item.index_groups()):
                    grid = resource_map.get_or_create_masked(item.name, k)
                    wr._ensure_len(grid + 1)
                    wr.amounts[grid] = len(group) * FRACTIONS_PER_UNIT
                    wr.masked.add(grid)
        return wr

    def _ensure_len(self, n: int) -> None:
        while len(self.amounts) < n:
            self.amounts.append(0)
            self.n_groups.append(1)

    def amount(self, resource_id: int) -> int:
        if resource_id < len(self.amounts):
            return self.amounts[resource_id]
        return 0

    def task_max_count(self) -> int:
        """Max number of simultaneously running single-node tasks.

        Tasks may consume disjoint resources, so the sound bound is the sum of
        pool sizes in whole units (each running task holds at least one unit
        of some pool), capped (reference workerload.rs computes an analogous
        bound to limit solver variables).
        """
        total = sum(
            a // FRACTIONS_PER_UNIT
            for rid, a in enumerate(self.amounts)
            if a > 0 and rid not in self.masked
        )
        return min(TASK_MAX_COUNT_CAP, max(total, 1))

    def is_capable_of(self, request: ResourceRequest) -> bool:
        """Could this worker EVER run a task with this request (empty worker)?

        Reference server/worker.rs:273-344 (is_capable_to_run_rqv).
        """
        if request.is_multi_node:
            return True  # capability of gangs is checked at the group level
        for entry in request.entries:
            have = self.amount(entry.resource_id)
            if entry.policy is AllocationPolicy.ALL:
                if have == 0:
                    return False
            # For FORCE_COMPACT/FORCE_TIGHT an empty worker can always pick
            # the fullest groups, so the minimal-group ceil split is feasible
            # iff the total fits — same check as the plain policies. The exact
            # group-shape check happens in the worker allocator.
            elif have < entry.amount:
                return False
        return True

    def is_capable_of_rqv(self, rqv: ResourceRequestVariants) -> bool:
        return any(self.is_capable_of(v) for v in rqv.variants)

    def to_dense_row(self, n_resources: int) -> list[int]:
        row = list(self.amounts[:n_resources])
        row.extend(0 for _ in range(n_resources - len(row)))
        return row
