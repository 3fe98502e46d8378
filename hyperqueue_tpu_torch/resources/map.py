"""Interning maps for resource names and request variants.

Reference semantics: crates/tako/src/internal/common/resources/map.rs —
resource names intern to dense ResourceIds with CPU pinned to id 0 (map.rs:7);
ResourceRequestVariants intern to ResourceRqIds (map.rs:15,95-117) so each
distinct request enters the scheduler exactly once. rq-ids are the row space
of the dense solver snapshot.
"""

from __future__ import annotations

from hyperqueue_tpu_torch.resources.request import ResourceRequestVariants
from hyperqueue_tpu_torch.utils.metrics import REGISTRY

CPU_RESOURCE_NAME = "cpus"
CPU_RESOURCE_ID = 0

_SOLVE_MASK_ROWS = REGISTRY.counter(
    "hq_solve_mask_rows",
    "indexed-resource mask subcolumns interned into the dense solve "
    "(one per distinct (resource, group) pair, e.g. gpus#0)",
)


class ResourceIdMap:
    """name <-> dense resource id; CPU is always id 0.

    Mask subcolumns: a non-fungible indexed constraint ("group k of gpus")
    interns as its own dense column named ``gpus#k`` and is tracked in
    ``masked_rids``; the solver sees one ordinary needs/free column.
    ``hq_solve_mask_rows`` counts the distinct mask subcolumns interned.
    """

    def __init__(self):
        self._names: list[str] = [CPU_RESOURCE_NAME]
        self._ids: dict[str, int] = {CPU_RESOURCE_NAME: CPU_RESOURCE_ID}
        self.masked_rids: set[int] = set()

    def get_or_create(self, name: str) -> int:
        rid = self._ids.get(name)
        if rid is None:
            rid = len(self._names)
            self._names.append(name)
            self._ids[name] = rid
        return rid

    def get_or_create_masked(self, name: str, group: int) -> int:
        rid = self.get_or_create(f"{name}#{group}")
        if rid not in self.masked_rids:
            self.masked_rids.add(rid)
            _SOLVE_MASK_ROWS.inc()
        return rid

    def is_masked(self, resource_id: int) -> bool:
        return resource_id in self.masked_rids

    def get(self, name: str) -> int | None:
        return self._ids.get(name)

    def name_of(self, resource_id: int) -> str:
        return self._names[resource_id]

    def names(self) -> list[str]:
        return list(self._names)

    def __len__(self) -> int:
        return len(self._names)


class ResourceRqMap:
    """ResourceRequestVariants <-> dense rq-id."""

    def __init__(self):
        self._variants: list[ResourceRequestVariants] = []
        self._ids: dict[ResourceRequestVariants, int] = {}

    def get_or_create(self, rqv: ResourceRequestVariants) -> int:
        rq_id = self._ids.get(rqv)
        if rq_id is None:
            rq_id = len(self._variants)
            self._variants.append(rqv)
            self._ids[rqv] = rq_id
        return rq_id

    def get_variants(self, rq_id: int) -> ResourceRequestVariants:
        return self._variants[rq_id]

    def all(self) -> list[ResourceRequestVariants]:
        return list(self._variants)

    def __len__(self) -> int:
        return len(self._variants)
