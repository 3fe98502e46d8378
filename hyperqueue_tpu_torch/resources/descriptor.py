"""Worker resource descriptors — what a worker physically offers.

Reference semantics: crates/tako/src/internal/common/resources/descriptor.rs —
ResourceDescriptorKind List/Groups/Range/Sum (descriptor.rs:22) plus coupling
of group-structured resources with weights (descriptor.rs:249-295).

A descriptor is the worker-side truth; the server only needs the summed
amounts per resource (dense vector) plus group shapes for multi-group policy
checks, which `total_amount()`, `n_groups()` and `index_groups()` provide.
`to_dict`/`from_dict` are the wire form a worker registers with.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT


class DescriptorKind(enum.Enum):
    LIST = "list"        # explicit non-fungible indices (e.g. GPU ids)
    GROUPS = "groups"    # indices partitioned into groups (NUMA sockets)
    RANGE = "range"      # contiguous integer indices
    SUM = "sum"          # fungible amount only (e.g. memory bytes)


@dataclass(frozen=True, slots=True)
class ResourceDescriptorItem:
    name: str
    kind: DescriptorKind
    # LIST: groups == [values]; GROUPS: one list per group; RANGE: values built
    # from range_start..range_end; SUM: sum_size only.
    groups: tuple[tuple[str, ...], ...] = ()
    range_start: int = 0
    range_end: int = -1  # inclusive
    sum_size: int = 0  # fixed-point fractions

    @classmethod
    def list(cls, name: str, values: list[str]) -> "ResourceDescriptorItem":
        return cls(name=name, kind=DescriptorKind.LIST, groups=(tuple(values),))

    @classmethod
    def range(cls, name: str, start: int, end: int) -> "ResourceDescriptorItem":
        return cls(name=name, kind=DescriptorKind.RANGE, range_start=start, range_end=end)

    @classmethod
    def group_list(cls, name: str, groups: list[list[str]]) -> "ResourceDescriptorItem":
        return cls(
            name=name,
            kind=DescriptorKind.GROUPS,
            groups=tuple(tuple(g) for g in groups),
        )

    @classmethod
    def sum(cls, name: str, size: int) -> "ResourceDescriptorItem":
        """size in fixed-point fractions."""
        return cls(name=name, kind=DescriptorKind.SUM, sum_size=size)

    def validate(self) -> None:
        if self.kind in (DescriptorKind.LIST, DescriptorKind.GROUPS):
            seen: set[str] = set()
            for group in self.groups:
                for value in group:
                    if value in seen:
                        raise ValueError(
                            f"duplicate index {value!r} in resource {self.name!r}"
                        )
                    seen.add(value)
            if not seen:
                raise ValueError(f"resource {self.name!r} has no indices")
        elif self.kind is DescriptorKind.RANGE:
            if self.range_end < self.range_start:
                raise ValueError(f"empty range for resource {self.name!r}")
        elif self.kind is DescriptorKind.SUM:
            if self.sum_size <= 0:
                raise ValueError(f"resource {self.name!r} has zero size")

    def index_groups(self) -> list[list[str]]:
        """Concrete indices per group (SUM has none)."""
        if self.kind is DescriptorKind.RANGE:
            return [[str(i) for i in range(self.range_start, self.range_end + 1)]]
        if self.kind in (DescriptorKind.LIST, DescriptorKind.GROUPS):
            return [list(g) for g in self.groups]
        return []

    def total_amount(self) -> int:
        """Total capacity in fixed-point fractions."""
        if self.kind is DescriptorKind.SUM:
            return self.sum_size
        return sum(len(g) for g in self.index_groups()) * FRACTIONS_PER_UNIT

    def n_groups(self) -> int:
        groups = self.index_groups()
        return len(groups) if groups else 1


@dataclass(frozen=True, slots=True)
class CouplingWeight:
    """Affinity weight between group `group1` of `resource1` and group
    `group2` of `resource2` (reference descriptor.rs:249-265
    ResourceDescriptorCouplingItem; weights referenced by name here instead
    of positional index for wire robustness)."""

    resource1: str
    group1: int
    resource2: str
    group2: int
    weight: int = 256

    def normalized(self) -> "CouplingWeight":
        if self.resource1 > self.resource2:
            return CouplingWeight(
                self.resource2, self.group2, self.resource1, self.group1,
                self.weight,
            )
        return self


@dataclass(frozen=True, slots=True)
class ResourceDescriptorCoupling:
    """Declares coupled group-structured resources (e.g. cpus and gpus
    attached to the same NUMA node); the worker's group solver then prefers
    allocations whose groups align. Either explicit per-group-pair `weights`
    (reference descriptor.rs:249-295) or a plain `names` list, which expands
    to same-index group pairs at default weight 256 (the physical meaning of
    "socket j of cpus is socket j of gpus")."""

    names: tuple[str, ...] = ()
    weights: tuple[CouplingWeight, ...] = ()

    def expand_weights(
        self, n_groups_of: dict[str, int]
    ) -> list[CouplingWeight]:
        """Concrete weight list; names expand against actual group counts."""
        if self.weights:
            return [w.normalized() for w in self.weights]
        out: list[CouplingWeight] = []
        names = [n for n in self.names if n in n_groups_of]
        for i, r1 in enumerate(names):
            for r2 in names[i + 1:]:
                for g in range(min(n_groups_of[r1], n_groups_of[r2])):
                    out.append(CouplingWeight(r1, g, r2, g).normalized())
        return out


@dataclass(frozen=True, slots=True)
class ResourceDescriptor:
    items: tuple[ResourceDescriptorItem, ...]
    coupling: ResourceDescriptorCoupling | None = None

    def validate(self) -> None:
        names = [item.name for item in self.items]
        if len(set(names)) != len(names):
            raise ValueError("duplicate resource name in descriptor")
        for item in self.items:
            item.validate()
        if self.coupling:
            for name in self.coupling.names:
                if name not in names:
                    raise ValueError(f"coupling references unknown resource {name!r}")
            for w in self.coupling.weights:
                for rname, group in ((w.resource1, w.group1),
                                     (w.resource2, w.group2)):
                    it = self.item(rname)
                    if it is None:
                        raise ValueError(
                            f"coupling references unknown resource {rname!r}"
                        )
                    if group >= it.n_groups():
                        raise ValueError(
                            f"coupling references group {group} of "
                            f"{rname!r} which has {it.n_groups()} groups"
                        )

    def item(self, name: str) -> ResourceDescriptorItem | None:
        for it in self.items:
            if it.name == name:
                return it
        return None

    @classmethod
    def simple_cpus(cls, n_cpus: int) -> "ResourceDescriptor":
        return cls(
            items=(ResourceDescriptorItem.range("cpus", 0, n_cpus - 1),)
        )

    @classmethod
    def from_dict(cls, data: dict) -> "ResourceDescriptor":
        items = []
        for it in data.get("items", []):
            items.append(
                ResourceDescriptorItem(
                    name=it["name"],
                    kind=DescriptorKind(it["kind"]),
                    groups=tuple(tuple(g) for g in it.get("groups", ())),
                    range_start=it.get("range_start", 0),
                    range_end=it.get("range_end", -1),
                    sum_size=it.get("sum_size", 0),
                )
            )
        coupling = None
        raw = data.get("coupling")
        if raw:
            if isinstance(raw, dict):
                coupling = ResourceDescriptorCoupling(
                    names=tuple(raw.get("names") or ()),
                    weights=tuple(
                        CouplingWeight(*w) for w in raw.get("weights") or ()
                    ),
                )
            else:  # legacy plain name list
                coupling = ResourceDescriptorCoupling(names=tuple(raw))
        return cls(items=tuple(items), coupling=coupling)

    def to_dict(self) -> dict:
        return {
            "items": [
                {
                    "name": it.name,
                    "kind": it.kind.value,
                    "groups": [list(g) for g in it.groups],
                    "range_start": it.range_start,
                    "range_end": it.range_end,
                    "sum_size": it.sum_size,
                }
                for it in self.items
            ],
            "coupling": {
                "names": list(self.coupling.names),
                "weights": [
                    [w.resource1, w.group1, w.resource2, w.group2, w.weight]
                    for w in self.coupling.weights
                ],
            }
            if self.coupling
            else None,
        }
