"""Worker resource descriptors — what a worker physically offers.

Reference semantics: crates/tako/src/internal/common/resources/descriptor.rs —
ResourceDescriptorKind List/Groups/Range/Sum (descriptor.rs:22).

A descriptor is the worker-side truth; the server only needs the summed
amounts per resource (dense vector) plus group shapes for multi-group policy
checks, which `total_amount()`, `n_groups()` and `index_groups()` provide.
The wire format, validation and the coupling of group-structured resources
come with the host-planes slice that reads them.
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
    def sum(cls, name: str, size: int) -> "ResourceDescriptorItem":
        """size in fixed-point fractions."""
        return cls(name=name, kind=DescriptorKind.SUM, sum_size=size)

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
class ResourceDescriptor:
    items: tuple[ResourceDescriptorItem, ...]
