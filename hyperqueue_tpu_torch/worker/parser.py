"""Resource definition parser for `hq worker start --resource`.

Reference: crates/hyperqueue/src/worker/parser.rs (718 LoC) — syntaxes:
  name=range(1-5)          indices 1..5
  name=[a,b,c]             explicit list
  name=[[a,b],[c,d]]       groups (NUMA)
  name=sum(1024)           fungible amount (units)
  name=4 / name=4x2        shorthand: N indices / N groups x M
"""

from __future__ import annotations

import re

from hyperqueue_tpu_torch.resources.amount import amount_from_str
from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptorItem


class ResourceParseError(ValueError):
    pass


def parse_resource_definition(spec: str) -> ResourceDescriptorItem:
    name, sep, value = spec.partition("=")
    name = name.strip()
    value = value.strip()
    if not sep or not name or not value:
        raise ResourceParseError(
            f"invalid resource definition {spec!r}, expected name=value"
        )

    m = re.fullmatch(r"range\((\d+)-(\d+)\)", value)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ResourceParseError(f"empty range in {spec!r}")
        return ResourceDescriptorItem.range(name, lo, hi)

    m = re.fullmatch(r"sum\(([\d.]+)\)", value)
    if m:
        return ResourceDescriptorItem.sum(name, amount_from_str(m.group(1)))

    if value.startswith("[["):
        groups = _parse_nested_list(value, spec)
        return ResourceDescriptorItem.group_list(name, groups)

    if value.startswith("["):
        if not value.endswith("]"):
            raise ResourceParseError(f"unterminated list in {spec!r}")
        items = [v.strip() for v in value[1:-1].split(",") if v.strip()]
        if not items:
            raise ResourceParseError(f"empty list in {spec!r}")
        return ResourceDescriptorItem.list(name, items)

    m = re.fullmatch(r"(\d+)x(\d+)", value)
    if m:
        n_groups, per_group = int(m.group(1)), int(m.group(2))
        groups = [
            [str(g * per_group + i) for i in range(per_group)]
            for g in range(n_groups)
        ]
        return ResourceDescriptorItem.group_list(name, groups)

    if value.isdigit():
        return ResourceDescriptorItem.range(name, 0, int(value) - 1)

    raise ResourceParseError(f"cannot parse resource definition {spec!r}")


def _parse_nested_list(value: str, spec: str) -> list[list[str]]:
    if not value.endswith("]]"):
        raise ResourceParseError(f"unterminated group list in {spec!r}")
    inner = value[1:-1].strip()
    groups: list[list[str]] = []
    depth = 0
    current = ""
    for ch in inner:
        if ch == "[":
            depth += 1
            current = ""
        elif ch == "]":
            depth -= 1
            items = [v.strip() for v in current.split(",") if v.strip()]
            if items:
                groups.append(items)
        elif depth > 0:
            current += ch
    if not groups:
        raise ResourceParseError(f"empty group list in {spec!r}")
    return groups


def parse_resource_coupling(text: str):
    """Parse a --coupling value into a ResourceDescriptorCoupling.

    Two forms (reference parser.rs:229 parse_resource_coupling):
      "cpus,gpus"                        — plain names: same-index groups of
                                           the listed resources couple at the
                                           default weight 256
      "cpus[0]:gpus[0]=256,cpus[1]:gpus[1]" — explicit weighted group pairs
                                           (weight defaults to 256)
    """
    from hyperqueue_tpu_torch.resources.descriptor import (
        CouplingWeight,
        ResourceDescriptorCoupling,
    )

    text = text.strip()
    if "[" not in text:
        return ResourceDescriptorCoupling(
            names=tuple(n.strip() for n in text.split(",") if n.strip())
        )
    item_re = re.compile(
        r"^\s*(\w+)\[(\d+)\]\s*:\s*(\w+)\[(\d+)\]\s*(?:=\s*(\d+))?\s*$"
    )
    weights = []
    for part in text.split(","):
        m = item_re.match(part)
        if m is None:
            raise ResourceParseError(f"invalid coupling item {part.strip()!r}")
        r1, g1, r2, g2, w = m.groups()
        weights.append(
            CouplingWeight(
                r1, int(g1), r2, int(g2), int(w) if w else 256
            ).normalized()
        )
    return ResourceDescriptorCoupling(weights=tuple(weights))
