"""Hardware detection for worker resource descriptors.

Reference: crates/hyperqueue/src/worker/hwdetect.rs:22-168 — CPUs with NUMA
groups from /sys, hyper-thread sibling pruning, GPUs from CUDA_VISIBLE_DEVICES
and /proc, memory from /proc/meminfo. Additionally (TPU-native): TPU chips
from /dev/accel* and TPU_VISIBLE_DEVICES.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path

from hyperqueue_tpu_torch.resources.amount import FRACTIONS_PER_UNIT
from hyperqueue_tpu_torch.resources.descriptor import (
    ResourceDescriptor,
    ResourceDescriptorItem,
)


def detect_cpus(no_hyper_threading: bool = False) -> ResourceDescriptorItem:
    """NUMA-grouped CPU list; falls back to a flat range."""
    node_dirs = sorted(
        glob.glob("/sys/devices/system/node/node[0-9]*"),
        key=lambda p: int(re.search(r"node(\d+)$", p).group(1)),
    )
    try:
        available = sorted(os.sched_getaffinity(0))
    except AttributeError:
        available = list(range(os.cpu_count() or 1))
    avail_set = set(available)

    pruned: set[int] = set()
    if no_hyper_threading:
        for cpu in available:
            sibling_file = Path(
                f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list"
            )
            if sibling_file.exists():
                siblings = _parse_cpu_list(sibling_file.read_text())
                for extra in siblings[1:]:
                    pruned.add(extra)
    usable = [c for c in available if c not in pruned]

    if len(node_dirs) > 1:
        groups: list[list[str]] = []
        seen: set[int] = set()
        for node_dir in node_dirs:
            cpulist = Path(node_dir) / "cpulist"
            if not cpulist.exists():
                continue
            cpus = [
                c
                for c in _parse_cpu_list(cpulist.read_text())
                if c in avail_set and c not in pruned and c not in seen
            ]
            seen.update(cpus)
            if cpus:
                groups.append([str(c) for c in cpus])
        if len(groups) > 1:
            return ResourceDescriptorItem.group_list("cpus", groups)
    return ResourceDescriptorItem.list("cpus", [str(c) for c in usable])


def _parse_cpu_list(text: str) -> list[int]:
    out: list[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def detect_gpus() -> ResourceDescriptorItem | None:
    visible = os.environ.get("CUDA_VISIBLE_DEVICES") or os.environ.get(
        "HIP_VISIBLE_DEVICES"
    )
    if visible:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
        if ids:
            return ResourceDescriptorItem.list("gpus", ids)
    nvidia = sorted(glob.glob("/proc/driver/nvidia/gpus/*"))
    if nvidia:
        return ResourceDescriptorItem.list(
            "gpus", [str(i) for i in range(len(nvidia))]
        )
    return None


def detect_tpus() -> ResourceDescriptorItem | None:
    visible = os.environ.get("TPU_VISIBLE_DEVICES")
    if visible:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
        if ids:
            return ResourceDescriptorItem.list("tpus", ids)
    accels = sorted(glob.glob("/dev/accel[0-9]*")) + sorted(
        glob.glob("/dev/vfio/[0-9]*")
    )
    if accels:
        return ResourceDescriptorItem.list(
            "tpus", [str(i) for i in range(len(accels))]
        )
    return None


def detect_memory() -> ResourceDescriptorItem | None:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kib = int(line.split()[1])
                    # expose memory in MiB units
                    mib = kib // 1024
                    return ResourceDescriptorItem.sum(
                        "mem", mib * FRACTIONS_PER_UNIT
                    )
    except OSError:
        pass
    return None


def detect_resources(
    n_cpus: int | None = None, no_hyper_threading: bool = False,
    with_memory: bool = False,
) -> ResourceDescriptor:
    items = []
    if n_cpus is not None:
        items.append(ResourceDescriptorItem.range("cpus", 0, n_cpus - 1))
    else:
        items.append(detect_cpus(no_hyper_threading=no_hyper_threading))
    for detector in (detect_gpus, detect_tpus):
        item = detector()
        if item is not None:
            items.append(item)
    if with_memory:
        mem = detect_memory()
        if mem is not None:
            items.append(mem)
    return ResourceDescriptor(items=tuple(items))
