"""Hardware telemetry for worker overviews.

Reference: crates/tako/src/internal/worker/hwmonitor/{mod,nvidia,amd}.rs —
CPU/memory/network usage plus GPU stats feeding WorkerOverview messages on a
configurable interval. Implemented over /proc and /sys (no extra deps); TPU
utilization is exposed when the accel sysfs paths exist.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from hyperqueue_tpu_torch.utils import clock


def parse_nvidia_smi_csv(text: str) -> list[dict]:
    """Parse `nvidia-smi --format=csv,noheader --query-gpu=pci.bus_id,
    utilization.gpu,memory.used,memory.total` output (reference
    hwmonitor/nvidia.rs parse_nvidia_gpu_stats)."""
    gpus = []
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 4 or not parts[0]:
            continue

        def num(value):
            digits = "".join(
                c for c in value if c.isdigit() or c == "."
            )
            try:
                return float(digits)
            except ValueError:
                return 0.0

        mem_used, mem_total = num(parts[2]), num(parts[3])
        gpus.append(
            {
                "id": parts[0],
                "vendor": "nvidia",
                "usage_percent": num(parts[1]),
                "mem_usage_percent": (
                    round(mem_used / mem_total * 100.0, 1)
                    if mem_total > 0
                    else 0.0
                ),
            }
        )
    return gpus


def parse_rocm_smi_json(text: str) -> list[dict]:
    """Parse `rocm-smi --json --showuse --showbus --showmemuse` output
    (reference hwmonitor/amd.rs parse_amd_gpu_stats)."""
    try:
        data = json.loads(text)
    except ValueError:
        return []
    gpus = []
    for card in sorted(data):
        stats = data[card]
        if not isinstance(stats, dict):
            continue

        def num(value):
            try:
                return float(value)
            except (TypeError, ValueError):
                return 0.0

        gpus.append(
            {
                "id": stats.get("PCI Bus", card),
                "vendor": "amd",
                "usage_percent": num(stats.get("GPU use (%)")),
                "mem_usage_percent": num(stats.get("GPU memory use (%)")),
            }
        )
    return gpus


class GpuMonitor:
    """NVIDIA (nvidia-smi) + AMD (rocm-smi) utilization collectors feeding
    worker overviews; vendors whose tool is absent are silently skipped
    (reference hwmonitor/{nvidia,amd}.rs)."""

    def __init__(self):
        self._nvidia = shutil.which("nvidia-smi")
        self._rocm = shutil.which("rocm-smi")

    @property
    def available(self) -> bool:
        return bool(self._nvidia or self._rocm)

    def sample(self) -> list[dict]:
        gpus: list[dict] = []
        if self._nvidia:
            try:
                out = subprocess.run(
                    [
                        self._nvidia,
                        "--format=csv,noheader",
                        "--query-gpu=pci.bus_id,utilization.gpu,"
                        "memory.used,memory.total",
                    ],
                    capture_output=True,
                    text=True,
                    timeout=5,
                    check=True,
                )
                gpus.extend(parse_nvidia_smi_csv(out.stdout))
            except (OSError, subprocess.SubprocessError):
                pass
        if self._rocm:
            try:
                out = subprocess.run(
                    [self._rocm, "--json", "--showuse", "--showbus",
                     "--showmemuse"],
                    capture_output=True,
                    text=True,
                    timeout=5,
                    check=True,
                )
                gpus.extend(parse_rocm_smi_json(out.stdout))
            except (OSError, subprocess.SubprocessError):
                pass
        return gpus


class HwSampler:
    def __init__(self):
        self._last_cpu = self._read_cpu_times()
        self._last_per_cpu = self._read_per_cpu_times()
        self._last_time = clock.monotonic()
        self._gpu = GpuMonitor()

    @staticmethod
    def _read_cpu_times():
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()[1:]
            numbers = [int(x) for x in fields]
            idle = numbers[3] + (numbers[4] if len(numbers) > 4 else 0)
            return sum(numbers), idle
        except (OSError, ValueError, IndexError):
            return (0, 0)

    @staticmethod
    def _read_per_cpu_times():
        """[(total, idle)] per logical cpu (reference cpu_util_table.rs
        shows a per-CPU utilization grid in the worker detail screen)."""
        out = []
        try:
            with open("/proc/stat") as f:
                for line in f:
                    if not line.startswith("cpu") or line.startswith("cpu "):
                        continue
                    numbers = [int(x) for x in line.split()[1:]]
                    idle = numbers[3] + (numbers[4] if len(numbers) > 4 else 0)
                    out.append((sum(numbers), idle))
        except (OSError, ValueError, IndexError):
            pass
        return out

    def sample(self) -> dict:
        total, idle = self._read_cpu_times()
        last_total, last_idle = self._last_cpu
        dt_total = total - last_total
        dt_idle = idle - last_idle
        self._last_cpu = (total, idle)
        cpu_usage = 0.0
        if dt_total > 0:
            cpu_usage = 100.0 * (1.0 - dt_idle / dt_total)

        per_cpu = self._read_per_cpu_times()
        per_core = []
        for i, (t, ii) in enumerate(per_cpu):
            if i < len(self._last_per_cpu):
                lt, li = self._last_per_cpu[i]
                dt, di = t - lt, ii - li
                per_core.append(
                    round(100.0 * (1.0 - di / dt), 1) if dt > 0 else 0.0
                )
        self._last_per_cpu = per_cpu

        mem_total = mem_avail = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        mem_total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        mem_avail = int(line.split()[1]) * 1024
        except OSError:
            pass

        load = os.getloadavg() if hasattr(os, "getloadavg") else (0, 0, 0)
        out = {
            "timestamp": clock.now(),
            "cpu_usage_percent": round(cpu_usage, 1),
            "cpu_per_core_percent": per_core,
            "mem_total_bytes": mem_total,
            "mem_available_bytes": mem_avail,
            "loadavg_1m": load[0],
        }
        if self._gpu.available:
            out["gpus"] = self._gpu.sample()
        return out
