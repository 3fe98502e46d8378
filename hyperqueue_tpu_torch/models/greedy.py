"""Greedy cut-scan scheduling model: bucketing, backend choice and resident
state around the kernel.

Real ticks have varying worker, batch, resource and variant counts. This
wrapper pads every dimension up to a bucket (powers of two with a small
floor), so that steady-state ticks reuse the same persistent padded buffers
and device tensors.

Padding is semantically inert: padded workers have zero free resources and
zero task slots, are not idle for gangs and belong to no group; padded
batches have size 0 and no gang; padded variants are all-zero need rows
with an infinite min_time, which the kernel masks off.

Backends. Each solve runs on the host (the native scan, utils/native.py,
or the numpy twin, ops/assign.greedy_cut_scan_numpy) or on the device (the
kernel, through the residency below). The default, `backend="device"`,
always solves on the model's device: on the CPU that is the kernel's plain
PyTorch version through the residency. `"numpy"` always solves on the host.
`"auto"` is the server's choice and must be asked for: on the card it
decides per solve with a cost model (per-shape EWMAs of measured end-to-end
solve times, and the device's sync round trip from a background probe, the
K5 kernel in ops/probe.py, that ages out and re-probes); on the CPU it
stays on the host. A probe that failed makes every `"auto"` decision raise
with the probe's exception.

The device path keeps the padded state RESIDENT on the device
(parallel/resident.py): per-tick uploads are only the dirty-row delta, the
kernel updates free/nt_free in place so the state after solve N feeds solve
N+1 on the device, and the padded counts are sliced to the live (B, V, W)
extents on the device before the copy to the host, into pinned host sets
that later solves reuse. A device solve that fails raises; the solver
watchdog (scheduler/watchdog.py) counts the failure and degrades to a host
solve only where its caller gave it a host fallback.

The model runs on the card (`device="cuda"`) unless the caller asks for the
CPU. Without CUDA the default model refuses to start rather than solving
somewhere else, and a card model builds its kernels when it is constructed.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from hyperqueue_tpu_torch.ops.assign import (
    greedy_cut_scan,
    greedy_cut_scan_numpy,
    host_visit_classes,
    scarcity_weights,
)
from hyperqueue_tpu_torch.parallel.resident import DeviceResidency
from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils.constants import INF_TIME
from hyperqueue_tpu_torch.utils.trace import ranges as _ranges

# smallest bucket of each padded dimension
_WORKER_FLOOR = 8
_BATCH_FLOOR = 8
_RESOURCE_FLOOR = 4
_VARIANT_FLOOR = 1
_GROUP_FLOOR = 4
# the visit-class rows' bucket: part of the cost model's shape key only
_CLASS_FLOOR = 4

BACKENDS = ("auto", "device", "numpy")

# pinned host sets kept per padded shape beyond which the least recently
# used shape is dropped
_PINNED_SHAPES = 8


def _bucket(n: int, floor: int) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "GreedyCutScanModel(device='cuda') needs a CUDA device and none "
            "is available; pass device='cpu' to solve with the plain "
            "PyTorch version"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# Device sync-latency probe, shared by all models in the process.
# None = not yet resolved; float = measured round-trip ms (inf = the probe
# failed, and probe_error() holds why). Probed in a BACKGROUND daemon thread
# so the caller never blocks on it; a resolved measurement AGES OUT
# (REPROBE_INTERVAL_S): callers that pass max_age_s re-launch the probe in
# the background when the value is stale, so a device that was slow at
# startup gets re-evaluated instead of being benched forever.
_DEVICE_SYNC_MS: float | None = None
_PROBE_ERROR: BaseException | None = None
_PROBE_RUNNING = False
_PROBE_DONE = None  # threading.Event of the probe currently in flight
_PROBE_TS = 0.0     # clock.monotonic() stamp of the last RESOLVED probe
_PROBE_LOCK = threading.Lock()

# A tick must complete in single-digit milliseconds; a device whose launch
# plus readback round trip alone exceeds this is not worth using for the
# solve, however fast the kernel is on the device.
DISPATCH_LATENCY_BUDGET_MS = 5.0

# re-probe the sync latency when the last measurement is older than this
# and the host path is currently winning (the device path self-measures)
REPROBE_INTERVAL_S = 30.0

# while the cost model picks the host, retry the device path after this
# many solves even if the last device measurement lost — measurements go
# stale as shapes and device health drift
DEVICE_RETRY_SOLVES = 512

# cost-model EWMA smoothing for per-shape host/device solve times
_EWMA_ALPHA = 0.25


def _start_probe_locked() -> None:
    global _PROBE_RUNNING, _PROBE_DONE
    _PROBE_RUNNING = True
    _PROBE_DONE = threading.Event()
    done = _PROBE_DONE

    def _probe():
        global _DEVICE_SYNC_MS, _PROBE_ERROR, _PROBE_RUNNING, _PROBE_TS
        from hyperqueue_tpu_torch.ops import probe

        error = None
        try:
            measured = probe.sync_round_trip_ms("cuda")
        except Exception as e:  # noqa: BLE001 - kept for probe_error()
            measured = float("inf")
            error = e
        with _PROBE_LOCK:
            _DEVICE_SYNC_MS = measured
            _PROBE_ERROR = error
            _PROBE_TS = clock.monotonic()
            _PROBE_RUNNING = False
        done.set()

    threading.Thread(
        target=_probe, name="hq-device-probe", daemon=True
    ).start()


def device_sync_ms(wait_s: float = 0.0,
                   max_age_s: float | None = None) -> float | None:
    """Current known device sync round trip in ms.

    Starts the background probe on first call; returns None while the
    FIRST probe is unresolved (callers treat that as "use the host solve
    for now"). `max_age_s` triggers a background RE-probe when the last
    resolved measurement is older — the stale value keeps being returned
    until the new one lands, so callers never block on freshness.
    `wait_s` > 0 blocks up to that long for a result — a benchmark or a
    smoke run uses it for a stable backend choice; the tick never does."""
    with _PROBE_LOCK:
        if _DEVICE_SYNC_MS is None and not _PROBE_RUNNING:
            _start_probe_locked()
        elif (
            max_age_s is not None
            and not _PROBE_RUNNING
            and _DEVICE_SYNC_MS is not None
            and clock.monotonic() - _PROBE_TS > max_age_s
        ):
            _start_probe_locked()
        done = _PROBE_DONE
    if wait_s > 0 and done is not None:
        done.wait(wait_s)
    return _DEVICE_SYNC_MS


def probe_error() -> BaseException | None:
    """The exception of the last resolved probe (None when it measured)."""
    return _PROBE_ERROR


def _reset_probe_for_tests() -> None:
    global _DEVICE_SYNC_MS, _PROBE_ERROR, _PROBE_RUNNING, _PROBE_DONE
    global _PROBE_TS
    with _PROBE_LOCK:
        _DEVICE_SYNC_MS = None
        _PROBE_ERROR = None
        _PROBE_RUNNING = False
        _PROBE_DONE = None
        _PROBE_TS = 0.0


class ResidentParanoidError(AssertionError):
    """The device-resident solve diverged from a fresh full-upload solve.

    Deliberately loud: the solver watchdog re-raises it instead of
    degrading (masking the divergence behind the fallback would both hide
    the bug and destroy the evidence via resident invalidation)."""


class _PinnedSet:
    """Pinned host memory that one device solve copies its counts and
    state after the solve into. `busy` from the dispatch until `result()`
    has read it: a set whose solve was never read (a stranded watchdog
    solve, or a handle dropped unread) is never handed out again."""

    __slots__ = ("counts", "free", "nt", "busy")

    def __init__(self, n_counts: int, free_shape: tuple):
        self.counts = torch.empty(n_counts, dtype=torch.int32,
                                  pin_memory=True)
        self.free = torch.empty(free_shape, dtype=torch.int32,
                                pin_memory=True)
        self.nt = torch.empty(free_shape[0], dtype=torch.int32,
                              pin_memory=True)
        self.busy = False


class _ReadyCounts:
    """Solve handle whose result is already materialized (host paths)."""

    __slots__ = ("_counts",)

    def __init__(self, counts: np.ndarray):
        self._counts = counts

    def result(self) -> np.ndarray:
        return self._counts


class _DeviceCounts:
    """In-flight device solve: the counts and the state after the solve are
    being copied to host memory behind `event`. `result()` waits for the
    copy, re-synchronizes the residency mirror, feeds the cost model, runs
    the paranoid check when it is due and returns C-contiguous int32
    counts. Between construction and `result()` the device executes while
    the host does other tick work (the pipelined tick uses this window)."""

    __slots__ = ("_model", "_res", "_host", "_event", "_prep", "_pinned")

    def __init__(self, model, res, host, event, prep, pinned=None):
        self._model = model
        self._res = res
        self._host = host      # (counts, free_after, nt_after) host tensors
        self._event = event    # None on the CPU, where the copy is done
        self._prep = prep
        self._pinned = pinned  # the _PinnedSet behind `host` on the card

    def result(self) -> np.ndarray:
        model = self._model
        prep = self._prep
        t0 = time.perf_counter()
        ranges = _ranges()
        ranges.begin("device_sync")
        if self._event is not None:
            self._event.synchronize()
        counts, free_after, nt_after = (t.numpy() for t in self._host)
        self._res.apply_outputs(free_after, nt_after)
        if self._pinned is not None:
            self._pinned.busy = False
        sync_ms = (time.perf_counter() - t0) * 1e3
        ranges.end("device_sync")
        # the cost the TICK pays: dispatch + readback wait. A synchronous
        # solve calls result() at once, so sync_ms holds the whole device
        # execution; a pipelined one calls it a tick later, when the
        # execution already overlapped host work
        model._observe("device", prep["shape_key"],
                       prep["dispatch_ms"] + sync_ms)
        model.last_phases = {
            "pad_ms": prep["pad_ms"],
            "visit_ms": prep["visit_ms"],
            "dispatch_ms": prep["dispatch_ms"],
            "sync_ms": sync_ms,
        }
        model._maybe_paranoid_check(prep, counts)
        return counts


class GreedyCutScanModel:
    """The production tick solve: padded buckets, the backend cost model,
    resident device state and the cut-scan kernel."""

    def __init__(self, device="cuda", backend="device"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"not {backend!r}")
        self.device = _resolve_device(device)
        self.backend = backend
        if self.device.type == "cuda":
            # build both kernels now, not inside the first solve, where a
            # build would run under the watchdog's deadline
            from hyperqueue_tpu_torch.ops.assign import _cut_scan_lib
            from hyperqueue_tpu_torch.ops.probe import _probe_lib

            _cut_scan_lib()
            _probe_lib()
        # which path the last solve ran (host-native / host-numpy /
        # device-cuda / device-cpu) and why the cost model chose it
        self.last_backend: str | None = None
        self.last_backend_reason: str = ""
        # persistent padded buffers, keyed by bucket shape: steady-state
        # ticks reuse the same host arrays instead of re-allocating and
        # re-zeroing every call
        self._buffers: dict[tuple, dict] = {}
        # counts NEW bucket-shape allocations: a steady-state tick must not
        # increment it
        self.shape_allocations = 0
        # per-phase latency of the last solve() in ms (pad/visit/dispatch/
        # sync) — consumed by the tick's phase breakdown
        self.last_phases: dict = {}
        self._res = DeviceResidency(self.device)
        # pinned host sets of the device path, per padded (counts, free)
        # shape; `pinned_sets` counts the sets made, which stops growing
        # once a steady tick finds a set that is not busy
        self._pinned: dict[tuple, list[_PinnedSet]] = {}
        self.pinned_sets = 0
        # per-shape EWMA of measured end-to-end solve ms, host vs device —
        # the backend decision reads these
        self._cost: dict[str, dict[tuple, float]] = {"host": {}, "device": {}}
        self._solves_since_device = 0
        # paranoid mode: every Nth RESIDENT device solve re-runs the same
        # padded inputs through a fresh full-upload solve and asserts
        # bitwise count equality (0 = off)
        self.paranoid_resident = 0
        self._resident_solves = 0
        self.paranoid_checks = 0

    # -- backend selection -------------------------------------------------
    def _sticky_host(self) -> bool | None:
        """Process-sticky part of the backend decision: True = host always
        (forced numpy, or a CPU model left on auto), False = device forced,
        None = a card model on auto — decide per solve."""
        if self.backend == "numpy":
            return True
        if self.backend == "device":
            return False
        if self.device.type == "cpu":
            # the plain PyTorch version is the kernel's stand-in, not a
            # solver to choose: on the CPU the host scan is the solve
            return True
        return None

    def _backend_decision(self, shape_key: tuple) -> tuple[str, str]:
        """("host"|"device", reason) for THIS solve.

        The cost model compares per-shape EWMAs of measured end-to-end
        solve times. Until a host measurement exists the budget rule
        applies (device only when its sync round trip fits the tick
        budget); a benched device is retried after DEVICE_RETRY_SOLVES and
        the sync probe re-runs every REPROBE_INTERVAL_S, so neither a slow
        first probe nor a transiently slow device is permanent."""
        sticky = self._sticky_host()
        if sticky is True:
            return "host", (
                "forced-numpy" if self.backend == "numpy" else "cpu-host"
            )
        if sticky is False:
            return "device", "forced-device"
        sync_ms = device_sync_ms(max_age_s=REPROBE_INTERVAL_S)
        if sync_ms is None:
            return "host", "sync-probe-pending"
        if sync_ms == float("inf"):
            # the JAX model benches the device here ("sync-probe-failed")
            # and solves on the host for ever; a probe kernel that fails
            # on the card is a fault to report, not a reason to move
            raise RuntimeError(
                f"the device sync probe failed: {probe_error()!r}"
            ) from probe_error()
        host_est = self._cost["host"].get(shape_key)
        dev_est = self._cost["device"].get(shape_key)
        if dev_est is not None and host_est is not None:
            if dev_est <= host_est:
                return "device", "cost-model"
            if (
                self._solves_since_device >= DEVICE_RETRY_SOLVES
                and sync_ms < host_est
            ):
                return "device", "periodic-retry"
            return "host", (
                f"cost-model (device {dev_est:.1f}ms > host {host_est:.1f}ms)"
            )
        if host_est is None and dev_est is not None:
            return "device", "cost-model"
        if host_est is not None:
            # no device measurement for this shape yet: its end-to-end time
            # is at least the sync round trip — try it when that alone
            # could beat the measured host time
            if sync_ms < host_est:
                return "device", "first-measurement"
            return "host", (
                f"sync {sync_ms:.1f}ms exceeds host {host_est:.1f}ms"
            )
        # no measurements at all: the conservative budget rule
        if sync_ms <= DISPATCH_LATENCY_BUDGET_MS:
            return "device", "sync-within-budget"
        return "host", (
            f"sync {sync_ms:.1f}ms exceeds the "
            f"{DISPATCH_LATENCY_BUDGET_MS:.0f}ms budget"
        )

    def _observe(self, kind: str, shape_key: tuple, ms: float) -> None:
        table = self._cost[kind]
        prev = table.get(shape_key)
        table[shape_key] = (
            ms if prev is None else prev + _EWMA_ALPHA * (ms - prev)
        )
        if kind == "device":
            self._solves_since_device = 0

    # -- solve -------------------------------------------------------------
    def solve(
        self,
        free: np.ndarray,       # (W, R) int32
        nt_free: np.ndarray,    # (W,) int32
        lifetime: np.ndarray,   # (W,) int32 seconds, INF_TIME when unlimited
        needs: np.ndarray,      # (B, V, R) int32
        sizes: np.ndarray,      # (B,) int32/int64
        min_time: np.ndarray,   # (B, V) int32 seconds
        priorities: list | None = None,  # accepted for model-interface
                                         # parity; rows are already in
                                         # descending priority order
        total: np.ndarray | None = None,     # (W, R) int32 pool totals
        all_mask: np.ndarray | None = None,  # (B, V, R) int32 0/1 ALL-policy
        weights: np.ndarray | None = None,   # (B, V) request weights,
                                             # consumed by run_tick's batch
                                             # order; accepted for parity
        gang_nodes: np.ndarray | None = None,    # (B,) int32 gang sizes
        gang_ok: np.ndarray | None = None,       # (W,) int32 host idleness
        group_onehot: np.ndarray | None = None,  # (W, G) int32 group map
        affinity: np.ndarray | None = None,      # (B, W) float policy
                                                 # weights per batch row
    ) -> np.ndarray:
        """Returns counts (B, V, W) int32 (unpadded, C-contiguous). On the
        card they lie in a pinned host set that a later solve reuses once
        this one is read: a caller that keeps them past its next solve
        copies them."""
        return self.solve_async(
            free, nt_free, lifetime, needs, sizes, min_time,
            total=total, all_mask=all_mask, gang_nodes=gang_nodes,
            gang_ok=gang_ok, group_onehot=group_onehot, affinity=affinity,
        ).result()

    def solve_async(self, free, nt_free, lifetime, needs, sizes, min_time,
                    priorities=None, total=None, all_mask=None, weights=None,
                    gang_nodes=None, gang_ok=None, group_onehot=None,
                    affinity=None):
        """Dispatch one solve; returns a handle whose `.result()` yields the
        unpadded counts. A host solve computes eagerly (the handle is a
        box); on the card the handle comes back with the kernel and the
        copies ENQUEUED, so the caller can overlap host work. A device
        solve that fails raises (no host fallback here), and so does a
        solve on "auto" after the sync probe failed."""
        prep = self.prepare(
            free, nt_free, lifetime, needs, sizes, min_time, total, all_mask,
            gang_nodes=gang_nodes, gang_ok=gang_ok,
            group_onehot=group_onehot, affinity=affinity,
        )
        backend, reason = self._backend_decision(prep["shape_key"])
        self.last_backend_reason = reason
        self._solves_since_device += 1
        if backend == "host":
            return self._host_solve(prep)
        return self._device_solve(prep)

    # -- preparation -------------------------------------------------------
    def prepare(self, free, nt_free, lifetime, needs, sizes, min_time,
                total=None, all_mask=None, gang_nodes=None, gang_ok=None,
                group_onehot=None, affinity=None, priorities=None,
                weights=None, fresh=False) -> dict:
        """Pad one solve's inputs into the persistent bucket buffers and
        compute the visit classes: returns the kernel's padded host inputs
        (free_p, nt_p, life_p, needs_p, sizes_p, mt_p, total_p, amask_p,
        gang_p, gok_p, goh_p, pmask_p, class_m, order_ids) with the live
        extents, the cost model's shape key and timings. Every backend
        solves from these.

        Gang rows: an all-zero `gang_nodes` is an ordinary solve; missing
        `gang_ok` / `group_onehot` mean no idle worker / one group of none.
        Affinity: a uniform positive matrix cannot reorder or exclude and
        is dropped; otherwise it keys the visit classes, and where some
        weight is <= 0 its positive entries become the policy mask.
        `priorities` and `weights` are taken as solve takes them, and
        ignored. `fresh` pads into new buffers that no later call reuses
        (solve_query)."""
        _t0 = time.perf_counter()
        n_w, n_r = free.shape
        n_b, n_v, _ = needs.shape

        pw = self._worker_bucket(n_w)
        pb = _bucket(max(n_b, 1), _BATCH_FLOOR)
        pr = _bucket(max(n_r, 1), _RESOURCE_FLOOR)
        pv = _bucket(max(n_v, 1), _VARIANT_FLOOR)

        if all_mask is not None and not np.any(all_mask):
            all_mask = None  # keep the common no-ALL buffers
        has_all = all_mask is not None
        if gang_nodes is not None and not np.any(np.asarray(gang_nodes) > 0):
            gang_nodes = None  # an all-zero gang column: no gang rows
        has_gang = gang_nodes is not None
        if affinity is not None:
            affinity = np.asarray(affinity, dtype=np.float32)
            if (
                affinity.size == 0
                or (affinity.min() == affinity.max() and affinity.min() > 0)
            ):
                # a uniform positive matrix cannot change the visit order
                # or exclude a worker
                affinity = None
        has_pmask = affinity is not None and bool(np.any(affinity <= 0))

        buf = (self._new_buffers(pw, pb, pr, pv, has_all) if fresh
               else self._get_buffers(pw, pb, pr, pv, has_all))
        free_p = buf["free"]
        nt_p = buf["nt"]
        life_p = buf["life"]
        needs_p = buf["needs"]
        sizes_p = buf["sizes"]
        mt_p = buf["mt"]
        # zero whatever the PREVIOUS call wrote beyond this call's extents
        # (same bucket, smaller active region), then fill the active slices
        lw, lb, lr, lv = buf["extents"]
        if lw > n_w:
            free_p[n_w:lw] = 0
            nt_p[n_w:lw] = 0
            life_p[n_w:lw] = 0
        if lr > n_r:
            free_p[:n_w, n_r:lr] = 0
            needs_p[:n_b, :n_v, n_r:lr] = 0
        if lb > n_b:
            needs_p[n_b:lb] = 0
            sizes_p[n_b:lb] = 0
        if lv > n_v:
            needs_p[:n_b, n_v:lv] = 0
        buf["extents"] = (n_w, n_b, n_r, n_v)

        free_p[:n_w, :n_r] = free
        nt_p[:n_w] = nt_free
        life_p[:n_w] = lifetime
        needs_p[:n_b, :n_v, :n_r] = needs
        sizes_p[:n_b] = np.minimum(sizes, np.int32(2**30))
        mt_p[:n_b, :n_v] = min_time
        # absent variants must never be eligible: give them infinite
        # min_time; padded batch rows get plain zeros in the live-variant
        # columns (size 0 keeps them inert either way, but the buffer must
        # match a fresh allocation exactly across variant-count changes)
        mt_p[:, n_v:] = int(INF_TIME)
        mt_p[n_b:, :n_v] = 0
        total_p = amask_p = None
        if has_all:
            total_p = buf["total"]
            amask_p = buf["amask"]
            if lw > n_w:
                total_p[n_w:lw] = 0
            if lr > n_r:
                total_p[:n_w, n_r:lr] = 0
                amask_p[:n_b, :n_v, n_r:lr] = 0
            if lb > n_b:
                amask_p[n_b:lb] = 0
            if lv > n_v:
                amask_p[:n_b, n_v:lv] = 0
            total_p[:n_w, :n_r] = total if total is not None else free
            amask_p[:n_b, :n_v, :n_r] = all_mask
        gang_p = gok_p = goh_p = None
        pg = 0
        if has_gang:
            # FRESH per-solve allocations, not persistent buffers: gang rows
            # appear on a minority of ticks, and the arrays are small
            n_g = group_onehot.shape[1] if group_onehot is not None else 1
            pg = _bucket(max(n_g, 1), _GROUP_FLOOR)
            gang_p = np.zeros(pb, dtype=np.int32)
            gang_p[:n_b] = gang_nodes
            gok_p = np.zeros(pw, dtype=np.int32)
            if gang_ok is not None:
                gok_p[:n_w] = gang_ok
            goh_p = np.zeros((pw, pg), dtype=np.int32)
            if group_onehot is not None:
                goh_p[:n_w, :n_g] = group_onehot
        aff_p = pmask_p = None
        if affinity is not None:
            # fresh per-solve allocations too: weighted objectives appear
            # only under an active policy
            aff_p = np.zeros((pb, pw), dtype=np.float32)
            aff_p[:n_b, :n_w] = affinity
            if has_pmask:
                pmask_p = np.zeros((pb, pw), dtype=np.int32)
                pmask_p[:n_b, :n_w] = (affinity > 0).astype(np.int32)
        _t1 = time.perf_counter()

        scarcity = np.asarray(
            scarcity_weights(free_p.astype(np.int64).sum(axis=0))
        ).astype(np.float32)
        class_m, order_ids = host_visit_classes(
            free_p, needs_p, scarcity, all_mask=amask_p, affinity=aff_p
        )
        _t2 = time.perf_counter()
        pm = _bucket(class_m.shape[0], _CLASS_FLOOR)

        return {
            "free_p": free_p, "nt_p": nt_p, "life_p": life_p,
            "needs_p": needs_p, "sizes_p": sizes_p, "mt_p": mt_p,
            "total_p": total_p, "amask_p": amask_p,
            "gang_p": gang_p, "gok_p": gok_p, "goh_p": goh_p,
            "pmask_p": pmask_p,
            "class_m": class_m, "order_ids": order_ids,
            "extents": (n_b, n_v, n_w),
            "shape_key": (pw, pb, pr, pv, pm, has_all, has_gang, pg,
                          has_pmask),
            "has_gang": has_gang, "has_pmask": has_pmask,
            "pad_ms": (_t1 - _t0) * 1e3,
            "visit_ms": (_t2 - _t1) * 1e3,
            "dispatch_ms": 0.0,
        }

    # -- host path ---------------------------------------------------------
    def _host_solve(self, prep) -> _ReadyCounts:
        _t0 = time.perf_counter()
        ranges = _ranges()
        ranges.begin("solve_dispatch")
        counts = self._host_counts(prep)
        _t1 = time.perf_counter()
        ranges.end("solve_dispatch")
        n_b, n_v, n_w = prep["extents"]
        out = np.ascontiguousarray(counts[:n_b, :n_v, :n_w])
        _t2 = time.perf_counter()
        self.last_phases = {
            "pad_ms": prep["pad_ms"],
            "visit_ms": prep["visit_ms"],
            "dispatch_ms": (_t1 - _t0) * 1e3,
            "sync_ms": (_t2 - _t1) * 1e3,
        }
        self._observe("host", prep["shape_key"], (_t2 - _t0) * 1e3)
        return _ReadyCounts(out)

    def _host_counts(self, prep) -> np.ndarray:
        """The host solve on the padded inputs: the native C++ scan when
        the library is available, else the numpy twin. Gang rows and the
        policy mask are numpy-only — the native scan has neither, so a
        solve carrying either bypasses it rather than silently dropping
        the constraint."""
        from hyperqueue_tpu_torch.utils.native import native_cut_scan

        args = (prep["free_p"], prep["nt_p"], prep["life_p"],
                prep["needs_p"], prep["sizes_p"], prep["mt_p"],
                prep["class_m"], prep["order_ids"])
        if not (prep["has_gang"] or prep["has_pmask"]):
            counts = native_cut_scan(*args, total=prep["total_p"],
                                     all_mask=prep["amask_p"])
            if counts is not None:
                self.last_backend = "host-native"
                return counts
        self.last_backend = "host-numpy"
        counts, _free_after, _nt_after = greedy_cut_scan_numpy(
            *args, total=prep["total_p"], all_mask=prep["amask_p"],
            gang_nodes=prep["gang_p"], gang_ok=prep["gok_p"],
            group_onehot=prep["goh_p"], policy_mask=prep["pmask_p"],
        )
        return counts

    # -- device path (resident state, in-place solve) ---------------------
    def invalidate_resident(self) -> None:
        """Drop the device-resident state (the next device solve uploads in
        full). The watchdog calls this whenever a solve is abandoned or
        degraded mid-flight: the resident tensors may then hold outputs the
        host never accounted for. A stranded solve may still be writing
        them; their memory returns to PyTorch's caching allocator and is
        reused only in the order of the stream they were used on."""
        self._res.invalidate()

    def resident_stats(self) -> dict:
        return {"backend": self.last_backend,
                "backend_reason": self.last_backend_reason,
                **self._res.stats(),
                "paranoid_checks": self.paranoid_checks,
                "pinned_sets": self.pinned_sets}

    def _kernel_inputs(self, prep, place):
        """The kernel's inputs other than free/nt_free/lifetime/total,
        each through `place` (host array -> tensor on the model's device)."""
        return dict(
            needs=place("needs", prep["needs_p"]),
            sizes=place("sizes", prep["sizes_p"]),
            min_time=place("min_time", prep["mt_p"]),
            class_m=place("class_m", prep["class_m"]),
            order_ids=place("order_ids", prep["order_ids"]),
            all_mask=place("all_mask", prep["amask_p"]),
            gang_nodes=place("gang_nodes", prep["gang_p"]),
            gang_ok=place("gang_ok", prep["gok_p"]),
            group_onehot=place("group_onehot", prep["goh_p"]),
            policy_mask=place("policy_mask", prep["pmask_p"]),
        )

    def _kernel_dispatch(self, free_d, nt_d, life_d, total_d, inputs,
                         site="tick"):
        """Launch the solve's kernel on device tensors (free_d/nt_d updated
        in place) and return its padded counts; the resident and the fresh
        solve both come here, and a subclass swaps the kernel here. `site`
        names the launch site in K1's counts."""
        return greedy_cut_scan(free_d, nt_d, life_d, total=total_d,
                               site=site, **inputs)

    def _device_solve(self, prep) -> _DeviceCounts:
        _t0 = time.perf_counter()
        ranges = _ranges()
        ranges.begin("solve_dispatch")
        res = self._res
        free_d, nt_d, life_d, total_d = res.sync(
            prep["free_p"], prep["nt_p"], prep["life_p"], prep["total_p"]
        )
        counts = self._kernel_dispatch(
            free_d, nt_d, life_d, total_d,
            self._kernel_inputs(prep, res.place_cached),
        )
        # the kernel updated free_d/nt_d in place: they are the state after
        # the tick and stay resident for the next one
        res.adopt_outputs(free_d, nt_d)
        n_b, n_v, n_w = prep["extents"]
        live = counts[:n_b, :n_v, :n_w].contiguous()
        pinned = None
        if self.device.type == "cuda":
            # copies and event on the current stream of the calling thread
            # (the watchdog's solve thread, or the tick's own)
            pinned = self._pinned_set(counts.numel(), tuple(free_d.shape))
            host = (pinned.counts[:live.numel()].view(live.shape),
                    pinned.free, pinned.nt)
            for dst, src in zip(host, (live, free_d, nt_d)):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            event = None
            host = (live, free_d.clone(), nt_d.clone())
        prep["dispatch_ms"] = (time.perf_counter() - _t0) * 1e3
        ranges.end("solve_dispatch")
        self.last_backend = f"device-{self.device.type}"
        self._resident_solves += 1
        return _DeviceCounts(self, res, host, event, prep, pinned)

    def _pinned_set(self, n_counts: int, free_shape: tuple) -> _PinnedSet:
        """A pinned set for one device solve: the first of this shape that
        no unread solve holds, else a new one. The server's order reads
        each solve before it dispatches the next, pipelined or not, so a
        steady run keeps one set per shape instead of allocating pinned
        memory per solve; a caller that dispatches before it reads gets a
        second."""
        key = (n_counts, free_shape)
        sets = self._pinned.pop(key, [])
        self._pinned[key] = sets  # most recently used last
        while len(self._pinned) > _PINNED_SHAPES:
            self._pinned.pop(next(iter(self._pinned)))
        for pinned in sets:
            if not pinned.busy:
                break
        else:
            pinned = _PinnedSet(n_counts, free_shape)
            sets.append(pinned)
            self.pinned_sets += 1
        pinned.busy = True
        return pinned

    def _maybe_paranoid_check(self, prep, out: np.ndarray) -> None:
        """Resident-vs-fresh bit-exactness guard: every paranoid_resident-th
        resident solve re-runs the SAME padded inputs through a fresh
        full-upload solve and asserts count equality. The padded buffers
        are untouched between dispatch and result (the pipeline maps a
        pending solve before preparing the next), so the comparison is
        exact by construction."""
        if (
            not self.paranoid_resident
            or self._resident_solves % self.paranoid_resident != 0
        ):
            return
        self.paranoid_checks += 1
        n_b, n_v, n_w = prep["extents"]
        fresh = self._fresh_device_counts(prep)[:n_b, :n_v, :n_w]
        if not np.array_equal(out, fresh):
            raise ResidentParanoidError(
                "paranoid-resident: device-resident counts diverge from a "
                "fresh full-upload solve of the same padded inputs"
            )

    def _fresh_device_counts(self, prep, site="tick") -> np.ndarray:
        """Full-upload reference solve: no residency, no placement cache.
        The kernel updates free/nt_free (and reads total) in place, so it
        gets COPIES of the padded buffers, never the buffers or the
        resident tensors."""
        def put(_name, arr):
            if arr is None:
                return None
            return torch.from_numpy(
                np.array(arr, dtype=np.int32, copy=True)
            ).to(self.device)

        counts = self._kernel_dispatch(
            put("free", prep["free_p"]), put("nt", prep["nt_p"]),
            put("life", prep["life_p"]), put("total", prep["total_p"]),
            self._kernel_inputs(prep, put), site=site,
        )
        return counts.cpu().numpy()

    # -- a solve that is no tick's (the autoalloc demand query) ----------
    def solve_query(self, free, nt_free, lifetime, needs, sizes, min_time,
                    priorities=None, total=None, all_mask=None, weights=None,
                    gang_nodes=None, gang_ok=None, group_onehot=None,
                    affinity=None) -> np.ndarray:
        """Solve once outside the tick's state; returns the unpadded
        counts (B, V, W) int32, equal to what `solve` gives on the same
        inputs.

        The autoalloc demand query (autoalloc/query.py) solves the real
        workers plus fake rows for the workers a queue could start. Its W
        differs from the tick's, and the kernel updates free/nt_free in
        place, so `solve` would replace the tick's resident state (and its
        mirror) with the query's. This path pads into buffers of its own,
        not the bucket buffers a pending tick solve is still read from;
        solves on the host where the ticks are sticky to it and otherwise
        launches the same kernel (K1's `alloc_query` site) on uploads of
        its own, on the calling thread's current stream, so after any tick
        solve dispatched there before it; and leaves the resident tensors,
        the mirror, the pinned sets, the cost model and the `last_*`
        telemetry as they were."""
        prep = self.prepare(
            free, nt_free, lifetime, needs, sizes, min_time, total, all_mask,
            gang_nodes=gang_nodes, gang_ok=gang_ok,
            group_onehot=group_onehot, affinity=affinity, fresh=True,
        )
        n_b, n_v, n_w = prep["extents"]
        if self._sticky_host() is True:
            last_backend = self.last_backend
            try:
                counts = self._host_counts(prep)
            finally:
                self.last_backend = last_backend
        else:
            counts = self._fresh_device_counts(prep, site="alloc_query")
        return np.ascontiguousarray(counts[:n_b, :n_v, :n_w])

    # -- padded-buffer management -----------------------------------------
    def _worker_bucket(self, n_w: int) -> int:
        """Padded W of a solve over n_w workers."""
        return _bucket(n_w, _WORKER_FLOOR)

    @staticmethod
    def _new_buffers(pw: int, pb: int, pr: int, pv: int,
                     has_all: bool) -> dict:
        """Zeroed padded host buffers of one bucket shape."""
        buf = {
            "free": np.zeros((pw, pr), dtype=np.int32),
            "nt": np.zeros(pw, dtype=np.int32),
            "life": np.zeros(pw, dtype=np.int32),
            "needs": np.zeros((pb, pv, pr), dtype=np.int32),
            "sizes": np.zeros(pb, dtype=np.int32),
            "mt": np.zeros((pb, pv), dtype=np.int32),
            "extents": (0, 0, 0, 0),
        }
        if has_all:
            buf["total"] = np.zeros((pw, pr), dtype=np.int32)
            buf["amask"] = np.zeros((pb, pv, pr), dtype=np.int32)
        return buf

    def _get_buffers(self, pw: int, pb: int, pr: int, pv: int,
                     has_all: bool) -> dict:
        """Persistent padded host buffers for one bucket shape (a new key
        is counted in `shape_allocations`)."""
        key = (pw, pb, pr, pv, has_all)
        buf = self._buffers.get(key)
        if buf is not None:
            # true LRU: a hit moves the shape to the end so the steady-state
            # bucket is never the eviction victim when rare shapes pass by
            self._buffers.pop(key)
            self._buffers[key] = buf
        if buf is None:
            self.shape_allocations += 1
            buf = self._new_buffers(pw, pb, pr, pv, has_all)
            self._buffers[key] = buf
            # bound the cache: bucket shapes are few (powers of two), but
            # a pathological workload must not grow this without limit
            while len(self._buffers) > 8:
                self._buffers.pop(next(iter(self._buffers)))
        return buf
