"""Greedy cut-scan scheduling model: bucketing + resident state around the
kernel.

Real ticks have varying worker, batch, resource and variant counts. This
wrapper pads every dimension up to a bucket (powers of two with a small
floor), so that steady-state ticks reuse the same persistent padded buffers
and device tensors.

Padding is semantically inert: padded workers have zero free resources and
zero task slots, are not idle for gangs and belong to no group; padded
batches have size 0 and no gang; padded variants are all-zero need rows
with an infinite min_time, which the kernel masks off.

The padded state stays RESIDENT on the device (parallel/resident.py): per-
tick uploads are only the dirty-row delta, the kernel updates free/nt_free
in place so the state after solve N feeds solve N+1 on the device, and the
padded counts are sliced to the live (B, V, W) extents on the device before
the copy to the host.

The model runs on the card (`device="cuda"`) unless the caller asks for the
CPU, where the kernel's plain PyTorch version solves. Without CUDA the
default model refuses to start rather than solving somewhere else.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hyperqueue_tpu_torch.ops.assign import (
    greedy_cut_scan,
    host_visit_classes,
    scarcity_weights,
)
from hyperqueue_tpu_torch.parallel.resident import DeviceResidency
from hyperqueue_tpu_torch.utils.constants import INF_TIME

# smallest bucket of each padded dimension
_WORKER_FLOOR = 8
_BATCH_FLOOR = 8
_RESOURCE_FLOOR = 4
_VARIANT_FLOOR = 1
_GROUP_FLOOR = 4


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


class _DeviceCounts:
    """In-flight device solve: the counts and the state after the solve are
    being copied to host memory behind `event`. `result()` waits for the
    copy, re-synchronizes the residency mirror and returns C-contiguous
    int32 counts."""

    __slots__ = ("_model", "_res", "_host", "_event", "_prep")

    def __init__(self, model, res, host, event, prep):
        self._model = model
        self._res = res
        self._host = host      # (counts, free_after, nt_after) host tensors
        self._event = event    # None on the CPU, where the copy is done
        self._prep = prep

    def result(self) -> np.ndarray:
        prep = self._prep
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        counts, free_after, nt_after = (t.numpy() for t in self._host)
        self._res.apply_outputs(free_after, nt_after)
        sync_ms = (time.perf_counter() - t0) * 1e3
        self._model.last_phases = {
            "pad_ms": prep["pad_ms"],
            "visit_ms": prep["visit_ms"],
            "dispatch_ms": prep["dispatch_ms"],
            "sync_ms": sync_ms,
        }
        return counts


class GreedyCutScanModel:
    """The production tick solve: padded buckets, resident device state and
    the cut-scan kernel."""

    def __init__(self, device="cuda"):
        self.device = _resolve_device(device)
        # which path the last solve ran; the tick's phase breakdown and the
        # smoke run report it
        self.last_backend: str | None = None
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

    # -- solve -------------------------------------------------------------
    def solve(
        self,
        free: np.ndarray,       # (W, R) int32
        nt_free: np.ndarray,    # (W,) int32
        lifetime: np.ndarray,   # (W,) int32 seconds, INF_TIME when unlimited
        needs: np.ndarray,      # (B, V, R) int32
        sizes: np.ndarray,      # (B,) int32/int64
        min_time: np.ndarray,   # (B, V) int32 seconds
        total: np.ndarray | None = None,     # (W, R) int32 pool totals
        all_mask: np.ndarray | None = None,  # (B, V, R) int32 0/1 ALL-policy
        gang_nodes: np.ndarray | None = None,    # (B,) int32 gang sizes
        gang_ok: np.ndarray | None = None,       # (W,) int32 host idleness
        group_onehot: np.ndarray | None = None,  # (W, G) int32 group map
        affinity: np.ndarray | None = None,      # (B, W) float policy
                                                 # weights per batch row
    ) -> np.ndarray:
        """Returns counts (B, V, W) int32 (unpadded, C-contiguous)."""
        return self.solve_async(
            free, nt_free, lifetime, needs, sizes, min_time,
            total=total, all_mask=all_mask, gang_nodes=gang_nodes,
            gang_ok=gang_ok, group_onehot=group_onehot, affinity=affinity,
        ).result()

    def solve_async(self, free, nt_free, lifetime, needs, sizes, min_time,
                    total=None, all_mask=None, gang_nodes=None, gang_ok=None,
                    group_onehot=None, affinity=None) -> _DeviceCounts:
        """Dispatch one solve; returns a handle whose `.result()` yields the
        unpadded counts. On the card the handle comes back with the kernel
        and the copies ENQUEUED, so the caller can overlap host work."""
        prep = self.prepare(
            free, nt_free, lifetime, needs, sizes, min_time, total, all_mask,
            gang_nodes=gang_nodes, gang_ok=gang_ok,
            group_onehot=group_onehot, affinity=affinity,
        )
        return self._device_solve(prep)

    # -- preparation -------------------------------------------------------
    def prepare(self, free, nt_free, lifetime, needs, sizes, min_time,
                total=None, all_mask=None, gang_nodes=None, gang_ok=None,
                group_onehot=None, affinity=None) -> dict:
        """Pad one solve's inputs into the persistent bucket buffers and
        compute the visit classes: returns the kernel's padded host inputs
        (free_p, nt_p, life_p, needs_p, sizes_p, mt_p, total_p, amask_p,
        gang_p, gok_p, goh_p, pmask_p, class_m, order_ids) with the live
        extents and timings.

        Gang rows: an all-zero `gang_nodes` is an ordinary solve; missing
        `gang_ok` / `group_onehot` mean no idle worker / one group of none.
        Affinity: a uniform positive matrix cannot reorder or exclude and
        is dropped; otherwise it keys the visit classes, and where some
        weight is <= 0 its positive entries become the policy mask."""
        _t0 = time.perf_counter()
        n_w, n_r = free.shape
        n_b, n_v, _ = needs.shape

        pw = _bucket(n_w, _WORKER_FLOOR)
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

        buf = self._get_buffers(pw, pb, pr, pv, has_all)
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

        return {
            "free_p": free_p, "nt_p": nt_p, "life_p": life_p,
            "needs_p": needs_p, "sizes_p": sizes_p, "mt_p": mt_p,
            "total_p": total_p, "amask_p": amask_p,
            "gang_p": gang_p, "gok_p": gok_p, "goh_p": goh_p,
            "pmask_p": pmask_p,
            "class_m": class_m, "order_ids": order_ids,
            "extents": (n_b, n_v, n_w),
            "pad_ms": (_t1 - _t0) * 1e3,
            "visit_ms": (_t2 - _t1) * 1e3,
            "dispatch_ms": 0.0,
        }

    # -- device path (resident state, in-place solve) ---------------------
    def resident_stats(self) -> dict:
        return {"backend": self.last_backend, **self._res.stats()}

    def _device_solve(self, prep) -> _DeviceCounts:
        _t0 = time.perf_counter()
        res = self._res
        free_d, nt_d, life_d, total_d = res.sync(
            prep["free_p"], prep["nt_p"], prep["life_p"], prep["total_p"]
        )
        counts = greedy_cut_scan(
            free_d, nt_d, life_d,
            res.place_cached("needs", prep["needs_p"]),
            res.place_cached("sizes", prep["sizes_p"]),
            res.place_cached("min_time", prep["mt_p"]),
            res.place_cached("class_m", prep["class_m"]),
            res.place_cached("order_ids", prep["order_ids"]),
            total=total_d,
            all_mask=res.place_cached("all_mask", prep["amask_p"]),
            gang_nodes=res.place_cached("gang_nodes", prep["gang_p"]),
            gang_ok=res.place_cached("gang_ok", prep["gok_p"]),
            group_onehot=res.place_cached("group_onehot", prep["goh_p"]),
            policy_mask=res.place_cached("policy_mask", prep["pmask_p"]),
        )
        # the kernel updated free_d/nt_d in place: they are the state after
        # the tick and stay resident for the next one
        res.adopt_outputs(free_d, nt_d)
        n_b, n_v, n_w = prep["extents"]
        live = counts[:n_b, :n_v, :n_w].contiguous()
        if self.device.type == "cuda":
            pinned = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (live, free_d, nt_d)
            ]
            for dst, src in zip(pinned, (live, free_d, nt_d)):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            host = tuple(pinned)
        else:
            event = None
            host = (live, free_d.clone(), nt_d.clone())
        prep["dispatch_ms"] = (time.perf_counter() - _t0) * 1e3
        self.last_backend = f"device-{self.device.type}"
        return _DeviceCounts(self, res, host, event, prep)

    # -- padded-buffer management -----------------------------------------
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
            self._buffers[key] = buf
            # bound the cache: bucket shapes are few (powers of two), but
            # a pathological workload must not grow this without limit
            while len(self._buffers) > 8:
                self._buffers.pop(next(iter(self._buffers)))
        return buf
