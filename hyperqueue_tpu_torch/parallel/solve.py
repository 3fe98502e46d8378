"""The sharded tick solve (K2): the cut-scan with the worker axis split into
contiguous shards.

Scaling model, as in the JAX package: the dense tick state is (W, R) with
W = workers, the axis that grows with the cluster. A mesh of D shards splits
it contiguously (W % D == 0, as shard_map requires); needs, sizes and the
other per-batch inputs are replicated.

Semantics: identical to the single-block kernel (ops/assign.greedy_cut_scan)
by construction. Both water-fill each (batch, variant) over the workers in
(visit class ascending, worker index ascending) order; with the worker axis
split contiguously, "worker index order" within a class is (shard
ascending, local index ascending), so each worker's prefix is

    prefix(w) = capacity of strictly-lower classes (cluster-wide)
              + capacity of w's class on lower shards
              + exclusive local cumsum within w's class

All three terms come from one exchange per step of every shard's (C,)
per-class capacity sums (C = N_VISIT_CLASSES = 16). A gang row exchanges
the (G,) per-group eligible counts instead, chooses the group from the
cluster-wide counts and shifts each shard's take-prefix by the chosen
group's eligible count on the lower shards.

A mesh is a tuple of torch.device, one per shard. Shards may repeat a
device: D shards of one card are D blocks of one launch of
csrc/sharded_scan.cu, which exchange their per-step vectors either as one
thread-block cluster (through distributed shared memory behind the cluster
barrier, where the card fits such a cluster: up to 16 blocks) or as a
cooperative grid (through a mailbox in device memory behind a grid
barrier, up to the blocks the card holds at once). A mesh over several cards
(the exchange through peer memory or NCCL) is not ported yet and raises
NotImplementedError (ROADMAP, Queue 1 item 1). On CPU tensors the solve runs
`sharded_cut_scan_reference`, its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hyperqueue_tpu_torch.ops.assign import (
    MAX_KERNEL_GROUPS,
    MAX_KERNEL_WORKERS,
    N_VISIT_CLASSES,
    SMEM_LIMIT,
    _UNNEEDED,
    _group_ids,
    _ring,
    _validate,
    ents_scratch,
)


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_worker_mesh(devices) -> tuple[torch.device, ...]:
    """The mesh of one shard per entry of `devices` (torch.device or
    strings). Repeats of one device are shards of that device; a mesh
    over more than one device raises NotImplementedError."""
    mesh = tuple(_normalize(d) for d in devices)
    if not mesh:
        raise ValueError("a worker mesh needs at least one shard")
    if len(set(mesh)) > 1:
        names = sorted(map(str, set(mesh)))
        raise NotImplementedError(
            f"a worker mesh over several devices ({names}) needs the "
            "multi-card exchange, not ported yet (ROADMAP, Queue 1 item 1);"
            " repeat one device for shards of one card"
        )
    return mesh


def shard_bounds(n_w: int, n_shards: int) -> list[tuple[int, int]]:
    """[lo, hi) worker rows of each shard: the contiguous split of the
    padded W, which must be a multiple of the shard count."""
    if n_shards < 1 or n_w % n_shards != 0:
        raise ValueError(
            f"W = {n_w} workers do not split into {n_shards} equal shards"
        )
    size = n_w // n_shards
    return [(d * size, (d + 1) * size) for d in range(n_shards)]


def place_tick_inputs(mesh, free, nt_free, lifetime, needs, sizes, min_time,
                      class_m, order_ids, total=None, all_mask=None,
                      gang_nodes=None, gang_ok=None, group_onehot=None,
                      policy_mask=None):
    """The tick's host arrays as int32 tensors on the mesh's device, in
    sharded_cut_scan's argument order (absent options stay None). Fresh
    copies: the solve updates free and nt_free in place."""
    def put(arr):
        if arr is None:
            return None
        return torch.from_numpy(
            np.array(arr, dtype=np.int32, copy=True)
        ).to(mesh[0])

    return tuple(put(a) for a in (
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_onehot, policy_mask,
    ))


def sharded_cut_scan_reference(
    mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
    order_ids, total=None, all_mask=None,
    gang_nodes=None, gang_ok=None, group_onehot=None, policy_mask=None,
):
    """The sharded cut-scan in plain PyTorch, shard by shard and step by
    step, as the JAX shard_map body computes it.

    Pure: returns (counts (B,V,W) int32, free_after (W,R) int32, nt_after
    (W,) int32). Each step, every shard computes its capacities and its
    (C,) per-class sums; the sums are stacked into (D, C) (the all_gather)
    and each shard fills its workers with the prefix of lower classes
    cluster-wide, plus its class on lower shards, plus the exclusive
    cumsum within its class (_sharded_water_fill_classed). A gang row
    stacks the (D, G) per-group eligible counts, chooses the first group
    with gang_nodes[b] eligible members (else the first with the most) and
    shifts each shard's take-prefix by the chosen group's count on the
    lower shards (_sharded_gang_select). Sums are int64; free and nt_free
    keep int32 wrap-around between steps.
    """
    bounds = shard_bounds(free.shape[0], len(mesh))
    n_b, n_v, _n_r = needs.shape
    dev = free.device
    i64 = torch.int64
    classes = torch.arange(N_VISIT_CLASSES, device=dev)
    # each shard's state: row ranges of the worker axis
    f = [free[lo:hi].to(torch.int32).clone() for lo, hi in bounds]
    nt = [nt_free[lo:hi].to(torch.int32).clone() for lo, hi in bounds]
    life = [lifetime[lo:hi].to(i64) for lo, hi in bounds]
    tot = None if total is None else [total[lo:hi].to(i64)
                                      for lo, hi in bounds]
    oid = order_ids.to(i64).clamp(0, class_m.shape[0] - 1)
    visit = class_m.to(i64).clamp(0, N_VISIT_CLASSES - 1)[oid]  # (B, V, W)
    counts = torch.zeros((n_b, n_v, free.shape[0]), dtype=torch.int32,
                         device=dev)
    zero = torch.zeros((), dtype=i64, device=dev)
    gangs = None
    if gang_nodes is not None:
        gangs = gang_nodes.tolist()
        avail = [gang_ok[lo:hi] != 0 for lo, hi in bounds]
        groups = [group_onehot[lo:hi] != 0 for lo, hi in bounds]
    for b in range(n_b):
        pmask = None if policy_mask is None else [
            policy_mask[b, lo:hi] > 0 for lo, hi in bounds]
        if gangs is not None and gangs[b] > 0:
            n = gangs[b]
            elig, local = [], []
            for d in range(len(bounds)):
                e = avail[d] & (min_time[b, 0].to(i64) <= life[d]) \
                    & (nt[d] >= 1)
                if pmask is not None:
                    e = e & pmask[d]
                elig.append(e)
                local.append((e[:, None] & groups[d]).sum(dim=0))
            gathered = torch.stack(local)  # (D, G)
            per_group = gathered.sum(dim=0)
            feasible = per_group >= n
            any_feasible = feasible.any()
            chosen = torch.where(
                any_feasible, torch.argmax(feasible.to(torch.int32)),
                torch.argmax(per_group),
            ).view(1)
            for d, (lo, hi) in enumerate(bounds):
                sel = (elig[d] & groups[d].index_select(1, chosen)[:, 0]) \
                    .to(i64)
                lower = gathered[:d].index_select(1, chosen).sum()
                take = (sel > 0) & (torch.cumsum(sel, 0) - sel + lower < n)
                counts[b, 0, lo:hi] = (take & any_feasible).to(torch.int32)
                keep = (~take).to(torch.int32)
                f[d] = f[d] * keep[:, None]
                nt[d] = nt[d] * keep
                avail[d] = avail[d] & ~take
            continue
        remaining = sizes[b].to(i64)
        for v in range(n_v):
            need = needs[b, v].to(i64)
            needed = need > 0
            all_r = None if all_mask is None else all_mask[b, v] > 0
            any_req = needed.any() if all_r is None \
                else needed.any() | all_r.any()
            caps, onehots, local = [], [], []
            for d, (lo, hi) in enumerate(bounds):
                f64 = f[d].to(i64)
                per_res = torch.where(
                    needed[None, :],
                    torch.div(f64, need.clamp(min=1)[None, :],
                              rounding_mode="floor"),
                    _UNNEEDED,
                )
                if all_r is not None:
                    fit = ((f64 == tot[d]) & (tot[d] > 0)).to(i64)
                    per_res = torch.where(all_r[None, :], fit, per_res)
                cap = torch.minimum(per_res.min(dim=1).values, nt[d].to(i64))
                ok = (min_time[b, v].to(i64) <= life[d]) & any_req
                cap = torch.where(ok, cap, zero).clamp(min=0)
                cap = torch.minimum(cap, remaining.clamp(min=0))
                if pmask is not None:
                    cap = torch.where(pmask[d], cap, zero)
                onehot = (visit[b, v, lo:hi, None] == classes).to(i64)
                caps.append(cap)
                onehots.append(onehot)
                local.append((cap[:, None] * onehot).sum(dim=0))
            gathered = torch.stack(local)  # (D, C)
            per_class = gathered.sum(dim=0)
            class_before = torch.cumsum(per_class, 0) - per_class
            for d, (lo, hi) in enumerate(bounds):
                cap, onehot = caps[d], onehots[d]
                cap_c = cap[:, None] * onehot
                within = torch.cumsum(cap_c, 0) - cap_c
                offset = class_before + gathered[:d].sum(dim=0)
                prefix = ((within + offset[None, :]) * onehot).sum(dim=1)
                a32 = torch.minimum((remaining - prefix).clamp(min=0),
                                    cap).to(torch.int32)
                f[d] = f[d] - a32[:, None] * need.to(torch.int32)[None, :]
                if all_r is not None:
                    f[d] = f[d] * (1 - a32[:, None]
                                   * all_r.to(torch.int32)[None, :])
                nt[d] = nt[d] - a32
                if gangs is not None:
                    avail[d] = avail[d] & (a32 == 0)
                counts[b, v, lo:hi] = a32
            remaining = remaining - torch.minimum(remaining.clamp(min=0),
                                                  per_class.sum())
    return counts, torch.cat(f), torch.cat(nt)


# the largest thread-block cluster (non-portable); the card may fit fewer
# blocks of a large layout, which the library's occupancy query says
CLUSTER_LIMIT = 16


def sharded_smem_bytes(n_wl, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                       resident) -> int:
    """Dynamic shared memory of one shard's block (n_wl workers) at these
    shapes, as csrc/cut_scan_core.cuh lays it out for the sharded kernel
    (make_layout with the sharded header and 32-bit visit orders; a card
    test holds it equal to hq_sharded_smem_bytes). The same for both
    exchanges."""
    return _ring(n_wl, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                 resident, sharded=True)[2]


def sharded_ring(n_wl, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                 resident) -> int:
    """Steps per ring chunk of that layout, negated where it is direct
    (hq_sharded_ring's answer)."""
    cs, direct, _n = _ring(n_wl, n_r, n_v, n_m, n_g, all_policy, gang,
                           masked, resident, sharded=True)
    return -cs if direct else cs


def sharded_exchange(n_shards: int, max_cluster: int = CLUSTER_LIMIT) -> str:
    """The exchange a launch of n_shards blocks runs: "cluster" where one
    thread-block cluster holds them (at most max_cluster), else "grid"."""
    return "cluster" if n_shards <= max_cluster else "grid"


def sharded_layout(n_w, n_shards, n_r, n_v, n_m, n_g=0, all_policy=False,
                   gang=False, masked=False, native=False) -> dict:
    """What a sharded launch at these shapes runs, chosen before the launch:
    the instantiation ("resident" where a shard's state fits its block's
    shared memory, else "global") and the exchange ("cluster" where one cluster of n_shards such blocks fits
    the card, else "grid"). With `native` the kernel library decides
    (hq_sharded_smem_bytes, hq_sharded_ring and the occupancy query
    hq_sharded_max_cluster; builds the kernel); else the mirror here, with
    CLUSTER_LIMIT for the largest cluster. Returns {"exchange",
    "instantiation", "resident_bytes", "global_bytes", "ring_steps",
    "max_cluster"}; raises where a shard is wider than one
    block takes."""
    shard_bounds(n_w, n_shards)
    n_wl = n_w // n_shards
    if n_wl > MAX_KERNEL_WORKERS:
        raise ValueError(
            f"the sharded kernel takes at most {MAX_KERNEL_WORKERS} workers "
            f"per shard, got {n_wl}"
        )
    shape = (n_wl, n_r, n_v, n_m, n_g if gang else 0, all_policy, gang,
             masked)
    if native:
        lib, _record = _sharded_scan_lib()
        args = [int(x) for x in shape]
        res = int(lib.hq_sharded_smem_bytes(*args, 1))
        glob = int(lib.hq_sharded_smem_bytes(*args, 0))
        limit = int(lib.hq_sharded_smem_limit())
    else:
        res = sharded_smem_bytes(*shape, True)
        glob = sharded_smem_bytes(*shape, False)
        limit = SMEM_LIMIT
    if glob > limit:
        raise ValueError(f"a shard's layout ({glob} bytes) exceeds {limit}")
    resident = res <= limit
    if native:
        ring = int(lib.hq_sharded_ring(*args, int(resident)))
        max_cluster = _native_max_cluster(*args, int(resident))
    else:
        ring = sharded_ring(*shape, resident)
        max_cluster = CLUSTER_LIMIT
    return {"exchange": sharded_exchange(n_shards, max_cluster),
            "instantiation": "resident" if resident else "global",
            "resident_bytes": res, "global_bytes": glob,
            "ring_steps": ring, "max_cluster": max_cluster}


@functools.lru_cache(maxsize=256)
def _native_max_cluster(*args) -> int:
    """hq_sharded_max_cluster (the card's occupancy query, up to 16 of
    them) once per layout shape in a process: the card does not change."""
    lib, _record = _sharded_scan_lib()
    return int(lib.hq_sharded_max_cluster(*args))


def _sharded_scan_lib():
    from hyperqueue_tpu_torch.ops.build import load_library

    lib, record = load_library("sharded_scan")
    if not getattr(lib, "_hq_prototypes", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hq_sharded_scan.argtypes = [vp] * 20 + [ci] * 9 + [vp]
        lib.hq_sharded_scan.restype = ci
        for name in ("hq_sharded_smem_bytes", "hq_sharded_ring"):
            getattr(lib, name).argtypes = [ci] * 9
        lib.hq_sharded_smem_bytes.restype = ctypes.c_longlong
        lib.hq_sharded_ring.restype = ci
        lib.hq_sharded_max_cluster.argtypes = [ci] * 9
        lib.hq_sharded_max_cluster.restype = ci
        lib.hq_sharded_smem_limit.restype = ctypes.c_longlong
        lib.hq_sharded_block_threads.restype = ci
        lib.hq_cluster_step_latency.argtypes = [ci, ci, vp, vp]
        lib.hq_cluster_step_latency.restype = ci
        lib.hq_grid_step_latency.argtypes = [ci, ci, vp, vp, vp]
        lib.hq_grid_step_latency.restype = ci
        lib._hq_prototypes = True
    return lib, record


def _launch_sharded(mesh, free, nt_free, lifetime, needs, sizes, min_time,
                    class_m, order_ids, total, all_mask, gang_nodes, gang_ok,
                    group_onehot, policy_mask, exchange, resident):
    """One launch of the named exchange and instantiation on these CUDA
    tensors (free and nt_free updated in place); returns
    (counts, cudaError)."""
    n_w, n_r, n_b, n_v, n_m, n_g = _validate(
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_onehot, policy_mask,
    )
    device = free.device
    n_d = len(mesh)
    shard_bounds(n_w, n_d)
    gang = gang_nodes is not None
    counts = torch.empty((n_b, n_v, n_w), dtype=torch.int32, device=device)
    if n_b == 0:
        return counts, 0
    group_ids = None if not gang else _group_ids(group_onehot)
    lib, _record = _sharded_scan_lib()
    ring = int(lib.hq_sharded_ring(
        n_w // n_d, n_r, n_v, n_m, n_g, int(total is not None), int(gang),
        int(policy_mask is not None), int(resident)))
    words = ents_scratch(n_r, ring, n_d)

    def scratch(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    order = None if resident else scratch((n_m, n_w))
    ents = None if words is None else scratch(words)
    grid = exchange == "grid"
    mail = scratch((2, n_d, N_VISIT_CLASSES)) if grid else None
    mail_g = scratch((2, n_d, n_g)) if grid and gang else None
    barrier = scratch(1) if grid else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hq_sharded_scan(
            free.data_ptr(), nt_free.data_ptr(), lifetime.data_ptr(),
            needs.data_ptr(), sizes.data_ptr(), min_time.data_ptr(),
            class_m.data_ptr(), order_ids.data_ptr(), ptr(total),
            ptr(all_mask), ptr(gang_nodes), ptr(gang_ok), ptr(group_ids),
            ptr(policy_mask), counts.data_ptr(), ptr(order), ptr(ents),
            ptr(mail), ptr(mail_g), ptr(barrier), n_w, n_r, n_b, n_v, n_m,
            n_g, n_d, 1 if exchange == "cluster" else 2, int(resident),
            stream,
        )
    return counts, rc


def sharded_cut_scan(
    mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
    order_ids, total=None, all_mask=None,
    gang_nodes=None, gang_ok=None, group_onehot=None, policy_mask=None,
):
    """The cut-scan over the mesh's D worker shards; returns counts
    (B, V, W) int32 and updates `free` and `nt_free` IN PLACE to the state
    after the solve (the counterpart of sharded_cut_scan_donate's donated
    buffers). Inputs as ops/assign.greedy_cut_scan, on the mesh's device,
    with W % D == 0.

    On CUDA tensors it launches the CUDA kernel (csrc/sharded_scan.cu), one
    block of 256 threads per shard, on the current stream, in the exchange
    and instantiation `sharded_layout(..., native=True)` picks by shape
    before the launch, and counts the launch in `sharded_cut_scan.launches` and in
    `.cluster_launches` or `.grid_launches` and `.resident_launches` or
    `.global_launches`; a refused launch (among others: more shards than
    the card holds at once) raises and nothing switches. On CPU tensors it
    runs `sharded_cut_scan_reference`.
    """
    n_w, n_r, n_b, n_v, n_m, n_g = _validate(
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_onehot, policy_mask,
    )
    device = free.device
    if _normalize(device) != mesh[0]:
        raise ValueError(f"the inputs are on {device}, the mesh on {mesh[0]}")
    n_d = len(mesh)
    shard_bounds(n_w, n_d)
    if device.type == "cpu":
        if gang_nodes is not None:
            _group_ids(group_onehot)  # the kernel's contract, checked alike
        counts, free_after, nt_after = sharded_cut_scan_reference(
            mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
            order_ids, total=total, all_mask=all_mask,
            gang_nodes=gang_nodes, gang_ok=gang_ok,
            group_onehot=group_onehot, policy_mask=policy_mask,
        )
        free.copy_(free_after)
        nt_free.copy_(nt_after)
        return counts
    if device.type != "cuda":
        raise ValueError(f"sharded_cut_scan runs on cuda or cpu, not {device}")
    if n_g > MAX_KERNEL_GROUPS:
        raise ValueError(
            f"the sharded kernel takes at most {MAX_KERNEL_GROUPS} worker "
            f"groups, got {n_g}"
        )
    layout = sharded_layout(n_w, n_d, n_r, n_v, n_m, n_g, total is not None,
                            gang_nodes is not None, policy_mask is not None,
                            native=True)
    resident = layout["instantiation"] == "resident"
    counts, rc = _launch_sharded(
        mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
        order_ids, total, all_mask, gang_nodes, gang_ok, group_onehot,
        policy_mask, layout["exchange"], resident)
    if rc != 0:
        raise RuntimeError(
            f"sharded cut-scan launch failed ({layout['exchange']}, "
            f"{layout['instantiation']}): cudaError {rc}")
    if n_b == 0:
        return counts
    f = sharded_cut_scan
    f.launches += 1
    if layout["exchange"] == "cluster":
        f.cluster_launches += 1
    else:
        f.grid_launches += 1
    if resident:
        f.resident_launches += 1
    else:
        f.global_launches += 1
    return counts


LAUNCH_COUNTS = ("launches", "cluster_launches", "grid_launches",
                 "resident_launches", "global_launches")
for _name in LAUNCH_COUNTS:
    setattr(sharded_cut_scan, _name, 0)


def reset_launch_counts() -> None:
    """Sets every launch count of sharded_cut_scan to 0."""
    for name in LAUNCH_COUNTS:
        setattr(sharded_cut_scan, name, 0)


def sharded_cut_scan_forced(
    mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
    order_ids, total=None, all_mask=None, gang_nodes=None, gang_ok=None,
    group_onehot=None, policy_mask=None, exchange="cluster", resident=True,
):
    """One launch of the named exchange ("cluster" or "grid") and
    instantiation on these CUDA tensors, whatever sharded_layout would
    pick: counts, with free/nt_free
    updated in place as by sharded_cut_scan. For checks and measurements
    only: not counted as a launch of the solve. Raises where the kernel
    refuses the launch."""
    counts, rc = _launch_sharded(
        mesh, free, nt_free, lifetime, needs, sizes, min_time, class_m,
        order_ids, total, all_mask, gang_nodes, gang_ok, group_onehot,
        policy_mask, exchange, resident)
    if rc != 0:
        kind = "resident" if resident else "global"
        raise RuntimeError(
            f"sharded cut-scan launch failed ({exchange}, {kind}): "
            f"cudaError {rc}")
    return counts


def _latency_ms(launch, device, steps) -> float:
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(2):  # the first launch warms up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = launch(stream.cuda_stream)
            end.record(stream)
            if rc != 0:
                raise RuntimeError(f"step latency launch failed: {rc}")
        end.synchronize()
    return start.elapsed_time(end) / steps


def grid_step_latency_ms(steps: int, n_shards: int, device="cuda") -> float:
    """Device time of one block-wide scan of the solve's kind plus one grid
    barrier over `n_shards` blocks of a shard's size (the grid exchange's
    per-step floor), from `steps` of them in one cooperative launch timed
    with CUDA events. Measurement only: the tick never calls it."""
    lib, _record = _sharded_scan_lib()
    out = torch.empty(n_shards, dtype=torch.int64, device=device)
    barrier = torch.empty(1, dtype=torch.int32, device=device)
    return _latency_ms(lambda s: lib.hq_grid_step_latency(
        steps, n_shards, barrier.data_ptr(), out.data_ptr(), s),
        device, steps)


def cluster_step_latency_ms(steps: int, n_shards: int,
                            device="cuda") -> float:
    """Device time of one block-wide scan of the solve's kind plus one
    cluster barrier over a cluster of `n_shards` blocks of a shard's size
    (the cluster exchange's per-step floor), from `steps` of them in one launch
    timed with CUDA events. Measurement only: the tick never calls it."""
    lib, _record = _sharded_scan_lib()
    out = torch.empty(n_shards, dtype=torch.int64, device=device)
    return _latency_ms(lambda s: lib.hq_cluster_step_latency(
        steps, n_shards, out.data_ptr(), s), device, steps)
