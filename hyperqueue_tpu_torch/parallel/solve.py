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
device: D shards of one card are D blocks of one cooperative launch of
csrc/sharded_scan.cu, which exchange their per-step vectors through a
mailbox in device memory behind a grid barrier. A mesh over several cards
(the exchange through peer memory or NCCL) is not ported yet and raises
NotImplementedError (ROADMAP, Queue 1 item 1). On CPU tensors the solve runs
`sharded_cut_scan_reference`, its plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hyperqueue_tpu_torch.ops.assign import (
    MAX_KERNEL_GROUPS,
    MAX_KERNEL_WORKERS,
    N_VISIT_CLASSES,
    _UNNEEDED,
    _group_ids,
    _validate,
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


def _sharded_scan_lib():
    from hyperqueue_tpu_torch.ops.build import load_library

    lib, record = load_library("sharded_scan")
    if not getattr(lib, "_hq_prototypes", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hq_sharded_scan.argtypes = [vp] * 20 + [ci] * 7 + [vp]
        lib.hq_sharded_scan.restype = ci
        lib.hq_grid_step_latency.argtypes = [ci, ci, vp, vp, vp]
        lib.hq_grid_step_latency.restype = ci
        lib._hq_prototypes = True
    return lib, record


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

    On CUDA tensors it launches the cooperative CUDA kernel
    (csrc/sharded_scan.cu), one block per shard, on the current stream,
    and counts the launch in `sharded_cut_scan.launches`; a refused launch
    (among others: more shards than the card holds at once) raises. On CPU
    tensors it runs `sharded_cut_scan_reference`.
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
    if n_w // n_d > MAX_KERNEL_WORKERS:
        raise ValueError(
            f"the sharded kernel takes at most {MAX_KERNEL_WORKERS} workers "
            f"per shard, got {n_w // n_d}"
        )
    if n_g > MAX_KERNEL_GROUPS:
        raise ValueError(
            f"the sharded kernel takes at most {MAX_KERNEL_GROUPS} worker "
            f"groups, got {n_g}"
        )
    counts = torch.empty((n_b, n_v, n_w), dtype=torch.int32, device=device)
    if n_b == 0:
        return counts
    group_ids = None if gang_nodes is None else _group_ids(group_onehot)
    lib, _record = _sharded_scan_lib()
    order = torch.empty((n_m, n_w), dtype=torch.int32, device=device)
    starts = torch.empty((n_m, n_d, N_VISIT_CLASSES + 1), dtype=torch.int32,
                         device=device)
    mail = torch.empty((2, n_d, N_VISIT_CLASSES), dtype=torch.int64,
                       device=device)
    mail_g = None if gang_nodes is None else torch.empty(
        (2, n_d, n_g), dtype=torch.int32, device=device)
    barrier = torch.empty(1, dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hq_sharded_scan(
            free.data_ptr(), nt_free.data_ptr(), lifetime.data_ptr(),
            needs.data_ptr(), sizes.data_ptr(), min_time.data_ptr(),
            class_m.data_ptr(), order_ids.data_ptr(), ptr(total),
            ptr(all_mask), ptr(gang_nodes), ptr(gang_ok), ptr(group_ids),
            ptr(policy_mask), counts.data_ptr(), order.data_ptr(),
            starts.data_ptr(), mail.data_ptr(), ptr(mail_g),
            barrier.data_ptr(), n_w, n_r, n_b, n_v, n_m, n_g, n_d, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sharded cut-scan launch failed: cudaError {rc}")
    sharded_cut_scan.launches += 1
    return counts


sharded_cut_scan.launches = 0


def grid_step_latency_ms(steps: int, n_shards: int, device="cuda") -> float:
    """Device time of one block-wide scan plus one grid barrier over
    `n_shards` blocks (the sharded kernel's per-step floor), from `steps`
    of them in one cooperative launch timed with CUDA events. Measurement
    only: the tick never calls it."""
    lib, _record = _sharded_scan_lib()
    device = torch.device(device)
    out = torch.empty(n_shards, dtype=torch.int64, device=device)
    barrier = torch.empty(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(2):  # the first launch warms up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = lib.hq_grid_step_latency(steps, n_shards, barrier.data_ptr(),
                                          out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            if rc != 0:
                raise RuntimeError(f"grid step latency launch failed: {rc}")
        end.synchronize()
    return start.elapsed_time(end) / steps
