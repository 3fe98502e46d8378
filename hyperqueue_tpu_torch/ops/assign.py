"""Dense scheduling-tick assignment: the greedy cut-scan (PyTorch + CUDA).

The per-tick decision "how many tasks of each request class go to each
worker" (the reference's MILP, crates/tako/src/internal/scheduler/
solver.rs:16-461) is a sequential scan over priority-ordered batches whose
every step water-fills one batch variant over all workers.

Host half (numpy, runs every tick on the host): `scarcity_weights` and
`host_visit_classes`, which give each worker its visit class per distinct
request mask.

Device half: `greedy_cut_scan` runs the scan as one hand-written CUDA kernel
(csrc/cut_scan.cu) on CUDA tensors, and as `greedy_cut_scan_reference`, its
plain PyTorch version, on CPU tensors.

Host solve: `greedy_cut_scan_numpy`, the numpy twin of the same scan (an own
copy of the JAX package's), which the model's cost model may pick instead
of the device (with the native scan, utils/native.py).

Semantics preserved from the reference solver:
  * Strict priority dominance with gap relaxation (solver.rs:240-410): a
    lower batch sees only the free resources left after every higher batch
    packed maximally.
  * Resource variants (request.rs:230), tried in user preference order.
  * min_time (request.rs:137): a variant is masked off on workers whose
    remaining lifetime is shorter.
  * Worker objective weights (solver.rs:520-549): the water-fill visits
    workers in an order that penalizes burning scarce resources a batch does
    not request, then lower index first.

Fused-mode additions (the JAX kernel's gang and policy-mask branches):
  * Gang rows: a multi-node task rides the scan as one all-or-nothing row
    that takes n idle workers of one worker group, or holds them without
    emitting when fewer are eligible.
  * Policy mask: an affinity weight of 0 excludes a worker from a batch.

Shapes (padded to buckets by the caller, models/greedy.py):
  free      (W, R) int32   free resource fractions per worker
  nt_free   (W,)   int32   remaining simultaneous-task slots per worker
  lifetime  (W,)   int32   remaining worker lifetime seconds (INF_TIME if none)
  needs     (B, V, R) int32  per-batch per-variant request vector; an all-zero
                             variant row is "variant absent"
  sizes     (B,)   int32   number of ready tasks in the batch (0 = padding row)
  min_time  (B, V) int32   per-variant minimal task duration in seconds
  class_m   (M, W) int32   visit class per distinct request mask, [0, 16)
  order_ids (B, V) int32   row of class_m each batch variant uses
  total     (W, R) int32   pool totals (ALL-policy only)
  all_mask  (B, V, R) int32  0/1 ALL-policy resources (ALL-policy only)
  gang_nodes (B,)   int32   gang size of a gang row, 0 = ordinary row
  gang_ok   (W,)    int32   0/1 host idleness (gang members must be idle)
  group_onehot (W, G) int32 0/1 worker group, at most one per worker
  policy_mask (B, W) int32  0/1, 0 = the policy excludes worker w for batch b
Output:
  counts    (B, V, W) int32  tasks of batch b, variant v to start on worker w
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hyperqueue_tpu_torch.utils.constants import INF_TIME  # noqa: F401

# Quantization of the waste score into the integer visit key: key =
# waste_q, waste_q in [0, _WASTE_Q].
_WASTE_Q = 65536

# Policy affinity weights are clamped to [0, _AFF_MAX] before quantization;
# the visit-class key combines (-affinity, waste) lexicographically, so the
# affinity term needs a multiplier strictly above the waste range.
_AFF_MAX = 256.0
# > max waste_q (waste <= 1 since scarcity sums to 1)
_AFF_STRIDE = _WASTE_Q * 2

# fixed class-axis width of the water-fill visit order; distinct waste levels
# per mask are clamped here (overflowing classes merge into the last one,
# which only relaxes the preference order among the most-wasteful workers)
N_VISIT_CLASSES = 16

# one kernel block, at most 16384 workers
MAX_KERNEL_WORKERS = 16384
# per-group eligible counts live in the block's shared memory
MAX_KERNEL_GROUPS = 16384

# The kernel's shared-memory layout (csrc/cut_scan_core.cuh make_layout), as
# the CPU tests' oracle: the dynamic shared memory an sm_90 block may opt
# into, the most steps of one ring chunk (and of a direct layout's chunk),
# and the fixed header (mbarriers, scan buffers, gang choice; a sharded
# block's also holds its class sums, the cluster mailbox and the warps'
# class offsets). The wrappers ask the kernel libraries themselves.
SMEM_LIMIT = 232448
_CHUNK_STEPS = 64
_DIRECT_CHUNK_STEPS = 8
_HEADER_BYTES = 1360
_SHARD_HEADER_BYTES = 5712
# bytes of one step entry (resource, need, reciprocal multiplier, kind and
# shift) in the ring or, for a direct layout, in device memory
ENTRY_BYTES = 16

# per-resource capacity of a resource the variant does not request
_UNNEEDED = 2**30


def scarcity_weights(total_amounts) -> np.ndarray:
    """(R,) float32 scarcity per resource, normalized to sum 1 (numpy, host).

    Rarer cluster-wide => larger weight. Resources with zero total capacity
    get weight 0 (nobody can waste them). total_amounts: (R,) summed capacity
    across workers.
    """
    total = np.asarray(total_amounts, dtype=np.float64)
    present = total > 0
    inv = np.where(
        present, total.max(initial=0.0) / np.maximum(total, 1.0), 0.0
    )
    norm = inv.sum()
    if norm <= 0:
        return np.zeros_like(total, dtype=np.float32)
    return (inv / norm).astype(np.float32)


def host_visit_classes(free0, needs, scarcity, all_mask=None, affinity=None):
    """Precompute worker visit classes per distinct request mask (numpy).

    The preference order (avoid burning scarce resources a request does not
    need, then lower worker index — reference solver.rs:520-549 objective)
    depends only on (a) which resources each request does NOT use and (b)
    which resources each worker has. Distinct "unused resource" masks per
    tick are few (M << B*V); each worker gets a visit CLASS per mask = dense
    rank of its waste score.

    affinity (B, W) float, optional: per-(batch, worker) policy weight. The
    visit key becomes the lexicographic pair (-affinity, waste), and the
    deduplication keys on (mask, affinity row). With affinity=None the
    classes depend on the masks alone.

    Returns (class_m (M, W) int32 in [0, N_VISIT_CLASSES), order_ids (B, V)
    int32).
    """
    n_b, n_v, _n_r = needs.shape
    has = np.asarray(free0) > 0  # (W, R)
    masks = np.asarray(needs) == 0  # (B, V, R): resources NOT requested
    if all_mask is not None:
        # an ALL-policy entry requests the resource (amount is the pool)
        masks = masks & ~(np.asarray(all_mask) > 0)
    flat = masks.reshape(n_b * n_v, -1)
    if affinity is None:
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        aff_u = None
    else:
        aff = np.clip(np.asarray(affinity, dtype=np.float64), 0.0, _AFF_MAX)
        aff_q = np.round(aff * _WASTE_Q).astype(np.int64)  # (B, W)
        aff_rep = np.repeat(aff_q, n_v, axis=0)  # (B*V, W)
        combined = np.concatenate([flat.astype(np.int64), aff_rep], axis=1)
        _u, index, inverse = np.unique(
            combined, axis=0, return_index=True, return_inverse=True
        )
        uniq = flat[index]
        aff_u = aff_rep[index]  # (M, W)
    weighted = has * np.asarray(scarcity)[None, :]  # (W, R)
    waste = np.einsum("mr,wr->mw", uniq.astype(np.float32), weighted)
    waste_q = np.round(waste * _WASTE_Q).astype(np.int64)
    key = waste_q if aff_u is None else waste_q - aff_u * np.int64(_AFF_STRIDE)
    class_m = np.empty_like(key, dtype=np.int32)
    for m in range(key.shape[0]):
        levels = np.unique(key[m])  # sorted ascending
        class_m[m] = np.searchsorted(levels, key[m]).astype(np.int32)
    np.clip(class_m, 0, N_VISIT_CLASSES - 1, out=class_m)
    order_ids = inverse.reshape(n_b, n_v).astype(np.int32)
    return class_m, order_ids


def _al16(n):
    return (n + 15) // 16 * 16


def _tma16(n):
    # a bulk-copy destination: the copy starts at the source's 16-byte
    # boundary below the data
    return _al16(n) + 16


def _layout_bytes(cs, n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                  resident, direct=False, sharded=False):
    # the layout with cs steps per ring chunk (layout_with)
    nb = (cs + n_v - 2) // n_v + 1  # most batches one chunk touches
    slot = (2 * _tma16(cs * 4) + _tma16(nb * 4) * (2 if gang else 1)
            + cs * 16)
    if not direct:
        slot += (_tma16(cs * n_r * 4) * (2 if all_policy else 1)
                 + cs * n_r * ENTRY_BYTES)
    n = (_SHARD_HEADER_BYTES if sharded else _HEADER_BYTES) + 2 * slot \
        + _tma16(n_w * 4)
    if gang:
        n += _al16(n_g * 4) + _al16(n_w)
    if resident:
        n += (_tma16(n_w * n_r * 4) * (2 if all_policy else 1)
              + _tma16(n_w * 4) * (3 if gang else 2)
              + _al16(n_m * n_w * (4 if sharded else 2))
              + (2 * _tma16(n_w * 4) if masked else 0))
    return n


def _ring(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked, resident,
          sharded=False):
    """(steps per chunk, direct, bytes) of the layout (make_layout): the
    most steps, up to _CHUNK_STEPS (at least one), with which it fits
    SMEM_LIMIT; where not even one step's inputs fit, a resident layout
    does not fit (the one-step layout, over the limit) and a global one is
    direct (_DIRECT_CHUNK_STEPS steps a chunk, the inputs of width R and
    the step entries in device memory), whose bytes may still be over the
    limit."""
    shape = (n_w, n_r, n_v, n_m, n_g if gang else 0, all_policy, gang,
             masked, resident)
    for cs in range(_CHUNK_STEPS, 0, -1):
        n = _layout_bytes(cs, *shape, sharded=sharded)
        if n <= SMEM_LIMIT:
            return cs, False, n
    if resident:
        return 1, False, n
    return (_DIRECT_CHUNK_STEPS, True,
            _layout_bytes(_DIRECT_CHUNK_STEPS, *shape, direct=True,
                          sharded=sharded))


def cut_scan_smem_bytes(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                        resident) -> int:
    """Dynamic shared memory of a cut-scan launch at these shapes, as the
    kernel lays it out (csrc/cut_scan_core.cuh make_layout; a card test
    holds the two equal): the header, a two-slot ring of step-input chunks,
    the capacity buffer, the gang carry and per-group counts and, on the
    resident instantiation, the worker state (free, nt_free, lifetime,
    total with ALL-policy, group ids with gang rows), the visit orders as
    16-bit indices and two policy-mask rows. The ring's chunk is the most
    steps, up to _CHUNK_STEPS, with which the layout fits SMEM_LIMIT; a
    chunk may end inside a batch. Where not even one step's inputs fit, the
    layout is direct (see _ring)."""
    return _ring(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                 resident)[2]


def cut_scan_ring(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                  resident) -> int:
    """Steps per ring chunk of the cut-scan's layout at these shapes,
    negated where the layout is direct (hq_cut_scan_ring's answer)."""
    cs, direct, _n = _ring(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                           resident)
    return -cs if direct else cs


def ents_scratch(n_r, ring_steps, n_blocks=1):
    """The step-entry scratch of a direct layout (ring_steps < 0): int32
    words for (blocks, 2 slots, steps, R) entries; None otherwise."""
    if ring_steps >= 0:
        return None
    return n_blocks * 2 * -ring_steps * n_r * ENTRY_BYTES // 4


def cut_scan_layout(n_w, n_r, n_v, n_m, n_g=0, all_policy=False, gang=False,
                    masked=False, native=False) -> dict:
    """Which instantiation of the cut-scan kernel a launch at these shapes
    runs, chosen before the launch: "resident" (the worker state in shared
    memory) where its layout fits, else "global" (the state in device
    memory), and that layout's ring: steps per chunk, negated where the
    layout is direct. With `native` the kernel library's own layout decides
    (native_smem_bytes, hq_cut_scan_smem_limit, hq_cut_scan_ring; builds the
    kernel), else its mirror here. Returns {"instantiation",
    "resident_bytes", "global_bytes", "ring_steps"}. Every R and V has a
    layout at W <= MAX_KERNEL_WORKERS; wider W raises."""
    if not 1 <= n_w <= MAX_KERNEL_WORKERS:
        raise ValueError(
            f"the cut-scan kernel takes 1 to {MAX_KERNEL_WORKERS} workers, "
            f"got {n_w}")
    nbytes = native_smem_bytes if native else cut_scan_smem_bytes
    ring = native_ring if native else cut_scan_ring
    shape = (n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked)
    res, glob = nbytes(*shape, True), nbytes(*shape, False)
    limit = (int(_cut_scan_lib()[0].hq_cut_scan_smem_limit()) if native
             else SMEM_LIMIT)
    if glob > limit:
        raise ValueError(
            f"the cut-scan kernel's shared memory ({glob} bytes at W={n_w}, "
            f"R={n_r}, V={n_v}, G={n_g}) exceeds {limit}")
    resident = res <= limit
    return {"instantiation": "resident" if resident else "global",
            "resident_bytes": res, "global_bytes": glob,
            "ring_steps": ring(*shape, resident)}


def largest_resident_w(n_r, n_v, n_m, n_g=0, all_policy=False, gang=False,
                       masked=False) -> int:
    """The widest W (at most MAX_KERNEL_WORKERS) whose resident layout
    fits SMEM_LIMIT at these shapes (the bytes grow with W)."""
    lo, hi = 1, MAX_KERNEL_WORKERS
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if cut_scan_smem_bytes(mid, n_r, n_v, n_m, n_g, all_policy, gang,
                               masked, True) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


def greedy_cut_scan_reference(
    free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
    total=None, all_mask=None,
    gang_nodes=None, gang_ok=None, group_onehot=None, policy_mask=None,
):
    """The cut-scan in plain PyTorch, one step per (batch, variant).

    Pure: returns (counts (B,V,W) int32, free_after (W,R) int32,
    nt_after (W,) int32) and leaves its inputs untouched. Sums are int64;
    free and nt_free keep int32 wrap-around arithmetic between steps. The
    scalar `remaining` stays a tensor, so on the card the loop waits for the
    device only once, to read the gang sizes.

    Gang rows (gang_nodes[b] > 0) and the policy mask follow the JAX
    kernel's scan_batches: a gang row picks the first worker group with
    gang_nodes[b] eligible members (idle in gang_ok, untouched by any
    earlier step of this solve, min_time of variant 0 within the lifetime,
    a task slot free, not masked), else the first group with the most; it
    takes that group's lowest-index eligible members, emits one count on
    each in variant 0 only if the gang is feasible, and holds them either
    way (free row and task slots zeroed). policy_mask[b, w] == 0 zeroes
    worker w's capacity for batch b after the remaining-size clamp.
    """
    n_w = free.shape[0]
    n_b, n_v, _n_r = needs.shape
    dev = free.device
    i64 = torch.int64
    f = free.to(torch.int32).clone()
    nt = nt_free.to(torch.int32).clone()
    life = lifetime.to(i64)
    need_all = needs.to(i64)
    n_classes = class_m.shape[0]
    # visit order per mask row: class ascending, then worker index
    cls = class_m.to(i64).clamp(0, N_VISIT_CLASSES - 1)
    idx = torch.arange(n_w, device=dev, dtype=i64)
    order = torch.argsort(cls * n_w + idx[None, :], dim=1)  # keys unique
    oid = order_ids.to(i64).clamp(0, n_classes - 1)
    tot = None if total is None else total.to(i64)
    counts = torch.zeros((n_b, n_v, n_w), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=i64, device=dev)
    gangs = None
    if gang_nodes is not None:
        gangs = gang_nodes.tolist()
        # the scan's gang-availability carry: idle and untouched so far
        avail = gang_ok != 0
        groups = group_onehot != 0
    pmask = None if policy_mask is None else policy_mask > 0
    for b in range(n_b):
        if gangs is not None and gangs[b] > 0:
            n = gangs[b]
            elig = avail & (min_time[b, 0].to(i64) <= life) & (nt >= 1)
            if pmask is not None:
                elig = elig & pmask[b]
            per_group = (elig[:, None] & groups).sum(dim=0)  # (G,)
            feasible = per_group >= n
            any_feasible = feasible.any()
            chosen = torch.where(
                any_feasible, torch.argmax(feasible.to(torch.int32)),
                torch.argmax(per_group),
            )
            sel = elig & groups.index_select(1, chosen.view(1))[:, 0]
            before = torch.cumsum(sel.to(i64), 0) - sel.to(i64)
            take = sel & (before < n)
            counts[b, 0] = (take & any_feasible).to(torch.int32)
            keep = (~take).to(torch.int32)
            f = f * keep[:, None]
            nt = nt * keep
            avail = avail & ~take
            continue
        remaining = sizes[b].to(i64)
        for v in range(n_v):
            need = need_all[b, v]
            needed = need > 0
            f64 = f.to(i64)
            per_res = torch.where(
                needed[None, :],
                torch.div(f64, need.clamp(min=1)[None, :],
                          rounding_mode="floor"),
                _UNNEEDED,
            )
            any_req = needed.any()
            all_r = None
            if all_mask is not None:
                all_r = all_mask[b, v].to(torch.int32)
                is_all = all_r > 0
                fit = ((f64 == tot) & (tot > 0)).to(i64)
                per_res = torch.where(is_all[None, :], fit, per_res)
                any_req = any_req | is_all.any()
            cap = per_res.min(dim=1).values
            cap = torch.minimum(cap, nt.to(i64))
            ok = (min_time[b, v].to(i64) <= life) & any_req
            cap = torch.where(ok, cap, zero).clamp(min=0)
            cap = torch.minimum(cap, remaining.clamp(min=0))
            if pmask is not None:
                cap = torch.where(pmask[b], cap, zero)
            perm = order[oid[b, v]]
            cap_sorted = cap[perm]
            prefix = torch.cumsum(cap_sorted, 0) - cap_sorted
            take = torch.minimum(
                (remaining - prefix).clamp(min=0), cap_sorted
            )
            assign = torch.empty_like(take)
            assign[perm] = take
            remaining = remaining - torch.minimum(
                remaining.clamp(min=0), cap.sum()
            )
            a32 = assign.to(torch.int32)
            f = f - a32[:, None] * need.to(torch.int32)[None, :]
            if all_r is not None:
                f = f * (1 - a32[:, None] * all_r[None, :])
            nt = nt - a32
            if gangs is not None:
                avail = avail & (assign == 0)
            counts[b, v] = a32
    return counts, f, nt


def greedy_cut_scan_numpy(
    free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
    total=None, all_mask=None,
    gang_nodes=None, gang_ok=None, group_onehot=None, policy_mask=None,
):
    """The cut-scan in numpy, on the host (identical semantics).

    The host solve of the model's cost model (models/greedy.py) when the
    native scan is unavailable or the solve carries gang rows or a policy
    mask, and the solver watchdog's fallback. Pure: returns (counts
    (B,V,W) int32, free_after (W,R) int64, nt_after (W,) int64).
    """
    free = np.asarray(free, dtype=np.int64).copy()
    nt_free = np.asarray(nt_free, dtype=np.int64).copy()
    lifetime = np.asarray(lifetime)
    if total is not None:
        total = np.asarray(total, dtype=np.int64)
    n_b, n_v, _n_r = needs.shape
    n_w = free.shape[0]
    counts = np.zeros((n_b, n_v, n_w), dtype=np.int32)
    class_ids = np.asarray(class_m)[np.asarray(order_ids)]  # (B, V, W)
    idx = np.arange(n_w)
    has_gang = gang_nodes is not None
    if has_gang:
        gang_nodes = np.asarray(gang_nodes)
        gang_avail = np.asarray(gang_ok, dtype=bool).copy()
        group_oh = np.asarray(group_onehot, dtype=bool)  # (W, G)
    pmask = (
        np.asarray(policy_mask) > 0 if policy_mask is not None else None
    )  # (B, W) bool

    for b in range(n_b):
        remaining = int(sizes[b])
        if has_gang and gang_nodes[b] > 0:
            # all-or-nothing gang row (see scan_batches): feasible -> emit
            # n co-scheduled counts in variant 0; either way HOLD the
            # selected workers for the rest of the scan
            n = int(gang_nodes[b])
            elig = (
                gang_avail
                & (min_time[b, 0] <= lifetime)
                & (nt_free >= 1)
            )
            if pmask is not None:
                elig = elig & pmask[b]
            per_group = (elig[:, None] & group_oh).sum(axis=0)  # (G,)
            feasible = per_group >= n
            chosen = int(
                np.argmax(feasible) if feasible.any()
                else np.argmax(per_group)
            )
            sel = elig & group_oh[:, chosen]
            prefix = np.cumsum(sel) - sel
            take = sel & (prefix < n)
            if feasible.any():
                counts[b, 0, take] = 1
            free[take] = 0
            nt_free[take] = 0
            gang_avail[take] = False
            continue
        for v in range(n_v):
            if remaining <= 0:
                break
            need = needs[b, v]
            needed = need > 0
            all_r = (
                np.asarray(all_mask[b, v]) > 0 if all_mask is not None
                else np.zeros_like(needed)
            )
            if not needed.any() and not all_r.any():
                continue
            if needed.any():
                per_res = np.min(
                    free[:, needed]
                    // np.asarray(need, dtype=np.int64)[needed],
                    axis=1,
                )
            else:
                per_res = np.full(n_w, 2**30, dtype=np.int64)
            if all_r.any():
                # ALL-policy resources: fits only on a fully idle pool,
                # at most one task per worker (solver.rs:120-124)
                all_fit = (
                    (free[:, all_r] == total[:, all_r])
                    & (total[:, all_r] > 0)
                ).all(axis=1)
                per_res = np.minimum(per_res, all_fit.astype(np.int64))
            cap = np.minimum(per_res, nt_free)
            cap[min_time[b, v] > lifetime] = 0
            np.clip(cap, 0, remaining, out=cap)
            if pmask is not None:
                cap[~pmask[b]] = 0
            if not cap.any():
                continue
            order = np.lexsort((idx, class_ids[b, v]))
            cap_sorted = cap[order]
            cum = np.cumsum(cap_sorted)
            take_sorted = np.clip(remaining - (cum - cap_sorted), 0, cap_sorted)
            assign = np.empty(n_w, dtype=np.int64)
            assign[order] = take_sorted
            assigned = int(take_sorted.sum())
            remaining -= assigned
            free -= assign[:, None] * need[None, :]
            if all_r.any():
                free[:, all_r] *= 1 - assign[:, None]
            nt_free -= assign
            if has_gang:
                gang_avail[assign > 0] = False
            counts[b, v] = assign
    return counts, free, nt_free


def _cut_scan_lib():
    from hyperqueue_tpu_torch.ops.build import load_library

    lib, record = load_library("cut_scan")
    if not getattr(lib, "_hq_prototypes", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        for entry in (lib.hq_cut_scan, lib.hq_cut_scan_resident):
            entry.argtypes = [vp] * 17 + [ci] * 6 + [vp]
            entry.restype = ci
        lib.hq_cut_scan_smem_bytes.argtypes = [ci] * 9
        lib.hq_cut_scan_smem_bytes.restype = ll
        lib.hq_cut_scan_ring.argtypes = [ci] * 9
        lib.hq_cut_scan_ring.restype = ci
        lib.hq_cut_scan_smem_limit.restype = ll
        lib.hq_cut_scan_block_threads.restype = ci
        lib.hq_recip_check.argtypes = [ll, ll, vp, vp]
        lib.hq_recip_check.restype = ci
        for entry in (lib.hq_scan_latency, lib.hq_scan_latency_legacy):
            entry.argtypes = [ci, vp, vp]
            entry.restype = ci
        lib.hq_step_split.argtypes = [ci] + [vp] * 6 + [ci] * 4 + [vp, vp]
        lib.hq_step_split.restype = ci
        lib._hq_prototypes = True
    return lib, record


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _group_ids(group_onehot):
    """(W,) int32 group index of each worker, -1 where its row is all zero.
    Raises unless every row of the one-hot is 0/1 with at most one 1 (on
    the card this check reads one flag back, a synchronization)."""
    bad = ((group_onehot != 0) & (group_onehot != 1)).any() | (
        group_onehot.sum(dim=1) > 1
    ).any()
    if bool(bad):
        raise ValueError(
            "group_onehot must be 0/1 with at most one group per worker"
        )
    member = group_onehot.sum(dim=1) > 0
    ids = torch.argmax(group_onehot, dim=1).to(torch.int32)
    return torch.where(member, ids, torch.full_like(ids, -1)).contiguous()


def _validate(free, nt_free, lifetime, needs, sizes, min_time, class_m,
              order_ids, total, all_mask, gang_nodes, gang_ok, group_onehot,
              policy_mask):
    """Raises unless the cut-scan's inputs are int32, contiguous, on one
    device and of consistent shapes (see greedy_cut_scan); returns
    (W, R, B, V, M, G), G = 0 without gang rows."""
    if (total is None) != (all_mask is None):
        raise ValueError("total and all_mask come together")
    gang = (gang_nodes, gang_ok, group_onehot)
    if any(x is None for x in gang) and any(x is not None for x in gang):
        raise ValueError("gang_nodes, gang_ok and group_onehot come together")
    device = free.device
    n_w, n_r = free.shape
    n_b, n_v = min_time.shape
    n_m = class_m.shape[0]
    for name, t, shape in (
        ("free", free, (n_w, n_r)), ("nt_free", nt_free, (n_w,)),
        ("lifetime", lifetime, (n_w,)), ("needs", needs, (n_b, n_v, n_r)),
        ("sizes", sizes, (n_b,)), ("min_time", min_time, (n_b, n_v)),
        ("class_m", class_m, (n_m, n_w)), ("order_ids", order_ids, (n_b, n_v)),
    ):
        _check(name, t, shape, device)
    if total is not None:
        _check("total", total, (n_w, n_r), device)
        _check("all_mask", all_mask, (n_b, n_v, n_r), device)
        if total.data_ptr() == free.data_ptr():
            raise ValueError("total must not share free's storage")
    n_g = 0
    if gang_nodes is not None:
        if group_onehot.dim() != 2 or group_onehot.shape[1] < 1:
            raise ValueError("group_onehot must be (W, G) with G >= 1")
        n_g = group_onehot.shape[1]
        _check("gang_nodes", gang_nodes, (n_b,), device)
        _check("gang_ok", gang_ok, (n_w,), device)
        _check("group_onehot", group_onehot, (n_w, n_g), device)
    if policy_mask is not None:
        _check("policy_mask", policy_mask, (n_b, n_w), device)
    if n_r < 1 or n_v < 1 or (n_m < 1 and n_b > 0):
        raise ValueError(
            f"need R >= 1, V >= 1 and M >= 1 (got R={n_r}, V={n_v}, "
            f"M={n_m})"
        )
    return n_w, n_r, n_b, n_v, n_m, n_g


def greedy_cut_scan(
    free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
    total=None, all_mask=None,
    gang_nodes=None, gang_ok=None, group_onehot=None, policy_mask=None,
):
    """The cut-scan; returns counts (B, V, W) int32 and updates `free` and
    `nt_free` IN PLACE to the state after the solve (the counterpart of the
    JAX kernel's donated free/nt_free buffers).

    Optional inputs, all int32: `total` (W, R) with `all_mask` (B, V, R)
    for ALL-policy requests; `gang_nodes` (B,), `gang_ok` (W,) and
    `group_onehot` (W, G), together, for all-or-nothing gang rows;
    `policy_mask` (B, W) 0/1 for the policy's hard exclusions. See
    greedy_cut_scan_reference for their semantics.

    On CUDA tensors it launches the CUDA kernel (csrc/cut_scan.cu) on the
    current stream, in the instantiation `cut_scan_layout` picks by shape
    before the launch (the worker state in shared memory where it fits,
    else in device memory), and counts the launch in
    `greedy_cut_scan.launches` and in `.resident_launches` or
    `.global_launches` (and, when gang rows or a policy mask ride it, in
    `.gang_launches` too); a refused launch raises. On CPU tensors it runs
    `greedy_cut_scan_reference`. The launch does not synchronize, except to
    validate a group one-hot (see _group_ids).
    """
    n_w, n_r, n_b, n_v, n_m, n_g = _validate(
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_onehot, policy_mask,
    )
    device = free.device
    if device.type == "cpu":
        if gang_nodes is not None:
            _group_ids(group_onehot)  # the kernel's contract, checked alike
        counts, free_after, nt_after = greedy_cut_scan_reference(
            free, nt_free, lifetime, needs, sizes, min_time, class_m,
            order_ids, total=total, all_mask=all_mask,
            gang_nodes=gang_nodes, gang_ok=gang_ok,
            group_onehot=group_onehot, policy_mask=policy_mask,
        )
        free.copy_(free_after)
        nt_free.copy_(nt_after)
        return counts
    if device.type != "cuda":
        raise ValueError(f"greedy_cut_scan runs on cuda or cpu, not {device}")
    if n_w > MAX_KERNEL_WORKERS:
        raise ValueError(
            f"the cut-scan kernel takes at most {MAX_KERNEL_WORKERS} "
            f"workers, got {n_w}"
        )
    if n_g > MAX_KERNEL_GROUPS:
        raise ValueError(
            f"the cut-scan kernel takes at most {MAX_KERNEL_GROUPS} "
            f"worker groups, got {n_g}"
        )
    counts = torch.empty((n_b, n_v, n_w), dtype=torch.int32, device=device)
    if n_b == 0:
        return counts
    lib, _record = _cut_scan_lib()
    layout = cut_scan_layout(
        n_w, n_r, n_v, n_m, n_g, total is not None, gang_nodes is not None,
        policy_mask is not None, native=True,
    )
    resident = layout["instantiation"] == "resident"
    group_ids = None if gang_nodes is None else _group_ids(group_onehot)
    rc = _launch(
        lib.hq_cut_scan_resident if resident else lib.hq_cut_scan,
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_ids, policy_mask, counts,
        n_g, order=None if resident else torch.empty(
            (n_m, n_w), dtype=torch.int32, device=device),
        ents=_ents(n_r, layout["ring_steps"], 1, device),
    )
    if rc != 0:
        raise RuntimeError(
            f"cut-scan kernel launch ({layout['instantiation']}) failed: "
            f"cudaError {rc}"
        )
    greedy_cut_scan.launches += 1
    if resident:
        greedy_cut_scan.resident_launches += 1
    else:
        greedy_cut_scan.global_launches += 1
    if gang_nodes is not None or policy_mask is not None:
        greedy_cut_scan.gang_launches += 1
    return counts


greedy_cut_scan.launches = 0
greedy_cut_scan.resident_launches = 0
greedy_cut_scan.global_launches = 0
greedy_cut_scan.gang_launches = 0


def reset_launch_counts() -> None:
    """Sets every launch count of greedy_cut_scan to 0."""
    for name in ("launches", "resident_launches", "global_launches",
                 "gang_launches"):
        setattr(greedy_cut_scan, name, 0)


def _ents(n_r, ring_steps, n_blocks, device):
    """The step-entry scratch of a direct layout on `device`, else None."""
    words = ents_scratch(n_r, ring_steps, n_blocks)
    if words is None:
        return None
    return torch.empty(words, dtype=torch.int32, device=device)


def _launch(entry, free, nt_free, lifetime, needs, sizes, min_time, class_m,
            order_ids, total, all_mask, gang_nodes, gang_ok, group_ids,
            policy_mask, counts, n_g, order=None, ents=None):
    """Calls one of the kernel's C entries with the tensors' pointers and
    shapes (n_g worker groups) on the current stream of their device;
    returns its cudaError."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    n_w, n_r = free.shape
    n_b, n_v = min_time.shape
    device = free.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return entry(
            free.data_ptr(), nt_free.data_ptr(), lifetime.data_ptr(),
            needs.data_ptr(), sizes.data_ptr(), min_time.data_ptr(),
            class_m.data_ptr(), order_ids.data_ptr(), ptr(total),
            ptr(all_mask), ptr(gang_nodes), ptr(gang_ok), ptr(group_ids),
            ptr(policy_mask), counts.data_ptr(), ptr(order), ptr(ents),
            n_w, n_r, n_b, n_v, class_m.shape[0], n_g, stream,
        )


def _events_ms(device, launch, reps, warm=1) -> float:
    """Mean device ms of `launch()` (which returns a cudaError) over `reps`
    calls on the current stream, by CUDA events after `warm` calls; raises
    on a refused launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for n in (warm, reps):  # the first round warms up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(n):
                rc = launch()
                if rc != 0:
                    raise RuntimeError(f"measurement launch failed: {rc}")
            end.record(stream)
        end.synchronize()
    return start.elapsed_time(end) / reps


def prologue_ms(class_m, reps=20, resident=False) -> float:
    """Device ms of the kernel's prologue alone (the counting sort of every
    visit-class row into visit order; resident: also the state's copy in
    and out, at R = 1) at this (M, W) table: a launch with no batches runs
    nothing else. CUDA events over `reps` launches after one warm-up.
    Measurement only: the tick never calls it, and it does not count as a
    launch of the solve."""
    lib, _record = _cut_scan_lib()
    device = class_m.device
    n_m, n_w = class_m.shape
    _check("class_m", class_m, (n_m, n_w), device)
    dummy = torch.zeros(max(n_w, 1), dtype=torch.int32, device=device)
    order = torch.empty((n_m, n_w), dtype=torch.int32, device=device)
    p = dummy.data_ptr()
    entry = lib.hq_cut_scan_resident if resident else lib.hq_cut_scan
    stream = torch.cuda.current_stream(device).cuda_stream
    return _events_ms(device, lambda: entry(
        p, p, p, p, p, p, class_m.data_ptr(), p, None, None, None, None,
        None, None, p, order.data_ptr(), None, n_w, 1, 0, 1, n_m, 0, stream,
    ), reps)


def scan_step_latency_ms(steps: int, device="cuda", legacy=False) -> float:
    """Device time of one block-wide scan with its barrier (the kernel's
    per-step floor: the one-barrier saturating scan; with `legacy`, the
    int64 scan and closing barrier), from `steps` of them in one launch
    timed with CUDA events. Measurement only: the tick never calls it."""
    lib, _record = _cut_scan_lib()
    device = torch.device(device)
    out = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    entry = lib.hq_scan_latency_legacy if legacy else lib.hq_scan_latency
    return _events_ms(device, lambda: entry(
        steps, out.data_ptr(), stream), 1) / steps


def cut_scan_forced(free, nt_free, lifetime, needs, sizes, min_time,
                    class_m, order_ids, total=None, all_mask=None,
                    gang_nodes=None, gang_ok=None, group_onehot=None,
                    policy_mask=None, resident=True):
    """One launch of the named instantiation on these CUDA tensors,
    whatever the layout would pick: counts, with free/nt_free updated in
    place as by greedy_cut_scan. For checks and measurements only: not counted as a
    launch of the solve. Raises where the kernel refuses the launch (a
    resident layout past SMEM_LIMIT is refused, never switched)."""
    n_w, n_r, n_b, n_v, n_m, n_g = _validate(
        free, nt_free, lifetime, needs, sizes, min_time, class_m, order_ids,
        total, all_mask, gang_nodes, gang_ok, group_onehot, policy_mask,
    )
    lib, _record = _cut_scan_lib()
    device = free.device
    group_ids = None if gang_nodes is None else _group_ids(group_onehot)
    counts = torch.empty((n_b, n_v, n_w), dtype=torch.int32, device=device)
    order = torch.empty((n_m, n_w), dtype=torch.int32, device=device)
    ring = native_ring(n_w, n_r, n_v, n_m, n_g, total is not None,
                       gang_nodes is not None, policy_mask is not None,
                       resident)
    rc = _launch(
        lib.hq_cut_scan_resident if resident else lib.hq_cut_scan, free,
        nt_free, lifetime, needs, sizes, min_time, class_m, order_ids, total,
        all_mask, gang_nodes, gang_ok, group_ids, policy_mask, counts, n_g,
        order=order, ents=_ents(n_r, ring, 1, device),
    )
    if rc != 0:
        kind = "resident" if resident else "global"
        raise RuntimeError(
            f"cut-scan kernel launch ({kind}) failed: cudaError {rc}")
    return counts


def cut_scan_variant_ms(free, nt_free, *args, reps=20, **kwargs) -> float:
    """Device ms of one cut_scan_forced launch (same arguments) at these
    inputs, by CUDA events over `reps` launches after one warm-up, each on
    a copy of free/nt_free made before the timing. Measurement only."""
    states = iter([(free.clone(), nt_free.clone()) for _ in range(reps + 1)])

    def launch():
        cut_scan_forced(*next(states), *args, **kwargs)
        return 0

    return _events_ms(free.device, launch, reps)


def native_smem_bytes(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                      resident) -> int:
    """The kernel's own layout bytes at these shapes (hq_cut_scan_smem_bytes;
    builds the kernel). cut_scan_smem_bytes must give the same number."""
    lib, _record = _cut_scan_lib()
    return int(lib.hq_cut_scan_smem_bytes(
        n_w, n_r, n_v, n_m, n_g if gang else 0, int(all_policy), int(gang),
        int(masked), int(resident)))


def native_ring(n_w, n_r, n_v, n_m, n_g, all_policy, gang, masked,
                resident) -> int:
    """The kernel's own ring at these shapes (hq_cut_scan_ring: steps per
    chunk, negated where direct); cut_scan_ring must give the same."""
    lib, _record = _cut_scan_lib()
    return int(lib.hq_cut_scan_ring(
        n_w, n_r, n_v, n_m, n_g if gang else 0, int(all_policy), int(gang),
        int(masked), int(resident)))


def recip_check(d0: int, d1: int, device="cuda") -> int:
    """Divisors in [d0, d1) whose per-step reciprocal (csrc/cut_scan.cu
    make_recip, recip_div) disagrees with the card's division at the
    dividends where a wrong multiplier or shift shows first; 0 when all
    agree. One launch covers any range of [1, 2^31)."""
    lib, _record = _cut_scan_lib()
    device = torch.device(device)
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hq_recip_check(d0, d1, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"reciprocal check launch failed: {rc}")
    return int(out.item())


def recip_numpy(d):
    """The per-step reciprocal of divisors d in [1, 2^31) as the kernel
    computes it (make_recip): (magic, shift) with
    floor(n / d) == (magic * n) >> shift for every n in [0, 2^31)."""
    d = np.asarray(d, dtype=np.uint64)
    ceil_log2 = np.array([int(x - 1).bit_length() for x in d.tolist()],
                         dtype=np.uint64)
    num = np.left_shift(np.uint64(1), np.uint64(31) + ceil_log2)
    return (num + d - np.uint64(1)) // d, (np.uint64(31) + ceil_log2)


# hq_step_split's variants: (threads, arithmetic, scan); arithmetic 0 none,
# 1 the int64 capacity, 2 the reciprocal; scan 0 the int64 scan and
# closing barrier, 1 the one-barrier saturating scan
STEP_SPLIT_VARIANTS = (
    (1024, 0, 0), (1024, 1, 0), (1024, 2, 0), (1024, 1, 1),
    (1024, 0, 1), (1024, 2, 1), (256, 0, 1), (256, 2, 1),
)


def step_split_ms(free, nt_free, lifetime, needs, sizes, min_time,
                  reps=20) -> dict:
    """Device ms of the solve's steps with the worker state in registers
    (the arithmetic and the scan, no loads or stores; csrc/cut_scan.cu
    step_split_kernel), per variant of STEP_SPLIT_VARIANTS, at these
    inputs (R = 4, W <= 1024): CUDA events over `reps` launches after one
    warm-up. Measurement only: the tick never calls it."""
    lib, _record = _cut_scan_lib()
    device = free.device
    n_w, n_r = free.shape
    n_b, n_v = min_time.shape
    out = torch.zeros(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    return {key: _events_ms(device, lambda variant=variant: lib.hq_step_split(
        variant, free.data_ptr(), nt_free.data_ptr(), lifetime.data_ptr(),
        needs.data_ptr(), sizes.data_ptr(), min_time.data_ptr(), n_w, n_r,
        n_b, n_v, out.data_ptr(), stream), reps)
        for variant, key in enumerate(STEP_SPLIT_VARIANTS)}
