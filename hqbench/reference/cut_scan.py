"""The greedy cut-scan in plain NumPy: the solve's counts.

A frozen copy of the cut-scan's NumPy twin (`ops/assign.py`
`greedy_cut_scan_numpy`, ordinary rows only: the benchmark's cells have no
gang rows and no policy mask), with the scarcity weights and the visit
order it reads. Semantics:

- batches are scanned in the solve's order; each (batch, variant) step
  water-fills the batch's remaining tasks over the workers, a lower batch
  seeing only what the higher ones left;
- a worker's capacity for a step is the least over the requested
  resources of free // need, and at most its free task slots;
- workers are visited in ascending waste (the scarcity of the resources
  the variant does not request that the worker has, quantized to 1/65536,
  ranked and clamped to 16 levels), then ascending row.
"""

from __future__ import annotations

import numpy as np

WASTE_Q = 65536
N_VISIT_CLASSES = 16


def scarcity_weights(total_amounts) -> np.ndarray:
    """(R,) float32: rarer cluster-wide is heavier, normalized to sum 1;
    a resource nobody has weighs 0."""
    total = np.asarray(total_amounts, dtype=np.float64)
    present = total > 0
    inv = np.where(present, total.max(initial=0.0) / np.maximum(total, 1.0),
                   0.0)
    norm = inv.sum()
    if norm <= 0:
        return np.zeros_like(total, dtype=np.float32)
    return (inv / norm).astype(np.float32)


def visit_orders(free, needs, scarcity):
    """(B, V, W) int64 worker visit order per batch variant."""
    n_b, n_v, _n_r = needs.shape
    n_w = free.shape[0]
    weighted = (free > 0) * scarcity[None, :]  # (W, R) float32
    masks = (needs == 0).reshape(n_b * n_v, -1)
    uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
    waste = np.einsum("mr,wr->mw", uniq.astype(np.float32),
                      weighted.astype(np.float32))
    key = np.round(waste * WASTE_Q).astype(np.int64)
    idx = np.arange(n_w)
    orders = np.empty((len(uniq), n_w), dtype=np.int64)
    for m in range(len(uniq)):
        levels = np.unique(key[m])
        rank = np.minimum(np.searchsorted(levels, key[m]),
                          N_VISIT_CLASSES - 1)
        orders[m] = np.lexsort((idx, rank))
    return orders[inverse.reshape(-1)].reshape(n_b, n_v, n_w)


def cut_scan(free, nt_free, needs, sizes):
    """counts (B, V, W) int64 of the scan over int64 inputs."""
    free = np.array(free, dtype=np.int64)
    nt_free = np.array(nt_free, dtype=np.int64)
    n_b, n_v, _n_r = needs.shape
    n_w = free.shape[0]
    scarcity = scarcity_weights(free.sum(axis=0))
    orders = visit_orders(free, needs, scarcity)
    counts = np.zeros((n_b, n_v, n_w), dtype=np.int64)
    for b in range(n_b):
        remaining = int(sizes[b])
        for v in range(n_v):
            if remaining <= 0:
                break
            need = needs[b, v]
            needed = need > 0
            if not needed.any():
                continue
            cap = np.min(free[:, needed] // need[needed], axis=1)
            cap = np.minimum(cap, nt_free)
            np.clip(cap, 0, remaining, out=cap)
            if not cap.any():
                continue
            order = orders[b, v]
            cap_sorted = cap[order]
            before = np.cumsum(cap_sorted) - cap_sorted
            take_sorted = np.clip(remaining - before, 0, cap_sorted)
            take = np.empty(n_w, dtype=np.int64)
            take[order] = take_sorted
            remaining -= int(take_sorted.sum())
            free -= take[:, None] * need[None, :]
            nt_free -= take
            counts[b, v] = take
    return counts
