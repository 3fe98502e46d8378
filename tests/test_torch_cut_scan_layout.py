"""The cut-scan kernel's host-side decisions and its 32-bit arithmetic, on the
CPU: the shared-memory layout that picks the kernel's instantiation before a
launch, the per-step reciprocal that replaces floor division, and the plain
version at the 2^31 edge where the kernel's saturating prefix matters.

The card tests (tests/test_torch_cuda.py) hold the same layout to the
kernel's own (hq_cut_scan_smem_bytes) and the reciprocal to the card's
division for every divisor. Every comparison here is exact.
"""

import jax
import numpy as np
import pytest
import torch

from hyperqueue_tpu.ops import assign as jax_assign
from hyperqueue_tpu_torch.ops import assign

LIMIT = assign.SMEM_LIMIT
KEYS = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
        "class_m", "order_ids")


SHAPES = [
    # (R, V, M, G, ALL, gang, mask): the default, fused and ALL-policy
    # north-star shapes, R = 8, M = 16 and wide group counts
    (4, 2, 3, 0, False, False, False),
    (4, 2, 7, 8, False, True, True),
    (4, 2, 3, 0, True, False, False),
    (8, 2, 16, 0, False, False, False),
    (3, 3, 16, 1024, True, True, True),
    (1, 1, 1, 16384, False, True, False),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_instantiation_flips_at_the_shared_memory_limit(shape):
    n_r, n_v, n_m, n_g, all_policy, gang, masked = shape
    w = assign.largest_resident_w(*shape)
    assert w < assign.MAX_KERNEL_WORKERS
    at = assign.cut_scan_layout(w, n_r, n_v, n_m, n_g, all_policy, gang,
                                masked)
    over = assign.cut_scan_layout(w + 1, n_r, n_v, n_m, n_g, all_policy,
                                  gang, masked)
    assert at["instantiation"] == "resident"
    assert at["resident_bytes"] <= LIMIT < over["resident_bytes"]
    assert over["instantiation"] == "global"
    # the global layout holds no per-worker state beyond the capacity buffer
    # (and the gang carry), so it stays far below the limit
    assert over["global_bytes"] < at["resident_bytes"]


def test_north_star_shapes_run_resident():
    # the default path (W 1,024, R 4, V 2, M 3) and the fused path (M 7, 8
    # groups, gang rows, a policy mask) both fit with room to spare
    default = assign.cut_scan_layout(1024, 4, 2, 3)
    fused = assign.cut_scan_layout(1024, 4, 2, 7, 8, False, True, True)
    assert default["instantiation"] == fused["instantiation"] == "resident"
    assert default["resident_bytes"] < 64 * 1024
    assert fused["resident_bytes"] < 96 * 1024


def test_layout_bytes_grow_with_every_input():
    base = dict(n_w=1000, n_r=4, n_v=2, n_m=3, n_g=8, all_policy=False,
                gang=False, masked=False, resident=True)
    n0 = assign.cut_scan_smem_bytes(**base)
    for key, value in (("n_w", 1001), ("n_r", 5), ("n_m", 4),
                       ("all_policy", True), ("gang", True),
                       ("masked", True)):
        assert assign.cut_scan_smem_bytes(**{**base, key: value}) > n0, key
    # without gang rows the group count does not matter
    assert assign.cut_scan_smem_bytes(**{**base, "n_g": 9999}) == n0
    # the global layout ignores the mask and the visit orders
    glob = {**base, "resident": False}
    g0 = assign.cut_scan_smem_bytes(**glob)
    assert assign.cut_scan_smem_bytes(**{**glob, "masked": True}) == g0
    assert assign.cut_scan_smem_bytes(**{**glob, "n_m": 16}) == g0


# (W, R, V, M, G, ALL, gang, mask) past what a full step ring (64 steps a
# chunk) leaves room for beside the global layout's worker buffers
WIDE = [
    (16384, 64, 2, 3, 0, False, False, False),
    (16384, 32, 2, 3, 16384, True, True, True),
    (16384, 200, 1, 1, 0, False, False, False),
    (16384, 48, 4, 16, 16384, True, True, True),
]


@pytest.mark.parametrize("shape", WIDE, ids=lambda s: "-".join(map(str, s)))
def test_global_layout_shrinks_the_step_ring_to_fit(shape):
    n_w, n_r, n_v = shape[:3]
    full = assign._layout_bytes(max(1, 64 // n_v), *shape, False)
    assert full > LIMIT
    layout = assign.cut_scan_layout(*shape)
    assert layout["instantiation"] == "global"
    assert layout["global_bytes"] <= LIMIT
    # the ring keeps whole batches: at least one, fewer than the full chunk
    one = assign._layout_bytes(1, *shape, False)
    assert one <= layout["global_bytes"] < full


def test_layout_refuses_what_no_instantiation_fits():
    """One batch's step inputs (V x R) past the room beside the worker
    buffers, even with one batch a chunk: refused (ROADMAP Queue 3)."""
    with pytest.raises(ValueError, match="one batch's step inputs"):
        assign.cut_scan_layout(16384, 1024, 2, 16, 16384, True, True, True)
    with pytest.raises(ValueError, match="exceeds"):
        assign.cut_scan_layout(64, 64, 2048, 1)
    # the last R that fits at W = 16,384 with every option, and at V = 2
    # without options
    assert assign.cut_scan_layout(16384, 866, 2, 16, 16384, True, True,
                                  True)["instantiation"] == "global"
    with pytest.raises(ValueError):
        assign.cut_scan_layout(16384, 867, 2, 16, 16384, True, True, True)
    assert assign.cut_scan_layout(16384, 2065, 2, 16)["instantiation"] == \
        "global"
    with pytest.raises(ValueError):
        assign.cut_scan_layout(16384, 2066, 2, 16)


def _divisor_edges():
    top = 2**31 - 1
    low = np.arange(1, 1 << 16, dtype=np.int64)
    high = np.arange(top - (1 << 16) + 1, top + 1, dtype=np.int64)
    powers = np.array(sorted({p + d for p in (2**k for k in range(32))
                              for d in (-1, 0, 1) if 1 <= p + d <= top}),
                      dtype=np.int64)
    return np.unique(np.concatenate([low, high, powers]))


@pytest.mark.parametrize("part", range(4))
def test_reciprocal_matches_floor_division_at_the_ends_of_the_range(part):
    """Every divisor in [1, 2^16), in (2^31 - 2^16, 2^31) and around every
    power of two, at the dividends where a wrong multiplier or shift shows
    first; the card test checks every divisor of [1, 2^31)."""
    d = np.array_split(_divisor_edges(), 4)[part]
    magic, shift = assign.recip_numpy(d)
    assert int(magic.max()) < 2**32
    top = 2**31 - 1
    k = top // d
    dividends = [np.zeros_like(d), np.ones_like(d), d - 1, d,
                 np.minimum(d + 1, top), k * d, k * d - 1,
                 np.full_like(d, top), np.full_like(d, top - 1),
                 np.minimum(2 * d - 1, top), (d * 0x9E3779B9) & top]
    for n in dividends:
        # (magic * n) >> shift in exact integers: magic < 2^32, n < 2^31
        got = (magic.astype(object) * n.astype(object)) >> shift.astype(
            object)
        np.testing.assert_array_equal(got.astype(np.int64), n // d)


def _edge_case(n_w=8):
    """The 2^31 edge: every worker fits 2^31 - 1 tasks and the batch holds
    2^30, so every cap is 2^30 and the fifth worker's prefix is 2^32."""
    case = {
        "free": np.full((n_w, 1), 2**31 - 1, np.int32),
        "nt_free": np.full(n_w, 2**31 - 1, np.int32),
        "lifetime": np.full(n_w, 2**31 - 1, np.int32),
        "needs": np.ones((1, 1, 1), np.int32),
        "sizes": np.array([2**30], np.int32),
        "min_time": np.zeros((1, 1), np.int32),
    }
    scarcity = assign.scarcity_weights(case["free"].astype(np.int64).sum(0))
    case["class_m"], case["order_ids"] = assign.host_visit_classes(
        case["free"], case["needs"], scarcity)
    return case


def test_plain_version_matches_numpy_twin_past_2_31():
    case = _edge_case()
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    counts, free, nt = assign.greedy_cut_scan_reference(*(t[k] for k in KEYS))
    want = assign.greedy_cut_scan_numpy(*(case[k] for k in KEYS))
    np.testing.assert_array_equal(counts.numpy(), want[0])
    np.testing.assert_array_equal(free.numpy(), want[1])
    np.testing.assert_array_equal(nt.numpy(), want[2])
    # the first worker takes the whole batch; nobody else gets a task
    assert counts[0, 0].tolist() == [2**30] + [0] * 7
    assert free[0, 0] == 2**30 - 1


@pytest.mark.xfail(strict=True, reason=(
    "the JAX kernel's int32 prefix and totals wrap past 2^31 - 1 (ROADMAP "
    "Queue 3); at this input it assigns no task"))
def test_jax_kernel_matches_numpy_twin_past_2_31():
    case = _edge_case()
    got = jax.jit(jax_assign.greedy_cut_scan_impl)(*(case[k] for k in KEYS))
    want = jax_assign.greedy_cut_scan_numpy(*(case[k] for k in KEYS))
    np.testing.assert_array_equal(np.asarray(got[0]), want[0])
