"""The cut-scan kernels' host-side decisions and their 32-bit arithmetic, on
the CPU: the shared-memory layout that picks an instantiation (and its step
ring) before a launch, for the single-block kernel and for a shard's block of
the sharded one, with the sharded kernel's exchange (cluster or grid); the
per-step reciprocal that replaces floor division; and the plain version at
the 2^31 edge where the kernel's saturating prefix matters and past the room
a ring of whole batches had.

The card tests (tests/test_torch_cuda.py) hold the same layouts to the
kernels' own (hq_cut_scan_smem_bytes, hq_sharded_smem_bytes and the rings)
and the reciprocal to the card's division for every divisor. Every
comparison here is exact.
"""

import jax
import numpy as np
import pytest
import torch

from hyperqueue_tpu.ops import assign as jax_assign
from hyperqueue_tpu_torch.ops import assign
from hyperqueue_tpu_torch.parallel import solve

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

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
    full = assign._layout_bytes(64, *shape, False)
    assert full > LIMIT
    layout = assign.cut_scan_layout(*shape)
    assert layout["instantiation"] == "global"
    assert layout["global_bytes"] <= LIMIT
    # the ring keeps a run of steps: at least one, fewer than the full chunk
    assert 1 <= layout["ring_steps"] < 64
    one = assign._layout_bytes(1, *shape, False)
    assert one <= layout["global_bytes"] < full
    # one more step a chunk would not fit
    more = assign._layout_bytes(layout["ring_steps"] + 1, *shape, False)
    assert more > LIMIT


# (W, R, V, M, G, ALL, gang, mask) that the ring of whole batches could not
# hold (the JAX kernel takes them)
PAST_THE_BATCH_RING = [
    (16384, 867, 2, 16, 16384, True, True, True),
    (16384, 2066, 2, 16, 0, False, False, False),
    (64, 64, 2048, 1, 0, False, False, False),
]


def test_layout_refuses_what_no_instantiation_fits():
    """Every R and V has a layout at W <= 16,384: a run of steps a chunk
    (a chunk may end inside a batch), down to one step, and past that a
    direct layout (the step inputs of width R in device memory). Only a W
    past one block is refused."""
    for shape in PAST_THE_BATCH_RING:
        layout = assign.cut_scan_layout(*shape)
        assert layout["global_bytes"] <= LIMIT, shape
        assert layout["ring_steps"] >= 1, shape  # the ring still holds them
    # R = 2,048 with every option: not even one step fits beside the
    # worker buffers, so the layout is direct
    direct = assign.cut_scan_layout(16384, 2048, 2, 16, 16384, True, True,
                                    True)
    assert direct["instantiation"] == "global"
    assert direct["ring_steps"] == -assign._DIRECT_CHUNK_STEPS
    assert assign.ents_scratch(2048, direct["ring_steps"]) == \
        2 * 8 * 2048 * 4
    # the last R with a ring step at that shape, and the first direct one
    last = max(r for r in range(1700, 1800) if assign.cut_scan_ring(
        16384, r, 2, 16, 16384, True, True, True, False) > 0)
    assert assign.cut_scan_ring(16384, last + 1, 2, 16, 16384, True, True,
                                True, False) == -8
    # a resident layout is never direct: where one step does not fit beside
    # the resident state, the block keeps its state in device memory
    narrow = assign.cut_scan_layout(1, 8000, 2, 1)
    assert narrow["instantiation"] == "global"
    assert narrow["ring_steps"] == -assign._DIRECT_CHUNK_STEPS
    assert assign.cut_scan_ring(1, 8000, 2, 1, 0, False, False, False,
                                True) == 1
    assert narrow["resident_bytes"] > LIMIT
    with pytest.raises(ValueError, match="1 to 16384 workers"):
        assign.cut_scan_layout(16385, 4, 2, 3)
    with pytest.raises(ValueError, match="1 to 16384 workers"):
        assign.cut_scan_layout(16385, 2066, 2, 16)


def _wide_variant_case(n_w=64, n_r=64, n_v=160, n_b=3, seed=12):
    """A batch of n_v variants over n_r resources: 2 x 24 x V x R bytes of
    step inputs, past the shared memory a ring of whole batches had."""
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 9, size=(n_w, n_r)).astype(np.int32) * 100
    needs = (rng.integers(0, 3, size=(n_b, n_v, n_r))
             * (rng.random((n_b, n_v, n_r)) < 0.05)).astype(np.int32) * 100
    case = {
        "free": free,
        "nt_free": rng.integers(0, 6, size=n_w).astype(np.int32),
        "lifetime": np.full(n_w, 2**31 - 1, np.int32),
        "needs": needs,
        "sizes": rng.integers(1, 400, size=n_b).astype(np.int32),
        "min_time": np.zeros((n_b, n_v), np.int32),
    }
    scarcity = assign.scarcity_weights(free.astype(np.int64).sum(0))
    case["class_m"], case["order_ids"] = assign.host_visit_classes(
        free, needs, scarcity)
    return case


def test_plain_version_matches_twin_and_jax_past_the_batch_ring():
    """W = 64, R = 64, V = 160: a batch whose step inputs a ring of whole
    batches could not hold. The port's plain version, the numpy twin and
    the JAX kernel agree exactly."""
    case = _wide_variant_case()
    assert assign._layout_bytes(1, 64, 64, 160, 1, 0, False, False, False,
                                False) <= LIMIT  # one step a chunk fits
    # the whole batch (160 steps) did not fit, neither instantiation
    assert assign._layout_bytes(160, 64, 64, 160, 1, 0, False, False,
                                False, False) > LIMIT
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    counts, free, nt = assign.greedy_cut_scan_reference(*(t[k] for k in KEYS))
    want = assign.greedy_cut_scan_numpy(*(case[k] for k in KEYS))
    got = jax.jit(jax_assign.greedy_cut_scan_impl)(*(case[k] for k in KEYS))
    for mine, twin, jx in zip((counts, free, nt), want, got):
        np.testing.assert_array_equal(mine.numpy(), twin)
        np.testing.assert_array_equal(np.asarray(jx), twin)
    assert int(counts.sum()) > 0


SHARD_SHAPES = [
    # (R, V, M, G, ALL, gang, mask): the multichip path's shape, the fused
    # shape and every option at once
    (4, 2, 3, 0, False, False, False),
    (4, 2, 7, 8, False, True, True),
    (3, 3, 16, 1024, True, True, True),
]


@pytest.mark.parametrize("shape", SHARD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_sharded_instantiation_flips_at_the_shared_memory_limit(shape):
    """A shard's block holds the larger header and 32-bit visit orders, so
    its resident limit lies below K1's; at it the layout is resident, one
    worker past it global."""
    lo, hi = 1, assign.MAX_KERNEL_WORKERS
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if solve.sharded_smem_bytes(mid, *shape, True) <= LIMIT:
            lo = mid
        else:
            hi = mid - 1
    assert lo < assign.largest_resident_w(*shape)
    n_d = 4
    at = solve.sharded_layout(lo * n_d, n_d, *shape)
    over = solve.sharded_layout((lo + 1) * n_d, n_d, *shape)
    assert at["instantiation"] == "resident"
    assert at["resident_bytes"] <= LIMIT < over["resident_bytes"]
    assert over["instantiation"] == "global"
    assert at["exchange"] == over["exchange"] == "cluster"
    # the same shapes on one block differ only by the header and orders
    n_r, n_v, n_m, n_g, all_policy, gang, masked = shape
    k1 = assign.cut_scan_smem_bytes(lo, *shape, False)
    assert solve.sharded_smem_bytes(lo, *shape, False) == \
        k1 + assign._SHARD_HEADER_BYTES - assign._HEADER_BYTES


def test_sharded_exchange_flips_at_the_largest_cluster():
    """Up to CLUSTER_LIMIT (16) shards are one cluster, one more is a grid;
    a card that fits fewer blocks of a layout in one cluster lowers the
    limit (the wrapper asks its occupancy query)."""
    limit = solve.CLUSTER_LIMIT
    assert limit == 16
    for n_d in (1, 2, 4, 8, limit):
        assert solve.sharded_layout(256 * n_d, n_d, 4, 2, 3)["exchange"] == \
            "cluster"
    for n_d in (limit + 1, 32):
        assert solve.sharded_layout(256 * n_d, n_d, 4, 2, 3)["exchange"] == \
            "grid"
    assert solve.sharded_exchange(8, max_cluster=8) == "cluster"
    assert solve.sharded_exchange(9, max_cluster=8) == "grid"
    assert solve.sharded_exchange(1, max_cluster=0) == "grid"
    # a shard is one block: W / D past 16,384 is refused, as W % D != 0
    with pytest.raises(ValueError, match="per shard"):
        solve.sharded_layout(16385 * 2, 2, 4, 2, 3)
    with pytest.raises(ValueError, match="equal shards"):
        solve.sharded_layout(1000, 3, 4, 2, 3)


def test_sharded_layout_takes_every_r_and_v():
    """As K1's: the three shapes the ring of whole batches refused, over 4
    shards, and a direct layout past one step's room."""
    for n_w, *rest in PAST_THE_BATCH_RING:
        layout = solve.sharded_layout(n_w * 4, 4, *rest)
        assert layout["global_bytes"] <= LIMIT
    direct = solve.sharded_layout(16384 * 4, 4, 2048, 2, 16, 16384, True,
                                  True, True)
    assert direct["ring_steps"] == -8
    assert assign.ents_scratch(2048, direct["ring_steps"], 4) == \
        4 * 2 * 8 * 2048 * 4


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
