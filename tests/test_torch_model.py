"""The port's GreedyCutScanModel (device="cpu") against the JAX package's
model with its jitted kernel (backend="jax") and its numpy path
(backend="numpy"), plus the device-residency contract of the port's model.

Every comparison is integer and exact (tolerance 0).
"""

import numpy as np
import pytest

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel

U = 10_000
INF = 2**31 - 1


def _tick(rng, n_w, n_b, n_r, n_v, with_all=False):
    total = rng.integers(1, 9, size=(n_w, n_r)) * U
    free = total - rng.integers(0, 4, size=(n_w, n_r)) * (U // 2)
    idle = rng.random(n_w) < 0.4
    free[idle] = total[idle]  # untouched pools, so ALL requests can fit
    needs = rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U // 2)
    kw = dict(
        free=free.astype(np.int32),
        nt_free=rng.integers(0, 10, size=n_w).astype(np.int32),
        lifetime=np.where(rng.random(n_w) < 0.2, 100, INF).astype(np.int32),
        needs=needs.astype(np.int32),
        sizes=rng.integers(0, 25, size=n_b).astype(np.int32),
        min_time=np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0)
        .astype(np.int32),
    )
    if with_all:
        all_mask = np.zeros((n_b, n_v, n_r), np.int32)
        all_mask[0, 0, n_r - 1] = 1
        kw["needs"][0, 0, n_r - 1] = 0
        kw.update(total=total.astype(np.int32), all_mask=all_mask)
    return kw


# (W, B, R, V, ALL) per tick: bucket shapes change between calls, and calls
# that return to a bucket with smaller extents exercise the re-zeroing
SHAPES = [
    (12, 5, 3, 2, False),
    (7, 3, 2, 1, False),
    (10, 4, 3, 2, False),   # same bucket as the first, smaller region
    (16, 8, 4, 2, True),
    (9, 2, 3, 1, False),
    (12, 5, 3, 2, False),
]


def test_model_matches_jax_and_numpy_across_bucket_changes():
    rng = np.random.default_rng(11)
    port = GreedyCutScanModel(device="cpu", backend="device")
    jax_model = JaxModel(backend="jax")
    np_model = JaxModel(backend="numpy")
    for n_w, n_b, n_r, n_v, with_all in SHAPES:
        kw = _tick(rng, n_w, n_b, n_r, n_v, with_all)
        got = port.solve(**kw)
        assert got.dtype == np.int32 and got.flags.c_contiguous
        assert got.shape == (n_b, n_v, n_w)
        np.testing.assert_array_equal(got, jax_model.solve(**kw))
        np.testing.assert_array_equal(got, np_model.solve(**kw))
    assert port.last_backend == "device-cpu"
    assert port.shape_allocations == 4
    assert set(port.last_phases) == {
        "pad_ms", "visit_ms", "dispatch_ms", "sync_ms"
    }


@pytest.mark.parametrize("seed", range(3))
def test_residency_soak_uploads_dirty_rows_only(seed):
    """Ticks with churn: after each solve the host applies the counts and
    a few workers release resources. The resident model must upload only
    the rows that changed and stay bitwise equal to a fresh solve."""
    rng = np.random.default_rng(300 + seed)
    n_w, n_b, n_r, n_v = 24, 6, 3, 2
    model = GreedyCutScanModel(device="cpu", backend="device")
    np_model = JaxModel(backend="numpy")
    base = _tick(rng, n_w, n_b, n_r, n_v)
    free = base["free"].astype(np.int64)
    nt = base["nt_free"].astype(np.int64)
    expected_dirty = None
    for tick in range(8):
        kw = dict(base, free=free.astype(np.int32),
                  nt_free=nt.astype(np.int32),
                  sizes=rng.integers(0, 25, size=n_b).astype(np.int32))
        counts = model.solve(**kw)
        stats = model.resident_stats()
        if tick == 0:
            assert stats["full_uploads"] == 1
        elif expected_dirty <= 32 // 2:
            assert stats["dirty_rows_last"] == expected_dirty
            assert stats["full_uploads"] == 1
        fresh = GreedyCutScanModel(device="cpu", backend="device").solve(**kw)
        np.testing.assert_array_equal(counts, fresh)
        np.testing.assert_array_equal(counts, np_model.solve(**kw))
        # the host applies the assignments exactly as the kernel did
        free = free - np.einsum("bvw,bvr->wr", counts, kw["needs"])
        nt = nt - counts.sum(axis=(0, 1))
        # churn: completions return resources on a few workers
        before = (free.copy(), nt.copy())
        rows = rng.choice(n_w, size=int(rng.integers(0, 6)), replace=False)
        free[rows] += rng.integers(0, 2, size=(rows.size, n_r)) * U
        nt[rows] += rng.integers(0, 2, size=rows.size)
        changed = (free != before[0]).any(axis=1) | (nt != before[1])
        expected_dirty = int(changed.sum())
    stats = model.resident_stats()
    assert stats["delta_uploads"] > 0
    assert stats["invalidations"] == 0


def test_residency_full_upload_when_most_rows_change():
    rng = np.random.default_rng(5)
    model = GreedyCutScanModel(device="cpu", backend="device")
    kw = _tick(rng, 16, 4, 3, 1)
    model.solve(**kw)
    kw2 = dict(kw, free=(kw["free"] + U).astype(np.int32))
    got = model.solve(**kw2)
    assert model.resident_stats()["full_uploads"] == 2
    np.testing.assert_array_equal(
        got, GreedyCutScanModel(device="cpu", backend="device").solve(**kw2)
    )


def test_place_cached_reuses_unchanged_inputs():
    rng = np.random.default_rng(6)
    model = GreedyCutScanModel(device="cpu", backend="device")
    kw = _tick(rng, 16, 4, 3, 1)
    model.solve(**kw)
    hits = model.resident_stats()["rep_cache_hits"]
    model.solve(**kw)
    # needs, sizes, min_time, class_m and order_ids all repeat
    assert model.resident_stats()["rep_cache_hits"] == hits + 5


def _fused_extras(rng, n_w, n_b, n_g, with_zeros=True):
    """Gang rows, idleness, groups and an affinity matrix for one tick."""
    gang_nodes = np.zeros(n_b, np.int32)
    gang_nodes[rng.choice(n_b, size=min(2, n_b), replace=False)] = (
        rng.integers(2, 4, size=min(2, n_b)))
    gids = rng.integers(0, n_g, size=n_w)
    weights = [0.0, 0.5, 1.0, 2.0] if with_zeros else [0.5, 1.0, 2.0]
    return dict(
        gang_nodes=gang_nodes,
        gang_ok=rng.integers(0, 2, size=n_w).astype(np.int32),
        group_onehot=(gids[:, None] == np.arange(n_g)[None, :])
        .astype(np.int32),
        affinity=rng.choice(np.array(weights, np.float32), size=(n_b, n_w)),
    )


@pytest.mark.parametrize("seed", range(4))
def test_fused_inputs_match_jax_and_numpy(seed):
    """Gang rows, idleness, groups and affinity (with and without zero
    weights) through the port's model and the JAX package's, over ticks
    that change buckets."""
    rng = np.random.default_rng(700 + seed)
    port = GreedyCutScanModel(device="cpu", backend="device")
    jax_model = JaxModel(backend="jax")
    np_model = JaxModel(backend="numpy")
    for n_w, n_b, n_g, with_zeros in [(12, 5, 2, True), (7, 3, 1, False),
                                      (10, 6, 3, True)]:
        kw = _tick(rng, n_w, n_b, 2, 2)
        kw.update(_fused_extras(rng, n_w, n_b, n_g, with_zeros))
        got = port.solve(**kw)
        np.testing.assert_array_equal(got, jax_model.solve(**kw))
        np.testing.assert_array_equal(got, np_model.solve(**kw))
        # the affinity alone and the gang rows alone
        for drop in (("gang_nodes", "gang_ok", "group_onehot"),
                     ("affinity",)):
            part = {k: v for k, v in kw.items() if k not in drop}
            np.testing.assert_array_equal(port.solve(**part),
                                          np_model.solve(**part))


def test_uniform_affinity_and_zero_gang_column_are_ordinary_solves():
    rng = np.random.default_rng(7)
    model = GreedyCutScanModel(device="cpu", backend="device")
    kw = _tick(rng, 8, 3, 2, 1)
    plain = JaxModel(backend="numpy").solve(**kw)
    np.testing.assert_array_equal(
        model.solve(**kw, gang_nodes=np.zeros(3, np.int32)), plain
    )
    uniform = np.full((3, 8), 2.0, np.float32)
    np.testing.assert_array_equal(model.solve(**kw, affinity=uniform), plain)
    prep = model.prepare(**kw, affinity=uniform,
                         gang_nodes=np.zeros(3, np.int32))
    assert prep["pmask_p"] is None and prep["gang_p"] is None
    # a uniform zero matrix excludes every worker
    zeros = np.zeros((3, 8), np.float32)
    assert model.solve(**kw, affinity=zeros).sum() == 0
    np.testing.assert_array_equal(
        model.solve(**kw, affinity=zeros),
        JaxModel(backend="numpy").solve(**kw, affinity=zeros),
    )
