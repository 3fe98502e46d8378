"""The port's CUDA cut-scan kernel against its plain PyTorch version, on a
card. Every test here needs an NVIDIA GPU (the kernel has no CPU mode) and
skips without one.

This file imports only the port, torch and numpy, so it also runs where JAX
is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
All comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    K1_EDGE_CASES,
    K1G_EDGE_CASES,
    K2_VR_CASES,
    K2G_VR_CASES,
    k1_edge_case,
    k1g_edge_case,
    sharded_vs_plain,
)
from hyperqueue_tpu_torch.convert import group_ids, tick_state_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.ops import assign
from hyperqueue_tpu_torch.scheduler.policy import TickPolicyContext
from hyperqueue_tpu_torch.scheduler.tick import Batch, create_batches, run_tick

U = 10_000
INF = 2**31 - 1
KEYS = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
        "class_m", "order_ids")
OPTIONAL = ("total", "all_mask", "gang_nodes", "gang_ok", "group_onehot",
            "policy_mask")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def random_case(seed, n_w, n_r, n_b, n_v, with_all):
    """Kernel inputs with negative free, min_time-masked workers, absent
    variants, padding rows and, optionally, ALL-policy requests."""
    rng = np.random.default_rng(seed)
    total = rng.integers(0, 9, size=(n_w, n_r)) * U
    free = total - rng.integers(0, 5, size=(n_w, n_r)) * (U // 2)
    needs = rng.integers(0, 4, size=(n_b, n_v, n_r)) * (U // 2)
    needs[rng.random((n_b, n_v)) < 0.2] = 0
    sizes = rng.integers(0, 4 * n_w // max(n_b, 1) + 3, size=n_b)
    sizes[rng.random(n_b) < 0.2] = 0
    min_time = np.where(rng.random((n_b, n_v)) < 0.3,
                        rng.integers(1, 7200, size=(n_b, n_v)), 0)
    min_time[(needs == 0).all(axis=2)] = INF
    case = {
        "nt_free": rng.integers(-2, 12, size=n_w),
        "lifetime": np.where(rng.random(n_w) < 0.3,
                             rng.integers(0, 7200, size=n_w), INF),
        "sizes": sizes, "min_time": min_time,
    }
    if with_all:
        all_mask = (rng.random((n_b, n_v, n_r)) < 0.25).astype(np.int32)
        needs[all_mask > 0] = 0
        idle = rng.random(n_w) < 0.5
        free[idle] = total[idle]
        case.update(total=total, all_mask=all_mask)
    free[-1, 0] = -(U // 2)
    case.update(free=free, needs=needs)
    scarcity = assign.scarcity_weights(np.maximum(free, 0).sum(axis=0))
    case["class_m"], case["order_ids"] = assign.host_visit_classes(
        free, needs, scarcity, all_mask=case.get("all_mask")
    )
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def fused_case(seed, n_w, n_r, n_b, n_v, n_g, gang=True, mask=True):
    """random_case with gang rows (a quarter of the rows, 1 to 16 nodes),
    60% idle workers in n_g groups (a few in none) and, with `mask`, an
    affinity matrix with zeros that keys the visit classes and gives the
    policy mask."""
    case = random_case(seed, n_w, n_r, n_b, n_v, False)
    rng = np.random.default_rng(seed + 77)
    if mask:
        affinity = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32),
                              size=(n_b, n_w), p=[0.2, 0.2, 0.4, 0.2])
        scarcity = assign.scarcity_weights(
            np.maximum(case["free"], 0).sum(axis=0))
        case["class_m"], case["order_ids"] = assign.host_visit_classes(
            case["free"], case["needs"], scarcity, affinity=affinity)
        case["policy_mask"] = (affinity > 0).astype(np.int32)
    if gang:
        gang_nodes = np.where(rng.random(n_b) < 0.25,
                              rng.integers(1, 17, size=n_b), 0)
        gids = rng.integers(0, n_g, size=n_w)
        onehot = np.zeros((n_w, n_g), np.int32)
        member = rng.random(n_w) < 0.95
        onehot[np.flatnonzero(member), gids[member]] = 1
        case.update(gang_nodes=gang_nodes,
                    gang_ok=(rng.random(n_w) < 0.6).astype(np.int32),
                    group_onehot=onehot)
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def instantiation_of(case):
    """The instantiation the wrapper picks for this case (by shape)."""
    n_w, n_r = case["free"].shape
    n_g = case["group_onehot"].shape[1] if "group_onehot" in case else 0
    return assign.cut_scan_layout(
        n_w, n_r, case["min_time"].shape[1], case["class_m"].shape[0], n_g,
        "total" in case, "gang_nodes" in case, "policy_mask" in case,
    )["instantiation"]


def forced_launch(t, opt, resident):
    """One launch of the given instantiation (not the wrapper's choice, not
    counted) on copies of free/nt_free: (counts, free, nt_free) after it."""
    free, nt = t["free"].clone(), t["nt_free"].clone()
    counts = assign.cut_scan_forced(free, nt, *(t[k] for k in KEYS[2:]),
                                    **opt, resident=resident)
    return counts, free, nt


def kernel_vs_reference(case, device):
    """The wrapper's launch against the plain version (counting one launch
    of the instantiation the layout picks, none of the other), then the
    other instantiation too where it fits, all exact."""
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    opt = {k: t.get(k) for k in OPTIONAL}
    ref = assign.greedy_cut_scan_reference(*(t[k] for k in KEYS), **opt)
    picked = instantiation_of(case)
    f = assign.greedy_cut_scan
    before = (f.launches, f.resident_launches, f.global_launches)
    state = {k: t[k].clone() for k in ("free", "nt_free")}
    counts = assign.greedy_cut_scan(*(t[k] for k in KEYS), **opt)
    torch.cuda.synchronize()
    resident = picked == "resident"
    assert (f.launches, f.resident_launches, f.global_launches) == (
        before[0] + 1, before[1] + resident, before[2] + (not resident))
    for name, got, want in zip(("counts", "free", "nt_free"),
                               (counts, t["free"], t["nt_free"]), ref):
        assert torch.equal(got, want), name
    if resident:
        got = forced_launch({**t, **state}, opt, resident=False)
        torch.cuda.synchronize()
        for name, g, want in zip(("counts", "free", "nt_free"), got, ref):
            assert torch.equal(g, want), f"global instantiation: {name}"
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("with_all", [False, True], ids=["plain", "all"])
@pytest.mark.parametrize("shape", [
    (8, 4, 8, 2), (13, 3, 5, 3), (1024, 4, 64, 2), (1500, 2, 17, 1),
    (4096, 4, 24, 2), (16384, 3, 6, 2),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_reference(cuda, shape, with_all):
    counts = kernel_vs_reference(
        random_case(sum(shape) + with_all, *shape, with_all), cuda
    )
    assert int(counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gang", "mask", "gang_mask"])
@pytest.mark.parametrize("shape", [
    (8, 2, 6, 2, 2), (1021, 3, 37, 2, 5), (1024, 8, 256, 2, 8),
    (1024, 4, 64, 2, 1024), (4096, 4, 64, 2, 8), (16384, 3, 24, 2, 1),
], ids=lambda s: "x".join(map(str, s)))
def test_gang_and_mask_kernel_matches_reference(cuda, shape, mode):
    gang_launches = assign.greedy_cut_scan.gang_launches
    counts = kernel_vs_reference(
        fused_case(sum(shape), *shape, gang="gang" in mode,
                   mask="mask" in mode), cuda)
    assert assign.greedy_cut_scan.gang_launches == gang_launches + 1
    assert int(counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", K1_EDGE_CASES)
def test_kernel_edge_cases_match_reference(cuda, name):
    """chip_smoke.py's K1 edge cases (see K1_EDGE_CASES there)."""
    case = k1_edge_case(name)
    if name.startswith("limit") or name.startswith("r64"):
        want = "resident" if name in ("limit", "limit_all") else "global"
        assert instantiation_of(case) == want
    kernel_vs_reference(case, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", K1G_EDGE_CASES)
def test_gang_edge_cases_match_reference(cuda, name):
    """chip_smoke.py's K1g edge cases (see K1G_EDGE_CASES there)."""
    case = k1g_edge_case(name)
    if name.startswith("limit") or name.startswith("r32"):
        want = "resident" if name == "limit" else "global"
        assert instantiation_of(case) == want
    gang_launches = assign.greedy_cut_scan.gang_launches
    kernel_vs_reference(case, cuda)
    assert assign.greedy_cut_scan.gang_launches == gang_launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True], ids=["global",
                                                          "resident"])
def test_layout_bytes_match_the_kernels(cuda, resident):
    rng = np.random.default_rng(int(resident))
    shapes = [(1024, 4, 2, 3, 0, 0, 0, 0), (1024, 4, 2, 7, 8, 0, 1, 1),
              (16384, 8, 2, 16, 16384, 1, 1, 1), (1, 1, 1, 1, 1, 0, 0, 0),
              (16384, 64, 2, 3, 0, 0, 0, 0), (16384, 32, 2, 3, 16384, 1, 1, 1),
              (16384, 64, 64, 16, 16384, 1, 1, 1)]
    shapes += [tuple(int(x) for x in (
        rng.integers(1, 16385), rng.integers(1, 65), rng.integers(1, 9),
        rng.integers(1, 17), rng.integers(1, 16385), rng.integers(0, 2),
        rng.integers(0, 2), rng.integers(0, 2))) for _ in range(200)]
    for n_w, n_r, n_v, n_m, n_g, all_p, gang, masked in shapes:
        args = (n_w, n_r, n_v, n_m, n_g if gang else 0, bool(all_p),
                bool(gang), bool(masked), resident)
        assert assign.cut_scan_smem_bytes(*args) == \
            assign.native_smem_bytes(*args), args
        assert assign.cut_scan_ring(*args) == assign.native_ring(*args), args
    lib, _record = assign._cut_scan_lib()
    assert int(lib.hq_cut_scan_smem_limit()) == assign.SMEM_LIMIT


@pytest.mark.cuda
def test_reciprocal_of_every_divisor(cuda):
    assert assign.recip_check(1, 2**31, cuda) == 0


@pytest.mark.cuda
def test_resident_launch_that_does_not_fit_is_refused(cuda, monkeypatch):
    """The C entry refuses a resident launch one worker past the limit, and
    the wrapper raises instead of switching to the other instantiation."""
    case = k1_edge_case("limit_plus_1")
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    opt = {k: t.get(k) for k in OPTIONAL}
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        forced_launch(t, opt, resident=True)  # cudaErrorInvalidValue
    layout = assign.cut_scan_layout
    monkeypatch.setattr(assign, "cut_scan_layout", lambda *a, **k: {
        **layout(*a, **k), "instantiation": "resident"})
    f = assign.greedy_cut_scan
    before = (f.launches, f.resident_launches, f.global_launches)
    with pytest.raises(RuntimeError, match=r"\(resident\) failed"):
        assign.greedy_cut_scan(*(t[k] for k in KEYS), **opt)
    assert (f.launches, f.resident_launches, f.global_launches) == before


@pytest.mark.cuda
def test_kernel_rejects_too_many_groups(cuda):
    case = fused_case(3, 8, 1, 2, 1, 2)
    case["group_onehot"] = np.zeros((8, 16385), np.int32)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    with pytest.raises(ValueError, match="at most 16384 worker groups"):
        assign.greedy_cut_scan(*(t[k] for k in KEYS),
                               **{k: t.get(k) for k in OPTIONAL})


@pytest.mark.cuda
def test_kernel_rejects_too_many_workers(cuda):
    case = random_case(1, 16385, 1, 1, 1, False)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    with pytest.raises(ValueError, match="at most 16384"):
        assign.greedy_cut_scan(*(t[k] for k in KEYS))


@pytest.mark.cuda
def test_model_on_card_matches_model_on_cpu(cuda):
    rng = np.random.default_rng(9)
    gpu = GreedyCutScanModel(device="cuda", backend="device")
    cpu = GreedyCutScanModel(device="cpu", backend="device")
    for n_w, n_b, n_r, n_v in [(100, 9, 3, 2), (60, 4, 2, 1), (100, 9, 3, 2)]:
        case = random_case(int(rng.integers(1 << 30)), n_w, n_r, n_b, n_v,
                           False)
        kw = {k: case[k] for k in KEYS[:6]}
        got = gpu.solve(**kw)
        np.testing.assert_array_equal(got, cpu.solve(**kw))
    assert gpu.last_backend == "device-cuda"


@pytest.mark.cuda
def test_device_solves_reuse_pinned_sets(cuda):
    """A solve read before the next one is dispatched hands its pinned set
    on; a solve still unread keeps it, and the next solve gets a set of its
    own. The same sequence on the CPU gives the same counts."""
    case = random_case(12, 100, 3, 9, 2, False)
    kw = {k: case[k] for k in KEYS[:6]}
    gpu = GreedyCutScanModel(device="cuda")
    cpu = GreedyCutScanModel(device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(gpu.solve(**kw), cpu.solve(**kw))
    assert gpu.pinned_sets == 1
    handles = [(m.solve_async(**kw), m.solve_async(**kw)) for m in (gpu, cpu)]
    assert gpu.pinned_sets == 2
    for (g, c) in zip(*handles):
        np.testing.assert_array_equal(g.result(), c.result())
    np.testing.assert_array_equal(gpu.solve(**kw), cpu.solve(**kw))
    assert gpu.pinned_sets == 2


def _fused_state(seed):
    """Two jobs of 1-cpu and 2-cpu tasks, two gang classes, 64 workers in
    four groups."""
    from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority

    rng = np.random.default_rng(seed)
    classes = [[{"entries": [("cpus", U, "compact")]}],
               [{"entries": [("cpus", 2 * U, "compact")]}],
               [{"entries": [], "n_nodes": 3}],
               [{"entries": [], "n_nodes": 5}]]
    tasks = [(t, int(rng.integers(0, 2)),
              (0, encode_sched_priority(int(rng.integers(1, 3)))))
             for t in range(1, 1500)]
    workers = [(w, [int(rng.choice([4, 8])) * U], 8, INF, None,
                f"g{w % 4}") for w in range(1, 65)]
    return tick_state_from_plain(["cpus"], classes, tasks, workers)


@pytest.mark.cuda
def test_fused_run_tick_on_card_matches_cpu(cuda):
    from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority

    gangs = [Batch(rq_id=2 + i % 2, priority=(1, encode_sched_priority(1)),
                   size=1, gang_task=90_000 + i, gang_nodes=3 + 2 * (i % 2))
             for i in range(6)]
    # group g2 excluded for the 1-cpu class and the 3-node gangs
    row = np.tile(np.array([1.0, 2.0, 0.0, 1.0], np.float32), 16)
    policy = TickPolicyContext({0: row, 2: row}, {2: 1})
    out = []
    for device in ("cuda", "cpu"):
        resource_map, rq_map, queues, rows = _fused_state(5)
        model = GreedyCutScanModel(device=device, backend="device")
        launches = assign.greedy_cut_scan.gang_launches
        out.append(run_tick(
            queues, rows, rq_map, resource_map, model,
            batches=create_batches(queues) + gangs,
            gang_ok=np.ones(len(rows), np.int32),
            group_ids=group_ids(rows), policy=policy,
        ))
        if device == "cuda":
            assert assign.greedy_cut_scan.gang_launches == launches + 1
    assert out[0] == out[1]
    assert any(v < 0 for *_x, v in out[0])


# -- the sync probe (K5) and the server's solve seam on the card -------------

@pytest.mark.cuda
@pytest.mark.parametrize("n, kind", [(256, "arange"), (256, "random"),
                                     (1000, "random"), (1, "random"),
                                     (0, "random")])
def test_sync_probe_kernel_matches_reference(cuda, n, kind):
    from hyperqueue_tpu_torch.ops import probe

    if kind == "arange":
        v = np.arange(n, dtype=np.int32)
    else:
        v = np.random.default_rng(n).integers(
            -2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    t = torch.from_numpy(v).to(cuda)
    launches = probe.sync_probe.launches
    got = probe.sync_probe(t)
    torch.cuda.synchronize()
    assert probe.sync_probe.launches == launches + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert int(got) == int(probe.sync_probe_reference(t))
    exact = 2 * int(v.astype(np.int64).sum())
    assert int(got) == (exact + 2**31) % 2**32 - 2**31


@pytest.mark.cuda
def test_sync_round_trip_and_device_sync_ms(cuda):
    from hyperqueue_tpu_torch.models import greedy
    from hyperqueue_tpu_torch.ops import probe

    launches = probe.sync_probe.launches
    ms = probe.sync_round_trip_ms(cuda, reps=3)
    assert 0 < ms < 1000
    assert probe.sync_probe.launches == launches + 4  # warm-up + 3
    greedy._reset_probe_for_tests()
    try:
        resolved = greedy.device_sync_ms(wait_s=30)
        assert resolved is not None and 0 < resolved < float("inf")
        assert greedy.probe_error() is None
    finally:
        greedy._reset_probe_for_tests()


def _server_state(seed):
    rng = np.random.default_rng(seed)
    classes = [[{"entries": [("cpus", U, "compact")]}],
               [{"entries": [("cpus", 2 * U, "compact"),
                             ("gpus", U, "compact")]},
                {"entries": [("cpus", 4 * U, "compact")]}]]
    tasks = [(t, int(rng.integers(0, 2)), (int(rng.integers(0, 3)), 0))
             for t in range(1, 3000)]
    workers = [(w, [int(rng.choice([4, 8, 16])) * U,
                    int(rng.choice([0, 0, 2])) * U], 16, INF, None)
               for w in range(1, 129)]
    return ["cpus", "gpus"], classes, tasks, workers


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_server_ticks_on_card_match_cpu(cuda, pipelined):
    """The server's seam on the card: a watchdog around an auto model,
    paranoid resident checks every second solve, ticks over the core's
    dense snapshot (pipelined in the server's order), against the same
    ticks through the plain version on the CPU."""
    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.models import greedy
    from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    greedy._reset_probe_for_tests()
    assert 0 < greedy.device_sync_ms(wait_s=30) < float("inf")
    results = []
    for device in ("cuda", "cpu"):
        core = core_from_plain(*_server_state(3))
        model = GreedyCutScanModel(device=device,
                                   backend="auto" if device == "cuda"
                                   else "device")
        model.paranoid_resident = 2
        watchdog = SolverWatchdog(model)
        pipeline = TickPipeline() if pipelined else None
        rng = np.random.default_rng(4)
        ticks, backends, running = [], [], []

        def start(assignments):
            for task, wid, rq_id, variant in assignments:
                w = core.workers[wid]
                w.assign(task, core.variant_amounts(rq_id, variant, w))
                running.append((task, wid, rq_id, variant))

        for _tick in range(6):
            mapped = []
            if pipeline is not None:
                mapped = pipeline.take_result(model=watchdog)
                start(mapped)
            snap = core.tick_cache.sync(core)
            out = run_tick(core.queues, None, core.rq_map, core.resource_map,
                           watchdog, dense=snap, key_cache=core.tick_cache,
                           pipeline=pipeline)
            start(out)
            backends.append((model.last_backend, model.last_backend_reason))
            ticks.append(out if pipeline is None else mapped)
            # a quarter of the running tasks finish before the next tick
            for i in sorted(rng.choice(len(running), len(running) // 4,
                                       replace=False), reverse=True):
                task, wid, rq_id, variant = running.pop(i)
                w = core.workers[wid]
                w.unassign(task, core.variant_amounts(rq_id, variant, w))
        results.append((ticks, len(running)))
        stats = watchdog.stats()
        assert (stats["failures"], stats["timeouts"],
                stats["degraded_ticks"]) == (0, 0, 0)
        assert model.paranoid_checks >= 2
        assert model.resident_stats()["invalidations"] == 0
        if device == "cuda":
            assert all(b == "device-cuda" for b, _r in backends), backends
            assert backends[0][1] == "sync-within-budget"
            assert watchdog.fallback is None
            # each solve is read before the next is dispatched: one pinned
            # set per padded shape
            assert model.pinned_sets == len(model._pinned)
    assert results[0] == results[1]
    greedy._reset_probe_for_tests()


# -- the sharded solve (K2) --------------------------------------------------

def pad_workers(case, n_shards):
    """The case with inert workers appended up to a multiple of n_shards
    (no free resources, no task slot, no lifetime, class 0, not idle, in no
    group, masked), as the model pads W."""
    n_w = case["free"].shape[0]
    extra = -n_w % n_shards
    if not extra:
        return case
    out = dict(case)
    for key in ("free", "nt_free", "lifetime", "total", "gang_ok",
                "group_onehot"):
        if key in case:
            out[key] = np.concatenate(
                [case[key], np.zeros((extra,) + case[key].shape[1:],
                                     np.int32)])
    for key in ("class_m", "policy_mask"):
        if key in case:
            out[key] = np.concatenate(
                [case[key], np.zeros((case[key].shape[0], extra), np.int32)],
                axis=1)
    return out


def straddle_case(n_w=1024, n_shards=4):
    """Gang rows whose chosen group crosses shard boundaries: group 0 holds
    the workers around the first boundary, group 1 the middle half (less
    group 0), group 2 the rest; all idle, with ordinary rows between the
    gang rows."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    rng = np.random.default_rng(31)
    size = n_w // n_shards
    gids = np.full(n_w, 2)
    gids[n_w // 4 + 24:3 * n_w // 4] = 1
    gids[size - 40:size + 24] = 0
    n_b = 12
    free = rng.integers(1, 8, size=(n_w, 2)) * U
    needs = rng.integers(0, 3, size=(n_b, 1, 2)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    gang_nodes = np.zeros(n_b, np.int64)
    gang_nodes[[0, 3, 5, 8, 11]] = [50, 20, 300, 2000, 7]
    sizes = np.where(gang_nodes > 0, 1, rng.integers(0, 200, size=n_b))
    onehot = np.zeros((n_w, 3), np.int32)
    onehot[np.arange(n_w), gids] = 1
    case = {"free": free, "nt_free": rng.integers(1, 6, size=n_w),
            "lifetime": np.full(n_w, INF), "needs": needs, "sizes": sizes,
            "min_time": np.zeros((n_b, 1)), "gang_nodes": gang_nodes,
            "gang_ok": np.ones(n_w), "group_onehot": onehot}
    case["class_m"], case["order_ids"] = host_visit_classes(
        free, needs, scarcity_weights(free.sum(axis=0)))
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def sharded_vs_reference(case, device, n_shards):
    """K2 through its wrapper (one launch counted, in the exchange and
    instantiation it picks) and through the forced entry in every other
    variant that fits (both exchanges, both instantiations), against its
    plain version and, where K1 takes the
    width, against K1, on the same inputs: counts, free and nt_free all
    exact (chip_smoke.sharded_vs_plain). Returns the plain counts."""
    from hyperqueue_tpu_torch.parallel import solve

    launches = solve.sharded_cut_scan.launches
    assert sharded_vs_plain(case, device, n_shards) == 0
    assert solve.sharded_cut_scan.launches == launches + 1
    mesh = solve.make_worker_mesh([device] * n_shards)
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    return solve.sharded_cut_scan_reference(
        mesh, *(t[k] for k in KEYS), **{k: t.get(k) for k in OPTIONAL})[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("with_all", [False, True], ids=["plain", "all"])
@pytest.mark.parametrize("shape", [
    (8, 4, 8, 2), (13, 3, 5, 3), (1000, 4, 40, 2), (1500, 2, 17, 1),
    (4096, 4, 24, 2), (16384, 3, 6, 2),
], ids=lambda s: "x".join(map(str, s)))
def test_sharded_kernel_matches_reference(cuda, shape, with_all, n_shards):
    case = pad_workers(random_case(sum(shape) + with_all, *shape, with_all),
                       n_shards)
    counts = sharded_vs_reference(case, cuda, n_shards)
    assert int(counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gang", "mask", "gang_mask"])
@pytest.mark.parametrize("shape", [
    (8, 2, 6, 2, 2), (1021, 3, 37, 2, 5), (1024, 8, 256, 2, 8),
    (1024, 4, 64, 2, 1024), (4096, 4, 64, 2, 8), (16384, 3, 24, 2, 1),
], ids=lambda s: "x".join(map(str, s)))
def test_sharded_gang_and_mask_kernel_matches_reference(cuda, shape, mode):
    case = fused_case(sum(shape), *shape, gang="gang" in mode,
                      mask="mask" in mode)
    counts = sharded_vs_reference(pad_workers(case, 4), cuda, 4)
    assert int(counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_gang_straddles_shards(cuda, n_shards):
    case = straddle_case(n_shards=n_shards)
    counts = sharded_vs_reference(case, cuda, n_shards).cpu().numpy()
    size = 1024 // n_shards
    first = np.flatnonzero(counts[0, 0])
    assert len(first) == 50 and first.min() < size <= first.max()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["all", "gang_mask"])
def test_sharded_kernel_beyond_one_block(cuda, fused):
    """32,768 workers over 4 shards, twice K1's width: against the plain
    version only."""
    case = fused_case(77, 32768, 3, 8, 2, 8) if fused \
        else random_case(76, 32768, 3, 8, 2, True)
    assert int(sharded_vs_reference(case, cuda, 4).sum()) > 0


@pytest.mark.cuda
def test_sharded_kernel_rejects_what_it_cannot_hold(cuda):
    from hyperqueue_tpu_torch.parallel import solve

    case = random_case(5, 1024, 2, 4, 1, False)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    # more shards than the card holds shard blocks at once
    mesh = solve.make_worker_mesh([cuda] * 1024)
    with pytest.raises(RuntimeError, match="launch failed"):
        solve.sharded_cut_scan(mesh, *(t[k] for k in KEYS))
    mesh = solve.make_worker_mesh([cuda] * 3)
    with pytest.raises(ValueError, match="equal shards"):
        solve.sharded_cut_scan(mesh, *(t[k] for k in KEYS))
    wide = random_case(6, 32768, 1, 1, 1, False)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in wide.items()}
    with pytest.raises(ValueError, match="per shard"):
        solve.sharded_cut_scan(solve.make_worker_mesh([cuda]),
                               *(t[k] for k in KEYS))


@pytest.mark.cuda
@pytest.mark.parametrize("name", K2_VR_CASES + K2G_VR_CASES)
def test_sharded_vr_edge_cases_match_reference(cuda, name):
    """The batches whose V x R step inputs a ring of whole batches could not
    hold (chip_smoke.py's edge cases), over 4 shards."""
    case = k1_edge_case(name) if name in K2_VR_CASES else k1g_edge_case(name)
    assert int(sharded_vs_reference(case, cuda, 4).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [16, 32])
def test_sharded_kernel_past_a_cluster(cuda, n_shards):
    """16 shards are the largest cluster (where the card fits it), 32 only
    the grid exchange: the wrapper picks it and counts it."""
    from hyperqueue_tpu_torch.parallel import solve

    case = random_case(41, 1024, 4, 64, 2, False)
    grid = solve.sharded_cut_scan.grid_launches
    assert int(sharded_vs_reference(case, cuda, n_shards).sum()) > 0
    if n_shards > solve.CLUSTER_LIMIT:
        assert solve.sharded_cut_scan.grid_launches == grid + 1


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True], ids=["global",
                                                          "resident"])
def test_sharded_layout_bytes_match_the_kernel(cuda, resident):
    from hyperqueue_tpu_torch.parallel import solve

    lib, _record = solve._sharded_scan_lib()
    rng = np.random.default_rng(10 + int(resident))
    shapes = [(256, 4, 2, 3, 0, 0, 0, 0), (256, 4, 2, 7, 8, 0, 1, 1),
              (4096, 867, 2, 16, 16384, 1, 1, 1), (16384, 2048, 2, 16, 16384,
                                                   1, 1, 1),
              (16, 64, 2048, 1, 0, 0, 0, 0)]
    shapes += [tuple(int(x) for x in (
        rng.integers(1, 16385), rng.integers(1, 65), rng.integers(1, 9),
        rng.integers(1, 17), rng.integers(1, 16385), rng.integers(0, 2),
        rng.integers(0, 2), rng.integers(0, 2))) for _ in range(200)]
    for n_wl, n_r, n_v, n_m, n_g, all_p, gang, masked in shapes:
        args = (n_wl, n_r, n_v, n_m, n_g if gang else 0, bool(all_p),
                bool(gang), bool(masked), resident)
        native = [int(a) for a in args]
        assert solve.sharded_smem_bytes(*args) == \
            lib.hq_sharded_smem_bytes(*native), args
        assert solve.sharded_ring(*args) == lib.hq_sharded_ring(*native), \
            args
    assert int(lib.hq_sharded_smem_limit()) == assign.SMEM_LIMIT
    assert int(lib.hq_sharded_cluster_limit()) == solve.CLUSTER_LIMIT


@pytest.mark.cuda
def test_refused_cluster_launch_raises(cuda, monkeypatch):
    """A cluster launch that the kernel refuses (17 blocks, past the largest
    cluster) raises; the wrapper never switches to the grid exchange."""
    from hyperqueue_tpu_torch.parallel import solve

    case = random_case(42, 17 * 16, 2, 4, 1, False)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    mesh = solve.make_worker_mesh([cuda] * 17)
    args = [t[k] for k in KEYS]
    with pytest.raises(RuntimeError, match="cudaError"):
        solve.sharded_cut_scan_forced(mesh, *args, exchange="cluster")
    layout = solve.sharded_layout
    monkeypatch.setattr(solve, "sharded_layout", lambda *a, **k: {
        **layout(*a, **k), "exchange": "cluster"})
    before = {k: getattr(solve.sharded_cut_scan, k)
              for k in solve.LAUNCH_COUNTS}
    with pytest.raises(RuntimeError, match=r"launch failed \(cluster"):
        solve.sharded_cut_scan(mesh, *args)
    assert before == {k: getattr(solve.sharded_cut_scan, k)
                      for k in solve.LAUNCH_COUNTS}


@pytest.mark.cuda
def test_cluster_step_latency(cuda):
    from hyperqueue_tpu_torch.parallel import solve

    for n_shards in (1, 4, 8, solve.CLUSTER_LIMIT):
        ms = solve.cluster_step_latency_ms(256, n_shards, cuda)
        assert 0 < ms < 1


@pytest.mark.cuda
def test_grid_step_latency(cuda):
    from hyperqueue_tpu_torch.parallel import solve

    for n_shards in (1, 4, 32):
        ms = solve.grid_step_latency_ms(256, n_shards, cuda)
        assert 0 < ms < 1


@pytest.mark.cuda
def test_multichip_model_on_card_matches_cpu(cuda):
    """Four shards of the card through the model (resident, with the
    paranoid fresh solve every second solve) against four CPU shards and
    against the single-block model on the card."""
    from hyperqueue_tpu_torch.models.multichip import MultichipModel
    from hyperqueue_tpu_torch.parallel import solve

    rng = np.random.default_rng(19)
    gpu = MultichipModel(devices=[cuda] * 4)
    gpu.paranoid_resident = 2
    cpu = MultichipModel(devices=["cpu"] * 4)
    single = GreedyCutScanModel(device="cuda")
    launches = solve.sharded_cut_scan.launches
    for n_w, n_b, n_r, n_v in [(100, 9, 3, 2), (61, 4, 2, 1), (100, 9, 3, 2)]:
        case = random_case(int(rng.integers(1 << 30)), n_w, n_r, n_b, n_v,
                           False)
        kw = {k: case[k] for k in KEYS[:6]}
        got = gpu.solve(**kw)
        np.testing.assert_array_equal(got, cpu.solve(**kw))
        np.testing.assert_array_equal(got, single.solve(**kw))
        assert gpu.last_backend_reason == "multichip-mesh"
    assert gpu.paranoid_checks == 1
    assert solve.sharded_cut_scan.launches == launches + 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_mu_ticks_on_card_match_cpu(cuda, seed):
    """Min-utilization workers with the card model: three ticks over a
    small north-star Core with four floored workers, the card's and the
    CPU's run_tick on identical state (the carve-out: K1 over the
    unfloored workers, the host search over the floored): the same
    assignments, one K1 launch a tick, every floor met or untouched."""
    from chip_smoke import CoreRunner, check_floors, mu_state
    from hyperqueue_tpu_torch.convert import core_from_plain

    plain = mu_state(n_floored=4, n_workers=64, n_tasks=4000, n_classes=16,
                     seed=seed)
    cores = [core_from_plain(*plain) for _ in range(2)]
    models = [GreedyCutScanModel(device="cuda"),
              GreedyCutScanModel(device="cpu", backend="device")]
    runners = [CoreRunner(core, seed) for core in cores]
    for t in range(3):
        outs, floored = [], []
        for core, model in zip(cores, models):
            assert core.tick_cache.sync(core) is None
            rows = core.worker_rows()
            floors = {r.worker_id: r.cpu_floor for r in rows
                      if r.cpu_floor > 0}
            before = assign.greedy_cut_scan.launches
            outs.append(run_tick(core.queues, rows, core.rq_map,
                                 core.resource_map, model))
            check_floors(outs[-1], floors, core.rq_map, f"tick {t}")
            floored.append(floors)
            if model.device.type == "cuda":
                assert assign.greedy_cut_scan.launches == before + 1
        assert outs[0] == outs[1], f"tick {t}"
        assert floored[0] == floored[1] and floored[0]
        for runner, out, floors in zip(runners, outs, floored):
            runner.start(out)
            runner.finish(floors)


@pytest.mark.cuda
def test_degraded_milp_tick_on_card_zeroes_the_floored_rows(cuda):
    """A failed MILP degrades its tick to the card model with the floored
    rows zeroed: the floored workers receive nothing, and the assignments
    equal the CPU fallback's on an identical Core."""
    from chip_smoke import milp_state
    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    class FailingMilp:
        supports_cpu_floor = True

        def solve(self, **kwargs):
            raise RuntimeError("injected solver failure")

    outs = []
    for device in ("cuda", "cpu"):
        core = core_from_plain(*milp_state())
        wd = SolverWatchdog(FailingMilp(), fallback=GreedyCutScanModel(
            device=device, backend="device"))
        rows = core.worker_rows()
        floored = {r.worker_id for r in rows if r.cpu_floor > 0}
        decision = {}
        before = assign.greedy_cut_scan.launches
        outs.append(run_tick(core.queues, rows, core.rq_map,
                             core.resource_map, wd, decision=decision))
        assert decision["solver"]["status"] == "fallback"
        assert floored and not {w for _t, w, *_ in outs[-1]} & floored
        if device == "cuda":
            assert assign.greedy_cut_scan.launches == before + 1
    assert outs[0] == outs[1] and outs[0]
