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


def kernel_vs_reference(case, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    opt = {k: t.get(k) for k in OPTIONAL}
    ref = assign.greedy_cut_scan_reference(*(t[k] for k in KEYS), **opt)
    launches = assign.greedy_cut_scan.launches
    counts = assign.greedy_cut_scan(*(t[k] for k in KEYS), **opt)
    torch.cuda.synchronize()
    assert assign.greedy_cut_scan.launches == launches + 1
    for name, got, want in zip(("counts", "free", "nt_free"),
                               (counts, t["free"], t["nt_free"]), ref):
        assert torch.equal(got, want), name
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
    gpu = GreedyCutScanModel(device="cuda")
    cpu = GreedyCutScanModel(device="cpu")
    for n_w, n_b, n_r, n_v in [(100, 9, 3, 2), (60, 4, 2, 1), (100, 9, 3, 2)]:
        case = random_case(int(rng.integers(1 << 30)), n_w, n_r, n_b, n_v,
                           False)
        kw = {k: case[k] for k in KEYS[:6]}
        got = gpu.solve(**kw)
        np.testing.assert_array_equal(got, cpu.solve(**kw))
    assert gpu.last_backend == "device-cuda"


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
        model = GreedyCutScanModel(device=device)
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
