"""The port's sharded solve (parallel/solve.py, K2's plain version on CPU
tensors) and MultichipModel against the JAX package's sharded_cut_scan and
MultichipModel on the virtual 8-device CPU mesh that conftest.py forces,
and against the port's single-block cut-scan (K1's plain version).

Every comparison is integer and exact (tolerance 0): counts, free_after and
nt_after. The JAX inputs share one shape per program (W=32, R=4, B=8, V=2,
16 visit-class rows), so each mesh size compiles each program once.
"""

import numpy as np
import pytest
import torch

import bench
from hyperqueue_tpu.models.multichip import MultichipModel as JaxMultichip
from hyperqueue_tpu.parallel import solve as jax_solve
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu_torch.convert import tick_state_from_plain
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.models.multichip import MultichipModel
from hyperqueue_tpu_torch.ops import assign, build
from hyperqueue_tpu_torch.parallel import solve
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from test_torch_tick import _apply, _release, export_plain

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

pytestmark = pytest.mark.multichip

U = 10_000
INF = 2**31 - 1
CPU = torch.device("cpu")
N_W, N_R, N_B, N_V, N_M = 32, 4, 8, 2, 16
OPTIONAL = ("total", "all_mask", "gang_nodes", "gang_ok", "group_onehot",
            "policy_mask")


def _classes(case, affinity=None):
    """Visit classes of the case, the table padded to N_M rows."""
    free, needs = case["free"], case["needs"]
    scarcity = assign.scarcity_weights(np.maximum(free, 0).sum(axis=0))
    class_m, order_ids = assign.host_visit_classes(
        free, needs, scarcity, all_mask=case.get("all_mask"),
        affinity=affinity)
    assert class_m.shape[0] <= N_M
    padded = np.zeros((N_M, N_W), np.int32)
    padded[:class_m.shape[0]] = class_m
    case["class_m"], case["order_ids"] = padded, order_ids


def _base(rng, lifetimes=False):
    free = rng.integers(0, 8, size=(N_W, N_R)) * U
    needs = rng.integers(0, 3, size=(N_B, N_V, N_R)) * (U // 2)
    return {
        "free": free,
        "nt_free": rng.integers(0, 10, size=N_W),
        "lifetime": rng.choice([60, 600, INF], size=N_W) if lifetimes
        else np.full(N_W, INF),
        "needs": needs,
        "sizes": rng.integers(0, 30, size=N_B),
        "min_time": rng.choice([0, 120, 3600], size=(N_B, N_V)) if lifetimes
        else np.zeros((N_B, N_V)),
    }


def _heterogeneous(rng):
    """Distinct per-worker resource patterns, so many visit classes."""
    case = _base(rng)
    case["free"][::3, 1] = 0
    case["free"][1::3, 2] = 0
    needs = np.zeros((N_B, N_V, N_R), np.int64)
    needs[:, 0, 0] = U
    needs[0, 0, 1] = U
    needs[1, 1, 2] = 2 * U
    needs[2, 0, 3] = U // 2
    needs[3, 0, 0] = 3 * U
    needs[4, 1, 0] = U
    needs[5, 0, 3] = U
    needs[6, 1, 1] = U
    case["needs"] = needs
    case["nt_free"] = rng.integers(1, 12, size=N_W)
    return case


def _all_policy(rng):
    case = _base(rng, lifetimes=True)
    total = case["free"].copy()
    case["free"][rng.random(N_W) < 0.5] -= U // 2
    all_mask = np.zeros((N_B, N_V, N_R), np.int32)
    all_mask[rng.random((N_B, N_V)) < 0.4, 1] = 1
    case["needs"][all_mask > 0] = 0
    case.update(total=total, all_mask=all_mask)
    return case


def _gang_straddle(rng):
    """Groups over worker ranges that cross the shard boundaries of every
    mesh of 2, 4 and 8 (group 0 = workers 12-19 across the boundary at 16,
    group 1 = 0-11 and 20-25, group 2 = 26-29, workers 30-31 in none);
    the first gang row takes 12-17, the second finds group 0 short and
    takes from group 1, the third is infeasible and holds."""
    case = _base(rng)
    gids = np.full(N_W, -1)
    gids[12:20] = 0
    gids[:12] = 1
    gids[20:26] = 1
    gids[26:30] = 2
    onehot = np.zeros((N_W, 3), np.int32)
    onehot[np.flatnonzero(gids >= 0), gids[gids >= 0]] = 1
    gang_nodes = np.zeros(N_B, np.int64)
    gang_nodes[[0, 2, 5]] = [6, 5, 30]
    case["sizes"][[0, 2, 5]] = 1
    case["nt_free"][:] = np.maximum(case["nt_free"], 1)
    case.update(gang_nodes=gang_nodes, gang_ok=np.ones(N_W),
                group_onehot=onehot)
    return case


def _mask(rng):
    return _base(rng, lifetimes=True)


KINDS = {
    "random": lambda rng: _base(rng),
    "lifetimes": lambda rng: _base(rng, lifetimes=True),
    "heterogeneous": _heterogeneous,
    "all": _all_policy,
    "gang_straddle": _gang_straddle,
    "mask": _mask,
}


def make_case(kind, seed):
    rng = np.random.default_rng(seed)
    case = KINDS[kind](rng)
    affinity = None
    if kind == "mask":
        affinity = rng.choice(np.array([0.0, 0.5, 1.0, 2.0]),
                              size=(N_B, N_W))
        case["policy_mask"] = (affinity > 0).astype(np.int32)
    _classes(case, affinity)
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def _args(case):
    return ([case[k] for k in ("free", "nt_free", "lifetime", "needs",
                               "sizes", "min_time", "class_m", "order_ids")],
            {k: case.get(k) for k in OPTIONAL})


def port_sharded(case, n_shards):
    mesh = solve.make_worker_mesh([CPU] * n_shards)
    args, opt = _args(case)
    placed = solve.place_tick_inputs(mesh, *args, **opt)
    counts = solve.sharded_cut_scan(mesh, *placed)
    return [x.numpy() for x in (counts, placed[0], placed[1])]


def jax_sharded(case, n_shards):
    mesh = jax_solve.make_worker_mesh(n_shards)
    args, opt = _args(case)
    placed = jax_solve.place_tick_inputs(mesh, *args, **opt)
    return [np.asarray(x) for x in jax_solve.sharded_cut_scan(mesh, *placed)]


def port_single(case):
    args, opt = _args(case)
    t = [torch.from_numpy(a) for a in args]
    opt = {k: None if v is None else torch.from_numpy(v)
           for k, v in opt.items()}
    return [x.numpy() for x in assign.greedy_cut_scan_reference(*t, **opt)]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_matches_jax_and_single_block(kind, n_shards):
    case = make_case(kind, 100 + len(kind))
    got = port_sharded(case, n_shards)
    for want in (jax_sharded(case, n_shards), port_single(case)):
        for name, g, w in zip(("counts", "free", "nt_free"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].sum() > 0
    if kind == "gang_straddle":
        np.testing.assert_array_equal(np.flatnonzero(got[0][0, 0]),
                                      np.arange(12, 18))
        second = np.flatnonzero(got[0][2, 0])
        assert len(second) == 5 and case["group_onehot"][second, 1].all()
        assert got[0][5].sum() == 0


@pytest.mark.parametrize("seed", [7, 11, 13])
def test_sharded_reference_matches_single_block_wide(seed):
    """Wider random fused instances (gang rows, ALL-free, a mask) at mesh
    sizes that do not divide into powers of two: K2's plain version equals
    K1's."""
    rng = np.random.default_rng(seed)
    n_w, n_b = 96, 24
    case = {
        "free": rng.integers(0, 8, size=(n_w, 3)) * U,
        "nt_free": rng.integers(-1, 10, size=n_w),
        "lifetime": np.where(rng.random(n_w) < 0.2, 100, INF),
        "needs": rng.integers(0, 3, size=(n_b, 2, 3)) * (U // 2),
        "sizes": rng.integers(0, 40, size=n_b),
        "min_time": np.where(rng.random((n_b, 2)) < 0.2, 3600, 0),
        "gang_nodes": np.where(rng.random(n_b) < 0.25,
                               rng.integers(1, 17, size=n_b), 0),
        "gang_ok": rng.random(n_w) < 0.6,
        "group_onehot": np.eye(5, dtype=np.int32)[
            rng.integers(0, 5, size=n_w)],
    }
    affinity = rng.choice(np.array([0.0, 1.0, 2.0]), size=(n_b, n_w))
    case["policy_mask"] = affinity > 0
    scarcity = assign.scarcity_weights(case["free"].sum(axis=0))
    case["class_m"], case["order_ids"] = assign.host_visit_classes(
        case["free"], case["needs"], scarcity, affinity=affinity)
    t = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
         for k, v in case.items()}
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    want = assign.greedy_cut_scan_reference(
        *(t[k] for k in keys), **{k: t.get(k) for k in OPTIONAL})
    for n_shards in (1, 3, 6, 12):
        got = solve.sharded_cut_scan_reference(
            (CPU,) * n_shards, *(t[k] for k in keys),
            **{k: t.get(k) for k in OPTIONAL})
        for g, w in zip(got, want):
            assert torch.equal(g, w), n_shards
    assert int(want[0].sum()) > 0


def test_sharded_updates_state_in_place_and_counts_nothing_on_cpu():
    case = make_case("all", 3)
    mesh = solve.make_worker_mesh(["cpu"] * 4)
    args, opt = _args(case)
    placed = solve.place_tick_inputs(mesh, *args, **opt)
    launches = solve.sharded_cut_scan.launches
    counts = solve.sharded_cut_scan(mesh, *placed)
    want = port_single(case)
    np.testing.assert_array_equal(counts.numpy(), want[0])
    np.testing.assert_array_equal(placed[0].numpy(), want[1])
    np.testing.assert_array_equal(placed[1].numpy(), want[2])
    assert solve.sharded_cut_scan.launches == launches  # no kernel on CPU


def test_uneven_split_raises():
    case = make_case("random", 1)
    args, opt = _args(case)
    mesh = solve.make_worker_mesh([CPU] * 3)
    with pytest.raises(ValueError, match="equal shards"):
        solve.sharded_cut_scan(mesh, *solve.place_tick_inputs(mesh, *args))
    with pytest.raises(ValueError, match="equal shards"):
        solve.shard_bounds(10, 4)
    assert solve.shard_bounds(12, 3) == [(0, 4), (4, 8), (8, 12)]


def test_mesh_over_several_devices_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        solve.make_worker_mesh([torch.device("cuda", 0),
                                torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="multi-card"):
        solve.make_worker_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        solve.make_worker_mesh([])
    assert solve.make_worker_mesh(["cpu"] * 3) == (CPU,) * 3
    model = MultichipModel(devices=["cpu", "cuda:1"])
    kw = _model_kwargs(np.random.default_rng(0), 12, 3, 2, 1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        model.solve(**kw)


def test_multichip_model_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultichipModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultichipModel(devices=["cuda:0"] * 4)
    assert MultichipModel(devices=["cpu"] * 2).device == CPU


# -- the production model (what `--scheduler=multichip` builds) --------------

def _model_kwargs(rng, n_w, n_r, n_b, n_v):
    return dict(
        free=(rng.integers(0, 8, size=(n_w, n_r)) * U).astype(np.int32),
        nt_free=rng.integers(0, 10, size=n_w).astype(np.int32),
        lifetime=rng.choice([60, 600, INF], size=n_w).astype(np.int32),
        needs=(rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2))
        .astype(np.int32),
        sizes=rng.integers(0, 30, size=n_b).astype(np.int32),
        min_time=rng.choice([0, 120, 3600], size=(n_b, n_v))
        .astype(np.int32),
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_multichip_model_matches_jax_and_greedy(n_shards):
    """Awkward unpadded shapes: the model pads W to a multiple of D."""
    port = MultichipModel(devices=[CPU] * n_shards)
    jax_model = JaxMultichip(n_devices=n_shards)
    greedy = GreedyCutScanModel(device="cpu")
    for seed in (2, 9):
        kw = _model_kwargs(np.random.default_rng(seed), 13, 3, 5, 2)
        got = port.solve(**kw)
        np.testing.assert_array_equal(got, jax_model.solve(**kw))
        np.testing.assert_array_equal(got, greedy.solve(**kw))
    assert port.last_backend_reason == "multichip-mesh"
    assert port.last_backend == "device-cpu"
    assert len(port._get_mesh()) == n_shards


def test_multichip_model_pads_to_a_multiple_of_the_shards():
    port = MultichipModel(devices=["cpu"] * 3, backend="auto")
    greedy = GreedyCutScanModel(device="cpu")
    kw = _model_kwargs(np.random.default_rng(4), 13, 3, 5, 2)
    np.testing.assert_array_equal(port.solve(**kw), greedy.solve(**kw))
    assert port._worker_bucket(13) == 18 and greedy._worker_bucket(13) == 16
    # a mesh bypasses the cost model, which would solve "auto" on the host
    assert port.last_backend_reason == "multichip-mesh"
    assert port._res.stats()["full_uploads"] == 1


def test_multichip_model_single_shard_fallback():
    model = MultichipModel(n_devices=1, device="cpu")
    kw = dict(
        free=np.array([[4 * U]], dtype=np.int32),
        nt_free=np.array([8], dtype=np.int32),
        lifetime=np.array([INF], dtype=np.int32),
        needs=np.array([[[U]]], dtype=np.int32),
        sizes=np.array([3], dtype=np.int32),
        min_time=np.zeros((1, 1), dtype=np.int32),
    )
    counts = model.solve(**kw)
    assert counts.sum() == 3
    assert model._mesh is False  # one shard: the single-block kernel
    assert model.last_backend_reason == "forced-device"
    np.testing.assert_array_equal(counts, JaxMultichip(n_devices=1)
                                  .solve(**kw))
    assert MultichipModel(devices=["cpu"] * 4, n_devices=1)._get_mesh() \
        is False


def _tick_batches(rng, n_r, w_now):
    """One tick's batches: sometimes a gang row over two groups, sometimes
    an ALL-policy batch."""
    n_b = int(rng.integers(1, 9))
    n_v = int(rng.integers(1, 3))
    needs = (rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2)) \
        .astype(np.int32)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    sizes = rng.integers(0, 25, size=n_b).astype(np.int32)
    kw = dict(needs=needs, sizes=sizes,
              min_time=rng.choice([0, 0, 120, 3600], size=(n_b, n_v))
              .astype(np.int32))
    if rng.random() < 0.5:
        gang_nodes = np.zeros(n_b, dtype=np.int32)
        g = int(rng.integers(0, n_b))
        gang_nodes[g] = int(rng.integers(2, 4))
        sizes[g] = 1
        gids = rng.integers(0, 2, size=w_now)
        kw.update(gang_nodes=gang_nodes,
                  gang_ok=rng.integers(0, 2, size=w_now).astype(np.int32),
                  group_onehot=np.eye(2, dtype=np.int32)[gids])
    if rng.random() < 0.3:
        all_mask = np.zeros((n_b, n_v, n_r), dtype=np.int32)
        all_mask[0, 0, 1] = 1
        needs[0, 0, 1] = 0
        kw["all_mask"] = all_mask
    return kw


def _workers(rng, n_w, n_r):
    free = (rng.integers(0, 8, size=(n_w, n_r)) * U).astype(np.int32)
    return (free, free.copy(),
            rng.integers(0, 10, size=n_w).astype(np.int32),
            rng.choice([600, 3600, INF], size=n_w).astype(np.int32))


def test_resident_multi_tick_soak_bitwise():
    """Twelve ticks through one resident MultichipModel of 4 shards, with
    gang rows, ALL-policy ticks, completions and worker churn (W resized
    across the shard padding) and the paranoid fresh solve armed every
    second solve, against a fresh MultichipModel and a fresh
    GreedyCutScanModel per tick."""
    rng = np.random.default_rng(0)
    n_r = 4
    free, total, nt_free, lifetime = _workers(rng, int(rng.integers(9, 20)),
                                              n_r)
    resident = MultichipModel(devices=[CPU] * 4)
    resident.paranoid_resident = 2
    gang_ticks = all_ticks = 0
    for tick in range(12):
        batch = _tick_batches(rng, n_r, free.shape[0])
        kw = dict(free=free.copy(), nt_free=nt_free.copy(),
                  lifetime=lifetime.copy(), **batch)
        if "all_mask" in batch:
            kw["total"] = total.copy()
            all_ticks += 1
        gang_ticks += "gang_nodes" in batch
        out = resident.solve(**{k: v.copy() for k, v in kw.items()})
        np.testing.assert_array_equal(
            out, MultichipModel(devices=[CPU] * 4).solve(**kw),
            err_msg=f"resident diverged from fresh at tick {tick}")
        np.testing.assert_array_equal(
            out, GreedyCutScanModel(device="cpu").solve(**kw),
            err_msg=f"sharded diverged from single-block at tick {tick}")
        assert out.flags.c_contiguous
        # the host applies the tick, then some workers finish
        used = np.einsum("bvw,bvr->wr", out.astype(np.int64),
                         batch["needs"].astype(np.int64))
        free = (free - used).astype(np.int32)
        if "all_mask" in batch:
            drained = np.einsum("bvw,bvr->wr", out.astype(np.int64),
                                batch["all_mask"].astype(np.int64)) > 0
            free[drained] = 0
        nt_free = (nt_free - out.sum(axis=(0, 1))).astype(np.int32)
        done = rng.integers(0, 2, size=free.shape[0]).astype(bool)
        free[done] = total[done]
        nt_free[done] = np.minimum(nt_free[done] + 1, 10)
        if rng.random() < 0.3:  # churn
            if rng.random() < 0.5 and free.shape[0] > 6:
                gone = int(rng.integers(0, free.shape[0]))
                free, total, nt_free, lifetime = (
                    np.delete(x, gone, axis=0)
                    for x in (free, total, nt_free, lifetime))
            else:
                joined = _workers(rng, 1, n_r)
                free, total, nt_free, lifetime = (
                    np.concatenate([x, y]) for x, y in zip(
                        (free, total, nt_free, lifetime), joined))
    stats = resident.resident_stats()
    assert stats["delta_uploads"] > 0 and stats["invalidations"] == 0
    assert resident.paranoid_checks > 0
    assert gang_ticks > 0 and all_ticks > 0


def test_run_tick_with_multichip_matches_jax():
    """Consecutive ticks of one bench-shaped state through the JAX run_tick
    with the JAX MultichipModel on 4 devices and the port's run_tick with
    MultichipModel on 4 CPU shards: the same assignment lists."""
    queues, worker_rows, rq_map, resource_map, _prio = bench.build_tick_state(
        n_workers=48, n_tasks=6_000, n_classes=12)
    rows = [
        jax_tick.WorkerRow(worker_id=r.worker_id, free=list(r.free),
                           nt_free=r.nt_free, lifetime_secs=r.lifetime_secs,
                           total=list(r.free))
        for r in worker_rows()
    ]
    plain = export_plain(resource_map, rq_map, queues, rows)
    p_resource_map, p_rq_map, p_queues, p_rows = tick_state_from_plain(*plain)
    totals = [list(row.total) for row in rows]
    nt0 = [row.nt_free for row in rows]
    jax_model = JaxMultichip(n_devices=4)
    port_model = MultichipModel(devices=[CPU] * 4)
    for t in range(3):
        want = jax_tick.run_tick(queues, rows, rq_map, resource_map,
                                 jax_model)
        got = port_tick.run_tick(p_queues, p_rows, p_rq_map, p_resource_map,
                                 port_model)
        assert got == want, f"tick {t}"
        assert got
        _apply(want, rows, rq_map)
        _apply(got, p_rows, p_rq_map)
        _release(rows, totals, nt0, t)
        _release(p_rows, totals, nt0, t)
    assert port_model.last_backend_reason == "multichip-mesh"


# -- the build ---------------------------------------------------------------

def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a kernel source includes, directly or
    through another header, builds that kernel anew; an edit to a header
    it does not include does not."""
    for name in ("cut_scan", "sharded_scan"):
        assert 'include "cut_scan_core.cuh"' in (
            build.CSRC_DIR / f"{name}.cu").read_text()
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '  # include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "c.cuh").write_text("int c;\n")
    digests = [build.source_digest("k")]
    for name, text in (("c.cuh", "int c2;\n"), ("b.cuh", "int b2;\n"),
                       ("a.cuh", '#include "b.cuh"\nint a2;\n'),
                       ("k.cu", '#include "a.cuh"\nint k2;\n')):
        (tmp_path / name).write_text(text)
        digests.append(build.source_digest("k"))
    assert digests[1] == digests[0]  # c.cuh is not included
    assert len(set(digests[1:])) == 4
