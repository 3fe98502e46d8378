"""The port's cut-scan (hyperqueue_tpu_torch.ops.assign) against the JAX
package's: the jitted JAX kernel on the CPU backend and its numpy twin.

Every comparison is integer and exact (tolerance 0): counts, the free
resources after the solve and the task slots after the solve. On the CPU the
port's wrapper runs its plain PyTorch version; the CUDA kernel itself is
held against that version on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from hyperqueue_tpu.ops import assign as jax_assign
from hyperqueue_tpu_torch.ops import assign as port_assign

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1

# one padded shape for every case keeps the jitted JAX kernel at two
# compilations (with and without ALL-policy inputs)
PW, PB, PR, PV, PM = 16, 8, 4, 2, 16

_JAX_SCAN = jax.jit(jax_assign.greedy_cut_scan_impl)


def _pad(free, nt_free, lifetime, needs, sizes, min_time, total=None,
         all_mask=None, shape=(PW, PB, PR, PV)):
    """Pad a case the way the model does: padded workers have nothing,
    padded batches have size 0, padded variants an infinite min_time."""
    pw, pb, pr, pv = shape
    free = np.asarray(free, dtype=np.int64)
    needs = np.asarray(needs, dtype=np.int64)
    n_w, n_r = free.shape
    n_b, n_v, _ = needs.shape
    out = {
        "free": np.zeros((pw, pr), np.int32),
        "nt_free": np.zeros(pw, np.int32),
        "lifetime": np.zeros(pw, np.int32),
        "needs": np.zeros((pb, pv, pr), np.int32),
        "sizes": np.zeros(pb, np.int32),
        "min_time": np.zeros((pb, pv), np.int32),
    }
    out["free"][:n_w, :n_r] = free
    out["nt_free"][:n_w] = nt_free
    out["lifetime"][:n_w] = lifetime
    out["needs"][:n_b, :n_v, :n_r] = needs
    out["sizes"][:n_b] = sizes
    out["min_time"][:n_b, :n_v] = min_time
    out["min_time"][:, n_v:] = INF
    if all_mask is not None:
        out["total"] = np.zeros((pw, pr), np.int32)
        out["total"][:n_w, :n_r] = total
        out["all_mask"] = np.zeros((pb, pv, pr), np.int32)
        out["all_mask"][:n_b, :n_v, :n_r] = all_mask
    return out


def _visit_classes(case, pm=PM, affinity=None):
    """Visit classes from both packages' host code (they must agree), with
    the mask table padded to `pm` rows."""
    scarcity = jax_assign.scarcity_weights(
        case["free"].astype(np.int64).sum(axis=0)
    )
    port_scarcity = port_assign.scarcity_weights(
        case["free"].astype(np.int64).sum(axis=0)
    )
    np.testing.assert_array_equal(port_scarcity, scarcity)
    cm, oi = jax_assign.host_visit_classes(
        case["free"], case["needs"], scarcity,
        all_mask=case.get("all_mask"), affinity=affinity,
    )
    pcm, poi = port_assign.host_visit_classes(
        case["free"], case["needs"], port_scarcity,
        all_mask=case.get("all_mask"), affinity=affinity,
    )
    np.testing.assert_array_equal(pcm, cm)
    np.testing.assert_array_equal(poi, oi)
    if pm is not None:
        cm = np.concatenate(
            [cm, np.zeros((pm - cm.shape[0], cm.shape[1]), np.int32)]
        )
    case["class_m"] = cm
    case["order_ids"] = oi
    return case


OPTIONAL = ("total", "all_mask", "gang_nodes", "gang_ok", "group_onehot",
            "policy_mask")


def _solve_all(case):
    """(port, jax, numpy) results, each (counts, free_after, nt_after)."""
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    t = {k: torch.from_numpy(np.array(case[k], dtype=np.int32))
         for k in keys + OPTIONAL if k in case}
    counts = port_assign.greedy_cut_scan(
        *(t[k] for k in keys), **{k: t.get(k) for k in OPTIONAL}
    )
    port = (counts.numpy(), t["free"].numpy(), t["nt_free"].numpy())
    opt = {k: case.get(k) for k in OPTIONAL}
    jx = _JAX_SCAN(*(case[k] for k in keys), **opt)
    jx = tuple(np.asarray(a) for a in jx)
    npy = jax_assign.greedy_cut_scan_numpy(*(case[k] for k in keys), **opt)
    return port, jx, npy


def _assert_exact(case):
    port, jx, npy = _solve_all(case)
    for name, p, j, n in zip(("counts", "free", "nt_free"), port, jx, npy):
        np.testing.assert_array_equal(p, j, err_msg=f"{name}: port vs jax")
        np.testing.assert_array_equal(p, n, err_msg=f"{name}: port vs numpy")
    return port


# the deterministic cases of tests/test_solver.py, with the counts that file
# pins for each (None where it pins an aggregate only)
SOLVER_CASES = {
    "single_batch_spreads": (
        dict(free=[[4 * U]] * 3, nt_free=[8] * 3, lifetime=[INF] * 3,
             needs=[[[U]]], sizes=[10], min_time=[[0]]),
        {(0, 0): [4, 4, 2]},
    ),
    "priority_dominance": (
        dict(free=[[4 * U]], nt_free=[8], lifetime=[INF],
             needs=[[[U]], [[U]]], sizes=[4, 4], min_time=[[0], [0]]),
        {(0, 0): [4], (1, 0): [0]},
    ),
    "gap_relaxation": (
        dict(free=[[4 * U]], nt_free=[8], lifetime=[INF],
             needs=[[[3 * U]], [[U]]], sizes=[5, 5], min_time=[[0], [0]]),
        {(0, 0): [1], (1, 0): [1]},
    ),
    "variants_preference": (
        dict(free=[[4 * U, 0], [4 * U, U]], nt_free=[8, 8],
             lifetime=[INF, INF], needs=[[[0, U], [2 * U, 0]]], sizes=[3],
             min_time=[[0, 0]]),
        {(0, 0): [0, 1]},
    ),
    "fractional_resources": (
        dict(free=[[4 * U, U]], nt_free=[8], lifetime=[INF],
             needs=[[[U, U // 2]]], sizes=[5], min_time=[[0]]),
        {(0, 0): [2]},
    ),
    "min_time_masks": (
        dict(free=[[4 * U], [4 * U]], nt_free=[8, 8], lifetime=[100, INF],
             needs=[[[U]]], sizes=[8], min_time=[[3600]]),
        {(0, 0): [0, 4]},
    ),
    "task_slot_cap": (
        dict(free=[[100 * U]], nt_free=[3], lifetime=[INF], needs=[[[U]]],
             sizes=[50], min_time=[[0]]),
        {(0, 0): [3]},
    ),
    "scarcity_avoids_gpu": (
        dict(free=[[8 * U, 2 * U], [8 * U, 0]], nt_free=[16, 16],
             lifetime=[INF, INF], needs=[[[U, 0]]], sizes=[8],
             min_time=[[0]]),
        {(0, 0): [0, 8]},
    ),
    "empty_and_padding_batches": (
        dict(free=[[4 * U]], nt_free=[8], lifetime=[INF],
             needs=[[[U]], [[0]]], sizes=[0, 7], min_time=[[0], [0]]),
        {(0, 0): [0], (1, 0): [0]},
    ),
}


@pytest.mark.parametrize("name", sorted(SOLVER_CASES))
def test_solver_cases_match_jax_and_numpy(name):
    spec, pinned = SOLVER_CASES[name]
    n_w = len(spec["free"])
    counts, _free, _nt = _assert_exact(_visit_classes(_pad(**spec)))
    for (b, v), expected in pinned.items():
        assert counts[b, v, :n_w].tolist() == expected


def _solver_random(seed):
    """tests/test_solver.py test_random_cross_check_vs_oracle's generator."""
    rng = np.random.default_rng(seed)
    n_w = int(rng.integers(1, 9))
    n_r = int(rng.integers(1, 4))
    n_b = int(rng.integers(1, 6))
    n_v = int(rng.integers(1, 3))
    return dict(
        free=rng.integers(0, 8, size=(n_w, n_r)) * U,
        nt_free=rng.integers(0, 10, size=n_w),
        lifetime=np.where(rng.random(n_w) < 0.2, 100, INF),
        needs=rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2),
        sizes=rng.integers(0, 12, size=n_b),
        min_time=np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0),
    )


@pytest.mark.parametrize("seed", range(8))
def test_solver_random_cases_match(seed):
    _assert_exact(_visit_classes(_pad(**_solver_random(seed))))


def _hard_random(seed, with_all):
    """Random cases with what the production path can throw at the kernel:
    negative free (prefill over-commit), short-lived workers under min_time,
    absent variants, padding rows and, optionally, ALL-policy requests."""
    rng = np.random.default_rng(1000 + seed)
    n_w = int(rng.integers(3, PW + 1))
    n_r = int(rng.integers(1, PR + 1))
    n_b = int(rng.integers(1, PB))       # at least one padding row
    n_v = int(rng.integers(1, PV + 1))
    total = rng.integers(0, 9, size=(n_w, n_r)) * U
    used = rng.integers(0, 5, size=(n_w, n_r)) * (U // 2)
    free = total - used                   # may go negative
    nt_free = rng.integers(-2, 12, size=n_w)
    lifetime = np.where(rng.random(n_w) < 0.3,
                        rng.integers(0, 7200, size=n_w), INF)
    needs = rng.integers(0, 4, size=(n_b, n_v, n_r)) * (U // 2)
    needs[rng.random((n_b, n_v)) < 0.2] = 0   # absent variants
    sizes = rng.integers(0, 30, size=n_b)
    min_time = np.where(rng.random((n_b, n_v)) < 0.3,
                        rng.integers(1, 7200, size=(n_b, n_v)), 0)
    min_time[(needs == 0).all(axis=2)] = INF
    kw = dict(free=free, nt_free=nt_free, lifetime=lifetime, needs=needs,
              sizes=sizes, min_time=min_time)
    if with_all:
        all_mask = (rng.random((n_b, n_v, n_r)) < 0.25).astype(np.int32)
        needs[all_mask > 0] = 0        # an ALL entry carries no amount
        # some pools untouched, so ALL requests can fit
        idle = rng.random(n_w) < 0.5
        free[idle] = total[idle]
        kw.update(total=total, all_mask=all_mask)
    free[-1, 0] = -(U // 2)  # always one over-committed worker
    return kw


@pytest.mark.parametrize("with_all", [False, True], ids=["plain", "all"])
@pytest.mark.parametrize("seed", range(8))
def test_hard_random_cases_match(seed, with_all):
    case = _hard_random(seed, with_all)
    _assert_exact(_visit_classes(_pad(**case)))


def test_negative_free_and_slots_assign_nothing_there():
    case = _pad(
        free=[[-U, 4 * U], [4 * U, 4 * U], [4 * U, -1]],
        nt_free=[8, -1, 8], lifetime=[INF] * 3,
        needs=[[[U, U]]], sizes=[20], min_time=[[0]],
    )
    counts, free, nt = _assert_exact(_visit_classes(case))
    assert counts[0, 0, :3].tolist() == [0, 0, 0]
    assert free[0].tolist()[:2] == [-U, 4 * U]


def test_all_policy_empties_pool_and_fits_once():
    case = _pad(
        free=[[4 * U, 2 * U], [4 * U, U]], nt_free=[8, 8],
        lifetime=[INF, INF], needs=[[[U, 0]]], sizes=[5], min_time=[[0]],
        total=[[4 * U, 2 * U], [4 * U, 2 * U]], all_mask=[[[0, 1]]],
    )
    counts, free, _nt = _assert_exact(_visit_classes(case))
    # only worker 0's pool is untouched; one task takes all of it
    assert counts[0, 0, :2].tolist() == [1, 0]
    assert free[0, 1] == 0 and free[0, 0] == 3 * U


def test_odd_unpadded_shapes_match():
    rng = np.random.default_rng(7)
    n_w, n_r, n_b, n_v = 13, 3, 5, 3
    case = dict(
        free=(rng.integers(0, 8, size=(n_w, n_r)) * U).astype(np.int32),
        nt_free=rng.integers(0, 10, size=n_w).astype(np.int32),
        lifetime=np.full(n_w, INF, np.int32),
        needs=(rng.integers(0, 3, size=(n_b, n_v, n_r)) * U).astype(np.int32),
        sizes=rng.integers(0, 20, size=n_b).astype(np.int32),
        min_time=np.zeros((n_b, n_v), np.int32),
    )
    _assert_exact(_visit_classes(case, pm=None))


@pytest.mark.parametrize("seed", range(4))
def test_visit_classes_with_affinity_match(seed):
    rng = np.random.default_rng(2000 + seed)
    case = _pad(**_hard_random(seed, with_all=seed % 2 == 1))
    affinity = rng.choice([0.0, 0.5, 1.0, 2.0], size=(PB, PW))
    _visit_classes(case, affinity=affinity)


# -- gang rows and the policy mask (the K1g branches) ------------------------

PG = 4  # the model's group bucket floor


def _gang_random(seed):
    """tests/test_solver.py test_gang_rows_numpy_matches_jax_and_hold_
    invariants' generator: up to two gang rows of 2-3 nodes, random
    idleness and one or two worker groups."""
    rng = np.random.default_rng(seed + 500)
    n_w = int(rng.integers(4, 12))
    n_r, n_b, n_v = 2, int(rng.integers(2, 7)), 2
    n_g = int(rng.integers(1, 3))
    free = rng.integers(0, 8, size=(n_w, n_r)) * U
    nt_free = rng.integers(0, 10, size=n_w)
    lifetime = np.where(rng.random(n_w) < 0.2, 100, INF)
    needs = rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    sizes = rng.integers(0, 12, size=n_b)
    min_time = np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0)
    gang_nodes = np.zeros(n_b, dtype=np.int64)
    for b in rng.choice(n_b, size=min(2, n_b), replace=False):
        gang_nodes[b] = int(rng.integers(2, 4))
        sizes[b] = 1
    gang_ok = rng.integers(0, 2, size=n_w)
    gids = rng.integers(0, n_g, size=n_w)
    kernel = dict(free=free, nt_free=nt_free, lifetime=lifetime, needs=needs,
                  sizes=sizes, min_time=min_time)
    return kernel, gang_nodes, gang_ok, gids


def _weighted_random(seed):
    """tests/test_solver.py _random_weighted_case's generator (seeded as
    test_weighted_affinity_numpy_matches_jax seeds it): affinity rows with
    zeros (hard exclusion), fractional and > 1 weights."""
    rng = np.random.default_rng(seed + 900)
    n_w = int(rng.integers(1, 9))
    n_r = int(rng.integers(1, 4))
    n_b = int(rng.integers(1, 6))
    n_v = int(rng.integers(1, 3))
    kernel = dict(
        free=rng.integers(0, 8, size=(n_w, n_r)) * U,
        nt_free=rng.integers(0, 10, size=n_w),
        lifetime=np.where(rng.random(n_w) < 0.2, 100, INF),
        needs=rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2),
        sizes=rng.integers(0, 12, size=n_b),
        min_time=np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0),
    )
    affinity = rng.choice(
        np.array([0.0, 0.5, 1.0, 2.0, 4.0]), size=(n_b, n_w))
    return kernel, affinity


def _with_gangs(case, gang_nodes, gang_ok, gids):
    """Pad the gang inputs as the model does (G bucketed at 4)."""
    case["gang_nodes"] = np.zeros(PB, np.int32)
    case["gang_nodes"][:len(gang_nodes)] = gang_nodes
    case["gang_ok"] = np.zeros(PW, np.int32)
    case["gang_ok"][:len(gang_ok)] = gang_ok
    case["group_onehot"] = np.zeros((PW, PG), np.int32)
    case["group_onehot"][np.arange(len(gids)), gids] = 1
    return case


def _padded_affinity(affinity):
    aff = np.zeros((PB, PW), np.float32)
    aff[:affinity.shape[0], :affinity.shape[1]] = affinity
    return aff


def _assert_gang_invariants(counts, free, needs, gang_nodes, gang_ok, gids,
                            pmask=None):
    """test_solver.py's invariants: a gang row emits exactly n counts on
    idle members of ONE group in variant 0, or nothing; members never
    overlap; ordinary rows fit the free resources."""
    n_b, n_w = len(gang_nodes), len(gids)
    counts = counts[:n_b, :, :n_w]
    ordinary = (np.asarray(gang_nodes) == 0)[:, None, None]
    used = np.einsum("bvw,bvr->wr", (counts * ordinary).astype(np.int64),
                     np.asarray(needs, np.int64)[:n_b])
    assert (used <= np.asarray(free)[:n_w]).all()
    taken: set[int] = set()
    for b in range(n_b):
        n = int(gang_nodes[b])
        if not n:
            continue
        assert counts[b, 1:].sum() == 0
        members = np.flatnonzero(counts[b, 0])
        assert counts[b, 0, members].tolist() == [1] * len(members)
        assert len(members) in (0, n)
        for w in members:
            assert gang_ok[w] == 1 and int(w) not in taken
            if pmask is not None:
                assert pmask[b, w] > 0
            taken.add(int(w))
        if len(members):
            assert len({int(gids[w]) for w in members}) == 1


@pytest.mark.parametrize("seed", range(6))
def test_gang_rows_match_jax_and_numpy(seed):
    kernel, gang_nodes, gang_ok, gids = _gang_random(seed)
    case = _with_gangs(_visit_classes(_pad(**kernel)), gang_nodes, gang_ok,
                       gids)
    counts, _free, _nt = _assert_exact(case)
    _assert_gang_invariants(counts, kernel["free"], kernel["needs"],
                            gang_nodes, gang_ok, gids)


@pytest.mark.parametrize("seed", range(6))
def test_policy_mask_matches_jax_and_numpy(seed):
    kernel, affinity = _weighted_random(seed)
    aff = _padded_affinity(affinity)
    case = _visit_classes(_pad(**kernel), affinity=aff)
    case["policy_mask"] = (aff > 0).astype(np.int32)
    counts, _free, _nt = _assert_exact(case)
    # a zero weight is a hard exclusion
    n_b, n_w = affinity.shape
    assert not counts[:n_b, :, :n_w][
        np.broadcast_to((affinity == 0)[:, None, :], (n_b, PV, n_w))
    ].any()


@pytest.mark.parametrize("seed", range(4))
def test_gang_rows_with_policy_mask_match(seed):
    kernel, gang_nodes, gang_ok, gids = _gang_random(seed + 10)
    rng = np.random.default_rng(seed + 3000)
    n_b, n_w = len(gang_nodes), len(gids)
    affinity = rng.choice(np.array([0.0, 1.0, 2.0]), size=(n_b, n_w),
                          p=[0.2, 0.5, 0.3])
    aff = _padded_affinity(affinity)
    case = _visit_classes(_pad(**kernel), affinity=aff)
    case["policy_mask"] = (aff > 0).astype(np.int32)
    case = _with_gangs(case, gang_nodes, gang_ok, gids)
    counts, _free, _nt = _assert_exact(case)
    _assert_gang_invariants(counts, kernel["free"], kernel["needs"],
                            gang_nodes, gang_ok, gids,
                            pmask=case["policy_mask"])


def test_infeasible_gang_holds_its_workers():
    # two idle workers in one group, a 3-node gang first: infeasible, so it
    # emits nothing but holds both; the ordinary row after it gets nothing
    spec = dict(free=[[4 * U]] * 3, nt_free=[4] * 3, lifetime=[INF] * 3,
                needs=[[[0]], [[U]]], sizes=[1, 10], min_time=[[0], [0]])
    case = _with_gangs(_visit_classes(_pad(**spec)), [3, 0], [1, 1, 0],
                       [0, 0, 0])
    counts, free, nt = _assert_exact(case)
    assert counts[0, 0, :3].tolist() == [0, 0, 0]
    assert counts[1, 0, :3].tolist() == [0, 0, 4]
    assert free[:2, 0].tolist() == [0, 0] and nt[:2].tolist() == [0, 0]


def test_gang_after_rows_that_touched_every_idle_worker():
    # the ordinary first row places one task on every idle worker (one
    # 3-cpu task fits per worker), so the gang row behind it finds no
    # available member although every worker keeps free task slots
    spec = dict(free=[[4 * U]] * 4, nt_free=[4] * 4, lifetime=[INF] * 4,
                needs=[[[3 * U]], [[0]]], sizes=[4, 1], min_time=[[0], [0]])
    case = _with_gangs(_visit_classes(_pad(**spec)), [0, 2], [1, 1, 1, 1],
                       [0, 0, 1, 1])
    counts, _free, _nt = _assert_exact(case)
    assert counts[0, 0, :4].tolist() == [1, 1, 1, 1]
    assert counts[1].sum() == 0


def test_gang_picks_first_feasible_group_else_the_largest():
    spec = dict(free=[[4 * U]] * 6, nt_free=[4] * 6, lifetime=[INF] * 6,
                needs=[[[0]], [[0]]], sizes=[1, 1], min_time=[[0], [0]])
    # groups: 0 = {0}, 1 = {1, 2}, 2 = {3, 4, 5}; the 2-node gang takes
    # group 1, the 3-node gang group 2
    case = _with_gangs(_visit_classes(_pad(**spec)), [2, 3], [1] * 6,
                       [0, 1, 1, 2, 2, 2])
    counts, _free, _nt = _assert_exact(case)
    assert counts[0, 0, :6].tolist() == [0, 1, 1, 0, 0, 0]
    assert counts[1, 0, :6].tolist() == [0, 0, 0, 1, 1, 1]


def test_gang_inputs_come_together_and_groups_partition():
    case = _visit_classes(_pad(**_solver_random(0)))
    t = {k: torch.from_numpy(np.array(v, dtype=np.int32))
         for k, v in case.items()}
    args = [t[k] for k in ("free", "nt_free", "lifetime", "needs", "sizes",
                           "min_time", "class_m", "order_ids")]
    with pytest.raises(ValueError, match="come together"):
        port_assign.greedy_cut_scan(
            *args, gang_nodes=torch.zeros(PB, dtype=torch.int32)
        )
    two_groups = torch.ones((PW, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="one group per worker"):
        port_assign.greedy_cut_scan(
            *args, gang_nodes=torch.full((PB,), 2, dtype=torch.int32),
            gang_ok=torch.ones(PW, dtype=torch.int32),
            group_onehot=two_groups,
        )
    with pytest.raises(ValueError, match="policy_mask"):
        port_assign.greedy_cut_scan(
            *args, policy_mask=torch.ones((PB, PW - 1), dtype=torch.int32)
        )


def test_wrapper_checks_dtype_and_shape():
    case = _visit_classes(_pad(**_solver_random(1)))
    t = {k: torch.from_numpy(np.array(v, dtype=np.int32))
         for k, v in case.items()}
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    bad = dict(t, free=t["free"].to(torch.int64))
    with pytest.raises(TypeError, match="free"):
        port_assign.greedy_cut_scan(*(bad[k] for k in keys))
    bad = dict(t, lifetime=t["lifetime"][:-1])
    with pytest.raises(ValueError, match="lifetime"):
        port_assign.greedy_cut_scan(*(bad[k] for k in keys))


# -- the host solve: the numpy twin and the native scan ---------------------

def _host_case(kind, seed):
    """Padded kernel inputs of the solver tests' generators."""
    if kind == "solver":
        return _visit_classes(_pad(**_solver_random(seed)))
    if kind in ("hard", "hard_all"):
        return _visit_classes(_pad(**_hard_random(seed, kind == "hard_all")))
    if kind == "gang":
        kernel, gang_nodes, gang_ok, gids = _gang_random(seed)
        return _with_gangs(_visit_classes(_pad(**kernel)), gang_nodes,
                           gang_ok, gids)
    kernel, affinity = _weighted_random(seed)
    aff = _padded_affinity(affinity)
    case = _visit_classes(_pad(**kernel), affinity=aff)
    case["policy_mask"] = (aff > 0).astype(np.int32)
    return case


HOST_KINDS = ["solver", "hard", "hard_all", "gang", "mask"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", HOST_KINDS)
def test_numpy_twin_matches_jax_twin_and_kernel(kind, seed):
    """The port's numpy twin against the JAX package's numpy twin and its
    jitted kernel: counts, free and nt_free after the solve, exactly."""
    case = _host_case(kind, seed)
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    opt = {k: case.get(k) for k in OPTIONAL}
    got = port_assign.greedy_cut_scan_numpy(*(case[k] for k in keys), **opt)
    want = jax_assign.greedy_cut_scan_numpy(*(case[k] for k in keys), **opt)
    jx = _JAX_SCAN(*(case[k] for k in keys), **opt)
    for name, g, w, j in zip(("counts", "free", "nt_free"), got, want, jx):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=f"{name}: vs jax twin")
        np.testing.assert_array_equal(g, np.asarray(j),
                                      err_msg=f"{name}: vs jax kernel")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["solver", "hard", "hard_all"])
def test_native_scan_matches_jax_native_and_kernel(kind, seed):
    """The port's native host scan (no gang rows, no mask: the model keeps
    those on the numpy twin) against the JAX package's native scan and
    its kernel. Where the library cannot be built, it answers None."""
    from hyperqueue_tpu.utils import native as jax_native
    from hyperqueue_tpu_torch.utils import native as port_native

    case = _host_case(kind, seed)
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    opt = {k: case.get(k) for k in ("total", "all_mask")}
    got = port_native.native_cut_scan(*(case[k] for k in keys), **opt)
    if port_native.load_native() is None:
        assert got is None
        return
    assert got.dtype == np.int32 and got.flags.c_contiguous
    jx = np.asarray(_JAX_SCAN(*(case[k] for k in keys), **opt)[0])
    np.testing.assert_array_equal(got, jx)
    want = jax_native.native_cut_scan(*(case[k] for k in keys), **opt)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    # the mapping's nonzero pass
    flat, vals = port_native.native_nonzero(got)
    bs, vs, ws = np.nonzero(got)
    np.testing.assert_array_equal(
        flat, np.ravel_multi_index((bs, vs, ws), got.shape))
    np.testing.assert_array_equal(vals, got[bs, vs, ws])


def test_native_scan_refuses_all_mask_without_total():
    from hyperqueue_tpu_torch.utils import native as port_native

    case = _host_case("hard_all", 1)
    if port_native.load_native() is None:
        return
    keys = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
            "class_m", "order_ids")
    with pytest.raises(ValueError, match="total"):
        port_native.native_cut_scan(*(case[k] for k in keys),
                                    all_mask=case["all_mask"])


# -- the sync probe (K5) -----------------------------------------------------

# the JAX package's probe program (models/greedy.py, `_probe`)
_JAX_PROBE = jax.jit(lambda v: (v * 2).sum())


@pytest.mark.parametrize("n, kind", [(256, "arange"), (256, "random"),
                                     (1000, "random"), (1, "random"),
                                     (0, "random")])
def test_sync_probe_plain_version_matches_jax_probe(n, kind):
    """K5's plain version against the JAX probe program, on the probe's own
    input and on seeded int32 that overflow the sum (both wrap modulo
    2^32)."""
    from hyperqueue_tpu_torch.ops import probe

    if kind == "arange":
        v = np.arange(n, dtype=np.int32)
    else:
        v = np.random.default_rng(n).integers(
            -2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    got = probe.sync_probe(torch.from_numpy(v))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(np.asarray(_JAX_PROBE(v)))
    exact = 2 * int(v.astype(np.int64).sum())
    assert int(got) == (exact + 2**31) % 2**32 - 2**31
    if kind == "arange":
        assert int(got) == probe._PROBE_SUM


def test_sync_probe_checks_its_input():
    from hyperqueue_tpu_torch.ops import probe

    with pytest.raises(TypeError, match="int32"):
        probe.sync_probe(torch.arange(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-D"):
        probe.sync_probe(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        probe.sync_probe(torch.arange(16, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="CUDA"):
        probe.sync_round_trip_ms("cpu")
