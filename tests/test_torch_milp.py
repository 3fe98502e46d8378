"""The port's MILP model (`--scheduler milp`) and the joint min-utilization
path against the JAX package's, from identical inputs (exact): the MILP's
counts, the assembled solve inputs it reads (`priorities`, `weights`,
`cpu_floor`), run_tick's joint path, and the watchdog's degraded tick with
the floored rows zeroed and its benched carve-out ticks."""

import time

import numpy as np
import pytest
import torch

from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.models.milp import MilpModel as JaxMilp
from hyperqueue_tpu.scheduler import tick as jax_tick
from hyperqueue_tpu.scheduler.watchdog import SolverWatchdog as JaxWatchdog
from hyperqueue_tpu_torch.convert import core_from_plain
from hyperqueue_tpu_torch.models import MilpModel
from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
from hyperqueue_tpu_torch.scheduler import tick as port_tick
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.utils.constants import INF_TIME
from test_torch_mu import (
    _apply,
    _dense,
    _release,
    check_floors,
    export_plain,
    jax_floor,
    mu_state,
    port_state,
    refresh_floors,
    run_both,
)

# one intra-op thread per process (see tests/test_torch_imports.py)
torch.set_num_threads(1)

U = 10_000


def makespan_instance(seed, weighted=False, floored=False):
    """tests/test_makespan.py's greedy-vs-MILP instance (6 workers, 3
    resources, 8 batches of 2 variants at 3 priority levels), optionally
    with request weights and cpu floors on two workers."""
    rng = np.random.default_rng(seed)
    n_w, n_r, n_b, n_v = 6, 3, 8, 2
    free = rng.integers(1, 12, size=(n_w, n_r)) * U
    needs = np.where(rng.random((n_b, n_v, n_r)) < 0.5,
                     rng.integers(1, 5, size=(n_b, n_v, n_r)) * U,
                     0).astype(np.int64)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    kwargs = dict(
        free=free, nt_free=np.full(n_w, 16, dtype=np.int32),
        lifetime=np.full(n_w, int(INF_TIME), dtype=np.int32), needs=needs,
        sizes=rng.integers(1, 10, size=n_b).astype(np.int32),
        min_time=np.zeros((n_b, n_v), dtype=np.int32),
        priorities=sorted((int(p) for p in rng.integers(0, 3, size=n_b)),
                          reverse=True),
    )
    if weighted:
        kwargs["weights"] = rng.choice([1.0, 0.5, 3.0], size=(n_b, n_v))
    if floored:
        floor = np.zeros(n_w, dtype=np.int64)
        floor[:2] = free[:2, 0] // 2 + U
        kwargs["cpu_floor"] = floor
    return kwargs


@pytest.mark.parametrize("variant", ["plain", "weighted", "floored"])
@pytest.mark.parametrize("seed", range(5))
def test_milp_counts_match_jax(seed, variant):
    kwargs = makespan_instance(seed, weighted=variant == "weighted",
                               floored=variant == "floored")
    want = JaxMilp().solve(**kwargs)
    got = MilpModel().solve(**kwargs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    used = np.einsum("bvw,bvr->wr", got.astype(np.int64), kwargs["needs"])
    assert (used <= kwargs["free"]).all()
    if variant == "floored":
        cpu = used[:, 0]
        floor = kwargs["cpu_floor"]
        assert ((cpu == 0) | (cpu >= floor)).all()


def test_milp_is_a_host_model():
    model = MilpModel()
    assert model.supports_cpu_floor
    assert getattr(model, "device", None) is None
    wd = SolverWatchdog(model)
    assert wd.supports_cpu_floor
    assert (wd.fallback.device.type, wd.fallback.backend) == ("cpu", "numpy")


def _assert_same_kwargs(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key == "priorities":
            assert got[key] == value
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key


@pytest.mark.parametrize("form", ["rows", "dense"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_assembled_inputs_match_jax(form, weighted):
    """assemble_solve_inputs of both packages, key for key and value for
    value, `priorities` and `weights` included, on worker rows and on a
    dense snapshot (the port's tick cache over a Core, the JAX package's
    DenseSnapshot), twice through a key cache (the layout memo)."""
    state, mus = mu_state(7, n_floored=0, weighted=weighted)
    resource_map, rq_map, queues, rows = state
    plain = export_plain(*state)
    p_resource_map, p_rq_map, p_queues, p_rows = port_state(state, mus)
    has_weights = []
    for _ in range(2):
        j_batches = jax_tick.create_batches(queues)
        p_batches = port_tick.create_batches(p_queues)
        if form == "rows":
            want = jax_tick.assemble_solve_inputs(rows, j_batches, rq_map,
                                                  resource_map)
            got = port_tick.assemble_solve_inputs(p_rows, p_batches,
                                                  p_rq_map, p_resource_map)
        else:
            from hyperqueue_tpu.scheduler.tick_cache import (
                DenseSnapshot,
                TickStateCache,
            )

            core = core_from_plain(*plain)
            snap = core.tick_cache.sync(core)
            dense = _dense(rows, len(resource_map))
            for key in ("free", "total", "nt_free"):
                np.testing.assert_array_equal(getattr(snap, key),
                                              getattr(dense, key))
            # a Core's finite lifetimes count down from its creation: the
            # JAX snapshot takes the port's
            want = jax_tick.assemble_solve_inputs(
                None, j_batches, rq_map, resource_map,
                dense=DenseSnapshot(
                    worker_ids=list(snap.worker_ids), free=dense.free,
                    total=dense.total, nt_free=dense.nt_free,
                    lifetime=np.array(snap.lifetime)),
                key_cache=TickStateCache())
            got = port_tick.assemble_solve_inputs(
                None, p_batches, core.rq_map, core.resource_map,
                dense=snap, key_cache=core.tick_cache)
        _assert_same_kwargs(got, want)
        has_weights.append("weights" in got)
    assert has_weights == [weighted] * 2
    assert len(set(got["priorities"])) > 1


@pytest.mark.parametrize("seed", range(4))
def test_joint_path_matches_jax(seed):
    """run_tick with floored workers under MilpModel: the joint program
    (no carve-out) in both packages, every floor met or not touched."""
    state, mus = mu_state(seed, n_workers=6, n_floored=2,
                          weighted=seed % 2 == 1)
    ticks = run_both(state, mus, 2, MilpModel(), jax_model=JaxMilp())
    assert any(ticks)


def test_joint_path_beats_the_carve_out_on_the_pinned_case():
    """tests/test_makespan.py's deviation case through the joint path: all
    six tasks placed, four of them meeting the floored worker's floor."""
    from hyperqueue_tpu.resources.map import ResourceIdMap, ResourceRqMap
    from hyperqueue_tpu.resources.request import (
        ResourceRequest,
        ResourceRequestEntry,
        ResourceRequestVariants,
    )
    from hyperqueue_tpu.scheduler.queues import TaskQueues

    resource_map = ResourceIdMap()
    for name in ("cpus", "gpus", "mem"):
        resource_map.get_or_create(name)
    rq_map = ResourceRqMap()
    rq = rq_map.get_or_create(ResourceRequestVariants.single(
        ResourceRequest(entries=(ResourceRequestEntry(0, U),))))
    queues = TaskQueues()
    for t in range(1, 7):
        queues.add(rq, (0, 0), t)
    rows = [jax_tick.WorkerRow(worker_id=1, free=[4 * U, 0, 0], nt_free=64,
                               lifetime_secs=int(INF_TIME),
                               total=[4 * U, 0, 0]),
            jax_tick.WorkerRow(worker_id=2, free=[4 * U, 0, 0], nt_free=64,
                               lifetime_secs=int(INF_TIME),
                               total=[4 * U, 0, 0],
                               cpu_floor=jax_floor([4 * U, 0, 0],
                                                   [4 * U, 0, 0], 1.0))]
    joint, = run_both((resource_map, rq_map, queues, rows),
                      {1: 0.0, 2: 1.0}, 1, MilpModel(), jax_model=JaxMilp())
    assert len(joint) == 6
    assert sum(1 for _t, w, _rq, _v in joint if w == 2) == 4


class _Primary:
    """A MILP that fails (or stalls past the deadline) on chosen solves."""

    supports_cpu_floor = True

    def __init__(self, milp, fail_on=(), stall_on=(), stall_s=0.0):
        self.milp = milp
        self.fail_on, self.stall_on, self.stall_s = fail_on, stall_on, stall_s
        self.calls = 0

    def solve(self, **kwargs):
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError("injected solver failure")
        if self.calls in self.stall_on:
            time.sleep(self.stall_s)
        return self.milp.solve(**kwargs)


class _Recorder:
    """The fallback, keeping every solve's inputs."""

    def __init__(self, model):
        self.model = model
        self.inputs = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def solve(self, **kwargs):
        self.inputs.append(kwargs)
        return self.model.solve(**kwargs)


@pytest.mark.parametrize("fault", ["failure", "timeout"])
def test_watchdog_degrades_with_floored_rows_zeroed(fault):
    """An armed tick takes the joint path; a failed or timed-out MILP
    degrades its tick to the greedy fallback with the floored workers'
    free and nt_free zeroed (they receive nothing); while benched the
    watchdog does not claim supports_cpu_floor, so the next ticks take the
    carve-out. Both packages, the same assignments and counters."""
    state, mus = mu_state(5, n_workers=8, n_floored=3)
    resource_map, rq_map, queues, rows = state
    p_resource_map, p_rq_map, p_queues, p_rows = port_state(state, mus)
    totals = [list(r.total) for r in rows]
    nt0 = [r.nt_free for r in rows]
    kw = ({"fail_on": (2,)} if fault == "failure"
          else {"stall_on": (2,), "stall_s": 0.5})
    j_fb = _Recorder(JaxModel(backend="numpy"))
    p_fb = _Recorder(GreedyCutScanModel(device="cpu", backend="device"))
    jwd = JaxWatchdog(_Primary(JaxMilp(), **kw), rearm_ticks=2,
                      fallback=j_fb)
    pwd = SolverWatchdog(_Primary(MilpModel(), **kw), rearm_ticks=2,
                         fallback=p_fb)
    for t in range(4):
        # a deadline that only the stalled solve overruns
        jwd.timeout_s = pwd.timeout_s = 0.2 if t == 1 else 60.0
        if t == 3:
            # the stalled solve drains before the re-arm is read
            deadline = time.monotonic() + 30
            while jwd._abandoned_busy() or pwd._abandoned_busy():
                assert time.monotonic() < deadline
                time.sleep(0.01)
        refresh_floors(rows, p_rows, mus)
        assert pwd.supports_cpu_floor == jwd.supports_cpu_floor == (t != 2)
        floored = {r.worker_id for r in p_rows if r.cpu_floor > 0}
        j_dec, p_dec = {}, {}
        want = jax_tick.run_tick(queues, rows, rq_map, resource_map, jwd,
                                 decision=j_dec)
        got = port_tick.run_tick(p_queues, p_rows, p_rq_map, p_resource_map,
                                 pwd, decision=p_dec)
        assert got == want, f"tick {t}"
        assert p_dec["solver"]["status"] == j_dec["solver"]["status"]
        check_floors(got, p_rows, p_rq_map)
        if t == 1:
            assert p_dec["solver"]["status"] == "fallback"
            assert floored
            assert not {w for _t, w, *_ in got} & floored
            inputs = p_fb.inputs[-1]
            assert "cpu_floor" not in inputs
            ids = [r.worker_id for r in p_rows]
            zeroed = [i for i, w in enumerate(ids) if w in floored]
            assert not inputs["free"][zeroed].any()
            assert not inputs["nt_free"][zeroed].any()
        _apply(want, rows, rq_map)
        _apply(got, p_rows, p_rq_map)
        _release(rows, totals, nt0, t)
        _release(p_rows, totals, nt0, t)
    p_stats, j_stats = pwd.stats(), jwd.stats()
    for key in ("failures", "timeouts", "degraded_ticks", "rearms",
                "skipped_ticks"):
        assert p_stats[key] == j_stats[key], key
    assert p_stats["degraded_ticks"] == 2
    assert len(p_fb.inputs) == 2
