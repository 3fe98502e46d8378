"""The solve backend of the port's model against the JAX package's: the
host-versus-device cost model, the sync probe's aging, the host solves, the
resident paranoid check and the solver watchdog.

The decision table is driven directly (no card needed): both models are
told an accelerator is visible (`_sticky_host` patched to None, as
tests/test_backend_select.py does for the JAX model) and fed the same
sequence of probe values, host/device measurements and retry counts; their
(backend, reason) must be equal, with the JAX package's "jax" named
"device" in the port, except where the probe failed: there the JAX model
solves on the host ("sync-probe-failed") and the port raises. Every other
comparison is exact (tolerance 0).
"""

import threading
import time

import numpy as np
import pytest
import torch

from hyperqueue_tpu.models import greedy as jax_greedy
from hyperqueue_tpu.models.greedy import GreedyCutScanModel as JaxModel
from hyperqueue_tpu.scheduler.watchdog import SolverWatchdog as JaxWatchdog
from hyperqueue_tpu_torch.models import greedy as port_greedy
from hyperqueue_tpu_torch.models.greedy import (
    GreedyCutScanModel,
    ResidentParanoidError,
)
from hyperqueue_tpu_torch.ops import build, probe
from hyperqueue_tpu_torch.scheduler import watchdog as port_watchdog
from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog
from hyperqueue_tpu_torch.utils import clock
from hyperqueue_tpu_torch.utils import native as port_native

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each
# of them starves the other workers (and their wall-clock gates)
torch.set_num_threads(1)

U = 10_000
INF = 2**31 - 1
SHAPES = [(1024, 256, 8, 2, 4, False, False, 0, False),
          (16, 8, 4, 1, 4, True, False, 0, False)]


def _kwargs(seed=0, n_w=12, n_b=5, n_r=3, n_v=2):
    rng = np.random.default_rng(seed)
    needs = rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U // 2)
    return dict(
        free=(rng.integers(1, 9, size=(n_w, n_r)) * U).astype(np.int32),
        nt_free=rng.integers(0, 10, size=n_w).astype(np.int32),
        lifetime=np.where(rng.random(n_w) < 0.2, 100, INF).astype(np.int32),
        needs=needs.astype(np.int32),
        sizes=rng.integers(0, 25, size=n_b).astype(np.int32),
        min_time=np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0)
        .astype(np.int32),
    )


def _rename(decision):
    backend, reason = decision
    return backend, reason.replace("forced-jax", "forced-device")


# -- the decision table -------------------------------------------------------

def test_constants_match_jax():
    for name in ("DISPATCH_LATENCY_BUDGET_MS", "REPROBE_INTERVAL_S",
                 "DEVICE_RETRY_SOLVES", "_EWMA_ALPHA"):
        assert getattr(port_greedy, name) == getattr(jax_greedy, name), name


@pytest.mark.parametrize("seed", range(6))
def test_decision_table_matches_jax(seed, monkeypatch):
    """A seeded walk over probe values (pending, failed, inside and outside
    the budget), host and device measurements on two shapes and retry
    counts; after every step both models decide the same for both
    shapes."""
    state = {"sync": None}
    fake = lambda wait_s=0.0, max_age_s=None: state["sync"]  # noqa: E731
    monkeypatch.setattr(jax_greedy, "device_sync_ms", fake)
    monkeypatch.setattr(port_greedy, "device_sync_ms", fake)
    jax_model = JaxModel()
    port = GreedyCutScanModel(device="cpu", backend="auto")
    monkeypatch.setattr(jax_model, "_sticky_host", lambda: None)
    monkeypatch.setattr(port, "_sticky_host", lambda: None)
    rng = np.random.default_rng(seed)
    syncs = [None, float("inf"), 0.05, 3.0, 5.0, 5.5, 63.0]
    for _step in range(120):
        op = rng.random()
        if op < 0.2:
            state["sync"] = syncs[int(rng.integers(len(syncs)))]
        elif op < 0.7:
            kind = "host" if rng.random() < 0.5 else "device"
            shape = SHAPES[int(rng.integers(2))]
            ms = float(rng.choice([0.5, 2.0, 10.0, 40.0, 200.0]))
            jax_model._observe(kind, shape, ms)
            port._observe(kind, shape, ms)
        else:
            n = int(rng.choice([0, 7, jax_greedy.DEVICE_RETRY_SOLVES - 1,
                                jax_greedy.DEVICE_RETRY_SOLVES, 4096]))
            jax_model._solves_since_device = n
            port._solves_since_device = n
        assert port._cost == jax_model._cost
        assert port._solves_since_device == jax_model._solves_since_device
        for shape in SHAPES:
            want = _rename(jax_model._backend_decision(shape))
            if state["sync"] == float("inf"):
                assert want == ("host", "sync-probe-failed")
                with pytest.raises(RuntimeError, match="probe failed"):
                    port._backend_decision(shape)
            else:
                assert port._backend_decision(shape) == want


def test_forced_and_sticky_backends(monkeypatch):
    shape = SHAPES[0]
    assert GreedyCutScanModel(device="cpu", backend="numpy") \
        ._backend_decision(shape) == ("host", "forced-numpy")
    assert GreedyCutScanModel(device="cpu", backend="device") \
        ._backend_decision(shape) == ("device", "forced-device")
    # the port's default solves on the model's device; the JAX default,
    # "auto", must be asked for
    assert GreedyCutScanModel(device="cpu").backend == "device"
    assert GreedyCutScanModel(device="cpu")._backend_decision(shape) == \
        ("device", "forced-device")
    # a CPU model on auto stays on the host, as JAX does on its CPU backend
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert GreedyCutScanModel(device="cpu", backend="auto") \
        ._backend_decision(shape) == \
        JaxModel()._backend_decision(shape) == ("host", "cpu-host")
    assert JaxModel(backend="numpy")._backend_decision(shape) == \
        ("host", "forced-numpy")
    assert _rename(JaxModel(backend="jax")._backend_decision(shape)) == \
        ("device", "forced-device")
    with pytest.raises(ValueError, match="backend"):
        GreedyCutScanModel(device="cpu", backend="jax")


def test_ewma_matches_jax():
    port = GreedyCutScanModel(device="cpu")
    jax_model = JaxModel()
    for kind, ms in [("host", 10.0), ("host", 20.0), ("device", 3.0),
                     ("host", 1.0), ("device", 9.0), ("device", 0.25)]:
        port._observe(kind, SHAPES[0], ms)
        jax_model._observe(kind, SHAPES[0], ms)
        assert port._cost == jax_model._cost
    assert 1.0 < port._cost["host"][SHAPES[0]] < 20.0


@pytest.mark.parametrize("extras", ["plain", "all", "gang", "affinity",
                                    "gang_affinity"])
def test_shape_key_matches_jax(extras):
    """The cost model's per-shape key, M bucket included, is the JAX
    model's, so the two decision tables compare one to one."""
    rng = np.random.default_rng(40)
    kw = _kwargs(41)
    n_w, n_b = kw["free"].shape[0], kw["needs"].shape[0]
    if extras == "all":
        all_mask = np.zeros(kw["needs"].shape, np.int32)
        all_mask[0, 0, 2] = 1
        kw["needs"][0, 0, 2] = 0
        kw.update(total=kw["free"].copy(), all_mask=all_mask)
    if "gang" in extras:
        gang = np.zeros(n_b, np.int32)
        gang[1] = 2
        gids = rng.integers(0, 5, size=n_w)
        kw.update(gang_nodes=gang, gang_ok=np.ones(n_w, np.int32),
                  group_onehot=(gids[:, None] == np.arange(5)[None, :])
                  .astype(np.int32))
    if "affinity" in extras:
        kw["affinity"] = rng.choice(np.array([0.0, 1.0, 2.0], np.float32),
                                    size=(n_b, n_w))
    port = GreedyCutScanModel(device="cpu").prepare(**kw)
    jax_prep = JaxModel(backend="numpy")._prepare(
        kw["free"], kw["nt_free"], kw["lifetime"], kw["needs"], kw["sizes"],
        kw["min_time"], kw.get("total"), kw.get("all_mask"),
        gang_nodes=kw.get("gang_nodes"), gang_ok=kw.get("gang_ok"),
        group_onehot=kw.get("group_onehot"), affinity=kw.get("affinity"))
    assert port["shape_key"] == jax_prep["shape_key"]


# -- the probe ----------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


@pytest.fixture
def fresh_probe():
    port_greedy._reset_probe_for_tests()
    yield
    port_greedy._reset_probe_for_tests()


def test_probe_ages_out_under_a_fake_clock(fresh_probe, monkeypatch):
    """The first call starts the probe; a resolved value is returned until
    it is older than max_age_s, then a re-probe runs in the background and
    the stale value is returned until the new one lands."""
    values = iter([0.25, 0.75])
    gate = threading.Event()

    def fake_round_trip(device="cuda", reps=3):
        gate.wait(10)
        return next(values)

    monkeypatch.setattr(probe, "sync_round_trip_ms", fake_round_trip)
    fake = _FakeClock()
    previous = clock.install(fake)
    try:
        assert port_greedy.device_sync_ms() is None  # pending
        gate.set()
        assert port_greedy.device_sync_ms(wait_s=10) == 0.25
        assert port_greedy.probe_error() is None
        # young: no re-probe
        fake.t += port_greedy.REPROBE_INTERVAL_S / 2
        assert port_greedy.device_sync_ms(
            max_age_s=port_greedy.REPROBE_INTERVAL_S) == 0.25
        assert not port_greedy._PROBE_RUNNING
        # stale: the old value comes back while the re-probe runs
        gate.clear()
        fake.t += port_greedy.REPROBE_INTERVAL_S
        assert port_greedy.device_sync_ms(
            max_age_s=port_greedy.REPROBE_INTERVAL_S) == 0.25
        assert port_greedy._PROBE_RUNNING
        gate.set()
        assert port_greedy.device_sync_ms(wait_s=10) == 0.75
        assert port_greedy._PROBE_TS == fake.t
    finally:
        clock.install(previous)


def test_failed_probe_keeps_its_exception(fresh_probe, monkeypatch):
    """The JAX probe turns a failure into inf and forgets why, and its
    model then solves on the host for ever; the port keeps the exception,
    and every solve on auto raises it instead of leaving the card."""
    def broken(device="cuda", reps=3):
        raise RuntimeError("sync-probe kernel launch failed: cudaError 98")

    monkeypatch.setattr(probe, "sync_round_trip_ms", broken)
    assert port_greedy.device_sync_ms(wait_s=10) == float("inf")
    assert "cudaError 98" in str(port_greedy.probe_error())
    model = GreedyCutScanModel(device="cpu", backend="auto")
    monkeypatch.setattr(model, "_sticky_host", lambda: None)
    with pytest.raises(RuntimeError, match="cudaError 98") as raised:
        model._backend_decision(SHAPES[0])
    assert raised.value.__cause__ is port_greedy.probe_error()
    with pytest.raises(RuntimeError, match="cudaError 98"):
        model.solve(**_kwargs(8))
    assert model.last_backend is None  # nothing solved anywhere


def test_real_probe_without_a_card_fails_loudly(fresh_probe):
    measured = port_greedy.device_sync_ms(wait_s=30)
    if torch.cuda.is_available():
        assert 0 < measured < float("inf")
        assert port_greedy.probe_error() is None
    else:
        assert measured == float("inf")
        assert "CUDA" in str(port_greedy.probe_error())


# -- solves through each backend ---------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_every_backend_solves_like_jax(seed):
    kw = _kwargs(100 + seed)
    want = JaxModel(backend="numpy").solve(**kw)
    for backend, expect in [("auto", ("host-", "cpu-host")),
                            ("numpy", ("host-", "forced-numpy")),
                            ("device", ("device-cpu", "forced-device"))]:
        model = GreedyCutScanModel(device="cpu", backend=backend)
        got = model.solve(**kw)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.flags.c_contiguous
        assert model.last_backend.startswith(expect[0])
        assert model.last_backend_reason == expect[1]
        assert set(model.last_phases) == {"pad_ms", "visit_ms",
                                          "dispatch_ms", "sync_ms"}


def test_host_rule_native_unless_gang_or_mask(monkeypatch):
    kw = _kwargs(7)
    model = GreedyCutScanModel(device="cpu", backend="numpy")
    model.solve(**kw)
    native = port_native.load_native() is not None
    assert model.last_backend == ("host-native" if native else "host-numpy")
    n_w, n_b = kw["free"].shape[0], kw["needs"].shape[0]
    aff = np.ones((n_b, n_w), np.float32)
    aff[0, 0] = 0.0
    got = model.solve(**kw, affinity=aff)
    assert model.last_backend == "host-numpy"
    np.testing.assert_array_equal(
        got, JaxModel(backend="numpy").solve(**kw, affinity=aff))
    gang = np.zeros(n_b, np.int32)
    gang[0] = 2
    model.solve(**kw, gang_nodes=gang, gang_ok=np.ones(n_w, np.int32),
                group_onehot=np.ones((n_w, 1), np.int32))
    assert model.last_backend == "host-numpy"
    # a host without the native library solves with the numpy twin
    monkeypatch.setattr(port_native, "_tried", True)
    monkeypatch.setattr(port_native, "_lib", None)
    np.testing.assert_array_equal(model.solve(**kw),
                                  JaxModel(backend="numpy").solve(**kw))
    assert model.last_backend == "host-numpy"


def test_auto_measures_both_sides_and_follows_the_cost_model(monkeypatch):
    """A model on auto that believes a device is visible: probe pending ->
    host; the probe resolves inside the budget and the host is slow ->
    device (first measurement), and each side feeds its EWMA."""
    state = {"sync": None}
    monkeypatch.setattr(port_greedy, "device_sync_ms",
                        lambda wait_s=0.0, max_age_s=None: state["sync"])
    model = GreedyCutScanModel(device="cpu", backend="auto")
    monkeypatch.setattr(model, "_sticky_host", lambda: None)
    kw = _kwargs(9)
    want = JaxModel(backend="numpy").solve(**kw)
    np.testing.assert_array_equal(model.solve(**kw), want)
    assert model.last_backend_reason == "sync-probe-pending"
    assert model.last_backend.startswith("host-")
    key = model.prepare(**kw)["shape_key"]
    assert key in model._cost["host"]
    model._cost["host"][key] = 1e9  # a host that lost
    state["sync"] = 0.01
    np.testing.assert_array_equal(model.solve(**kw), want)
    assert (model.last_backend, model.last_backend_reason) == (
        "device-cpu", "first-measurement")
    assert key in model._cost["device"]
    assert model._solves_since_device == 0
    model.solve(**kw)
    assert model.last_backend_reason == "cost-model"


def test_card_model_builds_its_kernels_at_construction(monkeypatch):
    """A card model whose kernel cannot be built raises when it is made,
    not inside its first solve (where the watchdog would hide the
    build)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []

    def fake_load(name):
        built.append(name)
        if name == "sync_probe":
            raise RuntimeError("nvcc failed on sync_probe.cu (exit 1)")
        lib = type("Lib", (), {})()
        lib._hq_prototypes = True
        return lib, {}

    monkeypatch.setattr(build, "load_library", fake_load)
    with pytest.raises(RuntimeError, match="sync_probe"):
        GreedyCutScanModel(device="cuda")
    assert built == ["cut_scan", "sync_probe"]


# -- the resident paranoid check ---------------------------------------------

def test_paranoid_check_passes_and_counts():
    model = GreedyCutScanModel(device="cpu", backend="device")
    model.paranoid_resident = 2
    kw = _kwargs(21)
    for _ in range(4):
        model.solve(**kw)
    assert model.paranoid_checks == 2
    stats = model.resident_stats()
    assert stats["paranoid_checks"] == 2
    assert stats["backend"] == "device-cpu"
    assert stats["backend_reason"] == "forced-device"


def test_corrupted_resident_state_raises():
    """Resident tensors that no longer match the host mirror make the
    resident solve diverge from a fresh one: the check must say so."""
    model = GreedyCutScanModel(device="cpu", backend="device")
    model.paranoid_resident = 1
    kw = _kwargs(22)
    # an empty solve leaves the state as it was: no row is dirty next tick
    model.solve(**dict(kw, sizes=np.zeros_like(kw["sizes"])))
    model._res.free.zero_()  # the mirror still believes the old rows
    with pytest.raises(ResidentParanoidError, match="diverge"):
        model.solve(**kw)


# -- the watchdog -------------------------------------------------------------

class _Primary:
    """A model whose solve fails, hangs or works on request."""

    def __init__(self, mode="fail"):
        self.mode = mode
        self.invalidated = 0
        self.release = threading.Event()
        self.inner = GreedyCutScanModel(device="cpu", backend="device")

    def invalidate_resident(self):
        self.invalidated += 1

    def solve(self, **kw):
        if self.mode == "fail":
            raise RuntimeError("cut-scan kernel launch failed: cudaError 700")
        if self.mode == "hang":
            self.release.wait(10)
        return self.inner.solve(**kw)


def _watchdog_pair(mode, timeout_s, rearm_ticks):
    port_primary, jax_primary = _Primary(mode), _Primary(mode)
    return (SolverWatchdog(port_primary, timeout_s=timeout_s,
                           rearm_ticks=rearm_ticks), port_primary,
            JaxWatchdog(jax_primary, timeout_s=timeout_s,
                        rearm_ticks=rearm_ticks), jax_primary)


def test_watchdog_failure_and_rearm_match_jax():
    wd, primary, jwd, jprimary = _watchdog_pair("fail", 0.0, 2)
    kw = _kwargs(30)
    want = JaxModel(backend="numpy").solve(**kw)
    assert isinstance(wd.fallback, GreedyCutScanModel)
    assert wd.fallback.device.type == "cpu"
    assert wd.fallback.backend == "numpy"
    for tick in range(4):
        if tick == 2:
            primary.mode = jprimary.mode = "ok"
        np.testing.assert_array_equal(wd.solve(**kw), want)
        np.testing.assert_array_equal(jwd.solve(**kw), want)
        assert wd.last_solve_degraded == jwd.last_solve_degraded
        assert wd.stats() == jwd.stats()
    assert set(wd.stats()) == set(jwd.stats())
    assert wd.failures == 1 and wd.degraded_ticks == 2 and wd.rearms == 1
    assert "cudaError 700" in wd.last_error
    assert primary.invalidated == jprimary.invalidated == 1
    assert wd.armed and primary.inner.last_backend == "device-cpu"


def test_watchdog_timeout_strands_and_rearms_after_drain():
    wd, primary, jwd, jprimary = _watchdog_pair("hang", 0.2, 1)
    kw = _kwargs(31)
    want = JaxModel(backend="numpy").solve(**kw)
    for w in (wd, jwd):
        np.testing.assert_array_equal(w.solve(**kw), want)
        assert w.timeouts == 1 and w.degraded_ticks == 1
        assert not w.armed  # the stranded solve still runs
        np.testing.assert_array_equal(w.solve(**kw), want)
    assert wd.stats()["bench_remaining"] == jwd.stats()["bench_remaining"]
    primary.mode = jprimary.mode = "ok"
    primary.release.set()
    jprimary.release.set()
    deadline = time.monotonic() + 10
    while (not wd.armed or not jwd.armed) and time.monotonic() < deadline:
        time.sleep(0.01)
    for w in (wd, jwd):
        np.testing.assert_array_equal(w.solve(**kw), want)
        assert w.rearms == 1 and not w.last_solve_degraded
    assert wd.stats() == jwd.stats()


def test_watchdog_skips_when_the_fallback_fails_too():
    class Broken:
        def solve(self, **kw):
            raise RuntimeError("broken")

    wd = SolverWatchdog(Broken(), timeout_s=0.0, fallback=Broken())
    kw = _kwargs(32)
    counts = wd.solve(**kw)
    assert counts.shape == (5, 2, 12) and counts.sum() == 0
    assert wd.skipped_ticks == 1 and wd.last_solve_skipped


class _CardPrimary(_Primary):
    """A primary that says it lives on the card (no card is touched)."""

    device = torch.device("cuda")


@pytest.mark.parametrize("path", ["solve", "solve_async"])
def test_watchdog_raises_card_failures_without_a_fallback(path):
    """A card primary gets no host fallback unless the caller passes one:
    a failure is counted, the resident state dropped and the error
    raised, on the synchronous and the pipelined path."""
    wd = SolverWatchdog(_CardPrimary("fail"), timeout_s=0.0, rearm_ticks=2)
    assert wd.fallback is None
    kw = _kwargs(34)
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="cudaError 700"):
            getattr(wd, path)(**kw)
        assert (wd.failures, wd.degraded_ticks, wd.skipped_ticks) == (
            attempt, 0, 0)
        assert wd.armed and not wd.last_solve_degraded
        assert wd.model.invalidated == attempt
    assert "cudaError 700" in wd.stats()["last_error"]
    wd.model.mode = "ok"
    np.testing.assert_array_equal(wd.solve(**kw),
                                  JaxModel(backend="numpy").solve(**kw))


def test_watchdog_raises_card_timeouts_without_a_fallback():
    primary = _CardPrimary("hang")
    wd = SolverWatchdog(primary, timeout_s=0.2, rearm_ticks=1)
    kw = _kwargs(35)
    with pytest.raises(port_watchdog.SolveTimeout, match="deadline"):
        wd.solve(**kw)
    assert wd.timeouts == 1 and primary.invalidated == 1
    # the stranded solve still runs in the primary: no solve may start
    with pytest.raises(port_watchdog.SolveTimeout, match="still runs"):
        wd.solve(**kw)
    assert wd.degraded_ticks == 0
    primary.mode = "ok"
    primary.release.set()
    deadline = time.monotonic() + 10
    while not wd.armed and time.monotonic() < deadline:
        time.sleep(0.01)
    np.testing.assert_array_equal(wd.solve(**kw),
                                  JaxModel(backend="numpy").solve(**kw))


def test_card_primary_degrades_to_a_fallback_it_was_given():
    fallback = GreedyCutScanModel(device="cpu", backend="numpy")
    wd = SolverWatchdog(_CardPrimary("fail"), timeout_s=0.0,
                        rearm_ticks=2, fallback=fallback)
    kw = _kwargs(36)
    np.testing.assert_array_equal(wd.solve(**kw),
                                  JaxModel(backend="numpy").solve(**kw))
    assert wd.failures == 1 and wd.degraded_ticks == 1
    assert wd.last_solve_degraded and not wd.armed


def test_resident_paranoid_error_passes_through_watchdog():
    model = GreedyCutScanModel(device="cpu", backend="device")
    model.paranoid_resident = 1
    wd = SolverWatchdog(model, timeout_s=5.0)
    kw = _kwargs(33)
    wd.solve(**dict(kw, sizes=np.zeros_like(kw["sizes"])))
    model._res.free.zero_()
    with pytest.raises(ResidentParanoidError):
        wd.solve(**kw)
    assert wd.armed and wd.failures == 0  # not benched: a debug verdict
    assert port_watchdog.DEFAULT_TIMEOUT_S == 5.0
