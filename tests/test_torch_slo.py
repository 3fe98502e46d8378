"""The port's SLO engine and health probes against the JAX package's, on
the CPU.

The cases of tests/test_slo.py run twinned: each against both packages
(`pkg` parametrizes them; each package has its own process-wide metrics
registry, which its SLO engine exports into). The readiness case drops
the lease half in the port: leases come with the federation plane
(ROADMAP Queue 1 item 10), so a port server's readiness has no lease
check. Then both engines judge the same observations and must agree on
every transition.
"""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

from hyperqueue_tpu.server import bootstrap as jax_bootstrap
from hyperqueue_tpu.utils import metrics as jax_metrics
from hyperqueue_tpu.utils import slo as jax_slo
from hyperqueue_tpu_torch.server import bootstrap as port_bootstrap
from hyperqueue_tpu_torch.utils import metrics as port_metrics
from hyperqueue_tpu_torch.utils import slo as port_slo

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.metrics

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", metrics=jax_metrics, slo=jax_slo,
        server=lambda **kw: jax_bootstrap.Server(**kw)),
    "port": types.SimpleNamespace(
        name="port", metrics=port_metrics, slo=port_slo,
        server=lambda **kw: port_bootstrap.Server(device="cpu", **kw)),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


def _page(pkg):
    return (pkg.slo.BurnRule("page", 14.4, 3600.0, 300.0),)


def _latency_engine(pkg, reg):
    spec = pkg.slo.SloSpec(
        name="tick", description="95% of ticks under 250 ms",
        metric="hq_test_tick_seconds", objective=0.95, threshold=0.25,
    )
    return pkg.slo.SloEngine(registry=reg, specs=(spec,), rules=_page(pkg),
                             scale=1.0)


# ------------------------------------------------------------- burn math
def test_latency_slo_fires_and_resolves(pkg):
    reg = pkg.metrics.MetricsRegistry()
    h = reg.histogram("hq_test_tick_seconds", "d", buckets=(0.25, 1.0))
    eng = _latency_engine(pkg, reg)

    for _ in range(10):
        h.observe(1.0)                      # all bad (over threshold)
    assert eng.evaluate(now=0.0) == []      # one sample: no delta yet
    for _ in range(10):
        h.observe(1.0)
    fired = eng.evaluate(now=10.0)
    assert len(fired) == 1
    alert = fired[0]
    assert alert["alert"] == "tick:page" and alert["state"] == "firing"
    # 100% bad / 5% budget = 20x burn on both windows
    assert alert["burn_rate"] == pytest.approx(20.0)
    assert alert["burn_short"] == pytest.approx(20.0)
    # steady state: no new transition while it keeps firing
    for _ in range(10):
        h.observe(1.0)
    assert eng.evaluate(now=20.0) == []
    assert eng.badge() == {"firing": 1, "worst": "page"}
    assert [a["alert"] for a in eng.paging_alerts()] == ["tick:page"]

    # exported judgement rides the module gauges (global registry)
    REGISTRY = pkg.metrics.REGISTRY
    burn = REGISTRY.get("hq_slo_burn_rate")
    assert burn.labels("tick", "1h").value == pytest.approx(20.0)
    assert REGISTRY.get("hq_slo_alerts_firing").labels("page").value == 1.0

    # recovery: the SHORT window clears first and resolves the alert
    # (now=400 puts the short-window baseline past the bad era)
    for _ in range(50):
        h.observe(0.1)                      # good
    resolved = eng.evaluate(now=400.0)
    assert len(resolved) == 1
    assert resolved[0]["state"] == "resolved"
    assert resolved[0]["fired_for"] == pytest.approx(390.0)
    assert eng.badge() == {"firing": 0, "worst": None}
    assert REGISTRY.get("hq_slo_alerts_firing").labels("page").value == 0.0
    # both transitions retained for `hq alerts` history
    assert [t["state"] for t in eng.alerts()["recent"]] == [
        "firing", "resolved"
    ]


def test_availability_slo_scores_gauge_fleet(pkg):
    reg = pkg.metrics.MetricsRegistry()
    g = reg.gauge("hq_test_shard_up", "d", labels=("shard",))
    spec = pkg.slo.SloSpec(
        name="avail", description="99.9% shards up",
        metric="hq_test_shard_up", kind="availability", objective=0.999,
    )
    eng = pkg.slo.SloEngine(registry=reg, specs=(spec,), rules=_page(pkg),
                            scale=1.0)

    g.labels("0").set(1.0)
    g.labels("1").set(0.0)                  # one dead shard
    assert eng.evaluate(now=0.0) == []
    fired = eng.evaluate(now=10.0)
    assert len(fired) == 1 and fired[0]["slo"] == "avail"
    # half the fleet down vs a 0.1% budget: an enormous burn
    assert fired[0]["burn_rate"] > 100

    g.labels("1").set(1.0)                  # shard recovered
    resolved = eng.evaluate(now=400.0)
    assert len(resolved) == 1 and resolved[0]["state"] == "resolved"


def test_no_traffic_means_no_burn(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.histogram("hq_test_tick_seconds", "d", buckets=(0.25, 1.0))
    eng = _latency_engine(pkg, reg)
    # metric registered but never observed: evaluate must no-op cleanly
    assert eng.evaluate(now=0.0) == []
    assert eng.evaluate(now=10.0) == []
    assert eng.alerts()["firing"] == []


def test_reset_clears_windows_and_alerts(pkg):
    reg = pkg.metrics.MetricsRegistry()
    h = reg.histogram("hq_test_tick_seconds", "d", buckets=(0.25, 1.0))
    eng = _latency_engine(pkg, reg)
    for _ in range(10):
        h.observe(1.0)
    eng.evaluate(now=0.0)
    for _ in range(10):
        h.observe(1.0)
    assert eng.evaluate(now=10.0)           # fired
    eng.reset()
    assert eng.alerts()["firing"] == []
    assert eng.alerts()["recent"] == []
    assert pkg.metrics.REGISTRY.get("hq_slo_alerts_firing").labels(
        "page").value == 0.0
    # windows restart clean: the old bad era is gone, not inherited
    assert eng.evaluate(now=20.0) == []


def test_alert_name_catalog_is_cross_product(pkg):
    names = pkg.slo.alert_names()
    assert len(names) == len(pkg.slo.DEFAULT_SPECS) * len(
        pkg.slo.DEFAULT_RULES)
    assert "tick-latency:page" in names
    assert "shard-availability:ticket" in names
    assert names == jax_slo.alert_names()


def test_window_scale_env(pkg, monkeypatch):
    monkeypatch.delenv("HQ_SLO_WINDOW_SCALE", raising=False)
    assert pkg.slo.window_scale() == 1.0
    monkeypatch.setenv("HQ_SLO_WINDOW_SCALE", "0.01")
    assert pkg.slo.window_scale() == pytest.approx(0.01)
    eng = pkg.slo.SloEngine(registry=pkg.metrics.MetricsRegistry())
    assert eng.scale == pytest.approx(0.01)
    monkeypatch.setenv("HQ_SLO_WINDOW_SCALE", "bogus")
    assert pkg.slo.window_scale() == 1.0


# ----------------------------------------------------------- HTTP probes
def test_probe_paths_answer_200_and_503(pkg):
    state = {"ok": True}

    def readyz():
        return state["ok"], {"checks": {"x": "ok" if state["ok"] else "bad"}}

    def broken():
        raise RuntimeError("boom")

    async def main():
        server, port = await pkg.metrics.start_exposition_server(
            lambda: "x 1\n", 0, host="127.0.0.1",
            probes={"/readyz": readyz,
                    "/healthz": lambda: (True, {"role": "test"}),
                    "/broken": broken},
        )
        loop = asyncio.get_running_loop()

        def ask(path):
            return loop.run_in_executor(None, pkg.metrics.probe,
                                        "127.0.0.1", port, path)

        try:
            status, payload = await ask("/readyz")
            assert status == 200 and payload["ok"] is True
            state["ok"] = False
            status, payload = await ask("/readyz")
            assert status == 503
            assert payload == {"checks": {"x": "bad"}, "ok": False}
            status, payload = await ask("/healthz")
            assert status == 200 and payload["role"] == "test"
            # a probe that raises IS unready — never a 500 or a hang
            status, payload = await ask("/broken")
            assert status == 503 and payload["error"] == "probe raised"
        finally:
            server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 30.0))


# ------------------------------------------- server readiness (acceptance)
class _FakeThread:
    def __init__(self, alive):
        self._alive = alive

    def is_alive(self):
        return self._alive


class _FakeJPlane:
    def __init__(self, alive=True):
        self._thread = _FakeThread(alive)


class _FakeLease:
    def __init__(self, age):
        self._age = age

    def age_seconds(self):
        return self._age


def test_server_readyz_flips_on_journal_death_and_lease_loss(tmp_path, pkg):
    server = pkg.server(server_dir=tmp_path / "srv", reattach_timeout=60.0)
    ok, detail = server._probe_readyz()
    assert ok, detail                       # fresh server: ready
    assert set(detail["checks"]) == {"solver", "slo"}

    # journal-plane thread death flips readiness (and liveness)
    server.jplane = _FakeJPlane(alive=False)
    ok, detail = server._probe_readyz()
    assert not ok and detail["checks"]["journal_plane"] == "dead"
    hok, hdetail = server._probe_healthz()
    assert not hok and hdetail["reason"] == "journal plane dead"
    server.jplane = _FakeJPlane(alive=True)
    ok, _ = server._probe_readyz()
    assert ok
    hok, hdetail = server._probe_healthz()
    assert hok and "uptime" in hdetail

    if pkg.name == "jax":
        # lease loss: an expired (or fenced) lease means a successor may
        # own the shard — this process must fail readiness immediately
        server.lease_timeout = 15.0
        server.lease = _FakeLease(age=3.0)
        ok, detail = server._probe_readyz()
        assert ok and detail["checks"]["lease"] == "ok"
        server.lease = _FakeLease(age=99.0)
        ok, detail = server._probe_readyz()
        assert not ok and detail["checks"]["lease"] == "stale"
        server.lease = _FakeLease(age=3.0)
        server.fenced = True
        ok, detail = server._probe_readyz()
        assert not ok and detail["checks"]["lease"] == "fenced"
        server.fenced = False
        server.lease = None
    else:
        # the port holds no lease (item 10): readiness never asks
        assert not hasattr(server, "lease")
        assert "lease" not in server._probe_readyz()[1]["checks"]

    # a firing page alert marks the server not-ready for NEW work
    server.slo._firing[("tick-latency", "page")] = {
        "alert": "tick-latency:page", "severity": "page",
    }
    ok, detail = server._probe_readyz()
    assert not ok and "tick-latency:page" in detail["checks"]["slo"]
    server.slo._firing.clear()
    ok, _ = server._probe_readyz()
    assert ok


# ----------------------------------------------------- across the packages
@pytest.mark.parametrize("seed", range(4))
def test_engines_agree_on_the_same_observations(seed):
    """Both engines, each over its own registry, fed the same seeded
    latency and availability observations at the same instants, emit the
    same transitions (burn rates to the float) and the same badges."""
    import random

    rng = random.Random(seed)
    engines = []
    for pkg in PKGS.values():
        reg = pkg.metrics.MetricsRegistry()
        h = reg.histogram("hq_test_tick_seconds", "d", buckets=(0.25, 1.0))
        g = reg.gauge("hq_test_shard_up", "d", labels=("shard",))
        specs = (
            pkg.slo.SloSpec(name="tick", description="d",
                            metric="hq_test_tick_seconds", objective=0.95,
                            threshold=0.25),
            pkg.slo.SloSpec(name="avail", description="d",
                            metric="hq_test_shard_up", kind="availability",
                            objective=0.99),
        )
        rules = (pkg.slo.BurnRule("page", 14.4, 3600.0, 300.0),
                 pkg.slo.BurnRule("ticket", 3.0, 21600.0, 1800.0))
        engines.append((pkg.slo.SloEngine(registry=reg, specs=specs,
                                          rules=rules, scale=1.0), h, g))
    for step in range(40):
        bad_share = rng.choice((0.0, 0.02, 0.5, 1.0))
        n = rng.randint(0, 30)
        values = [1.0 if rng.random() < bad_share else 0.1
                  for _ in range(n)]
        up = [rng.random() > 0.1 for _ in range(4)]
        outs = []
        for eng, h, g in engines:
            for v in values:
                h.observe(v)
            for shard, alive in enumerate(up):
                g.labels(str(shard)).set(1.0 if alive else 0.0)
            outs.append((eng.evaluate(now=step * 60.0), eng.badge()))
        assert outs[0] == outs[1], step
    assert engines[0][0].alerts() == engines[1][0].alerts()
