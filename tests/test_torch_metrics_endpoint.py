"""The port's metrics registry, exposition endpoint and scrape helpers
against the JAX package's, on the CPU.

The unit cases of tests/test_metrics.py run twinned: each against both
packages (`pkg` parametrizes them). Then the cross-package cases: the
exposition text byte-equal for the same registry (seeded instruments and
observations), relabel and merge equal, both parsers agreeing on each
other's text, and a started port server (`metrics_port=0`, real clock)
serving /metrics, /healthz and /readyz with the scheduler's and the
loop-lag families after a worker ran an array, every family of it one
the JAX package registers too (so the docs catalog covers it).
"""

from __future__ import annotations

import asyncio
import random
import types
from pathlib import Path

import pytest
import torch

import test_metrics as jax_metrics_tests
import test_torch_server_start as server_start
from hyperqueue_tpu.utils import metrics as jax_metrics
from hyperqueue_tpu.utils import trace as jax_trace
from hyperqueue_tpu_torch.utils import metrics as port_metrics
from hyperqueue_tpu_torch.utils import trace as port_trace

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.metrics

PKGS = {
    "jax": types.SimpleNamespace(name="jax", metrics=jax_metrics,
                                 trace=jax_trace),
    "port": types.SimpleNamespace(name="port", metrics=port_metrics,
                                  trace=port_trace),
}

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------- registry
def test_counter_and_gauge_semantics(pkg):
    r = pkg.metrics.MetricsRegistry()
    c = r.counter("hq_c_total", "c", labels=("op",))
    c.labels(op="a").inc()
    c.labels(op="a").inc(2)
    c.labels("b").inc()
    assert c.labels("a").value == 3
    assert c.labels("b").value == 1
    g = r.gauge("hq_g", "g")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.labels().value == 3
    # get-or-create returns the same instrument; type conflicts are loud
    assert r.counter("hq_c_total") is c
    with pytest.raises(ValueError):
        r.gauge("hq_c_total")


def test_histogram_bucket_edges_are_inclusive(pkg):
    r = pkg.metrics.MetricsRegistry()
    h = r.histogram("hq_h_seconds", "h", buckets=(0.01, 0.1, 1.0))
    # exactly-on-edge values land IN that bucket (le is <=)
    for v in (0.01, 0.1, 1.0, 5.0, 0.005):
        h.observe(v)
    text = r.render()
    parsed = pkg.metrics.parse_exposition(text)
    samples = parsed["hq_h_seconds"]["samples"]

    def bucket(le):
        return samples[
            ("hq_h_seconds_bucket", frozenset({("le", le)}))
        ]

    assert bucket("0.01") == 2        # 0.005 and 0.01
    assert bucket("0.1") == 3
    assert bucket("1") == 4
    assert bucket("+Inf") == 5
    assert samples[("hq_h_seconds_count", frozenset())] == 5
    assert abs(samples[("hq_h_seconds_sum", frozenset())] - 6.115) < 1e-9


def test_label_cardinality_cap(pkg):
    r = pkg.metrics.MetricsRegistry()
    g = r.gauge("hq_capped", "g", labels=("k",), max_series=4)
    for i in range(10):
        g.labels(i).set(i)
    assert len(g.series) == 4
    assert r.dropped_series == 6
    # dropped series silently no-op instead of raising on the hot path
    # (every capped .labels() call counts as one more drop)
    g.labels(99).inc()
    text = r.render()
    assert 'hq_capped{k="99"}' not in text
    assert "hq_metrics_dropped_series_total 7" in text


def test_exposition_golden(pkg):
    r = pkg.metrics.MetricsRegistry()
    c = r.counter("hq_ops_total", "operations handled", labels=("op",))
    c.labels("submit").inc(3)
    g = r.gauge("hq_depth", "queue depth")
    g.set(2.5)
    h = r.histogram("hq_lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    assert r.render() == (
        "# HELP hq_depth queue depth\n"
        "# TYPE hq_depth gauge\n"
        "hq_depth 2.5\n"
        "# HELP hq_lat_seconds latency\n"
        "# TYPE hq_lat_seconds histogram\n"
        'hq_lat_seconds_bucket{le="0.1"} 1\n'
        'hq_lat_seconds_bucket{le="1"} 2\n'
        'hq_lat_seconds_bucket{le="+Inf"} 2\n'
        "hq_lat_seconds_sum 0.55\n"
        "hq_lat_seconds_count 2\n"
        "# HELP hq_ops_total operations handled\n"
        "# TYPE hq_ops_total counter\n"
        'hq_ops_total{op="submit"} 3\n'
    )


def test_label_value_escaping_roundtrips(pkg):
    r = pkg.metrics.MetricsRegistry()
    g = r.gauge("hq_esc", "g", labels=("path",))
    # the second value is the chained-replace killer: a LITERAL backslash
    # followed by 'n' must not round-trip into a newline
    for nasty in ('a"b\\c\nd', "C:\\new\\path"):
        g.labels(nasty).set(1)
    parsed = pkg.metrics.parse_exposition(r.render())
    values = {dict(labels)["path"] for _, labels in
              parsed["hq_esc"]["samples"]}
    assert values == {'a"b\\c\nd', "C:\\new\\path"}


def test_reset_keeps_registrations_and_zeroes_values(pkg):
    r = pkg.metrics.MetricsRegistry()
    c = r.counter("hq_r_total", "c")
    h = r.histogram("hq_r_seconds", "h")
    c.inc(5)
    h.observe(0.2)
    r.reset()
    assert c.labels().value == 0
    assert h.labels().count == 0 and h.labels().sum == 0.0
    # the instrument handle stays live after reset
    c.inc()
    assert c.labels().value == 1


def test_collect_hooks_run_at_render_and_bad_hooks_are_contained(pkg):
    r = pkg.metrics.MetricsRegistry()
    g = r.gauge("hq_live", "g")
    state = {"v": 7}
    r.add_collect_hook(lambda: g.set(state["v"]))

    def bad():
        raise RuntimeError("boom")

    r.add_collect_hook(bad)
    assert "hq_live 7" in r.render()
    state["v"] = 9
    assert "hq_live 9" in r.render()


def test_export_samples_filters_scalars(pkg):
    r = pkg.metrics.MetricsRegistry()
    r.gauge("hq_worker_cpu_percent", "cpu").set(12.5)
    r.counter("hq_worker_done_total", "done").inc(3)
    r.histogram("hq_worker_lat_seconds", "lat").observe(0.1)
    r.gauge("hq_other", "other").set(1)
    samples = r.export_samples(prefix="hq_worker_")
    names = {s["name"] for s in samples}
    assert names == {"hq_worker_cpu_percent", "hq_worker_done_total"}
    by_name = {s["name"]: s for s in samples}
    assert by_name["hq_worker_cpu_percent"]["value"] == 12.5
    assert by_name["hq_worker_done_total"]["type"] == "counter"


def test_histogram_summary_percentiles(pkg):
    r = pkg.metrics.MetricsRegistry()
    h = r.histogram("hq_p_seconds", "p", buckets=(0.01, 0.1, 1.0))
    for _ in range(90):
        h.observe(0.05)
    for _ in range(10):
        h.observe(0.5)
    summary = pkg.metrics.histogram_summary(
        pkg.metrics.parse_exposition(r.render()), "hq_p_seconds")
    row = summary["_"]
    assert row["count"] == 100
    assert row["p50_le"] == 0.1
    assert row["p95_le"] == 1.0


def test_default_buckets_are_sorted(pkg):
    assert list(pkg.metrics.DEFAULT_BUCKETS) == sorted(
        pkg.metrics.DEFAULT_BUCKETS)
    assert pkg.metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS


def test_span_tracer_feeds_registry_histogram(pkg):
    tracer = pkg.trace.Tracer()
    tracer.record("unit/span", 0.002)
    h = pkg.metrics.REGISTRY.get("hq_span_seconds")
    assert h is not None
    assert h.labels("unit/span").count >= 1
    # debug-dump snapshot shape is unchanged by the fold-in
    snap = tracer.snapshot()
    assert set(snap["unit/span"]) == {
        "count", "total_ms", "mean_ms", "max_ms", "last_ms"
    }


def test_lag_tracker_feeds_the_loop_lag_histogram(pkg):
    lag = pkg.trace.LagTracker()
    for plane, dt in (("rpc", 0.001), ("rpc", 0.003), ("fanout", 0.2)):
        lag.observe(plane, dt)
    snap = lag.snapshot()
    assert snap["rpc"]["count"] == 2 and snap["rpc"]["max_ms"] == 3.0
    assert snap["fanout"]["total_ms"] == 200.0
    h = pkg.metrics.REGISTRY.get("hq_reactor_lag_seconds")
    assert h.labels("fanout").count >= 1
    lag.reset()
    assert lag.snapshot() == {}
    assert pkg.trace.LAG_PLANES == jax_trace.LAG_PLANES


# ----------------------------------------------------- across the packages
def _seeded_registry(pkg, seed: int):
    rng = random.Random(seed)
    r = pkg.metrics.MetricsRegistry()
    c = r.counter("hq_ops_total", "operations handled", labels=("op",))
    g = r.gauge("hq_depth", "queue depth", labels=("queue", "shard"))
    h = r.histogram("hq_lat_seconds", "latency")
    h2 = r.histogram("hq_age_seconds", "ages", labels=("plane",),
                     buckets=(0.005, 0.1, 1.0, 60.0))
    for _ in range(200):
        kind = rng.randrange(4)
        if kind == 0:
            c.labels(rng.choice(("submit", "wait", 'q"x\\'))).inc(
                rng.randint(1, 5))
        elif kind == 1:
            g.labels(rng.choice(("a", "b")), rng.randint(0, 3)).set(
                rng.uniform(-1e6, 1e6))
        elif kind == 2:
            h.observe(rng.expovariate(20.0))
        else:
            h2.labels(rng.choice(("rpc", "solve"))).observe(
                rng.uniform(0, 100))
    return r


@pytest.mark.parametrize("seed", range(5))
def test_exposition_byte_equal_for_the_same_registry(seed):
    texts = {n: _seeded_registry(p, seed).render() for n, p in PKGS.items()}
    assert texts["port"] == texts["jax"]
    # each parser reads the other's text to the same samples
    assert port_metrics.parse_exposition(texts["jax"]) == \
        jax_metrics.parse_exposition(texts["port"])
    parsed = port_metrics.parse_exposition(texts["port"])
    assert port_metrics.histogram_summary(parsed, "hq_age_seconds") == \
        jax_metrics.histogram_summary(parsed, "hq_age_seconds")
    # the fleet proxy's relabel and merge, text for text
    shards = {"0": texts["port"], "1": _seeded_registry(
        PKGS["jax"], seed + 100).render()}
    assert port_metrics.relabel_exposition(texts["port"], "shard", "0") \
        == jax_metrics.relabel_exposition(texts["port"], "shard", "0")
    assert port_metrics.merge_expositions(shards) == \
        jax_metrics.merge_expositions(shards)
    snaps = [_seeded_registry(p, seed).snapshot() for p in PKGS.values()]
    assert snaps[0] == snaps[1]


def test_port_metric_families_are_the_jax_packages(monkeypatch, tmp_path):
    """Every hq_* family the port registers is one the JAX package
    registers (tests/test_metrics.py's static scan over each source tree),
    so the docs/observability.md catalog documents the port's too."""
    jax_names = jax_metrics_tests.registered_metric_names()
    (tmp_path / "hyperqueue_tpu").symlink_to(
        REPO_ROOT / "hyperqueue_tpu_torch")
    monkeypatch.setattr(jax_metrics_tests, "REPO_ROOT", tmp_path)
    port_names = jax_metrics_tests.registered_metric_names()
    assert "hq_reactor_lag_seconds" in port_names
    assert port_names <= jax_names, sorted(port_names - jax_names)


def test_metrics_endpoint_on_a_started_port_server(tmp_path):
    """`Server(metrics_port=0)` on the real clock serves one scrapeable
    exposition with the scheduler's, the loop-lag and the per-worker
    families after a worker ran an array; /healthz and /readyz answer
    200; the endpoint closes with the server."""
    async def go():
        server = server_start.PKGS["port"].server(
            server_dir=tmp_path / "srv", metrics_port=0,
            metrics_host="127.0.0.1")
        access = await server.start()
        peer = server_start.PKGS["port"]
        client = server_start.ScriptedClient(peer, access)
        worker = server_start.ScriptedWorker(
            peer, access, server_start.worker_config(4))
        loop = asyncio.get_running_loop()
        try:
            await client.connect()
            await worker.connect()
            await worker.start_answering()
            await client.submit(server_start.array_job(
                "m", {"cmd": ["x"]}, ids=range(50)), "t-m")
            await client.request({"op": "job_wait", "job_ids": [1]})
            port = server.metrics_port
            text = await loop.run_in_executor(
                None, port_metrics.scrape, "127.0.0.1", port)
            health = await loop.run_in_executor(
                None, port_metrics.probe, "127.0.0.1", port, "/healthz")
            ready = await loop.run_in_executor(
                None, port_metrics.probe, "127.0.0.1", port, "/readyz")
        finally:
            await worker.close()
            await client.close()
            server.stop()
            await asyncio.wait_for(server.run_until_stopped(), 20.0)
        with pytest.raises(OSError):
            await loop.run_in_executor(
                None, port_metrics.scrape, "127.0.0.1", port, 1.0)
        return text, health, ready

    with server_start.server_process_state(fixed=False):
        text, health, ready = asyncio.run(asyncio.wait_for(go(), 60.0))
    parsed = port_metrics.parse_exposition(text)
    assert parsed["hq_solver_failures_total"]["type"] == "counter"
    assert parsed["hq_workers_connected"]["samples"][
        ("hq_workers_connected", frozenset())] == 1
    phases = port_metrics.histogram_summary(parsed, "hq_tick_phase_seconds")
    assert any("phase=total" in key for key in phases)
    lag = port_metrics.histogram_summary(parsed, "hq_reactor_lag_seconds")
    planes = {dict(kv.split("=") for kv in key.split(","))["plane"]
              for key in lag}
    # (no journal here: the worker frames are the in-loop `journal` plane)
    assert {"solve", "rpc", "journal", "ingest", "fanout"} <= planes
    assert any(dict(labels).get("worker") for _, labels in
               parsed["hq_worker_assigned_tasks"]["samples"])
    assert health[0] == 200 and health[1]["ok"] is True
    assert ready[0] == 200, ready
    assert set(ready[1]["checks"]) == {"solver", "ingest", "slo"}
