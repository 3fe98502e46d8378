"""The port's dashboard (`client/dashboard_data`, `client/dashboard`)
against the JAX package's, on the CPU.

Every case of tests/test_dashboard.py runs unchanged with the port's
dashboard modules in place of the JAX package's
(test_torch_cli_e2e.run_scenario): the data layer's worker, job and
allocation folds, time travel, the screens, a journal replay and `hq
dashboard --replay`. (`test_dashboard_cli_replay_plain` spawns `python
-m hyperqueue_tpu dashboard --replay` itself; that step stays the JAX
CLI's, and tests/test_torch_cli_twins.py runs the port's `hq dashboard
--replay` on a JAX server's journal.)

Beside them, `DashboardData` of both packages fed the same events, the
test module's sample and random streams under hypothesis, reaches equal
state, also when travelled back to an earlier time, and renders the same
screens.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_dashboard as jax_dashboard_tests
from hyperqueue_tpu.client import dashboard as jax_dashboard
from hyperqueue_tpu.client import dashboard_data as jax_data
from hyperqueue_tpu_torch.client import dashboard as port_dashboard
from hyperqueue_tpu_torch.client import dashboard_data as port_data
from test_torch_cli_e2e import run_scenario, scenarios

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("scenario", scenarios(jax_dashboard_tests))
def test_dashboard_case_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_dashboard_tests, scenario, tmp_path, monkeypatch)


def plain(value):
    """A DashboardData (or a part of it) as plain data: dataclasses by
    field, with their class name; deques as lists."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {"<class>": type(value).__name__,
                **{f.name: plain(getattr(value, f.name))
                   for f in dataclasses.fields(value)}}
    if isinstance(value, (jax_data.DashboardData, port_data.DashboardData)):
        return {k: plain(v) for k, v in vars(value).items()}
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, deque)):
        return [plain(v) for v in value]
    return value


def both_fed(events):
    datas = (jax_data.DashboardData(), port_data.DashboardData())
    for data in datas:
        for rec in events:
            data.add_event(dict(rec))
    return datas


SCREENS = ("cluster", "jobs", "autoalloc")


def assert_same_state(jax, port):
    assert plain(port) == plain(jax)
    t0, t1 = jax.time_span()
    assert port.time_span() == (t0, t1)
    for t in (t0, (t0 + t1) / 2, t1):
        assert plain(port.at(t)) == plain(jax.at(t))
        for screen in SCREENS:
            state = {"screen": screen, "mode": "replay", "now": t}
            assert port_dashboard.render_screen(port.at(t), state) == \
                jax_dashboard.render_screen(jax.at(t), state)


def test_sample_events_reach_equal_state():
    events = list(jax_dashboard_tests.sample_data().events)
    assert_same_state(*both_fed(events))


EVENT = st.one_of(
    st.fixed_dictionaries({
        "event": st.sampled_from(["worker-connected", "worker-lost"]),
        "id": st.integers(1, 3), "hostname": st.sampled_from(["a", "b"]),
        "group": st.just("default")}),
    st.fixed_dictionaries({
        "event": st.just("worker-overview"), "id": st.integers(1, 3),
        "hw": st.fixed_dictionaries({
            "cpu_usage_percent": st.floats(0, 100),
            "mem_total_bytes": st.just(2 ** 30),
            "mem_available_bytes": st.integers(0, 2 ** 30)})}),
    st.fixed_dictionaries({
        "event": st.sampled_from(["job-submitted", "job-opened"]),
        "job": st.integers(1, 3), "desc": st.just({"name": "j"}),
        "n_tasks": st.integers(0, 4)}),
    st.fixed_dictionaries({
        "event": st.sampled_from(["job-closed", "job-paused", "job-resumed",
                                  "job-completed"]),
        "job": st.integers(1, 3)}),
    st.fixed_dictionaries({
        "event": st.sampled_from(["task-started", "task-restarted",
                                  "task-finished", "task-failed",
                                  "task-canceled"]),
        "job": st.integers(1, 3), "task": st.integers(0, 3),
        "workers": st.lists(st.integers(1, 3), min_size=1, max_size=2),
        "error": st.just("boom")}),
    st.fixed_dictionaries({
        "event": st.sampled_from(["alloc-queue-created",
                                  "alloc-queue-removed",
                                  "alloc-queue-paused", "alloc-queued",
                                  "alloc-started", "alloc-finished"]),
        "queue_id": st.integers(1, 2), "alloc": st.sampled_from(["a1",
                                                                 "a2"]),
        "manager": st.just("slurm")}),
)


@settings(max_examples=150, deadline=None)
@given(events=st.lists(EVENT, max_size=30))
def test_random_event_streams_reach_equal_state(events):
    for i, rec in enumerate(events):
        rec["time"] = 100.0 + i
    outcomes = []
    for mod in (jax_data, port_data):
        data = mod.DashboardData()
        try:
            for rec in events:
                data.add_event(dict(rec))
            outcomes.append(("ok", data))
        except Exception as e:  # noqa: BLE001 - compared across packages
            outcomes.append((type(e).__name__, str(e)))
    if outcomes[0][0] != "ok" or outcomes[1][0] != "ok":
        assert outcomes[0] == outcomes[1]
        return
    jax, port = outcomes[0][1], outcomes[1][1]
    assert plain(port) == plain(jax)
    if events:
        assert_same_state(jax, port)
