"""The port's worker modules against the JAX package's, on the CPU.

Twins: every case of tests/test_allocator.py, the runner pool's launch-plan
cases of tests/test_runner_pool.py and the stream-writer cases of
tests/test_tick_cache.py run over both packages (`port_copy` execs a case's
source with the JAX package's imports pointed at the port). Then the same
inputs through both packages, compared: random allocate/release sequences,
the resource-definition and coupling parsers, `detect_gpus`/`detect_tpus`
under patched environments and globs, the `nvidia-smi` and `rocm-smi`
parsers, placeholders, the jittered backoff and the chaos plan's rule
matching. Last, the worker's `hq_worker_*` metric families against the JAX
worker's.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import random
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import test_allocator
import test_runner_pool
import test_tick_cache

import hyperqueue_tpu.utils.chaos as jax_chaos
import hyperqueue_tpu.utils.placeholders as jax_placeholders
import hyperqueue_tpu.utils.retry as jax_retry
import hyperqueue_tpu.worker.allocator as jax_allocator
import hyperqueue_tpu.worker.hwdetect as jax_hwdetect
import hyperqueue_tpu.worker.hwmonitor as jax_hwmonitor
import hyperqueue_tpu.worker.parser as jax_parser
import hyperqueue_tpu.resources.descriptor as jax_descriptor
import hyperqueue_tpu_torch.utils.chaos as port_chaos
import hyperqueue_tpu_torch.utils.placeholders as port_placeholders
import hyperqueue_tpu_torch.utils.retry as port_retry
import hyperqueue_tpu_torch.worker.allocator as port_allocator
import hyperqueue_tpu_torch.worker.hwdetect as port_hwdetect
import hyperqueue_tpu_torch.worker.hwmonitor as port_hwmonitor
import hyperqueue_tpu_torch.worker.parser as port_parser
import hyperqueue_tpu_torch.resources.descriptor as port_descriptor

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": types.SimpleNamespace(
        allocator=jax_allocator, descriptor=jax_descriptor,
        parser=jax_parser, hwdetect=jax_hwdetect, hwmonitor=jax_hwmonitor,
        placeholders=jax_placeholders, retry=jax_retry, chaos=jax_chaos),
    "port": types.SimpleNamespace(
        allocator=port_allocator, descriptor=port_descriptor,
        parser=port_parser, hwdetect=port_hwdetect,
        hwmonitor=port_hwmonitor, placeholders=port_placeholders,
        retry=port_retry, chaos=port_chaos),
}


def _to_port(source: str) -> str:
    return re.sub(r"\bhyperqueue_tpu\b", "hyperqueue_tpu_torch", source)


def port_copy(module, names=None) -> types.SimpleNamespace:
    """The module's cases run against the port: its source (the whole
    module, or only the named top-level objects, in order) exec'd with the
    JAX package's imports pointing at the port's modules."""
    if names is None:
        source = inspect.getsource(module)
        namespace: dict = {"__name__": f"{module.__name__}_port"}
    else:
        source = "\n\n".join(inspect.getsource(getattr(module, n))
                             for n in names)
        namespace = dict(vars(module))
    exec(compile(_to_port(source), module.__file__, "exec"), namespace)
    return types.SimpleNamespace(**namespace)


def _cases(module, prefix="test_"):
    return sorted(n for n, f in vars(module).items()
                  if n.startswith(prefix) and inspect.isfunction(f)
                  and f.__module__ == module.__name__)


# --- tests/test_allocator.py, twinned ---------------------------------------
ALLOCATOR = {"jax": test_allocator, "port": port_copy(test_allocator)}
ALLOCATOR_CASES = _cases(test_allocator)


def test_every_allocator_case_is_twinned():
    assert len(ALLOCATOR_CASES) == 36


@pytest.mark.parametrize("case", ALLOCATOR_CASES)
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_allocator_case(pkg, case):
    getattr(ALLOCATOR[pkg], case)()


def _random_descriptor(pkg, rng):
    d = PKGS[pkg].descriptor
    items = [d.ResourceDescriptorItem.group_list(
        "cpus", [[str(g * 4 + i) for i in range(rng.randint(2, 4))]
                 for g in range(rng.randint(1, 4))])]
    items.append(d.ResourceDescriptorItem.list(
        "gpus", [str(i) for i in range(rng.randint(1, 4))]))
    items.append(d.ResourceDescriptorItem.sum("mem", rng.randint(1, 64)))
    return d.ResourceDescriptor(items=tuple(items))


POLICIES = ["compact", "compact!", "scatter", "tight", "tight!", "all"]


@pytest.mark.parametrize("seed", range(6))
def test_allocator_random_sequences_agree(seed):
    """The same random allocate/release sequence on both packages' allocators
    gives the same claims (indices, fraction donors, sums) step by step."""
    U = 10_000
    allocators = {}
    for pkg in PKGS:
        rng = random.Random(seed)
        allocators[pkg] = PKGS[pkg].allocator.ResourceAllocator(
            _random_descriptor(pkg, rng))
    rng = random.Random(seed * 7919)
    live = {pkg: [] for pkg in PKGS}
    for _step in range(120):
        if live["jax"] and rng.random() < 0.35:
            k = rng.randrange(len(live["jax"]))
            for pkg in PKGS:
                allocators[pkg].release(live[pkg].pop(k))
            continue
        entries = []
        for name in rng.sample(["cpus", "gpus", "mem"], rng.randint(1, 3)):
            policy = rng.choice(POLICIES if name != "mem" else ["compact"])
            if policy == "all":
                amount = 0
            elif name == "gpus":
                amount = rng.choice([U // 4, U // 2, U, U + U // 2, 2 * U])
            else:
                amount = rng.randint(1, 4) * U
            entries.append({"name": name, "amount": amount,
                            "policy": policy})
        got = {pkg: allocators[pkg].try_allocate([dict(e) for e in entries])
               for pkg in PKGS}
        plain = {pkg: (None if a is None else dataclasses.asdict(a))
                 for pkg, a in got.items()}
        assert plain["jax"] == plain["port"], entries
        if got["jax"] is not None:
            for pkg in PKGS:
                live[pkg].append(got[pkg])


# --- the parsers -------------------------------------------------------------
DEFINITIONS = ["gpus=[0,1,3]", "cpus=range(2-5)", "numa=[[0,1],[2,3]]",
               "mem=sum(1024)", "cpus=2x4", "cpus=6", "x=[a, b]",
               "gpus=range(0-7)", "mem=sum(0.5)", "x=[[1],[]]"]
BAD_DEFINITIONS = ["cpus", "x=range(5-2)", "x=[]", "x=sum(abc)", "x=foo",
                   "=[1]"]


def _item_plain(item) -> dict:
    return {f.name: getattr(item, f.name)
            for f in dataclasses.fields(item)}


@pytest.mark.parametrize("spec", DEFINITIONS)
def test_resource_definition_parser_agrees(spec):
    items = [PKGS[p].parser.parse_resource_definition(spec) for p in PKGS]
    plain = [_item_plain(i) for i in items]
    assert str(plain[0]) == str(plain[1])
    assert items[1].index_groups() == items[0].index_groups()
    assert items[1].total_amount() == items[0].total_amount()


@pytest.mark.parametrize("spec", BAD_DEFINITIONS)
def test_resource_definition_parser_refuses_alike(spec):
    for pkg in PKGS.values():
        with pytest.raises(pkg.parser.ResourceParseError):
            pkg.parser.parse_resource_definition(spec)


COUPLINGS = ["cpus,gpus", "cpus[0]:gpus[0]=512, cpus[1]:gpus[1]",
             "gpus[1]:cpus[0]=64"]


@pytest.mark.parametrize("text", COUPLINGS)
def test_resource_coupling_parser_agrees(text):
    jax_c, port_c = (PKGS[p].parser.parse_resource_coupling(text)
                     for p in PKGS)
    assert port_c.names == jax_c.names
    assert [dataclasses.astuple(w) for w in port_c.weights] == \
        [dataclasses.astuple(w) for w in jax_c.weights]
    for pkg in PKGS.values():
        with pytest.raises(ValueError):
            pkg.parser.parse_resource_coupling("cpus[0]gpus[0]")


RESOURCE_TESTS = ["test_parse_resource_coupling",
                  "test_coupling_descriptor_roundtrip",
                  "test_coupling_validate_rejects_bad_group"]


@pytest.mark.parametrize("case", RESOURCE_TESTS)
def test_resource_parser_cases_on_the_port(case):
    """The parser cases of tests/test_resources.py, over the port."""
    import test_resources

    getattr(port_copy(test_resources, [case]), case)()


# --- hardware detection ------------------------------------------------------
@pytest.mark.parametrize("visible,proc", [
    ("0,1", []), ("GPU-aa,GPU-bb", []), ("", []), ("-1", []),
    (None, ["/proc/driver/nvidia/gpus/0000:01:00.0",
            "/proc/driver/nvidia/gpus/0000:02:00.0"]),
    (None, []),
])
def test_detect_gpus_agrees(monkeypatch, visible, proc):
    """The H100 is found through CUDA_VISIBLE_DEVICES, else through
    /proc/driver/nvidia/gpus (patched here); both packages agree."""
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)

    def fake_glob(pattern):
        return list(proc) if "nvidia" in pattern else []

    got = []
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.hwdetect.glob, "glob", fake_glob)
        item = pkg.hwdetect.detect_gpus()
        got.append(None if item is None else str(_item_plain(item)))
    assert got[0] == got[1]
    if visible == "0,1" or proc:
        assert "'name': 'gpus'" in got[1]


@pytest.mark.parametrize("visible,accels", [
    ("0,1,2,3", []), (None, ["/dev/accel0", "/dev/accel1"]), (None, []),
])
def test_detect_tpus_agrees(monkeypatch, visible, accels):
    if visible is None:
        monkeypatch.delenv("TPU_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("TPU_VISIBLE_DEVICES", visible)

    def fake_glob(pattern):
        return list(accels) if "accel" in pattern else []

    got = []
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.hwdetect.glob, "glob", fake_glob)
        item = pkg.hwdetect.detect_tpus()
        got.append(None if item is None else str(_item_plain(item)))
    assert got[0] == got[1]


def test_detect_resources_agrees(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    got = [pkg.hwdetect.detect_resources(n_cpus=3).to_dict()
           for pkg in PKGS.values()]
    assert got[0] == got[1]
    assert [i["name"] for i in got[1]["items"]][:2] == ["cpus", "gpus"]


# --- telemetry ---------------------------------------------------------------
def test_gpu_stat_parsers_on_the_port():
    """tests/test_misc_features.py's hwmonitor case, over the port."""
    import test_misc_features

    port_copy(test_misc_features,
              ["test_gpu_stat_parsers"]).test_gpu_stat_parsers()


@pytest.mark.parametrize("text", [
    "00000000:01:00.0, 35 %, 1024 MiB, 8192 MiB\n",
    # an H100's line, as the worker's query asks for it
    "00000000:19:00.0, 0 %, 0 MiB, 81559 MiB\n",
    "00000000:19:00.0, [N/A], [N/A], [N/A]\n",
    "garbage\n\n",
    "",
])
def test_nvidia_smi_parser_agrees(text):
    assert port_hwmonitor.parse_nvidia_smi_csv(text) == \
        jax_hwmonitor.parse_nvidia_smi_csv(text)


# --- placeholders, retry, chaos ----------------------------------------------
@pytest.mark.parametrize("template", [
    "%{SUBMIT_DIR}/job-%{JOB_ID}/%{TASK_ID}.%{UNKNOWN}",
    "%{CWD}/%{INSTANCE_ID}", "plain", "%{TASK_ID}%{TASK_ID}", "%{", "",
])
def test_placeholders_agree(template):
    got = []
    for pkg in PKGS.values():
        mapping = pkg.placeholders.task_placeholder_map(
            7, 42, 3, "/x", "uid", cwd="/w")
        got.append((mapping, pkg.placeholders.fill_placeholders(
            template, mapping)))
    assert got[0] == got[1]


def test_jittered_backoff_agrees():
    for seed in range(12):
        got = []
        for pkg in PKGS.values():
            rng, delay, steps = random.Random(seed), 0.25, []
            for remaining in (None, 10.0, 0.01, None, 3.0, None):
                sleep_for, delay = pkg.retry.jittered_backoff(
                    delay, 5.0, rng, remaining)
                steps.append((sleep_for, delay))
            got.append(steps)
        assert got[0] == got[1]
        assert all(0.0 < s <= 5.0 and d <= 5.0 for s, d in got[1])


PLAN = {"seed": 3, "rules": [
    {"site": "worker.send", "op": "task_finished", "action": "drop",
     "times": 2},
    {"site": "worker.recv", "op": "compute", "action": "dup", "prob": 0.3},
    {"site": "worker.reconnect", "action": "delay", "at": 3,
     "delay_ms": 5},
    {"site": "server.event", "event": "task-started", "action": "raise",
     "shard": 1},
]}


def test_chaos_plans_match_alike():
    """A plan's rules fire at the same matches in both packages (the
    per-rule RNG is seeded the same way)."""
    plans = [pkg.chaos.FaultPlan(PLAN) for pkg in PKGS.values()]
    rng = random.Random(5)
    for _ in range(300):
        site = rng.choice(["worker.send", "worker.recv", "worker.reconnect",
                           "server.event"])
        op = rng.choice([None, "task_finished", "compute"])
        event = rng.choice([None, "task-started"])
        shard = rng.choice([None, 0, 1])
        fired = [plan.match(site, op=op, event=event, shard=shard)
                 for plan in plans]
        assert [r.action if r else None for r in fired][0] == \
            [r.action if r else None for r in fired][1]


# --- tests/test_tick_cache.py's stream-writer cases, over a port runtime ----
STREAM_CASES = ["test_stream_writer_eviction_skips_in_use",
                "test_stream_writer_lru_reuse_moves_to_end",
                "test_stream_writer_refcount_shared_dir"]
STREAM = port_copy(test_tick_cache,
                   ["_DummyWriter", "_make_runtime", *STREAM_CASES])


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_writer_case_on_a_port_runtime(monkeypatch, case):
    assert "hyperqueue_tpu_torch" in type(STREAM._make_runtime()).__module__
    getattr(STREAM, case)(monkeypatch)


# --- tests/test_runner_pool.py's launch-plan cases, over the port -----------
PLAN_CASES = ["test_plan_key_shares_array_body_and_splits_differing_env",
              "test_plan_placeholder_cmd_and_cwd_fill_per_task"]
RUNNER_POOL = port_copy(test_runner_pool, PLAN_CASES)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_launch_plan_case_on_the_port(tmp_path, case):
    fn = getattr(RUNNER_POOL, case)
    fn(*([tmp_path] if inspect.signature(fn).parameters else []))


# --- metric families ---------------------------------------------------------
_FAMILIES = r"""
import json, sys
pkg = sys.argv[1]
__import__(pkg + ".worker.runtime")
metrics = __import__(pkg + ".utils.metrics", fromlist=["REGISTRY"])
print(json.dumps({name: [m.type, list(m.label_names), m.help,
                         list(m.buckets)]
                  for name, m in metrics.REGISTRY._metrics.items()
                  if name.startswith("hq_worker_")}))
"""


def _worker_families(pkg):
    """The hq_worker_* families a process registers by importing the
    worker runtime alone (a fresh process: the server's modules register
    families of that prefix too)."""
    out = subprocess.run([sys.executable, "-c", _FAMILIES, pkg], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_worker_metric_families_are_the_jax_workers():
    """The 19 hq_worker_* families of the worker runtime and its runner
    pool: the JAX package's names, types, labels, buckets and help texts.
    One help text is worded apart: the JAX package's cites its own
    project history there."""
    jax_f = _worker_families("hyperqueue_tpu")
    port_f = _worker_families("hyperqueue_tpu_torch")
    assert len(port_f) == 19
    assert sorted(port_f) == sorted(jax_f)
    reworded = "hq_worker_profile_plane_cpu_share"
    for name in port_f:
        if name == reworded:
            assert port_f[name][:2] == jax_f[name][:2]
            assert port_f[name][3] == jax_f[name][3]
        else:
            assert port_f[name] == jax_f[name], name
