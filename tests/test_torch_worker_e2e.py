"""The port's worker in a process of its own, over TCP, against the JAX
package's server and the port's, driven by the JAX package's CLI.

`PORT_WORKER_LAUNCHER` builds a `WorkerConfiguration` the way the JAX
package's `hq worker start` does (`client/cli.py` `cmd_worker_start`:
`detect_resources`, then `parse_resource_definition` for each
`--resource`, then `descriptor.validate()`) and runs
`hyperqueue_tpu_torch.worker.runtime.run_worker` against the server
directory's access record. It maps the `worker start` flags the scenarios
use, and checks on the way out that the process never imported torch,
numpy, msgpack, jax or the JAX package.

`with_port_workers(env_class)` derives an e2e environment (`utils_e2e.
HqEnv` for the JAX server, `test_torch_server_e2e.PortServerEnv` for the
port's) whose `start_worker` runs this launcher. Client commands stay the
JAX package's CLI.

The scenarios: a port worker completes a job with its runner pool on; it
rides out a kill -9 of a journaled server under `--on-server-lost
reconnect` and its running tasks are reattached, each run once; a
subprocess import of `worker.runtime` loads neither torch, numpy nor
msgpack; and a runner boots under `-S` and speaks the port's codec.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_server_e2e import PortServerEnv
from utils_e2e import HqEnv, _env_base, wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PORT_WORKER_LAUNCHER = r"""
import argparse, asyncio, logging, os, sys
from pathlib import Path

parser = argparse.ArgumentParser()
parser.add_argument("--server-dir", type=Path, required=True)
parser.add_argument("--cpus", type=int, default=None)
parser.add_argument("--resource", action="append", default=None)
parser.add_argument("--group", default="default")
parser.add_argument("--heartbeat", type=float, default=8.0)
parser.add_argument("--time-limit", type=float, default=None)
parser.add_argument("--idle-timeout", type=float, default=None)
parser.add_argument("--on-server-lost", default="stop",
                    choices=["stop", "finish-running", "reconnect"])
parser.add_argument("--reconnect-timeout", type=float, default=60.0)
parser.add_argument("--overview-interval", type=float, default=0.0)
parser.add_argument("--runner-pool", type=int, default=-1)
parser.add_argument("--uplink-flush", type=float, default=0.002)
parser.add_argument("--zero-worker", action="store_true")
parser.add_argument("--profile-hz", type=float, default=19.0)
args = parser.parse_args()
logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(levelname)s %(name)s: %(message)s")

from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor
from hyperqueue_tpu_torch.server.worker import WorkerConfiguration
from hyperqueue_tpu_torch.transport import codec
from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.worker.hwdetect import detect_resources
from hyperqueue_tpu_torch.worker.parser import parse_resource_definition
from hyperqueue_tpu_torch.worker.runtime import run_worker

descriptor = detect_resources(n_cpus=args.cpus)
if args.resource:
    items = {item.name: item for item in descriptor.items}
    for spec in args.resource:
        item = parse_resource_definition(spec)
        items[item.name] = item
    descriptor = ResourceDescriptor(items=tuple(items.values()))
descriptor.validate()
config = WorkerConfiguration(
    descriptor=descriptor, hostname=os.uname().nodename, group=args.group,
    heartbeat_secs=args.heartbeat, time_limit_secs=args.time_limit or 0.0,
    idle_timeout_secs=(args.idle_timeout
                       if args.idle_timeout is not None else -1.0),
    on_server_lost=args.on_server_lost,
    reconnect_timeout_secs=args.reconnect_timeout,
    overview_interval_secs=args.overview_interval,
    runner_pool=args.runner_pool, uplink_flush_secs=args.uplink_flush,
)
access = serverdir.load_access(args.server_dir)
log = logging.getLogger("hq.launcher")
log.info("codec backend %s", codec.BACKEND)


def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "numpy", "msgpack", "jax", "hyperqueue_tpu"))


log.info("foreign modules %s", foreign())
try:
    asyncio.run(run_worker(
        access.host_for_workers(), access.worker_port,
        access.worker_key_bytes(), config, zero_worker=args.zero_worker,
        server_dir=args.server_dir, profile_hz=args.profile_hz))
finally:
    log.info("foreign modules at exit %s", foreign())
"""


def port_worker_argv(server_dir, *extra: str, cpus: int | None = 4
                     ) -> list[str]:
    argv = [sys.executable, "-c", PORT_WORKER_LAUNCHER,
            "--server-dir", str(server_dir)]
    if cpus is not None:
        argv += ["--cpus", str(cpus)]
    return argv + list(extra)


def with_port_workers(env_class):
    """`env_class` with `start_worker` running the port's worker."""

    class PortWorkerEnv(env_class):
        def start_worker(self, *extra: str, cpus: int | None = 4,
                         env_extra=None) -> subprocess.Popen:
            n = sum(1 for name, _ in self.processes
                    if name.startswith("worker"))
            name = f"worker{n}"
            log = open(self.tmp / f"{name}.log", "wb")
            process = subprocess.Popen(
                port_worker_argv(self.server_dir, *extra, cpus=cpus),
                env={**_env_base(), **(env_extra or {})},
                cwd=self.work_dir, stdout=log, stderr=subprocess.STDOUT,
            )
            self.processes.append((name, process))
            return process

    PortWorkerEnv.__name__ = f"PortWorker{env_class.__name__}"
    return PortWorkerEnv


SERVERS = {"jax": HqEnv, "port": PortServerEnv}


@pytest.fixture(params=sorted(SERVERS))
def env(request, tmp_path):
    with with_port_workers(SERVERS[request.param])(tmp_path) as e:
        yield e


def _jobs(env):
    return json.loads(
        env.command(["job", "list", "--all", "--output-mode", "json"])
    )


def _assert_port_worker_log(env, name="worker0"):
    log = env.read_log(name)
    assert "codec backend native" in log, log
    assert "foreign modules []" in log, log


def test_port_worker_completes_a_job(env):
    """A port worker with a runner pool of 2 runs an 8-task array for the
    JAX CLI against either server; every task's stdout reaches its file,
    and the worker leaves on `hq server stop`."""
    env.start_server()
    worker = env.start_worker("--runner-pool", "2", cpus=2)
    env.wait_workers(1)
    out = env.command(["submit", "--array", "1-8", "--wait", "--",
                       "bash", "-c", "echo task-$HQ_TASK_ID"], timeout=60)
    assert "finished" in out
    assert _jobs(env)[0]["counters"]["finished"] == 8
    lines = env.command(["job", "cat", "1", "stdout"]).split()
    assert sorted(lines) == sorted(f"task-{i}" for i in range(1, 9))
    workers = json.loads(env.command(["worker", "list", "--output-mode",
                                      "json"]))
    assert len(workers) == 1
    env.command(["server", "stop"])
    wait_until(lambda: worker.poll() is not None, timeout=20,
               message="worker exited after server stop")
    _assert_port_worker_log(env)
    assert "runner pool started (2 warm runners)" in env.read_log("worker0")


def test_port_worker_reconnects_across_server_restart(env, tmp_path):
    """`--on-server-lost reconnect`: kill -9 a journaled server while two
    tasks run on a port worker, restart it on the same journal; the worker
    re-registers, its tasks are reattached (no second start) and finish."""
    journal = tmp_path / "journal.bin"
    marker = env.work_dir / "starts.txt"
    flag = env.work_dir / "flag"
    env.start_server("--journal", str(journal))
    env.start_worker("--on-server-lost", "reconnect", "--heartbeat", "1",
                     "--runner-pool", "1", cpus=2)
    env.wait_workers(1)
    env.command([
        "submit", "--array", "0-1", "--", "bash", "-c",
        f'echo "start:$HQ_TASK_ID:$HQ_INSTANCE_ID" >> {marker}; '
        f"while [ ! -f {flag} ]; do sleep 0.1; done",
    ])
    wait_until(lambda: _jobs(env)[0]["counters"]["running"] == 2,
               timeout=30, message="2 tasks running")
    env.kill_process("server")
    env.start_server("--journal", str(journal))
    wait_until(lambda: _jobs(env)[0]["counters"]["running"] == 2,
               timeout=40, message="tasks reattached as running")
    flag.touch()
    env.command(["job", "wait", "all"], timeout=40)
    assert _jobs(env)[0]["status"] == "finished"
    assert sorted(marker.read_text().split()) == ["start:0:0", "start:1:0"]
    assert "registered as worker" in env.read_log("worker0")
    _assert_port_worker_log(env)


def test_worker_runtime_imports_no_torch_numpy_or_msgpack():
    """Every worker module loads with neither torch, numpy, msgpack nor
    jax behind it: a worker pays no accelerator stack's boot."""
    code = (
        "import sys\n"
        "import hyperqueue_tpu_torch.worker.runtime\n"
        "import hyperqueue_tpu_torch.worker.hwdetect\n"
        "import hyperqueue_tpu_torch.worker.hwmonitor\n"
        "import hyperqueue_tpu_torch.worker.localcomm\n"
        "import hyperqueue_tpu_torch.worker.manager\n"
        "import hyperqueue_tpu_torch.worker.parser\n"
        "import hyperqueue_tpu_torch.worker.runner\n"
        "import hyperqueue_tpu_torch.utils.chaos\n"
        "from hyperqueue_tpu_torch.transport import codec\n"
        "print(codec.BACKEND, sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('torch', 'numpy', 'msgpack', 'jax', 'hyperqueue_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["native", "[]"]


def test_runner_boots_under_dash_s_with_the_port_codec(tmp_path):
    """The runner boots by path under `-S` with PYTHONPATH at the
    package's parent, spawns a payload from a launch frame and reports its
    exit through the port's codec."""
    import struct

    from hyperqueue_tpu_torch.transport import codec
    from hyperqueue_tpu_torch.worker import runner_pool

    argv, env = runner_pool._runner_argv_env()
    assert argv[1] == "-S" and argv[2].endswith("worker/runner.py")
    assert env["PYTHONPATH"] == str(ROOT)
    proc = subprocess.Popen(argv, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE)
    try:
        out = tmp_path / "out.txt"
        frame = codec.packb({"op": "launch", "key": 1, "ack": True,
                             "cmd": ["bash", "-c", "echo hi"],
                             "stdout": str(out)})
        proc.stdin.write(struct.pack("<I", len(frame)) + frame)
        proc.stdin.flush()
        msgs = []
        for _ in range(2):
            (n,) = struct.unpack("<I", proc.stdout.read(4))
            msgs.append(codec.unpackb(proc.stdout.read(n)))
        assert [m["op"] for m in msgs] == ["spawned", "exit"]
        assert msgs[1]["code"] == 0 and msgs[1]["key"] == 1
        assert out.read_text() == "hi\n"
        proc.stdin.close()
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
