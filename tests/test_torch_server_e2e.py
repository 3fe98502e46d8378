"""The port's server in a process of its own, driven by the JAX package's
worker and CLI, on the CPU.

`PortServerEnv` is `tests/utils_e2e.HqEnv` with one change: its server is
the port's, started through `hyperqueue_tpu_torch.server.bootstrap.
run_server(..., device="cpu")` in a subprocess (the launcher below maps
the `hq server start` flags these scenarios use onto `Server` keywords
and checks that the process never imported jax). Workers and client
commands stay the JAX package's own (`python -m hyperqueue_tpu worker
start`, `submit`, `job wait`, `server stop`), so every byte between them
and the server crosses the wire.

The server-only scenarios of tests/test_server_lifecycle.py and
tests/test_server_planes.py run against it: a job completes and the
server stops cleanly; explicit host and ports; a client of another
protocol version is refused; the ack waits for the commit watermark; a kill -9
between enqueue and commit is never acked; an acked array survives kill -9;
the fan-out pool and its inline escape hatch; a forced Python wire backend.
So do the server-side cases of tests/test_profiler.py: `hq server
profile` in its continuous and burst modes, the stats' per-plane CPU
block and reset-metrics.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from utils_e2e import HqEnv, _env_base, wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

pytestmark = pytest.mark.planes

# `hq server start` flags of these scenarios -> Server keywords
_LAUNCHER = r"""
import argparse, asyncio, logging, sys
from pathlib import Path

parser = argparse.ArgumentParser()
parser.add_argument("--server-dir", type=Path, required=True)
parser.add_argument("--journal", type=Path)
parser.add_argument("--journal-fsync", default="never")
parser.add_argument("--journal-plane", default="thread")
parser.add_argument("--fanout-senders", type=int, default=2)
parser.add_argument("--client-plane", default="thread")
parser.add_argument("--profile-hz", type=float, default=19.0)
parser.add_argument("--host")
parser.add_argument("--client-port", type=int, default=0)
parser.add_argument("--worker-port", type=int, default=0)
args = parser.parse_args()
logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(levelname)s %(name)s: %(message)s")
import torch

# one intra-op thread, as in the test processes: the suite runs beside
# wall-clock gates (tests/test_tick_cache.py::test_bench_smoke_gate)
torch.set_num_threads(1)
from hyperqueue_tpu_torch.server.bootstrap import run_server
from hyperqueue_tpu_torch.transport.aead import WIRE_BACKEND

assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), \
    "the port's server imported jax"
assert not any(m == "hyperqueue_tpu" or m.startswith("hyperqueue_tpu.")
               for m in sys.modules), "the port imported the JAX package"
logging.getLogger("hq.launcher").info("wire backend %s", WIRE_BACKEND)
asyncio.run(run_server(
    server_dir=args.server_dir, journal_path=args.journal,
    journal_fsync=args.journal_fsync, journal_plane=args.journal_plane,
    fanout_senders=args.fanout_senders, client_plane=args.client_plane,
    profile_hz=args.profile_hz, host=args.host,
    client_port=args.client_port, worker_port=args.worker_port,
    device="cpu",
))
"""


class PortServerEnv(HqEnv):
    """HqEnv whose `start_server` runs the port's server."""

    def start_server(self, *extra: str, env_extra=None) -> subprocess.Popen:
        before = {
            p.name for p in self.server_dir.iterdir() if p.name.isdigit()
        } if self.server_dir.exists() else set()
        n = sum(1 for name, _ in self.processes if name.startswith("server"))
        name = "server" if n == 0 else f"server{n}"
        log = open(self.tmp / f"{name}.log", "wb")
        process = subprocess.Popen(
            [sys.executable, "-c", _LAUNCHER,
             "--server-dir", str(self.server_dir), *extra],
            env={**_env_base(), **(env_extra or {})},
            cwd=self.work_dir, stdout=log, stderr=subprocess.STDOUT,
        )
        self.processes.append((name, process))

        def new_instance_ready():
            if process.poll() is not None:
                return True
            if not self.server_dir.exists():
                return False
            fresh = {
                p.name for p in self.server_dir.iterdir() if p.name.isdigit()
            } - before
            return any(
                (self.server_dir / d / "access.json").exists() for d in fresh
            )

        wait_until(new_instance_ready, timeout=60.0,
                   message="server access file")
        assert process.poll() is None, self.read_log(name)
        return process


@pytest.fixture
def env(tmp_path):
    with PortServerEnv(tmp_path) as e:
        yield e


def _stats(env):
    return json.loads(
        env.command(["server", "stats", "--output-mode", "json"])
    )


def _jobs(env):
    return json.loads(
        env.command(["job", "list", "--all", "--output-mode", "json"])
    )


def test_jax_worker_and_cli_complete_a_job(env):
    """`hq worker start`, `hq submit --wait`, `hq job wait` and `hq server
    stop` of the JAX package against the port's server: the job finishes
    on the JAX worker, the server exits 0 and retires `hq-current`."""
    env.start_server()
    env.start_worker(cpus=2)
    env.wait_workers(1)
    info = json.loads(env.command(["server", "info", "--output-mode",
                                   "json"]))
    assert info["scheduler"] == "auto" and info["wire_backend"]
    out = env.command(["submit", "--array", "1-8", "--wait", "--",
                       "bash", "-c", "echo $HQ_TASK_ID"], timeout=60)
    assert "job 1 finished" in out or "finished" in out
    wait = json.loads(env.command(["job", "wait", "1", "--output-mode",
                                   "json"], timeout=60))
    jobs = _jobs(env)
    assert jobs[0]["counters"]["finished"] == 8, (wait, jobs)
    workers = json.loads(env.command(["worker", "list", "--output-mode",
                                      "json"]))
    assert len(workers) == 1
    env.command(["server", "stop"])
    server = dict(env.processes)["server"]
    assert server.wait(timeout=20) == 0, env.read_log("server")
    assert not (env.server_dir / "hq-current").is_symlink()
    assert "wire backend" in env.read_log("server")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_explicit_host_and_ports(env):
    """Chosen ports and host land in the access record and server info."""
    cp, wp = _free_port(), _free_port()
    env.start_server("--host", "127.0.0.1",
                     "--client-port", str(cp), "--worker-port", str(wp))
    info = json.loads(
        env.command(["server", "info", "--output-mode", "json"])
    )
    assert info["host"] == "127.0.0.1"
    assert info["client_port"] == cp
    assert info["worker_port"] == wp
    access = json.loads(
        (env.server_dir / "hq-current" / "access.json").read_text()
    )
    assert access["client"]["port"] == cp
    assert access["worker"]["port"] == wp


def test_protocol_version_mismatch_rejected(env):
    """A JAX client speaking another protocol version is refused by the
    port's server at the handshake, with a clear error."""
    env.start_server()
    code = (
        "from pathlib import Path\n"
        "from hyperqueue_tpu.transport import auth\n"
        "auth.PROTOCOL_VERSION += 1\n"
        "from hyperqueue_tpu.client.connection import ClientSession\n"
        "session = ClientSession(Path(%r), retry_window=0.5)\n"
        "print(session.request({'op': 'server_info'}))\n"
    ) % str(env.server_dir)
    result = subprocess.run(
        [sys.executable, "-c", code],
        env=_env_base(), capture_output=True, text=True, timeout=30,
    )
    assert result.returncode != 0
    assert "version" in (result.stdout + result.stderr).lower()


def test_ack_waits_for_commit_watermark(env, tmp_path):
    """durability-before-visibility, positive half: with the commit
    thread slowed to one batch per second, every acked client RPC must
    take at least one commit cycle — the ack rode the watermark."""
    env.start_server(
        "--journal", str(tmp_path / "journal.bin"),
        "--journal-fsync", "always",
        env_extra={"HQ_JOURNAL_PLANE_TEST_DELAY": "1.0"},
    )
    t0 = time.perf_counter()
    out = env.command(
        ["submit", "--output-mode", "quiet", "--", "true"], timeout=30,
    )
    elapsed = time.perf_counter() - t0
    assert out.strip() == "1"
    assert elapsed >= 0.9, (
        f"submit acked in {elapsed:.3f}s — the ack outran the journal "
        "commit (durability-before-visibility regression)"
    )


def test_kill9_between_enqueue_and_commit_never_acked(env, tmp_path,
                                                     monkeypatch):
    """durability-before-visibility, negative half: kill -9 while the
    commit thread is still holding the batch. The client must NOT have
    been acked, and the restored server must show no trace of the job.
    (The in-process client gives up reconnecting after 2 s instead of
    its default 15.)"""
    monkeypatch.setenv("HQ_CLIENT_RETRY_SECS", "2")
    journal = tmp_path / "journal.bin"
    env.start_server(
        "--journal", str(journal), "--journal-fsync", "always",
        env_extra={"HQ_JOURNAL_PLANE_TEST_DELAY": "2.5"},
    )
    result: dict = {}

    def doomed_submit() -> None:
        try:
            result["out"] = env.command(
                ["submit", "--name", "doomed", "--", "true"], timeout=15,
            )
        except Exception as e:  # noqa: BLE001 - failure IS the expectation
            result["err"] = str(e)

    th = threading.Thread(target=doomed_submit, daemon=True)
    th.start()
    # the submit's event is enqueued almost immediately; its commit
    # cannot land before 2.5 s of wall clock — kill well inside that
    time.sleep(1.0)
    env.kill_process("server")
    th.join(timeout=20)
    assert "out" not in result, (
        "client was acked for a submit whose journal commit never "
        f"happened: {result.get('out')}"
    )
    env.start_server("--journal", str(journal))
    names = {j.get("name") for j in _jobs(env)}
    assert "doomed" not in names


def test_acked_chunk_survives_kill9(env, tmp_path):
    """Once the (gated) ack arrives, kill -9 + restore must show the
    work."""
    journal = tmp_path / "journal.bin"
    env.start_server("--journal", str(journal), "--journal-fsync", "always")
    env.command(
        ["submit", "--array", "0-99", "--name", "kept", "--", "true"],
        timeout=30,
    )
    env.kill_process("server")
    env.start_server("--journal", str(journal))
    jobs = {j.get("name"): j for j in _jobs(env)}
    assert "kept" in jobs
    assert jobs["kept"]["n_tasks"] == 100


def test_fanout_pool_and_inline_escape_hatch(env, tmp_path):
    """Downlink correctness is sender-pool-agnostic: the same workload
    completes with a 3-thread pool and with fanout_senders=0, and the
    pool run reports frames and bytes in stats."""
    env.start_server("--fanout-senders", "3")
    # a zero worker completes each task inline (no process a task): the
    # downlink is what this case exercises
    env.start_worker("--zero-worker", cpus=4)
    env.wait_workers(1)
    env.command(["submit", "--array", "0-199", "--wait", "--", "true"],
                timeout=120)
    fo = _stats(env)["fanout"]
    assert fo["senders"] == 3
    assert fo["frames_total"] > 0
    assert fo["bytes_total"] > 0
    assert fo["wire_backend"] in ("native", "openssl", "numpy", "python")
    env.command(["server", "stop"])

    with PortServerEnv(tmp_path / "inline") as env2:
        env2.start_server("--fanout-senders", "0", "--client-plane",
                          "reactor")
        env2.start_worker("--zero-worker", cpus=4)
        env2.wait_workers(1)
        env2.command(
            ["submit", "--array", "0-49", "--wait", "--", "true"],
            timeout=120,
        )
        stats = _stats(env2)
        assert stats["fanout"]["senders"] == 0
        assert stats["ingest"]["plane"] == "reactor"


def test_forced_python_wire_backend_e2e(env):
    """HQ_WIRE_BACKEND=python end to end (the port's server and the JAX
    worker on the compat AEAD, encrypted transport)."""
    forced = {"HQ_WIRE_BACKEND": "python"}
    env.start_server(env_extra=forced)
    env.start_worker("--zero-worker", cpus=2, env_extra=forced)
    env.wait_workers(1)
    info = json.loads(env.command(
        ["server", "info", "--output-mode", "json"]
    ))
    assert info["wire_backend"] == "python"
    env.command(["submit", "--array", "0-9", "--wait", "--", "true"],
                timeout=120)
    jobs = _jobs(env)
    assert jobs[0]["counters"]["finished"] == 10


def test_server_profile_cli_stats_block_and_reset(env):
    """`hq server profile` emits folded stacks, stats carry the per-plane
    CPU block, and reset-metrics clears the profiler aggregates."""
    env.start_server("--profile-hz", "47")
    env.command(["submit", "--array", "0-9", "--", "true"])

    def sampled():
        prof = _stats(env).get("profile") or {}
        return prof if prof.get("passes", 0) >= 10 else None

    prof = wait_until(sampled, timeout=15, message="profiler passes")
    assert prof["enabled"] and prof["hz"] == 47.0
    assert prof["planes"], "per-plane shares should be populated"
    assert prof["samples"] > 0 and prof["trie"]["nodes"] > 0
    for agg in prof["planes"].values():
        assert set(agg) == {"samples", "active", "cpu"}

    # human stats output renders the CPU block
    text = env.command(["server", "stats"])
    assert "cpu plane" in text and "Hz sampler" in text

    # folded output: non-comment `stack count` lines, reactor present
    out = env.command(["server", "profile"])
    lines = [ln for ln in out.splitlines()
             if ln.strip() and not ln.startswith("#")]
    assert lines
    planes_seen = {ln.split(";", 1)[0] for ln in lines}
    assert "reactor" in planes_seen
    for ln in lines:
        stack, _, count = ln.rpartition(" ")
        assert stack and int(count) > 0

    # windowed + json mode
    result = json.loads(env.command(
        ["server", "profile", "--seconds", "0.3", "--format", "json"]
    ))
    assert result["mode"] == "continuous"
    assert result["seconds"] == 0.3
    assert result["passes"] >= 5  # ~14 expected at 47 Hz
    assert "folded" in result

    # reset-metrics clears the profiler aggregates (steady-state
    # measurement contract) but sampling continues
    pre = _stats(env)["profile"]["passes"]
    env.command(["server", "reset-metrics"])
    post = _stats(env)["profile"]
    assert post["passes"] < pre
    assert post["enabled"], "reset must not stop the sampler"


def test_profile_burst_on_unprofiled_server(env):
    """A profile_hz=0 server still answers `hq server profile` with a
    throwaway burst sampler covering the requested window."""
    env.start_server("--profile-hz", "0")
    assert not (_stats(env).get("profile") or {}).get("enabled")
    result = json.loads(env.command(
        ["server", "profile", "--seconds", "0.5", "--format", "json"]
    ))
    assert result["mode"] == "burst"
    assert result["passes"] > 0
    assert result["folded"]
    # the burst sampler is throwaway: the server stays unprofiled
    assert not (_stats(env).get("profile") or {}).get("enabled")
