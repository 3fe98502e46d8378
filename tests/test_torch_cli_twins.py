"""Two command lines against one server, and a JAX deployment's files read
by the port, on the CPU.

- After a fixed scenario against one port server (a journal, one port
  worker; an array with a failing task, a TOML graph, a canceled job, a
  paused one), every read-only command with `--output-mode json` gives
  the same JSON through the JAX CLI and through the port's: `job
  list/info/summary/task-ids`, `task list/info/explain`, `worker
  list/info`, `server info`.
- The port's CLI completes a job against a JAX server and its worker,
  with the JAX server's access record; the JAX CLI does against the
  port's.
- A journal written by a JAX server in an e2e run: the port's `hq journal
  export`, `hq journal replay`, `hq journal report` and `hq dashboard
  --replay` give the JAX CLI's output on it.
"""

from __future__ import annotations

import json
import textwrap
import types

import pytest
import torch

from test_torch_cli_e2e import PortCliEnv, run_port_cli_inprocess
from utils_e2e import HqEnv, _run_cli_inprocess, wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


def both(env, args, cwd=None, expect_rc=0):
    """`args` through the JAX CLI and the port's against `env`'s server:
    (JAX stdout, port stdout)."""
    outs = []
    for run in (_run_cli_inprocess, run_port_cli_inprocess):
        result = run(args, env.server_dir, cwd or env.work_dir, 60)
        assert result.returncode == expect_rc, (run.__name__, args,
                                                result.stderr)
        outs.append(result.stdout)
    return outs


# fields that move between two reads of a live server
_LIVE = {"uptime", "last_heartbeat", "heartbeat_age", "time", "now",
         "idle_s", "age_s"}


def _settled(value):
    if isinstance(value, dict):
        return {k: _settled(v) for k, v in value.items() if k not in _LIVE}
    if isinstance(value, list):
        return [_settled(v) for v in value]
    return value


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """One port server after a fixed scenario, shared by the read-only
    comparisons (nothing here changes its state)."""
    tmp = tmp_path_factory.mktemp("twins")
    with PortCliEnv(tmp) as env:
        env.start_server("--journal", str(tmp / "journal.bin"))
        env.start_worker(cpus=2)
        env.wait_workers(1)
        env.command(["submit", "--array", "1-6", "--name", "arr", "--wait",
                     "--", "bash", "-c",
                     "test $HQ_TASK_ID -ne 4 || exit 3"], expect_fail=True)
        (env.work_dir / "g.toml").write_text(textwrap.dedent("""\
            name = "graph"
            [[task]]
            id = 0
            command = ["true"]
            [[task]]
            id = 1
            command = ["true"]
            deps = [0]
            """))
        env.command(["job", "submit-file", "g.toml"])
        env.command(["job", "wait", "2"])
        env.command(["submit", "--array", "1-3", "--name", "held",
                     "--cpus", "64", "--", "true"])
        env.command(["job", "cancel", "3"])
        env.command(["submit", "--name", "paused", "--cpus", "64", "--",
                     "true"])
        env.command(["job", "pause", "4"])
        yield env


READS = [
    ["job", "list", "--all"],
    ["job", "list"],
    ["job", "info", "1-4"],
    ["job", "summary"],
    ["job", "task-ids", "1"],
    ["task", "list", "1-4"],
    ["task", "info", "1", "3-5"],
    ["task", "info", "2"],
    ["task", "explain", "4.0"],
    ["task", "explain", "1.4"],
    ["worker", "list"],
    ["worker", "list", "--all"],
    ["worker", "info", "1"],
    ["server", "info"],
]


@pytest.mark.parametrize("args", READS, ids=lambda a: " ".join(a))
def test_read_commands_give_the_same_json(scenario, args):
    jax_out, port_out = both(scenario, [*args, "--output-mode", "json"])
    assert _settled(json.loads(port_out)) == _settled(json.loads(jax_out))


def test_port_cli_against_a_jax_server(tmp_path):
    """The JAX server's directory and access record serve the port's
    client: submit, wait, cat, list and stop."""
    with HqEnv(tmp_path) as env:
        env.start_server()
        env.start_worker(cpus=2)
        env.wait_workers(1)

        def port(args, expect_rc=0):
            result = run_port_cli_inprocess(args, env.server_dir,
                                            env.work_dir, 60)
            assert result.returncode == expect_rc, result.stderr
            return result.stdout

        out = port(["submit", "--array", "1-4", "--wait", "--", "bash",
                    "-c", "echo t$HQ_TASK_ID"])
        assert "job 1 finished" in out
        lines = sorted(port(["job", "cat", "1", "stdout"]).split())
        assert lines == ["t1", "t2", "t3", "t4"]
        jobs = json.loads(port(["job", "list", "--all", "--output-mode",
                                "json"]))
        assert jobs[0]["counters"]["finished"] == 4
        port(["server", "stop"])
        assert dict(env.processes)["server"].wait(timeout=20) == 0


def test_jax_cli_against_a_port_server(tmp_path):
    with PortCliEnv(tmp_path) as env:
        env.start_server()
        env.start_worker(cpus=2)
        env.wait_workers(1)
        for args in (["submit", "--array", "1-3", "--wait", "--", "true"],
                     ["job", "wait", "1"], ["server", "stop"]):
            result = _run_cli_inprocess(args, env.server_dir, env.work_dir,
                                        60)
            assert result.returncode == 0, result.stderr
        assert dict(env.processes)["server"].wait(timeout=20) == 0


@pytest.fixture(scope="module")
def jax_journal(tmp_path_factory):
    """A journal written by a JAX server in an e2e run: jobs that finish,
    fail and are canceled, a worker that comes and goes."""
    tmp = tmp_path_factory.mktemp("journal")
    journal = tmp / "journal.bin"
    with HqEnv(tmp) as env:
        env.start_server("--journal", str(journal))
        env.start_worker(cpus=2)
        env.wait_workers(1)
        env.command(["submit", "--array", "1-5", "--wait", "--", "bash",
                     "-c", "test $HQ_TASK_ID -ne 2 || exit 1"],
                    expect_fail=True)
        env.command(["submit", "--cpus", "64", "--", "true"])
        env.command(["job", "cancel", "2"])
        env.command(["server", "stop"])
        wait_until(lambda: dict(env.processes)["server"].poll() is not None,
                   timeout=20)
    return journal


@pytest.mark.parametrize("args", [
    ["journal", "export"], ["journal", "replay"],
    ["journal", "export", "--salvage"], ["dashboard", "--replay"],
], ids=lambda a: " ".join(a))
def test_jax_journal_reads_the_same(jax_journal, args, tmp_path):
    env = types.SimpleNamespace(server_dir=tmp_path / "none",
                                work_dir=tmp_path)
    jax_out, port_out = both(env, [*args, str(jax_journal)])
    assert port_out == jax_out
    assert port_out.strip()


def test_jax_journal_report_is_the_same(jax_journal, tmp_path):
    pages = []
    for name, run in (("jax", _run_cli_inprocess),
                      ("port", run_port_cli_inprocess)):
        out = tmp_path / f"{name}.html"
        result = run(["journal", "report", str(jax_journal), "--output",
                      str(out)], tmp_path / "none", tmp_path, 60)
        assert result.returncode == 0, result.stderr
        pages.append(out.read_text())
    assert pages[0] == pages[1]
    assert "HyperQueue-TPU journal report" in pages[1]
