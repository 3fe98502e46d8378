"""The port's command line against the JAX package's, without a server,
on the CPU.

- Parser parity: both `build_parser()` trees have the same subcommand
  paths, option strings, choices, defaults, `nargs`, types and actions;
  `hq generate-completion` prints the same script for each shell (up to
  the package name in `python -m`), and `hq doc` the same topics.
- The pure helpers, under hypothesis: selectors, durations, crash limits,
  weights, min utilization, id ranges, resource requests, array subsets
  and chunks, the stdin chunker, directives, job files, the JSON log
  formatter and `make_output` in its three modes give equal results and
  equal exceptions (type, message, exit code and stderr) in both packages.
- The federated paths without a running shard: every `hq fleet`
  subcommand, `hq top`, `job list`, `worker start` and `journal stream`
  on a federation root or a plain directory answer as the JAX CLI does;
  `hq server start --shards/--standby` without CUDA exits non-zero
  saying so and writes nothing (no host fallback), and a
  `--failover-watch` shard on the CPU holds its lease until `server
  stop`. Without CUDA the default `hq server start` exits non-zero and
  serves nothing.
- Imports: a `hq worker start` process and client processes of the port
  (`submit`, `job info` with pending reasons, `task explain`, `top`,
  `journal report`, `dashboard --replay`) load neither torch, numpy,
  msgpack, jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import subprocess
import sys
import types

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from hyperqueue_tpu.client import cli as jax_cli
from hyperqueue_tpu.client import directives as jax_directives
from hyperqueue_tpu.client import jobfile as jax_jobfile
from hyperqueue_tpu.client import output as jax_output
from hyperqueue_tpu.utils import logfmt as jax_logfmt
from hyperqueue_tpu.utils import serverdir as jax_serverdir
from hyperqueue_tpu_torch.client import cli as port_cli
from hyperqueue_tpu_torch.client import directives as port_directives
from hyperqueue_tpu_torch.client import jobfile as port_jobfile
from hyperqueue_tpu_torch.client import output as port_output
from hyperqueue_tpu_torch.utils import logfmt as port_logfmt
from test_torch_cli_e2e import (
    PortCliEnv,
    port_env_base,
    run_port_cli_inprocess,
)
from utils_e2e import _run_cli_inprocess, wait_until

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

SETTINGS = settings(max_examples=150, deadline=None)


def outcome(fn, *args, **kwargs):
    """What a call gives: its result (generators listed) or its exception
    (type name and message, or exit code), with what it printed."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = fn(*args, **kwargs)
            if isinstance(result, types.GeneratorType):
                result = list(result)
        return ("ok", result, out.getvalue(), err.getvalue())
    except SystemExit as e:
        return ("exit", e.code, out.getvalue(), err.getvalue())
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return (type(e).__name__, str(e), out.getvalue(), err.getvalue())


def same(jax_fn, port_fn, *args, **kwargs):
    a = outcome(jax_fn, *args, **kwargs)
    b = outcome(port_fn, *args, **kwargs)
    # repr: a NaN result equals itself
    assert repr(a) == repr(b), (args, kwargs, a, b)
    return a


# --- parser parity -----------------------------------------------------------
def parser_tree(parser, path=()) -> dict:
    """Every action of the parser tree by (subcommand path, dest, option
    strings): choices, default, nargs, type, action class, required."""
    out = {path + ("<defaults>",): sorted(parser._defaults)}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out[path + ("<sub>", a.dest)] = (sorted(a.choices), a.required)
            for name, sub in a.choices.items():
                out.update(parser_tree(sub, path + (name,)))
            continue
        out[path + (a.dest, tuple(a.option_strings))] = (
            None if a.choices is None else list(a.choices), repr(a.default),
            a.nargs, getattr(a.type, "__name__", repr(a.type)),
            type(a).__name__, a.required, repr(a.const))
    return out


def test_parser_trees_are_equal():
    jax_tree = parser_tree(jax_cli.build_parser())
    port_tree = parser_tree(port_cli.build_parser())
    assert sorted(jax_tree) == sorted(port_tree)
    diff = {k: (jax_tree[k], port_tree[k]) for k in jax_tree
            if jax_tree[k] != port_tree[k]}
    assert not diff, diff
    # every leaf subcommand has a handler of the port's
    leaves = [k[:-1] for k in port_tree if k[-1] == "<defaults>"
              and k[:-1] + ("<sub>",) not in {q[:len(k)] for q in port_tree}]
    assert len(leaves) > 60
    assert all("fn" in port_tree[leaf + ("<defaults>",)] for leaf in leaves)


def _cli_stdout(main, args, capsys):
    try:
        main(args)
        code = 0
    except SystemExit as e:
        code = e.code
    captured = capsys.readouterr()
    return code, captured.out, captured.err


@pytest.mark.parametrize("shell", ["bash", "zsh", "fish"])
def test_generate_completion_is_the_jax_clis(shell, capsys):
    jax_out = _cli_stdout(jax_cli.main, ["generate-completion", shell],
                          capsys)
    port_out = _cli_stdout(port_cli.main, ["generate-completion", shell],
                           capsys)
    assert port_out[0] == jax_out[0] == 0
    # the script completes the port's `python -m` where the JAX one
    # completes the JAX package's
    assert port_out[1].replace("hyperqueue_tpu_torch", "hyperqueue_tpu") \
        == jax_out[1]
    assert "complete" in port_out[1]


@pytest.mark.parametrize("topic", [None, "no-such-topic"])
def test_doc_gives_the_same_topics(topic, capsys):
    args = ["doc"] + ([topic] if topic else [])
    jax_out = _cli_stdout(jax_cli.main, args, capsys)
    port_out = _cli_stdout(port_cli.main, args, capsys)
    assert port_out == jax_out
    if topic:
        assert port_out[0] == 1 and "available:" in port_out[2]


# --- pure helpers --------------------------------------------------------------
SELECTOR_TEXT = st.one_of(
    st.sampled_from(["all", "last", "1", "1-3,7", "1-1000_000",
                     "1-9:2", "5_", "_5", "3-1", "1-5:0", ",", ""]),
    st.text(alphabet="0123456789-,:_ al", max_size=14),
)


@SETTINGS
@given(text=SELECTOR_TEXT, last=st.one_of(st.none(), st.integers(1, 99)))
def test_parse_selector(text, last):
    kind = same(jax_cli.parse_selector, port_cli.parse_selector, text,
                last)[0]
    assert kind in ("ok", "exit")


DURATION_TEXT = st.one_of(
    st.sampled_from(["90", "1.5h", "10min", "1h30m", "01:30:00", "2:05",
                     "500ms", "abc", "10parsecs", "1:2:3:4", "-5", " 7s ",
                     "3 days", "1e3", "nan"]),
    st.text(alphabet="0123456789.:hmsdayin -", max_size=10),
)


@SETTINGS
@given(text=DURATION_TEXT)
def test_parse_duration(text):
    same(jax_cli._parse_duration, port_cli._parse_duration, text)


NUMBER_TEXT = st.one_of(
    st.sampled_from(["never-restart", "unlimited", "0", "-1", "7", "0.5",
                     "1.0", "1.5", "sometimes", "inf", "-0.0"]),
    st.text(alphabet="0123456789.-e", max_size=6),
)


@SETTINGS
@given(text=NUMBER_TEXT)
def test_parse_crash_limit_weight_min_utilization(text):
    for name in ("_parse_crash_limit", "_parse_weight",
                 "_parse_min_utilization"):
        same(getattr(jax_cli, name), getattr(port_cli, name), text)


@SETTINGS
@given(ids=st.lists(st.integers(0, 60), max_size=25, unique=True))
def test_format_id_ranges(ids):
    same(jax_cli._format_id_ranges, port_cli._format_id_ranges, ids)


AMOUNT = st.one_of(st.sampled_from(["1", "0.5", "all", "2.25", "x", "-1",
                                    "", "1/2", "0.0001", "3.00001"]),
                   st.text(alphabet="0123456789.", max_size=5))


@SETTINGS
@given(cpus=st.one_of(st.none(), AMOUNT),
       resources=st.lists(st.tuples(st.sampled_from(["gpus", "mem", "x"]),
                                    st.sampled_from(["=", ""]), AMOUNT),
                          max_size=3),
       nodes=st.one_of(st.none(), st.integers(0, 4)),
       time_request=st.one_of(st.none(), st.floats(0, 100)),
       weight=st.one_of(st.none(), st.floats(0.1, 10)))
def test_build_request(cpus, resources, nodes, time_request, weight):
    args = argparse.Namespace(
        cpus=cpus, resource_request=[n + s + a for n, s, a in resources],
        nodes=nodes, time_request=time_request, weight=weight)
    same(jax_cli._build_request, port_cli._build_request, args)


@SETTINGS
@given(ids=st.one_of(st.none(), st.lists(st.integers(-3, 30), max_size=12)),
       entries=st.lists(st.text(max_size=4), max_size=20))
def test_subset_array_entries(ids, entries):
    same(jax_cli._subset_array_entries, port_cli._subset_array_entries,
         ids, entries)


@SETTINGS
@given(ids=st.lists(st.integers(0, 200), min_size=1, max_size=60,
                    unique=True),
       with_entries=st.booleans(), chunk=st.integers(1, 70))
def test_iter_array_chunks(ids, with_entries, chunk):
    ids = sorted(ids)
    array = {"ids": ids, "body": {"cmd": ["true"]}, "priority": 1}
    if with_entries:
        array["entries"] = [f"e{i}" for i in ids]
    same(jax_cli._iter_array_chunks, port_cli._iter_array_chunks, array,
         chunk)


@SETTINGS
@given(lines=st.lists(st.text(alphabet="ab c\n", max_size=6), max_size=40),
       chunk=st.integers(1, 12))
def test_iter_stdin_chunks(lines, chunk):
    same(lambda: jax_cli._iter_stdin_chunks({"b": 1}, chunk, iter(lines)),
         lambda: port_cli._iter_stdin_chunks({"b": 1}, chunk, iter(lines)))


DIRECTIVE_LINES = st.lists(st.sampled_from([
    "#!/bin/bash", "#HQ --name x", "#HQ --cpus 2 --priority=1", "#HQ",
    "#HQX --bad", "# plain comment", "", "echo hi", "#HQ --env 'A=B C'",
    "#HQ --unbalanced 'quote", "  #HQ --time-limit 10m"]), max_size=8)


@SETTINGS
@given(lines=DIRECTIVE_LINES)
def test_directives(lines, tmp_path_factory):
    text = "\n".join(lines) + "\n"
    same(jax_directives.parse_directives_text,
         port_directives.parse_directives_text, text)
    path = tmp_path_factory.mktemp("d") / "job.sh"
    path.write_text(text)
    same(jax_directives.parse_directives, port_directives.parse_directives,
         str(path))
    for mode in ("off", "file", "auto"):
        for p in (str(path), str(path) + ".missing", "x.py"):
            same(jax_directives.should_parse, port_directives.should_parse,
                 p, mode)


TASK = st.fixed_dictionaries({
    "id": st.integers(0, 6),
    "command": st.one_of(st.just(["echo", "x"]), st.just([]),
                         st.just("notalist")),
    "deps": st.lists(st.integers(0, 6), max_size=2),
    "priority": st.integers(-2, 2),
    "crash_limit": st.sampled_from([5, 0, "never-restart", "unlimited",
                                    -3]),
    "resources": st.dictionaries(st.sampled_from(["cpus", "gpus", "mem"]),
                                 st.sampled_from(["1", "0.5", "all", "x"]),
                                 max_size=2),
})


def _toml(tasks, name):
    out = [] if name is None else [f'name = "{name}"', "max_fails = 2"]
    for t in tasks:
        out += ["[[task]]", f"id = {t['id']}",
                f"command = {json.dumps(t['command'])}",
                f"deps = {json.dumps(t['deps'])}",
                f"priority = {t['priority']}",
                f"crash_limit = {json.dumps(t['crash_limit'])}"]
        if t["resources"]:
            res = ", ".join(f'"{k}" = "{v}"'
                            for k, v in t["resources"].items())
            out += ["[[task.request]]", f"resources = {{ {res} }}",
                    "time_request = 1.5"]
    return "\n".join(out) + "\n"


@SETTINGS
@given(tasks=st.lists(TASK, max_size=4),
       name=st.one_of(st.none(), st.sampled_from(["g", "graph"])))
def test_job_files(tasks, name, tmp_path_factory):
    path = tmp_path_factory.mktemp("j") / "job.toml"
    path.write_text(_toml(tasks, name))
    same(jax_jobfile.load_job_file, port_jobfile.load_job_file, path,
         "/submit")


@SETTINGS
@given(msg=st.text(max_size=20), level=st.sampled_from(
    [logging.INFO, logging.WARNING, logging.ERROR]),
    extra=st.dictionaries(st.sampled_from(["tick", "job", "task", "worker",
                                           "instance", "reason", "other"]),
                          st.one_of(st.integers(), st.text(max_size=5),
                                    st.none()), max_size=4))
def test_json_log_formatter(msg, level, extra):
    record = logging.LogRecord("hq.test", level, __file__, 1, msg, None,
                               None)
    record.__dict__.update(extra)
    assert jax_logfmt.JsonLogFormatter().format(record) \
        == port_logfmt.JsonLogFormatter().format(record)


@pytest.mark.parametrize("log_format", [None, "plain", "json", "xml"])
def test_setup_logging(log_format, monkeypatch):
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        got = []
        for mod in (jax_logfmt, port_logfmt):
            result = outcome(mod.setup_logging, log_format, "warning")
            handler = result[1] if result[0] == "ok" else None
            got.append((result[0], type(getattr(handler, "formatter",
                                                None)).__name__,
                        logging.getLogger().level))
        assert got[0] == got[1]
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


CELL = st.one_of(st.integers(-5, 500), st.text(max_size=6), st.none(),
                 st.floats(allow_nan=False, width=32))


@SETTINGS
@given(mode=st.sampled_from(["cli", "json", "quiet"]),
       header=st.sampled_from([["id", "status", "name"], ["job", "task"],
                               ["key", "value"], ["id"]]),
       rows=st.lists(st.lists(CELL, min_size=3, max_size=3), max_size=4),
       record=st.dictionaries(st.text(max_size=4), CELL, max_size=3),
       text=st.text(max_size=10), value=st.one_of(CELL, st.lists(CELL)))
def test_make_output(mode, header, rows, record, text, value):
    rows = [row[:len(header)] for row in rows]
    for call in (lambda o: o.table(header, rows), lambda o: o.record(record),
                 lambda o: o.message(text), lambda o: o.value(value)):
        same(lambda: call(jax_output.make_output(mode)),
             lambda: call(port_output.make_output(mode)))
    same(jax_output.fail, port_output.fail, text)


# --- refusals ---------------------------------------------------------------
FLEET = [["fleet", "metrics-proxy"], ["fleet", "trace-export", "t.json"],
         ["fleet", "status"], ["fleet", "migrate", "1", "0"],
         ["fleet", "accounting"], ["fleet", "profile"]]


@pytest.mark.parametrize("args", [
    ["server", "start", "--shards", "2"],
    ["server", "start", "--shards", "1", "--shard-id", "0"],
    ["server", "start", "--standby"],
    ["server", "start", "--failover-watch", "--scheduler", "cpu"],
    *FLEET,
], ids=lambda a: " ".join(a))
def test_federated_paths_refuse_naming_item_10(args, tmp_path, monkeypatch):
    """Until the federation was ported, each of these exited 1 naming
    ROADMAP item 10. Now: a shard or a standby solves on the card, so
    without CUDA it exits 1 saying so before it writes anything (it never
    falls back to the host); a `--failover-watch` shard on the CPU takes
    its lease and releases it at `server stop`; and each `hq fleet`
    subcommand answers as the JAX CLI's does, on a federation root with
    no shard running and on a plain directory."""
    if args[0] == "server" and "cpu" not in args:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        result = run_port_cli_inprocess(args, tmp_path / "server",
                                        tmp_path, 60)
        assert result.returncode == 1, result.stdout
        assert "CUDA" in result.stderr and "--scheduler cpu" in \
            result.stderr, result.stderr
        assert not (tmp_path / "server").exists()
        # a shard with its own journal is a usage error, answered before
        # the device (and so torch) is asked for
        result = run_port_cli_inprocess([*args, "--journal", "j.bin"],
                                        tmp_path / "server", tmp_path, 60)
        if "--standby" not in args:
            assert result.returncode == 1
            assert "--journal cannot be combined with --shards" in \
                result.stderr, result.stderr
        return
    if args[0] == "server":
        root = tmp_path / "root"
        shard = subprocess.Popen(
            [sys.executable, "-m", "hyperqueue_tpu_torch", *args,
             "--server-dir", str(root), "--shards", "2", "--shard-id", "1",
             "--lease-timeout", "2"],
            env=port_env_base(), stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        try:
            lease = root / "shard-0001" / "lease.json"
            wait_until(lambda: (root / "shard-0001" / "hq-current").exists()
                       and lease.exists(), timeout=60,
                       message="the shard's access record and lease")
            assert json.loads(lease.read_text())["epoch"] == 1
            assert json.loads((root / "federation.json").read_text())[
                "shard_count"] == 2
            stop = run_port_cli_inprocess(
                ["server", "stop"], root / "shard-0001", tmp_path, 60)
            assert stop.returncode == 0, stop.stderr
            assert shard.wait(timeout=30) == 0
        finally:
            if shard.poll() is None:
                shard.kill()
                shard.wait()
        assert not lease.exists()  # a clean stop retires the lease
        return
    if args[1] == "metrics-proxy":
        # an ephemeral port: the default 9090 may be taken here
        args = [*args, "--port", "0", "--host", "127.0.0.1"]
    answers = {}
    for name, run in (("jax", _run_cli_inprocess),
                      ("port", run_port_cli_inprocess)):
        root = tmp_path / name / "root"
        root.mkdir(parents=True)
        jax_serverdir.write_federation(root, 2)
        plain = tmp_path / name / "plain"
        outs = []
        for where in (plain, root):
            if where is root and args[1] == "metrics-proxy":
                continue  # serves until stopped
            r = run(args, where, tmp_path / name, 60)
            outs.append((r.returncode, r.stdout.replace(str(tmp_path / name),
                                                        "T"),
                         r.stderr.replace(str(tmp_path / name), "T")))
        answers[name] = outs
    assert answers["port"] == answers["jax"]
    assert answers["port"][0][0] == 1  # a plain dir is no federation root


def test_top_and_session_on_a_federation_root_refuse(tmp_path):
    """Until the federation was ported, these refused naming item 10 on a
    federation root. Now, on a root with no shard running, `hq top` shows
    every shard DOWN, `job list` and `worker start` name the shard whose
    server is missing and `journal stream` (shard 0's) ends at once, as
    in the JAX CLI."""
    answers = {}
    for name, run in (("jax", _run_cli_inprocess),
                      ("port", run_port_cli_inprocess)):
        root = tmp_path / name / "root"
        root.mkdir(parents=True)
        jax_serverdir.write_federation(root, 2)
        outs = []
        for args in (["top", "--once", "--output-mode", "json"],
                     ["job", "list"], ["journal", "stream"]):
            r = run(args, root, tmp_path, 60)
            # the fleet view's shards arrive in either order
            out = json.loads(r.stdout) if args[0] == "top" else r.stdout
            outs.append((r.returncode, out,
                         r.stderr.replace(str(root), "ROOT")))
        # a worker picks its shard at random: either one's is named
        r = run(["worker", "start", "--cpus", "1"], root, tmp_path, 60)
        assert r.returncode == 1
        assert "no running server found in " + str(root / "shard-000") \
            in r.stderr, r.stderr
        answers[name] = outs
    assert answers["port"] == answers["jax"]
    top, job_list, stream = answers["port"]
    assert top[1] == {"shards": {"0": None, "1": None}}
    assert job_list[0] == 1 and "ROOT/shard-0000" in job_list[2]
    assert stream[0] == 0


def test_default_server_start_refuses_without_cuda(tmp_path, monkeypatch):
    """No card and no `--scheduler cpu`: the default `hq server start`
    (and `--scheduler tpu`) exits non-zero saying so, and never serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--scheduler", "tpu"], ["--scheduler", "multichip"]):
        result = run_port_cli_inprocess(
            ["server", "start", *extra], tmp_path / "server", tmp_path, 60)
        assert result.returncode == 1
        assert "CUDA" in result.stderr and "--scheduler cpu" in \
            result.stderr, result.stderr
        assert not (tmp_path / "server").exists()


# --- imports of a client and a worker process -----------------------------
def test_client_and_worker_processes_load_no_torch_numpy_or_jax(tmp_path):
    """A port worker and the port's client commands (a submit, a job with
    pending reasons, an explain, `top`, a journal report and a dashboard
    replay) run as processes of their own that load neither torch, numpy,
    msgpack, jax nor the JAX package, and run the native codec."""
    journal = tmp_path / "journal.bin"
    commands = [
        ["submit", "--wait", "--", "true"],
        ["submit", "--cpus", "64", "--", "true"],
        ["job", "info", "2"],
        ["task", "explain", "2.0"],
        ["top", "--once", "--output-mode", "json"],
        ["journal", "report", str(journal), "--output",
         str(tmp_path / "report.html")],
        ["dashboard", "--replay", str(journal)],
    ]
    with PortCliEnv(tmp_path) as env:
        env.start_server("--journal", str(journal))
        environ = {**port_env_base(), "HQ_SERVER_DIR": str(env.server_dir)}

        def launch(n, args):
            return [sys.executable, "-c", chip_smoke.CLI_LAUNCHER,
                    str(tmp_path / f"report-{n}.json"), *args]

        worker = subprocess.Popen(launch("worker", ["worker", "start",
                                                    "--cpus", "1"]),
                                  env=environ, cwd=env.work_dir)
        try:
            env.wait_workers(1)
            for n, args in enumerate(commands):
                done = subprocess.run(launch(n, args), env=environ,
                                      cwd=env.work_dir, capture_output=True,
                                      text=True, timeout=60)
                assert done.returncode == 0, (args, done.stderr)
            assert "pending" in env.command(["job", "info", "2"])
            env.command(["server", "stop"])
            assert worker.wait(timeout=30) == 0
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
    for name in ["worker", *range(len(commands))]:
        report = json.loads((tmp_path / f"report-{name}.json").read_text())
        assert report["foreign"] == [], (name, report)
        assert report["codec"] == "native", (name, report)
