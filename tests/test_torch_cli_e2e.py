"""The JAX package's e2e scenarios, run unchanged against the port's own
server, worker and command line, on the CPU.

`PortCliEnv` is `tests/utils_e2e.HqEnv` with the port in every role: its
server and workers are `python -m hyperqueue_tpu_torch` processes (the
server with `--scheduler cpu` and `OMP_NUM_THREADS=1`), and its client
commands run the port's `client/cli.main` in-process (a copy of
`utils_e2e._run_cli_inprocess` over the port's CLI).

`run_scenario` calls one test function of a JAX test module with the
port in place of the JAX package for the length of the call: `HqEnv`
becomes `PortCliEnv`, every function or class the module imported from
`hyperqueue_tpu` becomes the port's of the same name, and every
`hyperqueue_tpu` module the function imports in its body reads as the
port's. Steps that spawn `python -m hyperqueue_tpu` themselves stay the
JAX CLI's; the files that run such scenarios add a port twin of the step.

This file runs every scenario of tests/test_e2e.py. The other scenario
modules run from tests/test_torch_cli_features.py, test_torch_cli_jobs.py,
test_torch_cli_output.py, test_torch_cli_ingest.py and test_torch_api.py.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import io
import os
import subprocess
import sys
import textwrap
import threading
import traceback
from pathlib import Path

import pytest
import torch

import test_e2e as jax_e2e
from utils_e2e import HqEnv, _env_base

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)


class _CliResult:
    """subprocess.run-shaped result of an in-process command."""

    __slots__ = ("returncode", "stdout", "stderr")

    def __init__(self, returncode: int, stdout: str, stderr: str):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr


def _capture_stream():
    raw = io.BytesIO()
    wrapper = io.TextIOWrapper(raw, encoding="utf-8", errors="replace",
                               write_through=True)
    return raw, wrapper


def run_port_cli_inprocess(args: list[str], server_dir: Path, cwd,
                           timeout: float) -> _CliResult:
    """The port's `cli.main(args)` in a worker thread with captured stdio,
    cwd and HQ_SERVER_DIR (utils_e2e._run_cli_inprocess over the port's
    CLI: a hung command's thread never restores the process-wide state
    after the caller gave up on it)."""
    out_raw, out = _capture_stream()
    err_raw, err = _capture_stream()
    result: dict = {}
    abandoned = threading.Event()
    restore_lock = threading.Lock()
    old_cwd = os.getcwd()
    old_sd = os.environ.get("HQ_SERVER_DIR")
    old_out, old_err = sys.stdout, sys.stderr

    def restore() -> None:
        sys.stdout, sys.stderr = old_out, old_err
        os.chdir(old_cwd)
        if old_sd is None:
            os.environ.pop("HQ_SERVER_DIR", None)
        else:
            os.environ["HQ_SERVER_DIR"] = old_sd

    def body() -> None:
        from hyperqueue_tpu_torch.client.cli import main as cli_main

        os.environ["HQ_SERVER_DIR"] = str(server_dir)
        os.chdir(str(cwd))
        sys.stdout, sys.stderr = out, err
        try:
            try:
                cli_main([str(a) for a in args])
                result["rc"] = 0
            except SystemExit as e:
                if isinstance(e.code, int) or e.code is None:
                    result["rc"] = e.code or 0
                else:
                    err.write(f"{e.code}\n")
                    result["rc"] = 2
            except BaseException:  # noqa: BLE001 - a crash's rc
                traceback.print_exc(file=err)
                result["rc"] = 1
        finally:
            with restore_lock:
                if not abandoned.is_set():
                    restore()

    t = threading.Thread(target=body, daemon=True, name="hq-port-cli")
    t.start()
    t.join(timeout)
    if t.is_alive():
        with restore_lock:
            abandoned.set()
            restore()
        raise subprocess.TimeoutExpired(cmd=args, timeout=timeout)
    out.flush()
    err.flush()
    return _CliResult(result.get("rc", 1),
                      out_raw.getvalue().decode("utf-8", "replace"),
                      err_raw.getvalue().decode("utf-8", "replace"))


def port_env_base() -> dict:
    """A port process's environment: the e2e base and one OpenMP thread
    (torch's default of a thread per core starves the suite's other
    processes)."""
    return {**_env_base(), "OMP_NUM_THREADS": "1"}


class PortCliEnv(HqEnv):
    """HqEnv whose server, workers and commands are the port's."""

    def _spawn(self, name: str, args: list[str], cwd=None,
               env_extra=None) -> subprocess.Popen:
        log = open(self.tmp / f"{name}.log", "wb")
        process = subprocess.Popen(
            [sys.executable, "-m", "hyperqueue_tpu_torch", *args],
            env={**port_env_base(), **(env_extra or {})},
            cwd=cwd or self.work_dir, stdout=log, stderr=subprocess.STDOUT,
        )
        self.processes.append((name, process))
        return process

    def start_server(self, *extra: str, env_extra=None) -> subprocess.Popen:
        # a scenario's own flags come after, so they win
        return super().start_server("--scheduler", "cpu", *extra,
                                    env_extra=env_extra)

    def start_shard(self, shard_id: int, shard_count: int, *extra: str,
                    env_extra=None) -> str:
        return super().start_shard(shard_id, shard_count, "--scheduler",
                                   "cpu", *extra, env_extra=env_extra)

    def start_standby(self, *extra: str, env_extra=None) -> str:
        # a promoted successor solves where the standby's flags say
        return super().start_standby("--scheduler", "cpu", *extra,
                                     env_extra=env_extra)

    def command(self, args: list[str], cwd=None, expect_fail=False,
                timeout=60.0, with_stderr=False) -> str:
        result = run_port_cli_inprocess(args, self.server_dir,
                                        cwd or self.work_dir, timeout)
        if expect_fail:
            assert result.returncode != 0, (
                f"expected failure, got: {result.stdout}")
        else:
            assert result.returncode == 0, (
                f"command {args} failed:\n{result.stdout}\n{result.stderr}")
        if with_stderr:
            return result.stdout + result.stderr
        return result.stdout


def scenarios(module, skip: dict | None = None) -> list:
    """pytest params of the module's test functions, by name; `skip` maps
    the names left out to their reasons (kept beside the call)."""
    skip = skip or {}
    return [pytest.param(fn, id=name) for name, fn in vars(module).items()
            if name.startswith("test_") and inspect.isfunction(fn)
            and fn.__module__ == module.__name__ and name not in skip]


def _port_name(name: str) -> str:
    return "hyperqueue_tpu_torch" + name[len("hyperqueue_tpu"):]


def _body_imports(fn) -> set[str]:
    """The `hyperqueue_tpu` modules `fn` imports in its own body."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "hyperqueue_tpu":
            found.add(node.module)
        elif isinstance(node, ast.Import):
            found.update(a.name for a in node.names
                         if a.name.split(".")[0] == "hyperqueue_tpu")
    return found


def use_port(module, fn, monkeypatch) -> None:
    """For the length of the test: the module's HqEnv is PortCliEnv, its
    JAX functions and classes are the port's, and the JAX modules `fn`
    imports in its body resolve to the port's."""
    if hasattr(module, "HqEnv"):
        monkeypatch.setattr(module, "HqEnv", PortCliEnv)
    for name, value in list(vars(module).items()):
        owner = getattr(value, "__module__", None) or ""
        if owner.split(".")[0] == "hyperqueue_tpu" and (
                inspect.isfunction(value) or inspect.isclass(value)):
            port = importlib.import_module(_port_name(owner))
            monkeypatch.setattr(module, name,
                                getattr(port, value.__qualname__))
    for name in _body_imports(fn):
        monkeypatch.setitem(sys.modules, name,
                            importlib.import_module(_port_name(name)))


def run_scenario(module, fn, tmp_path, monkeypatch, **fixtures) -> None:
    """Calls `fn` of the JAX test `module` with the port in place of the
    JAX package; `env` (a PortCliEnv over tmp_path), `tmp_path` and
    `monkeypatch` are given where it asks for them, and `fixtures` beside
    them."""
    use_port(module, fn, monkeypatch)
    params = inspect.signature(fn).parameters
    with PortCliEnv(tmp_path) as env:
        given = {"env": env, "tmp_path": tmp_path,
                 "monkeypatch": monkeypatch, **fixtures}
        missing = set(params) - set(given)
        assert not missing, f"{fn.__name__} asks for {missing}"
        fn(**{name: given[name] for name in params})


@pytest.mark.parametrize("scenario", scenarios(jax_e2e))
def test_e2e_scenario_on_the_port(scenario, tmp_path, monkeypatch):
    run_scenario(jax_e2e, scenario, tmp_path, monkeypatch)


def test_port_cli_env_runs_only_the_port(tmp_path):
    """The env's server and worker are the port's processes, and a
    command runs the port's CLI."""
    with PortCliEnv(tmp_path) as env:
        env.start_server()
        env.start_worker(cpus=1)
        env.wait_workers(1)
        argvs = [p.args for _n, p in env.processes]
        assert all(a[1:3] == ["-m", "hyperqueue_tpu_torch"] for a in argvs)
        assert "--scheduler" in argvs[0] and "cpu" in argvs[0]
        info = env.command(["server", "info", "--output-mode", "json"])
        assert '"scheduler": "cpu"' in info
        env.command(["server", "stop"])
        assert dict(env.processes)["server"].wait(timeout=20) == 0
