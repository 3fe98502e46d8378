"""The port's `Server.start()` against the JAX package's, on the CPU.

In one asyncio loop on 127.0.0.1, the JAX `Server` and then the port's
`Server(device="cpu")` each `start()` on port 0, under one installed clock
(a fixed one, moved by hand) and fixed uid, key and trace-id sources. The
same scripted workers and client, speaking the wire through a package's
`transport/auth`, run the same scenario against both:

- two arrays are submitted over the client plane, a small one and a lazy
  one over `lazy_array_threshold`; a 4-cpu worker registers, the scheduler
  loop ticks, the worker answers every compute entry (running, finished);
- a job no worker can run is paused, resumed, explained and cancelled;
- a second worker takes part of a third array and drops its connection:
  its tasks requeue onto the first;
- a silent worker is dropped by the heartbeat reaper (the clock moves);
- an allocation queue is listed, added, listed, removed and listed (the
  same answers from both);
- the federation's RPCs on a standalone server: a worker lend refuses
  (not a federated server), a live export of the first job seals it and
  journals its `migration-out`, a malformed import and the finalize of an
  unknown job answer as the JAX server's do;
- `stop_server` stops the server and every thread it started.

The `registered` frames (minus the uid), every compute entry, the RPC
answers, the keys of `server_stats` and the journal files must be equal
between the packages. The variants cover the ingest thread and the in-loop
client plane, the fan-out pool and `fanout_senders=0`; one more case has
the JAX package's transport (its worker and client side) talk to the
port's server.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import itertools
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from hyperqueue_tpu.server import bootstrap as jax_bootstrap
from hyperqueue_tpu.transport import auth as jax_auth
from hyperqueue_tpu.transport import framing as jax_framing
from hyperqueue_tpu.utils import clock as jax_clock
from hyperqueue_tpu.utils import serverdir as jax_serverdir
from hyperqueue_tpu.utils import trace as jax_trace
from hyperqueue_tpu_torch.resources import descriptor as port_descriptor
from hyperqueue_tpu_torch.server import bootstrap as port_bootstrap
from hyperqueue_tpu_torch.server import worker as port_worker
from hyperqueue_tpu_torch.transport import auth as port_auth
from hyperqueue_tpu_torch.transport import framing as port_framing
from hyperqueue_tpu_torch.utils import clock as port_clock
from hyperqueue_tpu_torch.utils import serverdir as port_serverdir
from hyperqueue_tpu_torch.utils import trace as port_trace

# one intra-op thread per process: the suite runs in several worker
# processes at once
torch.set_num_threads(1)

# how long one scenario (one server's life) may take before it fails
SCENARIO_TIMEOUT_S = 60.0
# how long a scripted peer waits for one expected frame or state
WAIT_S = 20.0

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", bootstrap=jax_bootstrap, clock=jax_clock,
        serverdir=jax_serverdir, trace=jax_trace, auth=jax_auth,
        framing=jax_framing,
        server=lambda **kw: jax_bootstrap.Server(**kw)),
    "port": types.SimpleNamespace(
        name="port", bootstrap=port_bootstrap, clock=port_clock,
        serverdir=port_serverdir, trace=port_trace, auth=port_auth,
        framing=port_framing,
        server=lambda **kw: port_bootstrap.Server(device="cpu", **kw)),
}


# ---------------------------------------------------------------------------
# process state a started server changes, and the seams made deterministic
# ---------------------------------------------------------------------------
class ManualClock:
    """A clock that stands still until the test moves it."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _counting_tokens(prefix: int):
    counter = itertools.count()

    def source(nbytes: int) -> str:
        return f"{prefix:02x}{next(counter):0{2 * nbytes - 2}x}"
    return source


@contextlib.contextmanager
def server_process_state(fixed: bool = True):
    """Save and restore what `Server.start()` changes in the whole
    process: the GC thresholds and its freeze. With `fixed`, also install
    one `ManualClock` in both packages and counting uid/key and trace-id
    sources (the same sequence in each package), and restore them after."""
    thresholds = gc.get_threshold()
    clock = ManualClock() if fixed else None
    saved = []
    try:
        if fixed:
            for pkg in PKGS.values():
                saved.append((
                    pkg,
                    pkg.clock.install(clock),
                    pkg.serverdir.set_token_source(_counting_tokens(1)),
                    pkg.trace.set_token_source(_counting_tokens(2)),
                ))
        yield clock
    finally:
        for pkg, prev_clock, prev_dir, prev_trace in saved:
            pkg.clock.install(prev_clock)
            pkg.serverdir.set_token_source(prev_dir)
            pkg.trace.set_token_source(prev_trace)
        gc.unfreeze()
        gc.set_threshold(*thresholds)


def reset_token_sources() -> None:
    """Restart both packages' counting sources (one server's life each)."""
    for pkg in PKGS.values():
        pkg.serverdir.set_token_source(_counting_tokens(1))
        pkg.trace.set_token_source(_counting_tokens(2))


async def wait_threads_gone(before: set, parked=(),
                            timeout: float = 10.0) -> list:
    """The threads started since `before` that are still alive once only
    threads named in `parked` are left, or after `timeout` (empty once
    the server's threads have all stopped)."""
    deadline = time.monotonic() + timeout
    while True:
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
        if all(t.name in parked for t in left) \
                or time.monotonic() > deadline:
            return left
        await asyncio.sleep(0.05)


# ---------------------------------------------------------------------------
# scripted peers
# ---------------------------------------------------------------------------
def worker_config(cpus: int, hostname: str = "w",
                  heartbeat_secs: float = 8.0) -> dict:
    desc = port_descriptor.ResourceDescriptor(items=(
        port_descriptor.ResourceDescriptorItem.sum("cpus", cpus * 10_000),
    ))
    return port_worker.WorkerConfiguration(
        descriptor=desc, hostname=hostname, heartbeat_secs=heartbeat_secs,
    ).to_wire()


class ScriptedWorker:
    """A worker speaking the wire through `peer`'s transport: registers,
    collects every compute entry (with its body resolved), keeps every
    other downlink message, and answers entries on demand — or, with
    `auto` set, answers every new entry (running, finished) in one frame
    as soon as the frame that brought it is read."""

    def __init__(self, peer, access, config: dict):
        self.peer = peer
        self.access = access
        self.config = config
        self.entries: list[dict] = []
        self.others: list[dict] = []
        self.changed = asyncio.Event()
        self.conn = None
        self.registered = None
        self._reader = None
        self.auto = False
        self.answered = 0

    async def connect(self) -> dict:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", self.access.worker_port)
        auth = self.peer.auth
        self.conn = await auth.do_authentication(
            reader, writer, auth.ROLE_WORKER, auth.ROLE_SERVER,
            self.access.worker_key_bytes())
        await self.conn.send({"op": "register", "config": self.config})
        self.registered = await self.conn.recv()
        self._reader = asyncio.ensure_future(self._read())
        return self.registered

    async def _read(self) -> None:
        try:
            while True:
                frame = await self.conn.recv()
                msgs = frame["msgs"] if frame.get("op") == "batch" \
                    else [frame]
                for msg in msgs:
                    if msg.get("op") == "compute":
                        bodies = msg["shared_bodies"]
                        for entry in msg["tasks"]:
                            self.entries.append(
                                {**entry, "body": bodies[entry["b"]]})
                    else:
                        self.others.append(msg)
                if self.auto and self.answered < len(self.entries):
                    await self.answer(self.entries[self.answered:])
                self.changed.set()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.changed.set()

    async def wait_for(self, predicate, what: str) -> None:
        deadline = time.monotonic() + WAIT_S
        while not predicate():
            self.changed.clear()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"worker waited for {what}")
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self.changed.wait(), min(left, 0.2))

    async def answer(self, entries, finish: bool = True) -> None:
        msgs = []
        for e in entries:
            msgs.append({"op": "task_running", "id": e["id"],
                         "instance": e["instance"]})
            if finish:
                msgs.append({"op": "task_finished", "id": e["id"],
                             "instance": e["instance"]})
        self.answered += len(entries)
        await self.conn.send({"op": "batch", "msgs": msgs})

    async def start_answering(self) -> None:
        """Answer what has come so far, then every entry as it comes."""
        self.auto = True
        if self.answered < len(self.entries):
            await self.answer(self.entries[self.answered:])

    async def send(self, msg: dict) -> None:
        await self.conn.send(msg)

    async def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()
            with contextlib.suppress(BaseException):
                await self._reader
        if self.conn is not None:
            self.conn.close()
            await self.conn.wait_closed()


class ScriptedClient:
    def __init__(self, peer, access):
        self.peer = peer
        self.access = access
        self.conn = None

    async def connect(self) -> None:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", self.access.client_port)
        auth = self.peer.auth
        self.conn = await auth.do_authentication(
            reader, writer, auth.ROLE_CLIENT, auth.ROLE_SERVER,
            self.access.client_key_bytes())

    async def request(self, msg: dict) -> dict:
        await self.conn.send(msg)
        return await asyncio.wait_for(self.conn.recv(), WAIT_S)

    async def submit(self, job: dict, trace_id: str) -> dict:
        return await self.request(self.peer.framing.attach_trace(
            {"op": "submit", "job": job}, trace_id, sent_at=0.0))

    async def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            await self.conn.wait_closed()


def one_cpu(cpus: int = 1) -> dict:
    return {"variants": [{"entries": [{"name": "cpus",
                                       "amount": cpus * 10_000}]}]}


def array_job(name: str, body: dict, cpus: int = 1, ids=None,
              id_range=None) -> dict:
    array = {"body": body, "request": one_cpu(cpus)}
    if id_range is not None:
        array["id_range"] = list(id_range)
    else:
        array["ids"] = list(ids)
    return {"name": name, "submit_dir": "/work", "array": array}


async def poll_rpc(client, msg: dict, predicate, what: str) -> dict:
    deadline = time.monotonic() + WAIT_S
    while True:
        resp = await client.request(msg)
        if predicate(resp):
            return resp
        if time.monotonic() > deadline:
            raise TimeoutError(f"client waited for {what}: {resp}")
        await asyncio.sleep(0.05)


# ---------------------------------------------------------------------------
# the scenario
# ---------------------------------------------------------------------------
def _explain(answer: dict) -> dict:
    """A task_explain answer without the solver backend it names (the
    JAX model solves this size on the host, the port's `device="cpu"`
    model runs the kernel's plain version, `device-cpu`) and without the
    tick's number (how many ticks ran depends on how the answers and the
    ticks interleaved)."""
    return {k: v for k, v in answer.items()
            if not k.startswith("solver_backend") and k != "decision_tick"}


# the allocation queue's life over the client plane: no submit runs in it
# (the queue is gone before the allocation service's next pass)
ALLOC_RPCS = (
    {"op": "alloc_list"},
    {"op": "alloc_add", "params": {"manager": "slurm", "backlog": 1},
     "no_dry_run": True},
    {"op": "alloc_list"},
    {"op": "alloc_remove", "queue_id": 1},
    {"op": "alloc_list"},
)

FEDERATION_RPCS = (
    {"op": "worker_lend", "worker_id": 1, "to_shard": 1},
    {"op": "migration_export", "mig": "m1", "job": 1, "to": 1},
    {"op": "migration_import", "record": {}},
    {"op": "migration_finalize", "mig": "m2", "job": 99, "to": 1},
)


async def run_scenario(pkg, peer, tmp_path: Path, clock: ManualClock,
                       **server_kwargs) -> dict:
    """One server's life (see the module docstring); returns everything
    the packages are compared on."""
    reset_token_sources()
    clock.t = ManualClock().t
    out: dict = {}
    threads_before = {t.ident for t in threading.enumerate()}
    server = pkg.server(
        server_dir=tmp_path / f"{pkg.name}-dir",
        journal_path=tmp_path / f"{pkg.name}.journal",
        lazy_array_threshold=64, **server_kwargs)
    access = await server.start()
    assert access.client_port and access.worker_port
    loaded = pkg.serverdir.load_access(server.server_dir)
    assert loaded.to_json() == access.to_json()
    client = ScriptedClient(peer, access)
    workers: list[ScriptedWorker] = []
    stopped = False
    try:
        await client.connect()
        out["info_keys"] = sorted(
            (await client.request({"op": "server_info"})))
        out["submit"] = [
            await client.submit(array_job("small", {"cmd": ["a"]},
                                          ids=range(6)), "t-small"),
            await client.submit(array_job("lazy", {"cmd": ["b"]},
                                          id_range=(0, 80)), "t-lazy"),
        ]
        a = ScriptedWorker(peer, access, worker_config(4, "wa"))
        workers.append(a)
        reg = dict(await a.connect())
        reg.pop("server_uid")
        out["registered"] = reg
        await a.start_answering()
        out["job_wait"] = await client.request(
            {"op": "job_wait", "job_ids": [1, 2]})
        assert len(a.entries) == 86
        out["entries_a"] = list(a.entries)
        a.auto = False
        out["job_list"] = await client.request({"op": "job_list"})
        out["job_info"] = await client.request(
            {"op": "job_info", "job_ids": [1, 2]})
        out["task_list"] = await client.request(
            {"op": "task_list", "job_id": 2})
        out["explain_done"] = _explain(await client.request(
            {"op": "task_explain", "job_id": 1, "task_id": 0}))

        # a job no worker can run: pause, resume, explain, cancel
        out["submit_big"] = await client.submit(
            array_job("big", {"cmd": ["c"]}, cpus=64, ids=range(3)),
            "t-big")
        # (explained once the tick it arrived for has judged it)
        out["explain_big"] = _explain(await poll_rpc(
            client, {"op": "task_explain", "job_id": 3, "task_id": 1},
            lambda r: r.get("decision_tick") is not None, "a tick"))
        out["pause"] = await client.request(
            {"op": "job_pause", "job_ids": [3]})
        out["resume"] = await client.request(
            {"op": "job_resume", "job_ids": [3]})
        out["cancel"] = await client.request(
            {"op": "job_cancel", "job_ids": [3]})

        # a second worker drops its connection: its tasks requeue onto A
        # (six one-cpu tasks fill A's 4 cpus and B's 2 in one tick)
        b = ScriptedWorker(peer, access, worker_config(2, "wb"))
        workers.append(b)
        await b.connect()
        n_a = len(a.entries)
        out["submit_requeue"] = await client.submit(
            array_job("requeue", {"cmd": ["d"]}, ids=range(6)), "t-rq")
        await a.wait_for(
            lambda: len(a.entries) - n_a + len(b.entries) >= 6,
            "6 entries over two workers")
        assert len(b.entries) == 2, b.entries
        out["entries_b"] = list(b.entries)
        await b.answer(b.entries, finish=False)
        await b.close()
        workers.remove(b)
        await a.wait_for(lambda: len(a.entries) - n_a >= 6,
                         "the requeued tasks")
        out["entries_a_requeue"] = a.entries[n_a:]
        assert sorted(e["instance"] for e in a.entries[n_a:])[-2:] != [0, 0]
        await a.start_answering()
        out["job_wait_requeue"] = await client.request(
            {"op": "job_wait", "job_ids": [4]})

        # a silent worker: the clock moves past its heartbeat limit
        c = ScriptedWorker(peer, access,
                           worker_config(1, "wc", heartbeat_secs=1.0))
        workers.append(c)
        await c.connect()
        await a.send({"op": "heartbeat"})
        await poll_rpc(client, {"op": "worker_list"},
                       lambda r: len(r["workers"]) == 2, "3 workers")
        clock.advance(10.0)
        out["worker_list"] = await poll_rpc(
            client, {"op": "worker_list"},
            lambda r: len(r["workers"]) == 1, "the reaper")
        out["worker_list_all"] = await client.request(
            {"op": "worker_list", "all": True})
        out["worker_info"] = await client.request(
            {"op": "worker_info", "worker_id": 1})
        out["worker_info_gone"] = await client.request(
            {"op": "worker_info", "worker_id": 3})
        out["journal_info"] = await client.request({"op": "journal_info"})
        stats = await client.request({"op": "server_stats"})
        out["stats_keys"] = sorted(stats)
        out["stats"] = stats
        out["alloc"] = [await client.request(m) for m in ALLOC_RPCS]
        out["federation"] = [await client.request(m)
                             for m in FEDERATION_RPCS]
        out["metrics_port"] = server.metrics_port
        out["stop"] = await client.request({"op": "stop_server"})
        await asyncio.wait_for(server.run_until_stopped(), WAIT_S)
        stopped = True
        await a.wait_for(lambda: any(m.get("op") == "stop"
                                     for m in a.others), "the stop")
        out["a_others"] = [m.get("op") for m in a.others]
    finally:
        for w in workers:
            await w.close()
        await client.close()
        if not stopped:
            server.stop()
            await asyncio.wait_for(server.run_until_stopped(), WAIT_S)
    # the JAX package leaves its solve thread parked after a shutdown
    parked = ("hq-solve-watchdog",) if pkg.name == "jax" else ()
    out["threads_left"] = [
        t.name for t in await wait_threads_gone(threads_before, parked)]
    out["hq_current"] = (
        server.server_dir / pkg.serverdir.CURRENT_LINK).is_symlink()
    out["journal"] = server.journal_path.read_bytes()
    return out


def _run_both(tmp_path, peers=("port", "port"), **server_kwargs):
    """The scenario on the JAX server, then on the port's, in one loop;
    `peers` names the transport of the scripted peers for each."""
    async def both(clock):
        return [
            await run_scenario(PKGS[name], PKGS[peer], tmp_path, clock,
                               **server_kwargs)
            for name, peer in zip(("jax", "port"), peers)
        ]

    with server_process_state() as clock:
        return asyncio.run(asyncio.wait_for(both(clock),
                                            2 * SCENARIO_TIMEOUT_S))


# answers whose every field is state, equal between the packages; the
# rest are compared on the fields named in the test
EQUAL_ANSWERS = (
    "submit", "registered", "entries_a", "job_wait", "job_list", "job_info",
    "task_list", "explain_done", "submit_big", "pause", "resume",
    "explain_big", "cancel", "submit_requeue", "entries_b",
    "entries_a_requeue", "job_wait_requeue", "worker_list",
    "worker_list_all", "worker_info", "worker_info_gone", "stats_keys",
    "info_keys", "alloc", "federation", "stop", "a_others",
)


@pytest.mark.parametrize(
    "client_plane,fanout_senders",
    [("thread", 2), ("thread", 0), ("reactor", 2), ("reactor", 0)],
    ids=["ingest-thread+fanout-pool", "ingest-thread+inline-fanout",
         "in-loop+fanout-pool", "in-loop+inline-fanout"],
)
def test_server_start_matches_jax(tmp_path, client_plane, fanout_senders):
    jax_out, port_out = _run_both(
        tmp_path, client_plane=client_plane, fanout_senders=fanout_senders,
        metrics_port=0)
    for key in EQUAL_ANSWERS:
        assert port_out[key] == jax_out[key], key
    # the whole journal, byte for byte
    assert port_out["journal"] == jax_out["journal"]
    # journal_info: everything but the file's own path
    def info(out):
        return {k: v for k, v in out["journal_info"].items() if k != "path"}
    assert info(port_out) == info(jax_out)
    for out in (jax_out, port_out):
        # the 86 tasks of the first two jobs finished on worker A, the
        # requeued job too; the dropped worker's were requeued
        assert [j["counters"]["finished"] for j in out["job_wait"]["jobs"]] \
            == [6, 80]
        assert out["job_wait_requeue"]["jobs"][0]["counters"]["finished"] \
            == 6
        assert out["hq_current"] is False
        assert out["a_others"][-1] == "stop"
        assert out["metrics_port"] > 0
    # every thread the port's server started has stopped; the JAX
    # package leaves its solve thread parked
    assert port_out["threads_left"] == []
    assert jax_out["threads_left"] in ([], ["hq-solve-watchdog"])
    # the port's server sealed its wire with the backend it names
    assert port_out["stats"]["fanout"]["senders"] == fanout_senders
    assert port_out["stats"]["ingest"]["plane"] == client_plane
    # the allocation queue came and went on both
    assert [r["op"] for r in port_out["alloc"]] == [
        "alloc_list", "alloc_add", "alloc_list", "ok", "alloc_list"]
    assert port_out["alloc"][2]["queues"][0]["params"]["manager"] == "slurm"
    # the federation's RPCs ran on the standalone server: the lend
    # refuses, the export sealed job 1 (its record carries the job), the
    # malformed import errs and the unknown job's finalize is a no-op
    lend, export, bad_import, finalize = port_out["federation"]
    assert lend == {"op": "error", "message": "not a federated server"}
    assert export["op"] == "migration_export"
    assert export["record"]["job_state"]["id"] == 1
    assert bad_import["op"] == "error"
    assert finalize["dup"] is True


def test_jax_transport_peers_against_the_port_server(tmp_path):
    """The JAX package's transport (worker and client side) against the
    port's server, and the port's against the JAX server: the same
    answers and journal as the port's own peers give."""
    jax_out, port_out = _run_both(tmp_path, peers=("port", "jax"))
    for key in EQUAL_ANSWERS:
        assert port_out[key] == jax_out[key], key
    assert port_out["journal"] == jax_out["journal"]
