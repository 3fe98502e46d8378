"""The `hq` command-line interface.

Reference: crates/hyperqueue/src/common/cli.rs:186-211 and bin/hq.rs:432-553 —
subcommand tree: server / worker / submit / job / task / output-log / alloc /
journal / dashboard. One binary drives everything; here it is
`python -m hyperqueue_tpu_torch` (`bin/hq` stays the JAX package's). The
server, a federation's shards and its warm standby solve on the CUDA
device unless `--scheduler cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from pathlib import Path

from hyperqueue_tpu_torch import __version__
from hyperqueue_tpu_torch.client.connection import (
    ClientError,
    ClientSession,
    FederatedSession,
    open_session,
)
from hyperqueue_tpu_torch.client.output import fail, make_output
from hyperqueue_tpu_torch.resources.amount import amount_from_str
from hyperqueue_tpu_torch.utils import serverdir
from hyperqueue_tpu_torch.utils.placeholders import fill_placeholders
from hyperqueue_tpu_torch.utils import clock


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--server-dir",
        default=None,
        help="server directory (default: ~/.hq-tpu-server or $HQ_SERVER_DIR)",
    )
    parser.add_argument(
        "--output-mode",
        choices=["cli", "json", "quiet"],
        default=os.environ.get("HQ_OUTPUT_MODE", "cli"),
    )


def _server_dir(args) -> Path:
    if args.server_dir:
        return Path(args.server_dir)
    return serverdir.default_server_dir()


def _session(args) -> ClientSession:
    # open_session routes through a FederatedSession when the server dir
    # is a federation root (per-shard routing + fan-out)
    try:
        return open_session(_server_dir(args))
    except FileNotFoundError as e:
        fail(str(e))


# ---------------------------------------------------------------- selectors
def parse_selector(text: str, last_id: int | None = None) -> list[int]:
    """Job/task selectors: "3", "1-5", "1,3-4", "last", "all" (reference
    transfer/messages.rs:255-285 IdSelector)."""
    if text == "all":
        return []
    if text == "last":
        if last_id is None:
            fail("no jobs submitted yet")
        return [last_id]
    ids: list[int] = []
    # underscore separators are readability sugar: 1-1000_000 == 1-1000000
    # (reference cli/shortcuts.md); steps via <start>-<end>:<step>.  Only
    # underscores BETWEEN digits are digit grouping — stripping them all
    # made typos like "_5" or "5_" silently parse
    cleaned = re.sub(r"(?<=\d)_(?=\d)", "", text)
    try:
        for part in cleaned.split(","):
            part = part.strip()
            if "-" in part:
                step = 1
                if ":" in part:
                    part, step_s = part.rsplit(":", 1)
                    step = int(step_s)
                    if step <= 0:
                        fail(f"selector step must be positive: {text!r}")
                lo, hi = part.split("-", 1)
                ids.extend(range(int(lo), int(hi) + 1, step))
            elif part:
                ids.append(int(part))
    except ValueError:
        fail(f"invalid selector: {text!r}")
    return ids


def _resolve_job_selector(session: ClientSession, text: str) -> list[int]:
    jobs = session.request({"op": "job_list"})["jobs"]
    if text == "all":
        return sorted(j["id"] for j in jobs)
    last = max((j["id"] for j in jobs), default=None)
    return parse_selector(text, last)


# ---------------------------------------------------------------- server cmds
def _setup_logging(args=None) -> None:
    """Server and worker processes log to stderr at $HQ_LOG level.

    --log-format json emits one JSON object per line with the correlation
    keys (tick/job/task/worker) the flight recorder and metrics use
    (utils/logfmt.py); plain stays the human-readable default."""
    from hyperqueue_tpu_torch.utils.logfmt import setup_logging

    setup_logging(getattr(args, "log_format", None))


def _server_device(scheduler: str) -> str:
    """Where the server's models solve: `--scheduler cpu` asks for the
    CPU; every other choice (`tpu` included) solves on the card, and a
    machine without CUDA refuses instead of falling back to the CPU."""
    if scheduler == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        fail(
            f"--scheduler {scheduler} solves on the CUDA device and this "
            "machine has none; pass --scheduler cpu to solve on the CPU"
        )
    return "cuda"


def cmd_server_start(args) -> None:
    import asyncio

    _setup_logging(args)

    profile_out = os.environ.get("HQ_PROFILE")

    # --- federation -----------------------------------------------------
    shards = int(getattr(args, "shards", 0) or 0)
    standby = bool(getattr(args, "standby", False))
    federated = shards >= 1
    if federated and not standby and args.journal:
        # a usage error, answered before the device is resolved (which
        # imports torch)
        fail(
            "--journal cannot be combined with --shards: federated "
            "shards always journal at <shard-dir>/journal.bin so a "
            "failover successor knows where to restore from"
        )
    device = _server_device(args.scheduler)
    if standby:
        _run_standby(args, shards, device)
        return

    from hyperqueue_tpu_torch.server.bootstrap import Server

    federation_root = None
    server_dir = _server_dir(args)
    journal = Path(args.journal) if args.journal else None
    shard_id = int(getattr(args, "shard_id", 0) or 0)
    if federated:
        from hyperqueue_tpu_torch.server.federation import shard_journal_path

        federation_root = server_dir
        server_dir = serverdir.shard_path(federation_root, shard_id)
        journal = shard_journal_path(federation_root, shard_id)

    async def go():
        server = Server(
            server_dir=server_dir,
            host=args.host,
            client_port=args.client_port,
            worker_port=args.worker_port,
            disable_client_auth=args.disable_client_authentication,
            disable_worker_auth=args.disable_worker_authentication,
            scheduler=args.scheduler,
            journal_path=journal,
            idle_timeout=args.idle_timeout,
            journal_flush_period=args.journal_flush_period,
            access_file=Path(args.access_file) if args.access_file else None,
            paranoid_tick=args.paranoid_tick,
            journal_fsync=args.journal_fsync,
            journal_compact_interval=args.journal_compact_interval,
            journal_compact_threshold=args.journal_compact_threshold,
            journal_salvage=args.journal_salvage,
            heartbeat_timeout_factor=args.heartbeat_timeout_factor,
            reattach_timeout=args.reattach_timeout,
            solver_watchdog_timeout=args.solver_watchdog_timeout,
            solver_rearm_ticks=args.solver_rearm_ticks,
            metrics_port=args.metrics_port,
            metrics_host=args.metrics_host,
            flight_recorder_ticks=args.flight_recorder_ticks,
            tick_pipeline=args.tick_pipeline,
            policy_file=(
                Path(args.policy_file) if args.policy_file else None
            ),
            stall_budget=args.stall_budget,
            stall_dumps=args.stall_dumps,
            profile_hz=args.profile_hz,
            task_trace_capacity=args.task_trace_capacity,
            client_plane=args.client_plane,
            journal_plane=args.journal_plane,
            fanout_senders=args.fanout_senders,
            ingest_window=args.ingest_window,
            lazy_array_threshold=args.lazy_array_threshold,
            shard_id=shard_id,
            shard_count=shards if federated else 1,
            federation_root=federation_root,
            lease_timeout=args.lease_timeout,
            failover_watch=getattr(args, "failover_watch", False),
            device=device,
        )
        access = await server.start()
        if federated:
            print(
                f"| shard {shard_id}/{shards} of federation "
                f"{federation_root}",
                flush=True,
            )
        print(
            f"+-- HyperQueue TPU server [{access.server_uid}] --\n"
            f"| clients: {access.host}:{access.client_port}\n"
            f"| workers: {access.host_for_workers()}:{access.worker_port}\n"
            f"+--",
            flush=True,
        )
        await server.run_until_stopped()

    if profile_out:
        import cProfile

        cProfile.runctx("asyncio.run(go())", globals(), locals(),
                        filename=profile_out + ".server")
    else:
        asyncio.run(go())


def _run_standby(args, shards: int, device: str) -> None:
    """`hq server start --standby`: warm failover successor + federation
    coordinator. Holds no shard of its own; claims dead shards through
    the atomic lease and boots a full restored Server over each, solving
    on `device` (the card, or the CPU under `--scheduler cpu`)."""
    import asyncio

    from hyperqueue_tpu_torch.server.federation import standby_main

    root = _server_dir(args)
    if shards >= 1:
        # allow the standby to come up FIRST in a deployment: it can
        # publish the federation descriptor the shards will join — and
        # GROW an existing one when restarted with a larger --shards
        # (online shard add; shrinking is rejected)
        existing = serverdir.load_federation(root)
        if existing is not None and shards != int(existing["shard_count"]):
            serverdir.grow_federation(root, shards)
        else:
            serverdir.write_federation(root, shards)
    # keep in lockstep with Server.federation_server_kwargs() — the
    # peer-promotion path clones the same subset from a live Server, and
    # a knob present in one list but not the other makes standby- and
    # peer-promoted successors behave differently for the same shard
    server_kwargs = dict(
        device=device,
        scheduler=args.scheduler,
        journal_fsync=args.journal_fsync,
        journal_flush_period=args.journal_flush_period,
        journal_compact_interval=args.journal_compact_interval,
        journal_compact_threshold=args.journal_compact_threshold,
        journal_salvage=args.journal_salvage,
        heartbeat_timeout_factor=args.heartbeat_timeout_factor,
        reattach_timeout=args.reattach_timeout,
        idle_timeout=args.idle_timeout,
        client_plane=args.client_plane,
        journal_plane=args.journal_plane,
        fanout_senders=args.fanout_senders,
        policy_file=(
            Path(args.policy_file) if args.policy_file else None
        ),
        lazy_array_threshold=args.lazy_array_threshold,
    )
    print(f"+-- HyperQueue TPU standby watching {root} --", flush=True)
    asyncio.run(standby_main(
        root,
        server_kwargs=server_kwargs,
        lease_timeout=args.lease_timeout,
        coordinate=not getattr(args, "no_coordinator", False),
        sample_interval=args.coordinator_interval,
        rebalance=getattr(args, "rebalance", False),
        # the standby's endpoint keeps hq_federation_shard_up and
        # failovers_total scrapeable through shard deaths
        metrics_port=args.metrics_port,
        metrics_host=args.metrics_host,
    ))


def cmd_server_stop(args) -> None:
    with _session(args) as session:
        session.request({"op": "stop_server"})
    make_output(args.output_mode).message("server stopped")


def _print_federation_block(fed: dict | None) -> None:
    if not fed:
        return
    lease_age = fed.get("lease_age_seconds")
    print(
        f"federation: shard {fed.get('shard_id')}/{fed.get('shard_count')}"
        f" — partition {fed.get('partition')}"
        + (" [promoted successor]" if fed.get("promoted") else "")
        + (" [FENCED]" if fed.get("fenced") else "")
    )
    print(
        f"  lease: held by {fed.get('lease_owner')} "
        f"(epoch {fed.get('lease_epoch')}, renewed "
        + (f"{lease_age:.1f}s ago)" if lease_age is not None else "?)")
    )
    print(
        f"  workers: {fed.get('workers_lent', 0)} lent, "
        f"{fed.get('workers_borrowed', 0)} borrowed"
    )


def cmd_server_info(args) -> None:
    with _session(args) as session:
        info = session.request(
            {"op": "server_info", "shard": getattr(args, "shard", 0)}
        )
    info.pop("op", None)
    out = make_output(args.output_mode)
    if "shards" in info and args.output_mode == "cli":
        # --shard all: one record per shard
        for rec in info["shards"]:
            rec.pop("op", None)
            out.record(rec)
        return
    out.record(info)


def cmd_server_stats(args) -> None:
    """Per-phase tick latency breakdown + incremental-cache counters."""
    with _session(args) as session:
        stats = session.request(
            {"op": "server_stats", "shard": getattr(args, "shard", 0)}
        )
    stats.pop("op", None)
    if args.output_mode != "cli":
        make_output(args.output_mode).record(stats)
        return
    if "shards" in stats:
        # --shard all: the cross-shard summary (full per-shard telemetry
        # stays one `--shard k` away; latencies are never summed)
        for rec in stats["shards"]:
            if rec.get("error"):
                print(f"shard {rec.get('shard_id')}: DOWN ({rec['error']})")
                continue
            _print_federation_block(rec.get("federation"))
            tick = rec.get("tick") or {}
            print(f"  ticks: {tick.get('ticks', 0)}, scheduler "
                  f"{rec.get('scheduler')}")
        return
    _print_federation_block(stats.get("federation"))
    tick = stats.get("tick") or {}
    print(f"scheduler: {stats.get('scheduler')} "
          f"(backend {stats.get('solve_backend')})")
    pol = stats.get("policy")
    if pol:
        print(
            f"policy: {pol.get('source')} — "
            f"{pol.get('affinity_classes', 0)} affinity class(es), "
            f"fairness {'on' if (pol.get('fairness') or {}).get('enabled') else 'off'}, "
            f"prediction {'on' if (pol.get('prediction') or {}).get('enabled') else 'off'}, "
            f"boost range {pol.get('boost_range')}"
        )
        pred = pol.get("prediction") or {}
        if pred.get("enabled"):
            line = (
                f"  predictor: {pred.get('classes', 0)} class(es), "
                f"{pred.get('observations', 0)} observation(s), "
                f"hit rate {pred.get('hit_rate', 0.0):.2f}"
            )
            if pred.get("seeded_from"):
                line += (
                    f", seeded {pred.get('seeded_samples', 0)} sample(s) "
                    f"from {pred['seeded_from']}"
                )
            print(line)
        jain = pol.get("jain")
        if jain:
            print(
                f"  fairness jain: last {jain.get('last')}, "
                f"avg {jain.get('avg')} over {jain.get('ticks')} tick(s)"
            )
    print(f"ticks: {tick.get('ticks', 0)}")
    phase_rows = tick.get("phases") or {}
    if phase_rows:
        print(f"{'phase':<16}{'mean ms':>10}{'last ms':>10}{'max ms':>10}")
        for name, row in phase_rows.items():
            print(f"{name:<16}{row['mean_ms']:>10.3f}"
                  f"{row['last_ms']:>10.3f}{row['max_ms']:>10.3f}")
    cache = stats.get("tick_cache") or {}
    print(
        "tick cache: "
        f"{cache.get('workers', 0)} workers x "
        f"{cache.get('resources', 0)} resources, "
        f"{cache.get('full_rebuilds', 0)} full rebuilds, "
        f"{cache.get('incremental_syncs', 0)} incremental syncs "
        f"({cache.get('rows_rewritten_last', 0)} rows rewritten last tick)"
    )
    if stats.get("shape_allocations") is not None:
        print(f"solver shape allocations: {stats['shape_allocations']}")
    wd = stats.get("watchdog") or {}
    if wd:
        state = (
            "armed"
            if wd.get("armed")
            else f"DEGRADED (re-arm in {wd.get('bench_remaining', 0)} ticks)"
        )
        print(
            f"solver watchdog: {state} — "
            f"{wd.get('failures', 0)} failure(s), "
            f"{wd.get('timeouts', 0)} timeout(s), "
            f"{wd.get('degraded_ticks', 0)} degraded tick(s), "
            f"{wd.get('rearms', 0)} re-arm(s)"
        )
        if wd.get("last_error"):
            print(f"  last solver error: {wd['last_error']}")
    if stats.get("reattach_pending"):
        print(
            f"tasks awaiting worker reattach: {stats['reattach_pending']}"
        )
    jn = stats.get("journal")
    if jn:
        age = jn.get("snapshot_age_seconds")
        print(
            f"journal: {jn['journal_bytes']} bytes, "
            f"{jn['segments']} segment(s), snapshot "
            + (f"{jn['snapshot_bytes']} bytes (age {age:.0f}s)"
               if jn.get("snapshot_bytes") else "none")
        )
        lc = jn.get("last_compaction")
        if lc:
            print(
                f"  last compaction ({lc['reason']}): "
                f"kept {lc['kept_records']}, dropped "
                f"{lc['dropped_records']}, "
                f"{lc['journal_bytes_before']} -> "
                f"{lc['journal_bytes_after']} bytes "
                f"in {lc['duration_ms']} ms"
            )
        lr = jn.get("last_restore")
        if lr:
            print(
                f"  last restore: {lr['duration_s']}s via "
                + ("snapshot" if lr.get("snapshot") else "full replay")
                + f", {lr['tail_events']} tail events"
            )
    jp = stats.get("journal_plane") or {}
    if jp.get("mode") == "thread":
        print(
            f"journal plane: thread — {jp.get('commits', 0)} group "
            f"commit(s), mean batch {jp.get('mean_batch', 0)} "
            f"(max {jp.get('max_batch', 0)}), "
            f"{jp.get('depth', 0)} pending"
        )
    elif jp.get("mode"):
        print(f"journal plane: {jp['mode']} (inline group commit)")
    fo = stats.get("fanout") or {}
    if fo:
        print(
            f"fan-out plane: {fo.get('senders', 0)} sender(s), "
            f"wire backend {fo.get('wire_backend')}, "
            f"{fo.get('frames_total', 0)} frame(s) / "
            f"{fo.get('bytes_total', 0)} bytes, "
            f"{fo.get('send_stalls', 0)} send stall(s)"
        )
    lag = stats.get("lag") or {}
    if lag:
        print(f"{'loop lag':<16}{'mean ms':>10}{'last ms':>10}{'max ms':>10}")
        for plane, row in lag.items():
            print(f"{plane:<16}{row['mean_ms']:>10.3f}"
                  f"{row['last_ms']:>10.3f}{row['max_ms']:>10.3f}")
    prof = stats.get("profile") or {}
    if prof.get("enabled") and prof.get("planes"):
        print(
            f"{'cpu plane':<16}{'cpu%':>10}{'samples':>10}{'active':>10}"
            f"   ({prof.get('hz')} Hz sampler, "
            f"{prof.get('window_passes', 0)} passes windowed)"
        )
        planes = sorted(
            prof["planes"].items(), key=lambda kv: -kv[1].get("cpu", 0.0)
        )
        for plane, row in planes:
            print(
                f"{plane:<16}{row.get('cpu', 0.0) * 100:>9.1f}%"
                f"{row.get('samples', 0):>10}{row.get('active', 0):>10}"
            )
    stalls = stats.get("stalls") or {}
    if stalls.get("captured"):
        last = stalls.get("last") or {}
        print(
            f"reactor stalls: {stalls['captured']} over the "
            f"{stalls.get('budget_s')}s budget — last: "
            f"{last.get('plane')} plane held {last.get('duration_s')}s "
            f"at tick {last.get('tick')}"
            + (f" (dump: {last['dump']})" if last.get("dump") else "")
        )
    traces = stats.get("task_traces") or {}
    if traces.get("capacity"):
        print(
            f"task traces: {traces.get('tasks', 0)} of "
            f"{traces['capacity']} slots, {traces.get('spans', 0)} spans, "
            f"{traces.get('evictions', 0)} evicted"
        )
    if stats.get("subscribers"):
        print(f"event subscribers: {stats['subscribers']}")
    if stats.get("paranoid_tick"):
        print(f"paranoid-tick: every {stats['paranoid_tick']} ticks")


def cmd_server_flight_recorder(args) -> None:
    """Dump the server's flight recorder: last N per-tick DecisionRecords
    plus recent control-plane events (`hq server flight-recorder dump`)."""
    with _session(args) as session:
        dump = session.request({"op": "flight_recorder_dump"})
    dump.pop("op", None)
    if args.json or args.output_mode == "json":
        print(json.dumps(dump, default=str))
        return
    out = make_output(args.output_mode)
    ticks = dump.get("ticks") or []
    out.message(
        f"flight recorder: {len(ticks)} tick record(s) "
        f"(capacity {dump.get('capacity_ticks')}, "
        f"{dump.get('dropped_idle_ticks', 0)} idle ticks dropped)"
    )
    if ticks:
        out.table(
            ["tick", "solver", "assigned", "prefilled", "unplaced",
             "reasons"],
            [
                [
                    r["tick"],
                    (r.get("solver") or {}).get("status", "?"),
                    r["counts"].get("assigned", 0)
                    + r["counts"].get("gang_assigned", 0),
                    r["counts"].get("prefilled", 0),
                    r["counts"].get("unplaced", 0),
                    " ".join(sorted({
                        e["reason"] for e in r.get("unplaced") or ()
                    })) or "-",
                ]
                for r in ticks[-20:]
            ],
        )
    events = dump.get("events") or []
    if events:
        out.message("recent control-plane events:")
        for e in events[-15:]:
            t = time.strftime("%H:%M:%S", time.localtime(e.get("time", 0)))
            rest = {k: v for k, v in e.items() if k not in ("time", "event")}
            out.message(f"  {t} {e.get('event')} {rest}")


def cmd_server_trace_export(args) -> None:
    """Write the run's Chrome trace-event JSON (Perfetto-loadable): one
    scheduler row from the flight recorder, one row per worker with its
    task spans."""
    with _session(args) as session:
        result = session.request({"op": "trace_export"})
    events = result.get("traceEvents") or []
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(args.output, "w") as f:
        json.dump(trace, f)
    n_tasks = sum(1 for e in events if e.get("cat") == "task")
    n_ticks = sum(1 for e in events if e.get("cat") == "tick")
    make_output(args.output_mode).message(
        f"trace written to {args.output} ({n_ticks} tick slice(s), "
        f"{n_tasks} task span(s)); open it at https://ui.perfetto.dev"
    )


def cmd_job_pause(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        result = session.request({"op": "job_pause", "job_ids": ids})
    paused = result["paused"]
    make_output(args.output_mode).message(
        f"paused {len(paused)} job(s): " + ", ".join(
            f"{p['job']} ({p['held']} held, "
            f"{p.get('retracted', 0)} recalled from workers)"
            for p in paused
        ) if paused else "no jobs paused"
    )


def cmd_job_resume(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        result = session.request({"op": "job_resume", "job_ids": ids})
    resumed = result["resumed"]
    make_output(args.output_mode).message(
        f"resumed {len(resumed)} job(s): " + ", ".join(
            f"{r['job']} ({r['released']} task(s) released)" for r in resumed
        ) if resumed else "no paused jobs matched"
    )


def cmd_server_generate_access(args) -> None:
    client_host = args.client_host or args.host
    worker_host = args.worker_host or args.host
    if not client_host or not worker_host:
        fail("provide --host, or both --client-host and --worker-host")
    record = serverdir.generate_access(
        host=client_host,
        client_port=args.client_port,
        worker_port=args.worker_port,
        worker_host=worker_host if worker_host != client_host else None,
    )

    def write(path, role=None):
        with open(path, "w") as f:
            json.dump(record.to_json(role), f, indent=2)
        os.chmod(path, 0o600)

    write(args.access_file)
    written = [args.access_file]
    # split access: a client-only and/or worker-only record, each usable as
    # access.json by just that role (reference generate_access.rs splitting)
    if args.client_file:
        write(args.client_file, "client")
        written.append(args.client_file)
    if args.worker_file:
        write(args.worker_file, "worker")
        written.append(args.worker_file)
    make_output(args.output_mode).message(
        f"access file(s) written to {', '.join(written)}"
    )


# ---------------------------------------------------------------- worker cmds
def cmd_worker_start(args) -> None:
    import asyncio

    # without this the runtime's own reporting (reconnects, reattaches,
    # the bound --metrics-port endpoint) goes nowhere
    _setup_logging(args)

    from hyperqueue_tpu_torch.server.worker import WorkerConfiguration
    from hyperqueue_tpu_torch.worker.hwdetect import detect_resources
    from hyperqueue_tpu_torch.worker.parser import parse_resource_definition
    from hyperqueue_tpu_torch.worker.runtime import run_worker

    from hyperqueue_tpu_torch.worker.manager import detect_manager

    # a federation root resolves to ONE shard's nested server dir: the
    # worker registers with that shard (and may later be lent to others
    # by the coordinator). --shard pins it; default spreads randomly.
    worker_dir = _server_dir(args)
    fed = serverdir.load_federation(worker_dir)
    if fed is not None:
        import random as _random

        shard = getattr(args, "shard", None)
        if shard is None:
            shard = _random.randrange(fed["shard_count"])
        if not (0 <= shard < fed["shard_count"]):
            fail(f"--shard {shard} outside 0..{fed['shard_count'] - 1}")
        worker_dir = serverdir.shard_path(worker_dir, shard)
    access = serverdir.load_access(worker_dir)
    manager_info = detect_manager(args.manager)
    descriptor = detect_resources(
        n_cpus=args.cpus,
        no_hyper_threading=args.no_hyper_threading,
    )
    if args.resource or args.coupling:
        from hyperqueue_tpu_torch.resources.descriptor import ResourceDescriptor
        from hyperqueue_tpu_torch.worker.parser import parse_resource_coupling

        items = {item.name: item for item in descriptor.items}
        for spec in args.resource or []:
            item = parse_resource_definition(spec)
            items[item.name] = item
        coupling = None
        if args.coupling:
            coupling = parse_resource_coupling(args.coupling)
        descriptor = ResourceDescriptor(
            items=tuple(items.values()), coupling=coupling
        )
    descriptor.validate()
    time_limit = args.time_limit or 0.0
    if not time_limit and manager_info.remaining_secs:
        time_limit = manager_info.remaining_secs
    # group defaults to the manager allocation id under PBS/Slurm so gang
    # members land on one allocation (reference worker.rs:440)
    group = args.group
    if group is None:
        group = (
            manager_info.job_id
            if manager_info.manager != "none" and manager_info.job_id
            else "default"
        )
    config = WorkerConfiguration(
        descriptor=descriptor,
        hostname=os.uname().nodename,
        group=group,
        heartbeat_secs=args.heartbeat,
        time_limit_secs=time_limit,
        # None = flag not given -> adopt the server default at registration;
        # an explicit --idle-timeout 0 means "never idle-stop"
        idle_timeout_secs=(
            args.idle_timeout if args.idle_timeout is not None else -1.0
        ),
        on_server_lost=args.on_server_lost,
        reconnect_timeout_secs=args.reconnect_timeout,
        overview_interval_secs=args.overview_interval,
        min_utilization=args.min_utilization,
        manager=manager_info.manager,
        manager_job_id=manager_info.job_id,
        alloc_id=os.environ.get("HQ_ALLOC_ID", ""),
        runner_pool=args.runner_pool,
        uplink_flush_secs=args.uplink_flush,
    )
    profile_out = os.environ.get("HQ_PROFILE")
    if not access.worker_port:
        fail("access record has no worker plane (client-only split file?)")
    coro_args = (
        access.host_for_workers(),
        access.worker_port,
        access.worker_key_bytes(),
        config,
    )
    worker_kwargs = {
        "zero_worker": args.zero_worker,
        # reconnect re-reads the access record from the server dir (a
        # restarted server publishes new ports/keys); under federation
        # this is the SHARD dir, so a failover successor's record is
        # picked up transparently
        "server_dir": worker_dir,
        "metrics_port": args.metrics_port,
        "metrics_host": args.metrics_host,
        "profile_hz": args.profile_hz,
    }
    if profile_out:
        import cProfile

        cProfile.runctx(
            "asyncio.run(run_worker(*coro_args, **worker_kwargs))",
            globals(), locals(), filename=profile_out + ".worker",
        )
    else:
        asyncio.run(run_worker(*coro_args, **worker_kwargs))


def cmd_worker_deploy_ssh(args) -> None:
    """Start a worker on each host via ssh (reference commands/worker.rs
    deploy-ssh). Requires passwordless ssh and a shared filesystem (or a
    pre-distributed access file via HQ_SERVER_DIR)."""
    import subprocess

    server_dir = str(_server_dir(args))
    with open(args.hostfile) as f:
        hosts = [line.strip() for line in f if line.strip()]
    if not hosts:
        fail("hostfile is empty")
    procs = []
    for host in hosts:
        remote_cmd = (
            f"{sys.executable} -m hyperqueue_tpu_torch worker start "
            f"--server-dir {server_dir} --group {args.group}"
        )
        if args.cpus:
            remote_cmd += f" --cpus {args.cpus}"
        procs.append(
            subprocess.Popen(
                ["ssh", "-o", "BatchMode=yes", host, remote_cmd]
            )
        )
    out = make_output(args.output_mode)
    out.message(f"deploying workers to {len(hosts)} host(s); Ctrl-C to stop")
    try:
        for p in procs:
            p.wait()
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()


def cmd_worker_list(args) -> None:
    want_all = args.all or args.filter == "offline"
    with _session(args) as session:
        workers = session.request(
            {"op": "worker_list", "all": want_all}
        )["workers"]
    if args.filter:
        workers = [w for w in workers
                   if w.get("status", "running") == args.filter]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(workers)
        return
    out.table(
        ["id", "hostname", "status", "group", "running", "resources"],
        [
            [
                w["id"],
                w["hostname"],
                w.get("status", "running"),
                w["group"],
                w["n_running"],
                " ".join(f"{k}={v / 10_000:g}"
                         for k, v in w["resources"].items()),
            ]
            for w in workers
        ],
    )


def cmd_worker_info(args) -> None:
    with _session(args) as session:
        worker = session.request(_worker_shard_msg(
            args, {"op": "worker_info", "worker_id": args.worker_id}
        ))["worker"]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(worker)
        return
    if "free" in worker:  # absent on offline (past) workers
        worker["free"] = " ".join(
            f"{k}={v / 10_000:g}" for k, v in worker["free"].items() if v
        )
    if "running_tasks" in worker:
        worker["running_tasks"] = " ".join(worker["running_tasks"]) or "-"
    if "lost_at" in worker:
        worker["lost_at"] = _format_time(worker["lost_at"])
    worker.pop("descriptor", None)
    overview = worker.pop("overview", None) or {}
    if overview.get("hw"):
        worker["cpu_usage"] = f"{overview['hw'].get('cpu_usage_percent', 0)}%"
    out.record(worker)


def cmd_server_debug_dump(args) -> None:
    with _session(args) as session:
        dump = session.request({"op": "server_debug_dump"})
    dump.pop("op", None)
    print(json.dumps(dump, indent=2, default=str))


def cmd_task_notify(args) -> None:
    from hyperqueue_tpu_torch.worker.localcomm import notify_from_task

    notify_from_task(args.payload or "")


def cmd_worker_address(args) -> None:
    with _session(args) as session:
        worker = session.request(_worker_shard_msg(
            args, {"op": "worker_info", "worker_id": args.worker_id}
        ))["worker"]
    make_output(args.output_mode).value(worker["hostname"])


def cmd_worker_wait(args) -> None:
    """Block until N workers are connected (reference `hq worker wait`)."""
    deadline = clock.now() + args.timeout
    with _session(args) as session:
        while True:
            workers = session.request({"op": "worker_list"})["workers"]
            if len(workers) >= args.count:
                make_output(args.output_mode).message(
                    f"{len(workers)} worker(s) connected"
                )
                return
            if clock.now() > deadline:
                fail(
                    f"timed out: {len(workers)}/{args.count} workers connected"
                )
            time.sleep(0.25)


def cmd_server_wait(args) -> None:
    """Block until a server is reachable in the server dir."""
    deadline = clock.now() + args.timeout
    while True:
        try:
            # retry_window=0: this loop IS the retry policy
            with open_session(_server_dir(args), retry_window=0) as session:
                session.request({"op": "server_info"})
            make_output(args.output_mode).message("server is running")
            return
        except (FileNotFoundError, ClientError, ConnectionError, OSError):
            if clock.now() > deadline:
                fail("timed out waiting for the server")
            time.sleep(0.25)


def _worker_shard_msg(args, msg: dict) -> dict:
    # worker ids are per shard under federation: thread --shard through
    # (FederatedSession requires it for worker-targeted ops)
    shard = getattr(args, "shard", None)
    if shard is not None:
        msg["shard"] = shard
    return msg


def cmd_worker_stop(args) -> None:
    with _session(args) as session:
        ids = parse_selector(args.selector)
        shards: list[int | None] = [getattr(args, "shard", None)]
        if (
            shards[0] is None
            and getattr(session, "shard_count", 0) > 1
            and not ids
        ):
            # federation `worker stop all` with no --shard: ids are per
            # shard (and collide across shards), so resolve AND stop
            # shard by shard
            shards = list(range(session.shard_count))
        stopped = []
        for shard in shards:
            msg: dict = {"op": "worker_list"}
            stop: dict = {"op": "worker_stop"}
            if getattr(args, "drain", False):
                # graceful: the server masks the worker out of the solve,
                # lets running tasks finish under the deadline, then stops
                stop["drain"] = True
                if getattr(args, "drain_timeout", None):
                    stop["timeout"] = args.drain_timeout
            if shard is not None:
                msg["shard"] = shard
                stop["shard"] = shard
            else:
                _worker_shard_msg(args, msg)
                _worker_shard_msg(args, stop)
            shard_ids = ids or [
                w["id"] for w in session.request(msg)["workers"]
            ]
            if not shard_ids:
                continue
            stop["worker_ids"] = shard_ids
            stopped.extend(session.request(stop)["stopped"])
    verb = "draining" if getattr(args, "drain", False) else "stopped"
    make_output(args.output_mode).message(f"{verb} workers: {stopped}")


# ---------------------------------------------------------------- submit
def _parse_env(pairs: list[str]) -> dict:
    env = {}
    for pair in pairs or []:
        key, sep, value = pair.partition("=")
        if not sep:
            fail(f"invalid --env {pair!r}, expected KEY=VALUE")
        env[key] = value
    return env


def _build_request(args) -> dict:
    entries = []
    if args.cpus:
        if str(args.cpus) == "all":
            entries.append({"name": "cpus", "amount": 0, "policy": "all"})
        else:
            entries.append(
                {"name": "cpus", "amount": amount_from_str(args.cpus),
                 "policy": "compact"}
            )
    for spec in args.resource_request or []:
        name, sep, amount = spec.partition("=")
        if not sep:
            fail(f"invalid --resource {spec!r}, expected name=amount")
        policy = "compact"
        if amount == "all":
            entries.append({"name": name, "amount": 0, "policy": "all"})
            continue
        entries.append(
            {"name": name, "amount": amount_from_str(amount), "policy": policy}
        )
    variant = {
        "n_nodes": args.nodes or 0,
        "min_time": args.time_request or 0.0,
        "entries": entries,
    }
    if getattr(args, "weight", None):
        variant["weight"] = args.weight
    return {"variants": [variant]}


def _parse_weight(text: str) -> float:
    value = float(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(
            "resource weight has to be a positive number"
        )
    return value


def _parse_min_utilization(text: str) -> float:
    value = float(text)
    if not 0.0 <= value <= 1.0:
        raise argparse.ArgumentTypeError(
            "min utilization has to be in range 0.0-1.0"
        )
    return value


_DURATION_UNITS = {
    "ms": 0.001, "s": 1.0, "sec": 1.0, "secs": 1.0, "second": 1.0,
    "seconds": 1.0, "m": 60.0, "min": 60.0, "mins": 60.0, "minute": 60.0,
    "minutes": 60.0, "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "hrs": 3600.0, "d": 86400.0, "day": 86400.0, "days": 86400.0,
}


def _parse_duration(text: str) -> float:
    """Seconds from `90`, `1.5h`, `10min`, `1h30m`, or `HH:MM:SS`
    (reference parse_hms_or_human_time, common/parser2.rs)."""
    text = text.strip()
    try:
        value = float(text)  # plain seconds
    except ValueError:
        pass
    else:
        if value < 0:
            raise argparse.ArgumentTypeError(
                f"duration must be non-negative, got {text!r}"
            )
        return value
    if ":" in text:  # [HH:]MM:SS
        parts = text.split(":")
        if len(parts) in (2, 3) and all(p.isdigit() for p in parts):
            secs = 0.0
            for p in parts:
                secs = secs * 60 + int(p)
            return secs
        raise argparse.ArgumentTypeError(f"invalid duration {text!r}")
    import re

    matches = re.findall(r"(\d+(?:\.\d+)?)\s*([a-zA-Z]+)", text)
    if not matches or "".join(n + u for n, u in matches) != text.replace(" ", ""):
        raise argparse.ArgumentTypeError(
            f"invalid duration {text!r} (expected e.g. 30, 10min, 1h30m, 01:30:00)"
        )
    secs = 0.0
    for number, unit in matches:
        scale = _DURATION_UNITS.get(unit.lower())
        if scale is None:
            raise argparse.ArgumentTypeError(
                f"unknown duration unit {unit!r} in {text!r}"
            )
        secs += float(number) * scale
    return secs


def _parse_crash_limit(text: str) -> int:
    """Positive integer, `never-restart` (-1 on the wire: fails on any
    worker loss while running, even clean stops — reference reactor.rs:166),
    or `unlimited` (0). Shared encoding: utils/parsing.py."""
    from hyperqueue_tpu_torch.utils.parsing import parse_crash_limit

    return parse_crash_limit(text, exc_type=argparse.ArgumentTypeError)


class _NotifyRunner:
    """Streams task-notify events in a daemon thread and runs the
    `--on-notify` program serially for events of the submitted job
    (reference JobSubmitOpts::on_notify). Subscription is acknowledged by
    the server's `stream_live` frame BEFORE the submit happens on the other
    connection, so no notify of the submitted job can precede the listener.
    Records arriving before the job id is known are buffered and replayed
    via flush() once `set_job_id` runs."""

    def __init__(self, args):
        import threading

        self._args = args
        self._job_id = None
        self.stop = False
        self._buffered: list[dict] = []
        self._lock = threading.Lock()
        self._subscribed = threading.Event()
        threading.Thread(target=self._loop, daemon=True).start()
        if not self._subscribed.wait(timeout=10):
            print("--on-notify: event stream subscription timed out; "
                  "notifications disabled", file=sys.stderr)

    def set_job_id(self, job_id: int) -> None:
        with self._lock:
            self._job_id = job_id
            self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        while self._buffered:
            self._run(self._buffered.pop(0))

    def _run(self, rec: dict) -> None:
        import subprocess

        if rec.get("job") != self._job_id:
            return
        try:
            subprocess.run([self._args.on_notify, json.dumps(rec)],
                           check=False)
        except OSError as e:
            print(f"--on-notify program failed: {e}", file=sys.stderr)

    def _loop(self):
        from hyperqueue_tpu_torch.client.connection import stream_events

        try:
            for msg in stream_events(
                _server_dir(self._args), filters=("task-notify",)
            ):
                if self.stop:
                    break
                op = msg.get("op")
                if op == "stream_live":
                    self._subscribed.set()
                    continue
                if op != "event":
                    continue
                with self._lock:
                    if self._job_id is None:
                        self._buffered.append(msg["record"])
                    else:
                        self._flush_locked()
                        self._run(msg["record"])
        except Exception as e:
            if not self._subscribed.is_set():
                print(f"--on-notify: event stream unavailable ({e}); "
                      "notifications disabled", file=sys.stderr)
                self._subscribed.set()  # unblock the submit
            # post-subscription errors: stream teardown at process exit


_KNOWN_PLACEHOLDERS = {"JOB_ID", "TASK_ID", "INSTANCE_ID", "SUBMIT_DIR",
                       "SERVER_UID", "CWD"}
# a stream dir is shared by the whole job (the format multiplexes tasks),
# so only job-scope placeholders resolve there
_STREAM_PLACEHOLDERS = {"JOB_ID", "SUBMIT_DIR", "SERVER_UID"}


def _check_submit_placeholders(args, is_array: bool) -> None:
    """Submit-time placeholder validation (reference
    tests/test_placeholders.py): a recursive %{CWD} in --cwd is an error;
    unknown placeholders and an array job whose output paths lack
    %{TASK_ID} get loud warnings (the tasks would clobber one file).
    Warnings go to stderr so --output-mode quiet/json stdout stays
    machine-parseable.

    A TASK-scope placeholder (%{TASK_ID}, %{INSTANCE_ID}, %{CWD}) in a
    --stream path is a hard error: the stream dir is shared by the whole
    job, the worker only expands job-scope placeholders there, and the
    unexpanded text would become a literal directory name shared by every
    task (reference behavior; regression-pinned in
    tests/test_tick_cache.py)."""
    pattern = re.compile(r"%\{([^}]*)\}")
    if args.cwd and "%{CWD}" in args.cwd:
        fail("--cwd cannot contain the %{CWD} placeholder")
    if args.stream:
        task_scope = sorted(
            set(pattern.findall(args.stream))
            & (_KNOWN_PLACEHOLDERS - _STREAM_PLACEHOLDERS)
        )
        if task_scope:
            plural = "s" if len(task_scope) > 1 else ""
            fail(
                f"--stream path cannot contain task-scope placeholder"
                f"{plural} {', '.join('%{' + p + '}' for p in task_scope)}:"
                f" the stream directory is shared by the whole job"
            )
    for label, value, known in (
        ("stdout", args.stdout, _KNOWN_PLACEHOLDERS),
        ("stderr", args.stderr, _KNOWN_PLACEHOLDERS),
        ("working directory", args.cwd, _KNOWN_PLACEHOLDERS),
        ("stream log", args.stream, _STREAM_PLACEHOLDERS),
    ):
        if not value:
            continue
        unknown = sorted(set(pattern.findall(value)) - known)
        if unknown:
            plural = "s" if len(unknown) > 1 else ""
            print(f"WARNING: unknown placeholder{plural} "
                  f"{', '.join(unknown)} in {label} path", file=sys.stderr)
    if is_array:
        for channel in ("stdout", "stderr"):
            value = getattr(args, channel)
            if value is None:
                continue  # the default path carries %{TASK_ID}
            covered = "%{TASK_ID}" in value or (
                "%{CWD}" in value and args.cwd and "%{TASK_ID}" in args.cwd
            )
            if not covered:
                print(f"WARNING: array job, but the {channel} path has no "
                      f"%{{TASK_ID}} placeholder — tasks will overwrite "
                      f"each other's output. Consider adding %{{TASK_ID}} "
                      f"to --{channel}.", file=sys.stderr)


def _subset_array_entries(
    task_ids: list[int] | None, entry_values: list[str]
) -> tuple[list[int], list[str]]:
    """--array selects a SUBSET of --each-line/--from-json entries: task
    id = entry index (0-based).  Ids beyond the entry count are removed —
    loudly, and an empty intersection is an error (a typo'd selector must
    not submit zero tasks silently; reference docs/jobs/arrays.md
    "Combining --each-line/--from-json with --array").  `--array all`
    parses to [] = every id, i.e. every entry."""
    if not task_ids:
        return list(range(len(entry_values))), entry_values
    ids = [i for i in task_ids if 0 <= i < len(entry_values)]
    dropped = len(task_ids) - len(ids)
    if not ids:
        fail(
            f"--array selects no tasks: all {len(task_ids)} ids fall "
            f"outside the {len(entry_values)} provided entries "
            f"(valid ids: 0-{len(entry_values) - 1})"
        )
    if dropped:
        print(
            f"WARNING: {dropped} --array id(s) outside the "
            f"{len(entry_values)} provided entries were dropped",
            file=sys.stderr,
        )
    return ids, [entry_values[i] for i in ids]


def _iter_array_chunks(array: dict, chunk_size: int):
    """Split one wire array description into submit chunks; contiguous id
    runs travel as compact "id_range" [start, stop) — O(1) per chunk on
    the wire and in the server's lazy store."""
    ids = array["ids"]
    entries = array.get("entries")
    base = {k: v for k, v in array.items() if k not in ("ids", "entries")}
    for start in range(0, len(ids), chunk_size):
        part = ids[start:start + chunk_size]
        chunk = dict(base)
        if part[-1] - part[0] + 1 == len(part):
            chunk["id_range"] = [part[0], part[0] + len(part)]
        else:
            chunk["ids"] = part
        if entries is not None:
            chunk["entries"] = entries[start:start + chunk_size]
        yield chunk


def _iter_stdin_chunks(array_base: dict, chunk_size: int, lines=None):
    """`hq submit --from-stdin`: one task per stdin line (entry in
    HQ_ENTRY), yielded in chunks WITHOUT ever materializing the whole
    task list client-side — memory is bounded by chunk_size plus the
    in-flight window, no matter how many lines arrive."""
    source = lines if lines is not None else sys.stdin
    next_id = 0
    entries: list[str] = []
    for line in source:
        entries.append(line.rstrip("\n"))
        if len(entries) >= chunk_size:
            chunk = dict(array_base)
            chunk["id_range"] = [next_id, next_id + len(entries)]
            chunk["entries"] = entries
            next_id += len(entries)
            entries = []
            yield chunk
    if entries:
        chunk = dict(array_base)
        chunk["id_range"] = [next_id, next_id + len(entries)]
        chunk["entries"] = entries
        yield chunk


def cmd_submit(args) -> None:
    if not args.command:
        fail("no command given")
    if args.from_stdin and (
        args.array or args.each_line or args.from_json or args.stdin
    ):
        fail("--from-stdin cannot be combined with --array/--each-line/"
             "--from-json/--stdin")
    submit_dir = os.getcwd()
    body_base = {
        "cmd": list(args.command),
        "env": _parse_env(args.env),
        "cwd": args.cwd,
        "stdout": args.stdout,
        "stderr": args.stderr,
        "submit_dir": submit_dir,
    }
    if args.stream:
        body_base["stream"] = os.path.abspath(args.stream)
    if args.pin:
        body_base["pin"] = args.pin
    if args.task_dir:
        body_base["task_dir"] = True
    if args.time_limit:
        body_base["time_limit"] = args.time_limit
    if args.stdin:
        body_base["stdin"] = (
            getattr(args, "_stdin_data", None) or sys.stdin.buffer.read()
        )
    request = _build_request(args)

    task_ids: list[int] | None = None
    entry_values: list[str] | None = None
    if args.array:
        task_ids = parse_selector(args.array)
    _check_submit_placeholders(
        args,
        is_array=args.array is not None or args.each_line is not None
        or args.from_json is not None or args.from_stdin,
    )
    if args.each_line:
        with open(args.each_line) as f:
            entry_values = [line.rstrip("\n") for line in f]
    elif args.from_json:
        with open(args.from_json) as f:
            data = json.load(f)
        if not isinstance(data, list):
            fail("--from-json expects a JSON array")
        entry_values = [json.dumps(v) for v in data]

    # arrays go compressed: one shared body/request + ids (+ entries) — a
    # million-task array must not serialize a million bodies
    job_desc = {
        "name": args.name or Path(args.command[0]).name,
        "submit_dir": submit_dir,
        "max_fails": args.max_fails,
    }
    if entry_values is not None:
        ids, entry_values = _subset_array_entries(task_ids, entry_values)
        job_desc["array"] = {
            "ids": ids, "entries": entry_values, "body": body_base,
            "request": request, "priority": args.priority,
            "crash_limit": args.crash_limit,
        }
    elif task_ids is not None:
        job_desc["array"] = {
            "ids": task_ids, "body": body_base, "request": request,
            "priority": args.priority, "crash_limit": args.crash_limit,
        }
    else:
        job_desc["tasks"] = [
            {"id": 0, "body": body_base, "request": request,
             "priority": args.priority, "crash_limit": args.crash_limit}
        ]
    if args.job is not None:
        job_desc["job_id"] = args.job

    notify_runner = None
    if args.on_notify and (args.wait or args.progress):
        notify_runner = _NotifyRunner(args)
    # streaming chunked ingest (ISSUE 10): stdin feeds, and arrays larger
    # than --chunk-size, go through the pipelined submit_chunk plane
    chunks_iter = None
    chunk_size = max(args.chunk_size, 1) if args.chunk_size else 0
    if args.from_stdin:
        array_base = {
            "body": body_base, "request": request,
            "priority": args.priority, "crash_limit": args.crash_limit,
        }
        chunks_iter = _iter_stdin_chunks(array_base, chunk_size or 16384)
    elif (
        chunk_size
        and job_desc.get("array")
        and len(job_desc["array"].get("ids") or ()) > chunk_size
    ):
        chunks_iter = _iter_array_chunks(job_desc["array"], chunk_size)
    with _session(args) as session:
        # trace-context stamp: the client's send clock opens every task's
        # distributed trace (`hq task trace` client/submit span)
        from hyperqueue_tpu_torch.transport.framing import attach_trace
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        if chunks_iter is not None:
            from hyperqueue_tpu_torch.client.connection import SubmitStream

            header = {
                "name": job_desc["name"], "submit_dir": submit_dir,
                "max_fails": args.max_fails,
            }
            if args.job is not None:
                header["job_id"] = args.job
            stream = SubmitStream(
                session, header, window=args.submit_window
            )
            for chunk in chunks_iter:
                stream.send_chunk(array=chunk)
            stream_job_id, stream_n = stream.finish()
            response = {"job_id": stream_job_id, "n_tasks": stream_n}
        else:
            response = session.request(attach_trace(
                {"op": "submit", "job": job_desc},
                new_trace_id(), sent_at=clock.now(),
            ))
        job_id = response["job_id"]
        if notify_runner is not None:
            notify_runner.set_job_id(job_id)
        out = make_output(args.output_mode)
        if args.output_mode == "quiet":
            out.value(job_id)
        else:
            out.message(
                f"Job submitted successfully, job ID: {job_id}"
                f" ({response['n_tasks']} tasks)"
            )
        try:
            if args.progress:
                jobs = _progress_loop(session, [job_id])
                job = jobs[0] if jobs else None
            elif args.wait:
                info = session.request({"op": "job_wait", "job_ids": [job_id]})
                job = info["jobs"][0] if info["jobs"] else None
            else:
                return
        finally:
            if notify_runner is not None:
                notify_runner.flush()  # buffered notifies of a fast job
                notify_runner.stop = True
        ok = job is not None and not (
            job["counters"]["failed"] or job["counters"]["canceled"]
        )
        if not args.progress:
            out.message(f"job {job_id} {job['status'] if job else 'unknown'}")
        if not ok:
            raise SystemExit(1)


# ---------------------------------------------------------------- job cmds
def cmd_job_list(args) -> None:
    with _session(args) as session:
        jobs = session.request({"op": "job_list"})["jobs"]
    # reference JobListOpts: open/running only by default; --all shows
    # everything; --filter selects explicit states
    if args.filter:
        wanted = set(args.filter.split(","))
        unknown = wanted - {"opened", "waiting", "running", "finished",
                            "failed", "canceled"}
        if unknown:
            fail(f"unknown job state(s) {sorted(unknown)}; valid: "
                 "opened, waiting, running, finished, failed, canceled")
        jobs = [j for j in jobs if j["status"] in wanted]
    elif not args.all:
        # reference hq.rs:95 default: waiting + running + opened
        jobs = [j for j in jobs if j["status"] in ("opened", "waiting",
                                                   "running")]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(jobs)
        return
    headers = ["id", "name", "status", "tasks", "finished", "failed"]
    if args.verbose:
        headers.append("cancel reason")
    out.table(
        headers,
        [
            [
                j["id"],
                j["name"],
                j["status"],
                j["n_tasks"],
                j["counters"]["finished"],
                j["counters"]["failed"],
            ] + ([j.get("cancel_reason", "")] if args.verbose else [])
            for j in sorted(jobs, key=lambda j: j["id"])
        ],
    )


def cmd_job_summary(args) -> None:
    """Per-status job counts (reference cli.rs:514 print_job_summary,
    JOB_SUMMARY_STATUS_ORDER rows even when a count is zero)."""
    with _session(args) as session:
        jobs = session.request({"op": "job_list"})["jobs"]
    order = ["running", "waiting", "opened", "finished", "failed", "canceled"]
    counts = {status: 0 for status in order}
    for j in jobs:
        counts[j["status"]] = counts.get(j["status"], 0) + 1
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(counts)
        return
    out.table(["status", "count"], [[s, counts[s]] for s in counts])


def cmd_job_info(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(jobs)
        return
    for job in jobs:
        record = {k: v for k, v in job.items() if k != "tasks"}
        record["counters"] = " ".join(
            f"{k}={v}" for k, v in record.pop("counters").items()
        )
        # "37 tasks waiting: 30 insufficient-capacity, 7 gang-incomplete"
        reasons = record.pop("pending_reasons", None)
        if reasons:
            from hyperqueue_tpu_torch.scheduler.decision import (
                format_reason_counts,
            )

            total = sum(reasons.values())
            record["pending"] = (
                f"{total} task(s) waiting: {format_reason_counts(reasons)}"
            )
        out.record(record)


def cmd_job_wait(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        t0 = clock.now()
        jobs = session.request({"op": "job_wait", "job_ids": ids})["jobs"]
    out = make_output(args.output_mode)
    bad = [
        j for j in jobs
        if j["counters"]["failed"] or j["counters"]["canceled"]
    ]
    out.message(
        f"waited {clock.now() - t0:.1f}s; "
        f"{len(jobs) - len(bad)} succeeded, {len(bad)} with failures"
    )
    if bad:
        raise SystemExit(1)


def cmd_job_timeline(args) -> None:
    """Task lifecycle timeline of selected jobs: per-phase
    (pending/queued/dispatch/run) percentiles plus a slowest-task
    drill-down, aggregated server-side from the same lifecycle stamps the
    event journal carries."""
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        results = []
        for job_id in ids:
            results.append(session.request(
                {"op": "job_timeline", "job_id": job_id,
                 "detail": bool(args.tasks)}
            ))
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        for r in results:
            r.pop("op", None)
        out.value(results)
        return
    for r in results:
        out.message(
            f"job {r['job']}: {r['n_finished']}/{r['n_tasks']} tasks "
            f"finished, makespan {r['makespan']:.3f}s"
        )
        out.table(
            ["phase", "count", "p50 (s)", "p95 (s)", "max (s)", "mean (s)",
             "total (s)"],
            [
                [
                    name,
                    row["count"],
                    f"{row['p50']:.4f}",
                    f"{row['p95']:.4f}",
                    f"{row['max']:.4f}",
                    f"{row['mean']:.4f}",
                    f"{row['total']:.3f}",
                ]
                for name, row in r["phases"].items()
            ],
        )
        if r.get("slowest"):
            out.message("slowest tasks:")
            out.table(
                ["task", "pending", "queued", "dispatch", "run",
                 "total (s)"],
                [
                    [
                        t["id"],
                        f"{t['phases']['pending']:.4f}",
                        f"{t['phases']['queued']:.4f}",
                        f"{t['phases']['dispatch']:.4f}",
                        f"{t['phases']['run']:.4f}",
                        f"{t['finished'] - t['submitted']:.3f}",
                    ]
                    for t in r["slowest"]
                ],
            )


def cmd_server_reset_metrics(args) -> None:
    """Zero the server's metrics plane (registry, tracer spans, tick-phase
    aggregates) so a benchmark can measure a steady-state window. Under a
    federation root, `--shard K|all` selects the shard(s) — `all` fans
    out so one reset opens a fleet-wide window."""
    out = make_output(args.output_mode)
    shard = getattr(args, "shard", None)
    with _session(args) as session:
        if shard is not None and not isinstance(session, FederatedSession):
            # selector convention (cf. `hq top --shard`): a classic dir
            # must not silently ignore the flag — the user would believe
            # a shard-targeted window was opened when it was not
            fail(f"--shard needs a federation root; "
                 f"{_server_dir(args)} is a classic server dir")
        result = session.request({"op": "reset_metrics", "shard": shard})
    if "shards" in result:
        for k, rec in enumerate(result["shards"]):
            if rec.get("error"):
                out.message(f"shard {k}: DOWN ({rec['error']})")
            else:
                out.message(f"shard {k}: metrics reset")
        return
    out.message("metrics reset")


def cmd_server_profile(args) -> None:
    """Pull flamegraph-ready folded stacks from the server's sampling
    profiler (`hq server profile`). With --seconds N the server diffs its
    cumulative trie across an N-second window (so the output shows only
    that window); without it you get the whole-run aggregate. Pipe the
    folded output straight into flamegraph.pl / speedscope."""
    seconds = args.seconds or 0.0
    with _session(args) as session:
        result = session.request({
            "op": "profile",
            "seconds": seconds,
            "shard": getattr(args, "shard", None),
        })
    records = result.get("shards")
    if records is None:
        records = [result]
    if args.format == "json":
        print(json.dumps(result, default=str))
        return
    for rec in records:
        shard = rec.get("shard", rec.get("shard_id"))
        if rec.get("error"):
            print(f"# shard {shard}: DOWN ({rec['error']})",
                  file=sys.stderr)
            continue
        if len(records) > 1:
            print(f"# shard {shard}", file=sys.stderr)
        print(
            f"# mode={rec.get('mode')} hz={rec.get('hz')} "
            f"passes={rec.get('passes')} seconds={rec.get('seconds')}",
            file=sys.stderr,
        )
        folded = rec.get("folded") or ""
        if folded:
            print(folded, end="" if folded.endswith("\n") else "\n")


_ACCOUNTING_HEADER = [
    "job", "label", "task s", "cpu s", "gpu s", "wait s", "crash",
    "runs", "done", "fail", "run",
]


def cmd_job_accounting(args) -> None:
    """Per-job usage ledger rows (ISSUE 18): closed run-span charges
    folded from the journal — stable under restore/replay/migration."""
    out = make_output(args.output_mode)
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        result = session.request({"op": "accounting", "job_ids": ids})
    rows = result.get("jobs") or []
    if not rows:
        fail("no accounting rows for that selector")
    out.table(
        _ACCOUNTING_HEADER,
        [
            [
                r["job"], r["label"],
                f"{r['task_seconds']:.3f}",
                f"{r['cpu_seconds']:.3f}",
                f"{r['gpu_seconds']:.3f}",
                f"{r['wait_seconds']:.3f}",
                r["crash_retries"], r["runs"], r["finished"],
                r["failed"], r["running"],
            ]
            for r in rows
        ],
    )


def cmd_fleet_accounting(args) -> None:
    """Per-label usage rollup across every shard (`hq fleet accounting`;
    also answers on a classic dir as a single-shard rollup)."""
    out = make_output(args.output_mode)
    with _session(args) as session:
        if isinstance(session, FederatedSession):
            result = session.request({"op": "accounting", "shard": "all"})
            records = [
                rec for rec in result["shards"] if not rec.get("error")
            ]
        else:
            records = [session.request({"op": "accounting"})]
    header = ["shard", "label", "jobs", "task s", "cpu s", "gpu s",
              "wait s", "crash", "run"]
    rows = []
    for rec in records:
        rollup = rec.get("rollup") or {}
        shard = rec.get("shard", 0)
        for label, agg in (rollup.get("labels") or {}).items():
            rows.append([
                shard, label, agg["jobs"],
                f"{agg['task_seconds']:.3f}",
                f"{agg['cpu_seconds']:.3f}",
                f"{agg['gpu_seconds']:.3f}",
                f"{agg['wait_seconds']:.3f}",
                agg["crash_retries"], agg["running"],
            ])
        totals = rollup.get("totals")
        if totals and totals["jobs"]:
            rows.append([
                shard, "(total)", totals["jobs"],
                f"{totals['task_seconds']:.3f}",
                f"{totals['cpu_seconds']:.3f}",
                f"{totals['gpu_seconds']:.3f}",
                f"{totals['wait_seconds']:.3f}",
                totals["crash_retries"], totals["running"],
            ])
    if not rows:
        out.message("no usage recorded yet")
        return
    out.table(header, rows)


def cmd_alerts(args) -> None:
    """`hq alerts [--shard K|all]`: firing SLO burn-rate alerts + the
    most recent transitions, per shard."""
    out = make_output(args.output_mode)
    shard = getattr(args, "shard", None)
    with _session(args) as session:
        if isinstance(session, FederatedSession):
            result = session.request(
                {"op": "alerts", "shard": shard if shard is not None
                 else "all"}
            )
            records = result.get("shards") or [result]
        else:
            if shard is not None:
                fail(f"--shard needs a federation root; "
                     f"{_server_dir(args)} is a classic server dir")
            records = [session.request({"op": "alerts"})]
    rows = []
    for rec in records:
        if rec.get("error"):
            rows.append([rec.get("shard_id", "?"), "shard-availability",
                         "page", "DOWN", "-", "-"])
            continue
        for alert in rec.get("firing") or []:
            rows.append([
                rec.get("shard", 0), alert["slo"], alert["severity"],
                "firing",
                f"{alert['burn_rate']:.2f}x",
                "/".join(f"{w:g}s" for w in alert.get("window") or ()),
            ])
    if rows:
        out.table(
            ["shard", "slo", "severity", "state", "burn", "windows"],
            rows,
        )
    else:
        out.message("no alerts firing")
    recent = [
        t for rec in records if not rec.get("error")
        for t in rec.get("recent") or []
    ]
    if recent and args.output_mode == "cli":
        out.message("recent transitions:")
        for t in recent[-10:]:
            out.message(
                f"  {t['alert']}: {t['state']} "
                f"(burn {t['burn_rate']:.2f}x)"
            )


def cmd_job_cancel(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        result = session.request({"op": "job_cancel", "job_ids": ids})["result"]
    make_output(args.output_mode).value(result)


def cmd_job_forget(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        result = session.request({"op": "job_forget", "job_ids": ids})
    make_output(args.output_mode).message(
        f"forgot {result['forgotten']} job(s)"
    )


def cmd_job_cat(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
    if not jobs:
        fail("job not found")
    stream = args.stream
    for job in jobs:
        detail = job
        task_filter = (
            set(parse_selector(args.tasks)) or None  # 'all' -> [] = all tasks
        ) if args.tasks else None
        for task in detail["tasks"]:
            if task_filter is not None and task["id"] not in task_filter:
                continue
            mapping = {
                "JOB_ID": str(job["id"]),
                "TASK_ID": str(task["id"]),
                "INSTANCE_ID": "0",
                "SUBMIT_DIR": job["submit_dir"],
            }
            path = fill_placeholders(
                f"%{{SUBMIT_DIR}}/job-%{{JOB_ID}}/%{{TASK_ID}}.{stream}", mapping
            )
            if os.path.exists(path):
                with open(path, "rb") as f:
                    sys.stdout.buffer.write(f.read())
    sys.stdout.flush()


def _progress_loop(session, ids: list[int]) -> list[dict]:
    """Poll + render a progress line until every job in `ids` is done;
    returns the final job infos."""
    while True:
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
        parts = []
        all_done = True
        for j in jobs:
            c = j["counters"]
            done = c["finished"] + c["failed"] + c["canceled"]
            parts.append(
                f"job {j['id']}: {done}/{j['n_tasks']} "
                f"(run {c['running']}, fail {c['failed']})"
            )
            if done < j["n_tasks"] or j["status"] == "running":
                all_done = False
        print("\r" + " | ".join(parts) + " " * 8, end="", flush=True)
        if all_done:
            print()
            return jobs
        time.sleep(0.5)


def cmd_job_progress(args) -> None:
    """Live progress display while jobs run (reference `hq job progress`)."""
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        _progress_loop(session, ids)


def _format_id_ranges(ids: list[int]) -> str:
    """Compact `1-3,5,7-9` rendering of a sorted id list."""
    parts: list[str] = []
    i = 0
    ids = sorted(ids)
    while i < len(ids):
        j = i
        while j + 1 < len(ids) and ids[j + 1] == ids[j] + 1:
            j += 1
        parts.append(str(ids[i]) if i == j else f"{ids[i]}-{ids[j]}")
        i = j + 1
    return ",".join(parts)


def cmd_job_task_ids(args) -> None:
    """Print the task ids of selected jobs, optionally filtered by task
    status (reference JobCommand::TaskIds, commands/job.rs)."""
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
    statuses = set(args.filter.split(",")) if args.filter else None
    per_job = {
        j["id"]: [
            t["id"] for t in j["tasks"]
            if statuses is None or t["status"] in statuses
        ]
        for j in jobs
    }
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(per_job)
        return
    for job_id, task_ids in per_job.items():
        print(f"{job_id}: {_format_id_ranges(task_ids)}")


def cmd_doc(args) -> None:
    docs_root = Path(__file__).resolve().parent.parent.parent / "docs"
    topic = args.topic or "index"
    # `hq doc arrays` or `hq doc jobs/arrays` — search every docs subtree
    # (reference: cli/documentation.md, `hq doc` opens a topic index)
    candidates = [docs_root / f"{topic}.md", docs_root / topic / "README.md"]
    if "/" not in topic:
        # bare names search every subtree; explicit paths must match
        # exactly (a typo'd path should error, not print a random page)
        candidates += sorted(docs_root.rglob(f"{topic}.md"))
    for candidate in candidates:
        if candidate.exists():
            print(candidate.read_text())
            return
    available = sorted(
        str(p.relative_to(docs_root))[:-3] for p in docs_root.rglob("*.md")
    )
    fail(f"unknown topic {topic!r}; available: {', '.join(available)}")


def cmd_generate_completion(args) -> None:
    """Emit a completion script for the hq CLI (top-level commands, their
    subcommands, and per-command long options, walked from the real parser
    tree — reference uses clap_complete with a shell argument). zsh reuses
    the bash script through bashcompinit; fish gets native complete
    lines."""
    parser = build_parser()

    def sub_actions(p):
        return [a for a in p._actions
                if isinstance(a, argparse._SubParsersAction)]

    def long_opts(p):
        out = []
        for a in p._actions:
            out.extend(s for s in a.option_strings if s.startswith("--"))
        return out

    subs = sub_actions(parser)
    top_choices = subs[0].choices if subs else {}

    if args.shell == "fish":
        lines = [
            f'complete -c hq -f -n "__fish_use_subcommand" '
            f'-a "{" ".join(top_choices)}"'
        ]
        for name, sub_parser in top_choices.items():
            nested = sub_actions(sub_parser)
            if nested:
                nested_names = " ".join(nested[0].choices)
                # suggest verbs only until one is typed; afterwards fall
                # through to per-verb options + default file completion
                lines.append(
                    f'complete -c hq -f '
                    f'-n "__fish_seen_subcommand_from {name}; and not '
                    f'__fish_seen_subcommand_from {nested_names}" '
                    f'-a "{nested_names}"'
                )
                for nname, nparser in nested[0].choices.items():
                    for opt in sorted(set(long_opts(nparser))):
                        lines.append(
                            f'complete -c hq '
                            f'-n "__fish_seen_subcommand_from {name}; and '
                            f'__fish_seen_subcommand_from {nname}" '
                            f'-l {opt.lstrip("-")}'
                        )
            for opt in sorted(set(long_opts(sub_parser))):
                lines.append(
                    f'complete -c hq '
                    f'-n "__fish_seen_subcommand_from {name}" '
                    f'-l {opt.lstrip("-")}'
                )
        print("\n".join(lines))
        return

    lines = [
        "_hq_complete() {",
        '  local cur=${COMP_WORDS[COMP_CWORD]}',
        '  local cmd=${COMP_WORDS[1]:-}',
        '  local sub=${COMP_WORDS[2]:-}',
        "  if [ $COMP_CWORD -eq 1 ]; then",
        f'    COMPREPLY=( $(compgen -W "{" ".join(top_choices)}" -- "$cur") )',
        "    return",
        "  fi",
        '  case "$cmd" in',
    ]
    for name, sub_parser in top_choices.items():
        nested = sub_actions(sub_parser)
        own_opts = sorted(set(long_opts(sub_parser)))
        if nested:
            nested_choices = nested[0].choices
            second = " ".join([*nested_choices, *own_opts])
            lines.append(f"    {name})")
            lines.append("      if [ $COMP_CWORD -eq 2 ]; then")
            lines.append(
                f'        COMPREPLY=( $(compgen -W "{second}" -- "$cur") )'
            )
            lines.append("        return")
            lines.append("      fi")
            lines.append('      case "$sub" in')
            for nname, nparser in nested_choices.items():
                nwords = " ".join(sorted(set(long_opts(nparser))))
                # only complete flags when one is being typed; bare
                # positions fall through to bash's default (filenames)
                lines.append(
                    f'        {nname}) [[ "$cur" == -* ]] && '
                    f'COMPREPLY=( $(compgen -W "{nwords}" -- "$cur") );'
                    " return;;"
                )
            lines.append("      esac")
            lines.append("      ;;")
        else:
            opt_words = " ".join(own_opts)
            lines.append(
                f'    {name}) [[ "$cur" == -* ]] && '
                f'COMPREPLY=( $(compgen -W "{opt_words}" -- "$cur") );'
                " return;;"
            )
    lines += [
        "  esac",
        "}",
        "complete -o default -F _hq_complete hq",
        'complete -o default -F _hq_complete "python -m hyperqueue_tpu_torch"'
        " 2>/dev/null || true",
    ]
    if args.shell == "zsh":
        # zsh consumes the bash script through its compatibility layer;
        # compinit must load first or bashcompinit's complete shim has no
        # compdef to call
        lines = [
            "autoload -U +X compinit && compinit",
            "autoload -U +X bashcompinit && bashcompinit",
        ] + lines
    print("\n".join(lines))


def cmd_job_open(args) -> None:
    with _session(args) as session:
        response = session.request(
            {"op": "open_job", "name": args.name or "job",
             "submit_dir": os.getcwd(), "max_fails": args.max_fails}
        )
    out = make_output(args.output_mode)
    if args.output_mode == "quiet":
        out.value(response["job_id"])
    else:
        out.message(f"opened job {response['job_id']}")


def cmd_job_close(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        response = session.request({"op": "close_job", "job_ids": ids})
    make_output(args.output_mode).message(f"closed jobs: {response['closed']}")


# ---------------------------------------------------------------- alloc
def _alloc_params(args) -> dict:
    return {
        "manager": args.manager,
        "backlog": args.backlog,
        "workers_per_alloc": args.workers_per_alloc,
        "max_worker_count": args.max_worker_count or 0,
        "time_limit_secs": args.time_limit,
        "name": args.name or "",
        "worker_args": (args.worker_args or [])
        + (
            ["--min-utilization", str(args.min_utilization)]
            if args.min_utilization
            else []
        ),
        "additional_args": args.additional_args or [],
        "idle_timeout_secs": args.idle_timeout,
        "worker_start_cmd": args.worker_start_cmd or "",
        "worker_stop_cmd": args.worker_stop_cmd or "",
        "worker_wrap_cmd": args.worker_wrap_cmd or "",
        "worker_time_limit_secs": args.worker_time_limit or 0.0,
        "on_server_lost": args.on_server_lost,
    }


def cmd_alloc_add(args) -> None:
    with _session(args) as session:
        response = session.request(
            {"op": "alloc_add", "params": _alloc_params(args),
             "no_dry_run": args.no_dry_run}
        )
    out = make_output(args.output_mode)
    if args.output_mode == "quiet":
        out.value(response["queue_id"])
    else:
        out.message(f"allocation queue {response['queue_id']} created")


def cmd_alloc_list(args) -> None:
    with _session(args) as session:
        queues = session.request({"op": "alloc_list"})["queues"]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(queues)
        return
    out.table(
        ["id", "manager", "state", "backlog", "workers/alloc", "allocations"],
        [
            [
                q["id"],
                q["params"]["manager"],
                q["state"],
                q["params"]["backlog"],
                q["params"]["workers_per_alloc"],
                len(q["allocations"]),
            ]
            for q in queues
        ],
    )


def cmd_alloc_info(args) -> None:
    with _session(args) as session:
        queues = session.request({"op": "alloc_list"})["queues"]
    queue = next((q for q in queues if q["id"] == args.queue_id), None)
    if queue is None:
        fail(f"allocation queue {args.queue_id} not found")
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(queue)
        return
    out.table(
        ["alloc", "status", "workers", "connected"],
        [
            [a["id"], a["status"], a["worker_count"], len(a["workers"])]
            for a in queue["allocations"]
        ],
    )


def cmd_alloc_log(args) -> None:
    """Print the manager-captured stdout/stderr of one allocation
    (reference commands/autoalloc.rs AutoAllocCommand::Log)."""
    with _session(args) as session:
        response = session.request(
            {"op": "alloc_log", "allocation_id": args.allocation_id}
        )
    alloc = response["allocation"]
    path = Path(alloc["workdir"]) / args.channel
    if not path.exists():
        fail(
            f"allocation {args.allocation_id} has no captured {args.channel} "
            f"(expected at {path}; the allocation may not have started yet)"
        )
    sys.stdout.write(path.read_text(errors="replace"))
    sys.stdout.flush()


def cmd_alloc_remove(args) -> None:
    with _session(args) as session:
        session.request({"op": "alloc_remove", "queue_id": args.queue_id})
    make_output(args.output_mode).message(
        f"allocation queue {args.queue_id} removed"
    )


def cmd_alloc_pause(args) -> None:
    with _session(args) as session:
        response = session.request(
            {"op": "alloc_pause", "queue_id": args.queue_id,
             "pause": args.alloc_cmd == "pause"}
        )
    make_output(args.output_mode).message(
        f"allocation queue {args.queue_id} is now {response['state']}"
    )


def cmd_alloc_dry_run(args) -> None:
    with _session(args) as session:
        response = session.request(
            {"op": "alloc_dry_run", "params": _alloc_params(args)}
        )
    out = make_output(args.output_mode)
    out.message(f"would submit via {response['submit_binary']}:")
    out.message(response["script"])


def cmd_alloc_events(args) -> None:
    """Scale decision records: why the elasticity controller did (or
    deliberately did not) scale each queue (ISSUE 13)."""
    with _session(args) as session:
        decisions = session.request({"op": "alloc_events"})["decisions"]
    if args.queue_id is not None:
        decisions = [d for d in decisions if d["queue"] == args.queue_id]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(decisions)
        return
    out.table(
        ["time", "queue", "verdict", "reason", "ticks", "detail"],
        [
            [
                time.strftime("%H:%M:%S", time.localtime(d["time"])),
                d["queue"],
                d["verdict"],
                d["reason"],
                d["ticks"],
                d.get("detail", ""),
            ]
            for d in decisions
        ],
    )


# ---------------------------------------------------------------- journal
def cmd_journal_export(args) -> None:
    from hyperqueue_tpu_torch.events.journal import Journal

    for record in Journal.read_all(
        Path(args.journal_file), salvage=getattr(args, "salvage", False)
    ):
        print(json.dumps(record, default=str))


def cmd_journal_flush(args) -> None:
    with _session(args) as session:
        session.request({"op": "journal_flush"})
    make_output(args.output_mode).message("journal flushed")


def cmd_journal_prune(args) -> None:
    with _session(args) as session:
        result = session.request({"op": "journal_prune"})
    make_output(args.output_mode).message(
        f"journal pruned: kept {result['kept_records']} records "
        f"for live jobs {result['live_jobs']}"
    )


def cmd_journal_compact(args) -> None:
    """Snapshot live server state + GC the superseded journal prefix."""
    with _session(args) as session:
        result = session.request({"op": "journal_compact"})
    out = make_output(args.output_mode)
    if args.output_mode != "cli":
        result.pop("op", None)
        out.record(result)
        return
    if result.get("skipped"):
        out.message(f"compaction skipped: {result['skipped']}")
        return
    out.message(
        f"journal compacted: {result['kept_records']} records kept, "
        f"{result['dropped_records']} dropped, "
        f"{result['journal_bytes_before']} -> "
        f"{result['journal_bytes_after']} bytes "
        f"(snapshot {result['snapshot_bytes']} bytes, "
        f"{result['duration_ms']} ms)"
    )


def cmd_journal_info(args) -> None:
    """Journal + snapshot sizes, lineage, and compaction/restore stats."""
    with _session(args) as session:
        info = session.request({"op": "journal_info"})
    if args.output_mode != "cli":
        info.pop("op", None)
        make_output(args.output_mode).record(info)
        return
    snap = info.get("snapshot") or {}
    print(f"journal: {info['path']} ({info['journal_bytes']} bytes, "
          f"{info['segments']} segment(s), fsync {info['fsync_policy']})")
    print(f"event seq: {info['event_seq']}  boots: {info['n_boots']}")
    if snap.get("bytes"):
        print(f"snapshot: {snap['path']} ({snap['bytes']} bytes, "
              f"age {snap['age_seconds']:.0f}s"
              + (f", prev {snap['prev_bytes']} bytes" if snap.get("prev_bytes")
                 else "") + ")")
    else:
        print("snapshot: none")
    lc = info.get("last_compaction")
    if lc:
        print(f"last compaction ({lc['reason']}): kept {lc['kept_records']}, "
              f"dropped {lc['dropped_records']}, "
              f"{lc['journal_bytes_before']} -> "
              f"{lc['journal_bytes_after']} bytes in {lc['duration_ms']} ms")
    lr = info.get("last_restore")
    if lr:
        print(f"last restore: {lr['duration_s']}s "
              f"({'snapshot ' + lr['snapshot'] if lr['snapshot'] else 'full replay'}, "
              f"{lr['tail_events']} tail events, "
              f"{lr['resubmitted']} resubmitted, "
              f"{lr['held_for_reattach']} held)")
    if info.get("compact_interval") or info.get("compact_threshold"):
        print(f"auto-compaction: every {info['compact_interval']}s"
              f" / over {info['compact_threshold']} bytes")


def cmd_journal_report(args) -> None:
    from hyperqueue_tpu_torch.client.report import build_report

    html_text = build_report(
        args.journal_file,
        start_time=args.start_time,
        end_time=args.end_time,
    )
    output = args.output or "hq-report.html"
    with open(output, "w") as f:
        f.write(html_text)
    make_output(args.output_mode).message(f"report written to {output}")


def cmd_journal_replay(args) -> None:
    """Offline NDJSON replay (alias of export; reference `journal replay`
    streams through a server — the journal format is identical)."""
    cmd_journal_export(args)


def cmd_journal_stream(args) -> None:
    from hyperqueue_tpu_torch.client.connection import stream_events

    try:
        for msg in stream_events(
            _server_dir(args),
            history=args.history,
            filters=args.filter or [],
        ):
            if msg.get("op") == "event":
                print(json.dumps(msg["record"], default=str), flush=True)
            elif msg.get("op") == "stream_live" and not args.follow:
                return
    except (ConnectionError, OSError, EOFError):
        pass


# ---------------------------------------------------------------- output-log
def cmd_output_log(args) -> None:
    from hyperqueue_tpu_torch.events.outputlog import STDERR, STDOUT, OutputLog

    log = OutputLog(args.stream_dir)
    out = make_output(args.output_mode)
    if args.log_cmd == "summary":
        out.record(log.summary())
    elif args.log_cmd == "jobs":
        # reference outputlog.rs:349 — one job id per line
        if args.output_mode == "json":
            out.value(log.job_ids())
        else:
            for job_id in log.job_ids():
                print(job_id)
    elif args.log_cmd == "cat":
        from hyperqueue_tpu_torch.ids import task_id_task

        channel = STDOUT if args.channel == "stdout" else STDERR
        # stream records carry packed (job, task) ids; --tasks selects by the
        # job-task part
        wanted = (
            set(parse_selector(args.tasks)) or None  # 'all' parses to [] = all tasks
        ) if args.tasks else None
        for task_id in log.task_ids():
            if wanted is None or task_id_task(task_id) in wanted:
                sys.stdout.buffer.write(log.cat(task_id, channel))
        sys.stdout.flush()
    elif args.log_cmd == "show":
        for rec in log.export():
            for line in rec["data"].splitlines():
                print(f"{rec['task']}:{rec['channel'][-3:]}> {line}")
    elif args.log_cmd == "export":
        for rec in log.export():
            print(json.dumps(rec))


def cmd_dashboard(args) -> None:
    from hyperqueue_tpu_torch.client.dashboard import run_dashboard

    try:
        run_dashboard(
            _server_dir(args) if not args.replay else None,
            interval=args.interval,
            replay=args.replay,
        )
    except KeyboardInterrupt:
        pass


# ---------------------------------------------------------------- task cmds
def cmd_task_list(args) -> None:
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value([{"job": j["id"], "tasks": j["tasks"]} for j in jobs])
        return
    for job in jobs:
        out.table(
            ["job", "task", "status", "workers", "error"],
            [
                [job["id"], t["id"], t["status"],
                 ",".join(map(str, t["workers"])), t["error"][:60]]
                for t in job["tasks"]
            ],
        )


def cmd_task_info(args) -> None:
    """Detailed info for selected tasks of a job (reference
    TaskCommand::Info, client/task.rs)."""
    with _session(args) as session:
        ids = _resolve_job_selector(session, args.selector)
        jobs = session.request({"op": "job_info", "job_ids": ids})["jobs"]
    if not jobs:
        fail("job not found")
    wanted = (
        set(parse_selector(args.tasks)) or None  # 'all' parses to [] = all tasks
    ) if args.tasks else None
    rows = []
    for job in jobs:
        for t in job["tasks"]:
            if wanted is not None and t["id"] not in wanted:
                continue
            rows.append((job, t))
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value([
            {"job": job["id"], **t} for job, t in rows
        ])
        return
    for job, t in rows:
        runtime = ""
        if t["started_at"] and t["finished_at"]:
            runtime = f"{t['finished_at'] - t['started_at']:.3f}s"
        out.record({
            "job": job["id"],
            "task": t["id"],
            "status": t["status"],
            "workers": ",".join(map(str, t["workers"])),
            "started": _format_time(t["started_at"]),
            "finished": _format_time(t["finished_at"]),
            "runtime": runtime,
            "error": t["error"],
        })


def _format_time(ts: float) -> str:
    if not ts:
        return ""
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


def cmd_worker_hwdetect(args) -> None:
    """Detect and print this node's resources without starting a worker
    (reference WorkerCommand::HwDetect)."""
    from hyperqueue_tpu_torch.worker.hwdetect import detect_resources

    descriptor = detect_resources(
        n_cpus=None,
        no_hyper_threading=args.no_hyper_threading,
        with_memory=True,
    )
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(descriptor.to_dict())
        return
    for item in descriptor.items:
        groups = item.index_groups()
        if item.kind.value == "sum":
            print(f"{item.name}: sum({item.total_amount()})")
        elif len(groups) > 1:
            print(f"{item.name}: {len(groups)} groups "
                  f"{[len(g) for g in groups]} "
                  f"({sum(len(g) for g in groups)} total)")
        else:
            print(f"{item.name}: {len(groups[0]) if groups else 0}")
    if descriptor.coupling:
        print(f"coupling: {', '.join(descriptor.coupling.names)}")


# ---------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="hq", description="HyperQueue-TPU: task-graph execution framework"
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    # server
    server = sub.add_parser("server", help="server management")
    ssub = server.add_subparsers(dest="server_cmd", required=True)
    p = ssub.add_parser("start")
    _add_common(p)
    p.add_argument("--host", default=None)
    p.add_argument("--client-port", type=int, default=0)
    p.add_argument("--worker-port", type=int, default=0)
    p.add_argument("--disable-client-authentication", action="store_true")
    p.add_argument("--disable-worker-authentication", action="store_true")
    p.add_argument("--scheduler",
                   choices=["auto", "cpu", "tpu", "milp", "multichip",
                            "greedy-numpy", "greedy-fused"],
                   default="auto",
                   help="auto/tpu run the greedy cut-scan on the CUDA "
                        "device, cpu its plain version on the CPU (the "
                        "only choice that solves off the card); "
                        "milp runs the exact host MILP (accuracy oracle); "
                        "multichip shards the cut-scan's worker axis over "
                        "shards of the card (identical semantics); "
                        "greedy-numpy pins the host numpy kernel; "
                        "greedy-fused additionally folds gang rows and "
                        "mask columns into the one dense solve "
                        "(docs/scheduler.md)")
    p.add_argument("--journal", default=None)
    p.add_argument("--journal-fsync", choices=["never", "periodic", "always"],
                   default="never",
                   help="fsync policy for the journal: never = fsync only "
                        "on clean close (flush-to-OS still per event), "
                        "periodic = fsync on the flush period, always = "
                        "fsync after every event (survives an OS crash)")
    p.add_argument("--heartbeat-timeout-factor", type=float, default=4.0,
                   metavar="X",
                   help="drop a worker after X missed heartbeat intervals "
                        "(timeout = heartbeat x X, floor 2s)")
    p.add_argument("--reattach-timeout", type=_parse_duration, default=15.0,
                   help="after a journal restore, hold maybe-running tasks "
                        "this long for their pre-crash worker to reconnect "
                        "and reclaim them before requeueing (0 = requeue "
                        "immediately)")
    p.add_argument("--solver-watchdog-timeout", type=_parse_duration,
                   default=5.0,
                   help="per-tick solve deadline before degrading to the "
                        "host greedy fallback (0 = exception guard only)")
    p.add_argument("--solver-rearm-ticks", type=int, default=20, metavar="N",
                   help="clean fallback ticks before re-trying a failed "
                        "primary solver")
    p.add_argument("--journal-flush-period", type=_parse_duration, default=0.0,
                   help="flush the journal on this period instead of after "
                        "every event (0 = per-event, the default)")
    p.add_argument("--journal-compact-interval", type=_parse_duration,
                   default=0.0,
                   help="snapshot live state and GC the superseded journal "
                        "prefix on this period (0 = no periodic compaction; "
                        "`hq journal compact` still works)")
    p.add_argument("--journal-compact-threshold", type=int, default=0,
                   metavar="BYTES",
                   help="also compact whenever the journal file exceeds "
                        "this many bytes (0 = no size trigger)")
    p.add_argument("--journal-salvage", action="store_true",
                   help="skip mid-file CRC-corrupt journal records (counted "
                        "in hq_journal_salvaged_records_total) instead of "
                        "refusing to start; torn tails are always handled")
    p.add_argument("--idle-timeout", type=_parse_duration, default=0.0,
                   help="default idle timeout adopted by workers that set "
                        "none of their own")
    p.add_argument("--access-file", default=None,
                   help="start with pre-shared keys/ports from generate-access")
    p.add_argument("--paranoid-tick", type=int, default=0, metavar="N",
                   help="debug: every N ticks, run the incremental and the "
                        "from-scratch tick assembly and assert they are "
                        "bit-identical (0 = off); on the device-resident "
                        "solve path the same cadence re-solves from a "
                        "fresh full upload and asserts identical counts, "
                        "and forces --tick-pipeline ticks synchronous")
    p.add_argument("--tick-pipeline", action="store_true",
                   help="two-stage async scheduling ticks: dispatch solve "
                        "N without blocking and map it at tick N+1, "
                        "overlapping device execution with inter-tick "
                        "host work (scheduler/pipeline.py); assignments "
                        "lag one tick")
    p.add_argument("--policy-file", default=None, metavar="TOML",
                   help="weighted scheduling objective (requires "
                        "--scheduler greedy-fused): TOML with [affinity] "
                        "per-(task-class, worker-group) weight rows "
                        "(0 = hard exclusion), [fairness] dominant-"
                        "resource-deficit priority boosts, and "
                        "[prediction] runtime-EWMA critical-path boosts "
                        "(docs/scheduler.md \"Scheduling policies\")")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus metrics on this port (0 = "
                        "ephemeral, see `hq server info`; off by default)")
    p.add_argument("--metrics-host", default="0.0.0.0", metavar="HOST",
                   help="bind address for the (unauthenticated) metrics "
                        "endpoint; use 127.0.0.1 behind a scraping sidecar")
    p.add_argument("--flight-recorder-ticks", type=int, default=512,
                   metavar="N",
                   help="keep the last N per-tick scheduling DecisionRecords"
                        " in memory for `hq server flight-recorder dump` / "
                        "`hq task explain` / `hq server trace export` "
                        "(0 = off)")
    p.add_argument("--log-format", choices=["plain", "json"],
                   default=os.environ.get("HQ_LOG_FORMAT", "plain"),
                   help="json: one JSON object per log line with "
                        "tick/job/task/worker correlation fields")
    p.add_argument("--stall-budget", type=_parse_duration, default=1.0,
                   help="reactor stall watchdog: when one work class "
                        "(rpc/journal/solve/fanout) or the loop itself "
                        "holds the event loop longer than this, auto-dump "
                        "flight recorder + trace + lag stats into the "
                        "instance dir (0 = record lag histograms only, "
                        "never capture)")
    p.add_argument("--stall-dumps", type=int, default=8, metavar="N",
                   help="keep at most N stall dump files")
    p.add_argument("--profile-hz", type=float, default=19.0, metavar="HZ",
                   help="always-on sampling profiler: walk every thread's "
                        "stack HZ times per second and fold the samples "
                        "into per-plane CPU-share gauges (hq_profile_*) "
                        "plus flamegraph data for `hq server profile` "
                        "(0 = off; the odd default avoids beating against "
                        "periodic work)")
    p.add_argument("--client-plane", choices=["thread", "reactor"],
                   default="thread",
                   help="where client connections are served: 'thread' "
                        "(default) runs accept/auth/framing/decode on a "
                        "dedicated connection-plane thread with a batched "
                        "handoff to the scheduler reactor; 'reactor' keeps "
                        "them on the reactor loop (escape hatch)")
    p.add_argument("--journal-plane", choices=["thread", "reactor"],
                   default="thread",
                   help="where the journal group commit + fsync runs: "
                        "'thread' (default) drains event batches onto a "
                        "dedicated commit thread and releases acks/"
                        "completions at the durability watermark; "
                        "'reactor' keeps the inline group-commit block "
                        "(escape hatch)")
    p.add_argument("--fanout-senders", type=int, default=2, metavar="N",
                   help="sender-pool threads running the downlink "
                        "msgpack-encode + AEAD-seal (worker compute "
                        "batches, client responses/streams, subscriber "
                        "fan-out); 0 keeps encodes inline on the owning "
                        "loop (escape hatch)")
    p.add_argument("--ingest-window", type=int, default=64, metavar="N",
                   help="per-client cap on handed-off, unanswered requests "
                        "before the connection plane pauses reading that "
                        "client (backpressure)")
    p.add_argument("--lazy-array-threshold", type=int, default=4096,
                   metavar="N",
                   help="array submits with at least N tasks are stored as "
                        "lazy chunks and materialized at dispatch "
                        "(0 disables lazy materialization)")
    p.add_argument("--task-trace-capacity", type=int, default=16384,
                   metavar="N",
                   help="bound the per-task distributed-trace store to N "
                        "tasks (`hq task trace`; 0 disables tracing "
                        "entirely, including trace headers on the wire)")
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="run as part of an N-shard federation: the server "
                        "dir becomes the federation root with one nested "
                        "server dir (+ journal + lease) per shard, job ids "
                        "partition statically across shards, and clients "
                        "route by job id (docs/deployment/federation.md)")
    p.add_argument("--shard-id", type=int, default=0, metavar="K",
                   help="with --shards N: which shard (0..N-1) this "
                        "process owns")
    p.add_argument("--standby", action="store_true",
                   help="run a warm failover successor instead of a "
                        "shard: watch every shard's lease, claim stale "
                        "ones atomically, restore their journal and "
                        "absorb their workers/clients; also runs the "
                        "worker-lending coordinator")
    p.add_argument("--lease-timeout", type=_parse_duration, default=15.0,
                   help="shard lease staleness bound: a shard whose lease "
                        "went unrenewed this long is claimable by a "
                        "successor (renewal runs at a third of this)")
    p.add_argument("--failover-watch", action="store_true",
                   help="this shard also volunteers as a successor for "
                        "dead sibling shards while its own backlog is "
                        "empty (peer failover without a standby)")
    p.add_argument("--no-coordinator", action="store_true",
                   help="with --standby: watch leases only, never lend "
                        "workers across shards")
    p.add_argument("--coordinator-interval", type=_parse_duration,
                   default=1.0,
                   help="with --standby: subscribe-feed sample cadence "
                        "driving the lending decisions")
    p.add_argument("--rebalance", action="store_true",
                   help="with --standby: also drive live job migrations "
                        "from backlogged shards toward idle ones "
                        "(largest job first, hysteresis-bounded; every "
                        "verdict lands in the ownership log)")
    p.set_defaults(fn=cmd_server_start)
    p = ssub.add_parser("stop")
    _add_common(p)
    p.set_defaults(fn=cmd_server_stop)
    p = ssub.add_parser("info")
    _add_common(p)
    p.add_argument("--shard", default="0", metavar="K|all",
                   help="federation: which shard to query (default 0; "
                        "'all' fans out, one record per shard)")
    p.set_defaults(fn=cmd_server_info)
    p = ssub.add_parser(
        "stats", help="scheduler telemetry: per-phase tick latency "
                      "breakdown + snapshot-cache counters"
    )
    _add_common(p)
    p.add_argument("--shard", default="0", metavar="K|all",
                   help="federation: which shard to query (default 0; "
                        "'all' fans out, one record per shard)")
    p.set_defaults(fn=cmd_server_stats)
    p = ssub.add_parser("debug-dump", help="full server state as JSON")
    _add_common(p)
    p.set_defaults(fn=cmd_server_debug_dump)
    p = ssub.add_parser(
        "flight-recorder",
        help="scheduling flight recorder: per-tick DecisionRecords + "
             "recent control-plane events",
    )
    _add_common(p)
    p.add_argument("fr_cmd", choices=["dump"])
    p.add_argument("--json", action="store_true",
                   help="print the raw dump as JSON")
    p.set_defaults(fn=cmd_server_flight_recorder)
    p = ssub.add_parser(
        "trace",
        help="export the run as Chrome trace-event JSON (Perfetto)",
    )
    _add_common(p)
    p.add_argument("trace_cmd", choices=["export"])
    p.add_argument("output", help="output path (e.g. trace.json)")
    p.set_defaults(fn=cmd_server_trace_export)
    p = ssub.add_parser(
        "reset-metrics",
        help="zero the metrics plane (registry + tracer + tick aggregates) "
             "for steady-state benchmark windows",
    )
    _add_common(p)
    p.add_argument("--shard", default=None, metavar="K|all",
                   help="federation: which shard to reset (default 0; "
                        "'all' fans out for a fleet-wide window)")
    p.set_defaults(fn=cmd_server_reset_metrics)
    p = ssub.add_parser(
        "profile",
        help="flamegraph-ready folded stacks from the always-on sampling "
             "profiler (or a one-shot burst when --profile-hz 0)",
    )
    _add_common(p)
    p.add_argument("--seconds", type=float, default=0.0, metavar="N",
                   help="sample a fresh N-second window instead of the "
                        "whole-run aggregate (burst mode always samples "
                        "a window; default 2s there)")
    p.add_argument("--format", choices=["folded", "json"], default="folded",
                   help="folded: 'plane;frame;frame count' lines for "
                        "flamegraph.pl/speedscope; json: full snapshot")
    p.add_argument("--shard", default=None, metavar="K|all",
                   help="federation: which shard to profile (default 0; "
                        "'all' fans out, one block per shard)")
    p.set_defaults(fn=cmd_server_profile)
    p = ssub.add_parser("wait", help="wait until the server is reachable")
    _add_common(p)
    p.add_argument("--timeout", type=float, default=60.0)
    p.set_defaults(fn=cmd_server_wait)
    p = ssub.add_parser("generate-access")
    _add_common(p)
    p.add_argument("access_file")
    p.add_argument("--host", default=None,
                   help="hostname for both planes (or set per-role hosts)")
    p.add_argument("--client-host", default=None)
    p.add_argument("--worker-host", default=None)
    p.add_argument("--client-port", type=int, required=True)
    p.add_argument("--worker-port", type=int, required=True)
    p.add_argument("--client-file", default=None,
                   help="also write a client-only access file")
    p.add_argument("--worker-file", default=None,
                   help="also write a worker-only access file")
    p.set_defaults(fn=cmd_server_generate_access)

    # worker
    worker = sub.add_parser("worker", help="worker management")
    wsub = worker.add_subparsers(dest="worker_cmd", required=True)
    p = wsub.add_parser("start")
    _add_common(p)
    p.add_argument("--cpus", type=int, default=None)
    p.add_argument("--resource", action="append", default=None,
                   help='e.g. "gpus=[0,1]", "mem=sum(1024)", "x=range(1-5)"')
    p.add_argument("--coupling", default=None,
                   help='comma-separated group resources allocated together, '
                        'e.g. "cpus,gpus"')
    p.add_argument("--group", default=None,
                   help="multi-node gang group; defaults to the manager "
                        "allocation id under PBS/Slurm, else 'default'")
    p.add_argument("--no-hyper-threading", action="store_true")
    p.add_argument("--heartbeat", type=_parse_duration, default=8.0)
    p.add_argument("--time-limit", type=_parse_duration, default=None)
    p.add_argument("--idle-timeout", type=_parse_duration, default=None)
    p.add_argument("--on-server-lost",
                   choices=["stop", "finish-running", "reconnect"],
                   default="stop")
    p.add_argument("--reconnect-timeout", type=_parse_duration, default=60.0,
                   help="with --on-server-lost reconnect: give up after "
                        "this long without a successful re-registration "
                        "(0 = keep retrying forever)")
    p.add_argument("--manager", choices=["auto", "pbs", "slurm", "none"],
                   default="auto",
                   help="batch manager detection (time limit from walltime)")
    p.add_argument("--overview-interval", type=_parse_duration, default=0.0,
                   help="send hardware telemetry every N seconds")
    p.add_argument("--min-utilization", type=_parse_min_utilization,
                   default=0.0,
                   help="only accept tasks while at least this fraction of "
                        "the worker's cpus would be busy (0.0-1.0)")
    p.add_argument("--zero-worker", action="store_true",
                   help="benchmark mode: tasks succeed instantly, no spawn")
    p.add_argument("--runner-pool", type=int, default=-1, metavar="N",
                   help="warm runner processes for task spawn (-1 = "
                        "auto-size to CPU capacity, 0 = disable and spawn "
                        "in the worker's event loop)")
    p.add_argument("--uplink-flush", type=_parse_duration, default=0.002,
                   metavar="SECS",
                   help="coalesce task-state uplinks for up to this long "
                        "into one frame (0 = send each batch as ready)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus metrics on this port (0 = "
                        "ephemeral; off by default — worker gauges still "
                        "piggyback on overview messages)")
    p.add_argument("--metrics-host", default="0.0.0.0", metavar="HOST",
                   help="bind address for the (unauthenticated) metrics "
                        "endpoint; use 127.0.0.1 behind a scraping sidecar")
    p.add_argument("--profile-hz", type=float, default=19.0, metavar="HZ",
                   help="always-on sampling profiler for the worker "
                        "process; per-plane shares piggyback on overview "
                        "messages for the fleet view (0 = off)")
    p.add_argument("--log-format", choices=["plain", "json"],
                   default=os.environ.get("HQ_LOG_FORMAT", "plain"),
                   help="json: one JSON object per log line with "
                        "task/worker correlation fields")
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="federation: register with shard K instead of a "
                        "random one (the coordinator may lend the worker "
                        "to other shards later)")
    p.set_defaults(fn=cmd_worker_start)
    p = wsub.add_parser("hw-detect", help="print detected node resources")
    _add_common(p)
    p.add_argument("--no-hyper-threading", action="store_true")
    p.set_defaults(fn=cmd_worker_hwdetect)
    p = wsub.add_parser("list")
    _add_common(p)
    p.add_argument("--all", action="store_true",
                   help="include disconnected workers")
    p.add_argument("--filter", choices=["running", "offline"], default=None)
    p.set_defaults(fn=cmd_worker_list)
    p = wsub.add_parser("stop")
    _add_common(p)
    p.add_argument("selector")
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="federation: worker ids are per shard — which "
                        "shard's workers to stop")
    p.add_argument("--drain", action="store_true",
                   help="graceful: stop scheduling new tasks onto the "
                        "worker, let running tasks finish, then stop it")
    p.add_argument("--drain-timeout", type=_parse_duration, default=None,
                   metavar="SECS",
                   help="with --drain: escalate to an immediate (clean) "
                        "stop after this long — running tasks requeue "
                        "without a crash charge (default 120s)")
    p.set_defaults(fn=cmd_worker_stop)
    p = wsub.add_parser("info")
    _add_common(p)
    p.add_argument("worker_id", type=int)
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="federation: which shard owns this worker id")
    p.set_defaults(fn=cmd_worker_info)
    p = wsub.add_parser("address")
    _add_common(p)
    p.add_argument("worker_id", type=int)
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="federation: which shard owns this worker id")
    p.set_defaults(fn=cmd_worker_address)
    p = wsub.add_parser("wait", help="wait until N workers are connected")
    _add_common(p)
    p.add_argument("count", type=int)
    p.add_argument("--timeout", type=float, default=60.0)
    p.set_defaults(fn=cmd_worker_wait)
    p = wsub.add_parser("deploy-ssh", help="start workers on hosts via ssh")
    _add_common(p)
    p.add_argument("hostfile", help="file with one hostname per line")
    p.add_argument("--cpus", type=int, default=None)
    p.add_argument("--group", default="default")
    p.set_defaults(fn=cmd_worker_deploy_ssh)

    # submit
    def _add_submit_args(p):
        _add_common(p)
        p.add_argument("--name", default=None)
        p.add_argument("--cpus", default=None)
        p.add_argument("--resource", dest="resource_request", action="append")
        p.add_argument("--nodes", type=int, default=None)
        p.add_argument("--time-request", type=_parse_duration, default=None,
                       help="minimal remaining worker lifetime needed to "
                            "start the task (e.g. 30, 10min, 01:30:00)")
        p.add_argument("--time-limit", type=_parse_duration, default=None,
                       help="kill a task after this long (e.g. 30, 10min)")
        p.add_argument("--priority", type=int, default=0)
        p.add_argument("--weight", type=_parse_weight, default=None,
                       help="scheduler objective weight: biases which same-"
                            "priority job wins contended workers (default 1.0)")
        p.add_argument("--max-fails", type=int, default=None)
        p.add_argument("--crash-limit", type=_parse_crash_limit, default=5,
                       help="positive integer, 'never-restart' or 'unlimited'")
        p.add_argument("--array", default=None)
        p.add_argument("--each-line", default=None)
        p.add_argument("--from-json", default=None)
        p.add_argument("--from-stdin", action="store_true",
                       help="one task per stdin line (entry in HQ_ENTRY), "
                            "streamed to the server in chunks — the task "
                            "list is never buffered whole on either side")
        p.add_argument("--chunk-size", type=int, default=16384,
                       help="tasks per streamed submit chunk; arrays "
                            "larger than this use the pipelined chunked "
                            "ingest plane (0 disables chunking)")
        p.add_argument("--submit-window", type=int, default=None,
                       help="max in-flight unacked chunks "
                            "(default HQ_SUBMIT_WINDOW or 8)")
        p.add_argument("--env", action="append")
        p.add_argument("--cwd", default=None)
        p.add_argument("--stdout", default=None)
        p.add_argument("--stderr", default=None)
        p.add_argument("--stream", default=None,
                       help="stream task output into this directory (.hqs files)")
        p.add_argument("--pin", choices=["taskset", "omp"], default=None,
                       help="pin tasks to their claimed cpu indices")
        p.add_argument("--task-dir", action="store_true",
                       help="create a private task directory (HQ_TASK_DIR)")
        p.add_argument("--stdin", action="store_true")
        p.add_argument("--wait", action="store_true")
        p.add_argument("--progress", action="store_true",
                       help="show a progress line until the job finishes")
        p.add_argument("--on-notify", default=None, metavar="PROGRAM",
                       help="with --wait/--progress: run PROGRAM (serially) "
                            "for each `hq task notify` event of this job, "
                            "event JSON as the first argument")
        p.add_argument("--job", type=int, default=None,
                       help="submit into an existing open job")
        p.add_argument("--directives", choices=["auto", "file", "stdin", "off"],
                       default="auto",
                       help="parse #HQ directive lines from the submitted "
                            "script (stdin: from the --stdin payload)")
        p.add_argument("command", nargs=argparse.REMAINDER)
        p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("submit", help="submit a job")
    _add_submit_args(p)

    # job
    job = sub.add_parser("job", help="job inspection")
    jsub = job.add_subparsers(dest="job_cmd", required=True)
    p = jsub.add_parser("list")
    _add_common(p)
    p.add_argument("--all", action="store_true",
                   help="include finished/failed/canceled jobs")
    p.add_argument("--filter", default=None,
                   help="comma-separated job states to show "
                        "(opened,waiting,running,finished,failed,canceled)")
    p.add_argument("--verbose", action="store_true",
                   help="additional columns (cancel reason)")
    p.set_defaults(fn=cmd_job_list)
    for name, fn, extra in [
        ("info", cmd_job_info, ()),
        ("wait", cmd_job_wait, ()),
        ("progress", cmd_job_progress, ()),
        ("cancel", cmd_job_cancel, ()),
        ("forget", cmd_job_forget, ()),
        ("close", cmd_job_close, ()),
        ("pause", cmd_job_pause, ()),
        ("resume", cmd_job_resume, ()),
    ]:
        p = jsub.add_parser(name)
        _add_common(p)
        p.add_argument("selector")
        p.set_defaults(fn=fn)
    p = jsub.add_parser("summary", help="job counts per status")
    _add_common(p)
    p.set_defaults(fn=cmd_job_summary)
    p = jsub.add_parser(
        "timeline",
        help="task lifecycle timeline: per-phase percentiles + slowest "
             "tasks (submit -> queued -> assigned -> spawned -> finished)",
    )
    _add_common(p)
    p.add_argument("selector")
    p.add_argument("--tasks", action="store_true",
                   help="include every task's timestamps (json mode)")
    p.set_defaults(fn=cmd_job_timeline)
    p = jsub.add_parser(
        "accounting",
        help="usage ledger: task/cpu/gpu/wait seconds and crash-charged "
             "retries per job, folded from the journal (survives "
             "restarts and live migration exactly-once)",
    )
    _add_common(p)
    p.add_argument("selector")
    p.set_defaults(fn=cmd_job_accounting)
    p = jsub.add_parser("submit", help="alias of top-level `hq submit`")
    _add_submit_args(p)
    p = jsub.add_parser("task-ids", help="print task ids of selected jobs")
    _add_common(p)
    p.add_argument("selector")
    p.add_argument("--filter", default=None,
                   help="comma-separated task statuses (e.g. failed,running)")
    p.set_defaults(fn=cmd_job_task_ids)
    p = jsub.add_parser("cat")
    _add_common(p)
    p.add_argument("selector")
    p.add_argument("stream", choices=["stdout", "stderr"])
    p.add_argument("--tasks", default=None)
    p.set_defaults(fn=cmd_job_cat)
    p = jsub.add_parser("open")
    _add_common(p)
    p.add_argument("--name", default=None)
    p.add_argument("--max-fails", type=int, default=None)
    p.set_defaults(fn=cmd_job_open)
    p = jsub.add_parser("submit-file", help="submit a TOML job definition")
    _add_common(p)
    p.add_argument("job_file")
    p.add_argument("--wait", action="store_true")
    p.add_argument("--chunk-size", type=int, default=16384,
                   help="stream jobfiles larger than this many tasks in "
                        "chunks over the pipelined ingest plane (0 = one "
                        "monolithic submit)")
    p.set_defaults(fn=cmd_job_submit_file)

    # alloc
    alloc = sub.add_parser("alloc", help="automatic allocation (PBS/Slurm)")
    asub = alloc.add_subparsers(dest="alloc_cmd", required=True)

    def add_alloc_params(p):
        # NOTE: manager must come after the options on the command line OR
        # options before the positional; argparse interleaves fine as long as
        # extra manager args are passed behind a literal "--"
        p.add_argument("--backlog", type=int, default=1)
        p.add_argument("--workers-per-alloc", type=int, default=1)
        p.add_argument("--max-worker-count", type=int, default=None)
        p.add_argument("--time-limit", type=_parse_duration, default=3600.0)
        p.add_argument("--idle-timeout", type=_parse_duration, default=300.0)
        p.add_argument("--name", default=None)
        p.add_argument("--worker-args", action="append")
        p.add_argument("--min-utilization", type=_parse_min_utilization,
                       default=0.0,
                       help="spawned workers only take tasks while at least "
                            "this fraction of their cpus stays busy")
        p.add_argument("--worker-start-cmd", default=None,
                       help="shell command run before each worker starts")
        p.add_argument("--worker-stop-cmd", default=None,
                       help="shell command run after the worker terminates "
                            "(best-effort)")
        p.add_argument("--worker-wrap-cmd", default=None,
                       help="command prepended to `hq worker start ...`")
        p.add_argument("--worker-time-limit", type=_parse_duration,
                       default=None,
                       help="stop workers this long after start (default: "
                            "the allocation time limit)")
        p.add_argument("--on-server-lost",
                       choices=["stop", "finish-running", "reconnect"],
                       default="finish-running")
        p.add_argument("--no-dry-run", action="store_true",
                       help="skip the probing allocation submit on `alloc add`")
        p.add_argument("manager", choices=["pbs", "slurm", "local"])
        p.add_argument("additional_args", nargs="*",
                       help="extra qsub/sbatch arguments after --")

    p = asub.add_parser("add")
    _add_common(p)
    add_alloc_params(p)
    p.set_defaults(fn=cmd_alloc_add)
    p = asub.add_parser("dry-run")
    _add_common(p)
    add_alloc_params(p)
    p.set_defaults(fn=cmd_alloc_dry_run)
    p = asub.add_parser("list")
    _add_common(p)
    p.set_defaults(fn=cmd_alloc_list)
    p = asub.add_parser("log", help="show an allocation's stdout/stderr")
    _add_common(p)
    p.add_argument("allocation_id")
    p.add_argument("channel", choices=["stdout", "stderr"])
    p.set_defaults(fn=cmd_alloc_log)
    p = asub.add_parser(
        "events", help="scale decision records (why did/didn't it scale)"
    )
    _add_common(p)
    p.add_argument("queue_id", type=int, nargs="?", default=None)
    p.set_defaults(fn=cmd_alloc_events)
    for name, fn in [("info", cmd_alloc_info), ("remove", cmd_alloc_remove),
                     ("pause", cmd_alloc_pause), ("resume", cmd_alloc_pause)]:
        p = asub.add_parser(name)
        _add_common(p)
        p.add_argument("queue_id", type=int)
        p.set_defaults(fn=fn)

    # journal
    journal = sub.add_parser("journal", help="event journal")
    josub = journal.add_subparsers(dest="journal_cmd", required=True)
    p = josub.add_parser("export", help="dump a journal file as NDJSON")
    _add_common(p)
    p.add_argument("journal_file")
    p.add_argument("--salvage", action="store_true",
                   help="skip mid-file CRC-corrupt records instead of "
                        "failing loudly")
    p.set_defaults(fn=cmd_journal_export)
    p = josub.add_parser("replay", help="replay a journal file as NDJSON")
    _add_common(p)
    p.add_argument("journal_file")
    p.add_argument("--salvage", action="store_true",
                   help="skip mid-file CRC-corrupt records instead of "
                        "failing loudly")
    p.set_defaults(fn=cmd_journal_replay)
    p = josub.add_parser("report", help="static HTML analytics report")
    _add_common(p)
    p.add_argument("journal_file")
    p.add_argument("--output", default=None)
    p.add_argument("--start-time", type=float, default=None,
                   help="window start, seconds from the first record")
    p.add_argument("--end-time", type=float, default=None,
                   help="window end, seconds from the first record")
    p.set_defaults(fn=cmd_journal_report)
    p = josub.add_parser("flush")
    _add_common(p)
    p.set_defaults(fn=cmd_journal_flush)
    p = josub.add_parser("prune")
    _add_common(p)
    p.set_defaults(fn=cmd_journal_prune)
    p = josub.add_parser(
        "compact",
        help="snapshot live state + GC the superseded journal prefix",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_journal_compact)
    p = josub.add_parser(
        "info", help="journal/snapshot sizes and compaction stats"
    )
    _add_common(p)
    p.set_defaults(fn=cmd_journal_info)
    p = josub.add_parser("stream", help="stream live server events as NDJSON")
    _add_common(p)
    p.add_argument("--history", action="store_true",
                   help="replay journaled history first")
    p.add_argument("--follow", action="store_true",
                   help="keep streaming live events")
    p.add_argument("--filter", action="append",
                   help="event kind prefix filter (job/task/worker/alloc)")
    p.set_defaults(fn=cmd_journal_stream)

    # task
    task = sub.add_parser("task", help="task inspection")
    tsub = task.add_subparsers(dest="task_cmd", required=True)
    p = tsub.add_parser("list")
    _add_common(p)
    p.add_argument("selector")
    p.set_defaults(fn=cmd_task_list)
    p = tsub.add_parser("info", help="detailed task info")
    _add_common(p)
    p.add_argument("selector")
    p.add_argument("tasks", nargs="?", default=None,
                   help="task id selector (e.g. 1-3,7); all tasks if omitted")
    p.set_defaults(fn=cmd_task_info)
    p = tsub.add_parser("explain", help="why is this task (not) running")
    _add_common(p)
    p.add_argument("target",
                   help="<job> or <job>.<task> (task defaults to the "
                        "job's first pending task)")
    p.add_argument("task_id", type=int, nargs="?", default=None,
                   help="task id (legacy two-argument form)")
    p.set_defaults(fn=cmd_task_explain)
    p = tsub.add_parser(
        "trace",
        help="the task's distributed trace: client submit -> journal "
             "commit -> solve/dispatch -> worker spawn -> completion",
    )
    _add_common(p)
    p.add_argument("target",
                   help="<job> or <job>.<task> (task defaults to 0)")
    p.add_argument("task_id", type=int, nargs="?", default=None,
                   help="task id (two-argument form)")
    p.set_defaults(fn=cmd_task_trace)
    p = tsub.add_parser("notify",
                        help="send a notification from inside a task")
    _add_common(p)
    p.add_argument("payload", nargs="?", default="")
    p.set_defaults(fn=cmd_task_notify)

    # output-log
    olog = sub.add_parser("output-log", help="read streamed task output")
    osub = olog.add_subparsers(dest="log_cmd", required=True)
    for name in ("summary", "jobs", "cat", "show", "export"):
        p = osub.add_parser(name)
        _add_common(p)
        p.add_argument("stream_dir")
        if name == "cat":
            p.add_argument("channel", choices=["stdout", "stderr"])
            p.add_argument("--tasks", default=None)
        p.set_defaults(fn=cmd_output_log)

    # dashboard
    p = sub.add_parser("dashboard", help="live terminal overview")
    _add_common(p)
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--replay", default=None, metavar="JOURNAL",
                   help="replay a finished journal offline with time scrub")
    p.set_defaults(fn=cmd_dashboard)

    # top: push-fed live cluster view (subscribe RPC — no polling)
    p = sub.add_parser(
        "top", help="live cluster view streamed from the subscribe RPC; "
                    "against a federation root: the whole fleet"
    )
    _add_common(p)
    p.add_argument("--interval", type=float, default=1.0,
                   help="metric-sample refresh interval (seconds)")
    p.add_argument("--once", action="store_true",
                   help="print one sample and exit (scriptable)")
    p.add_argument("--shard", type=int, default=None, metavar="K",
                   help="federation: focus one shard with the classic "
                        "single-server view (default: fleet view)")
    p.set_defaults(fn=cmd_top)

    # fleet: cross-shard observability over a federation root (ISSUE 15)
    fleet = sub.add_parser(
        "fleet",
        help="fleet observability over a federation root: metrics "
             "federation + stitched trace export",
    )
    fsub = fleet.add_subparsers(dest="fleet_cmd", required=True)
    p = fsub.add_parser(
        "metrics-proxy",
        help="serve one /metrics endpoint re-exporting every shard's "
             "exposition under a shard label (dead shards appear as "
             "hq_federation_shard_up 0)",
    )
    _add_common(p)
    p.add_argument("--port", type=int, default=9090,
                   help="port to serve on (0 = ephemeral, printed)")
    p.add_argument("--host", default="0.0.0.0")
    p.set_defaults(fn=cmd_fleet_metrics_proxy)
    p = fsub.add_parser(
        "trace-export",
        help="one Perfetto timeline for the whole fleet: a row group "
             "per shard (ticks, boots/promotions, lease epochs, lending "
             "moves, elasticity verdicts)",
    )
    _add_common(p)
    p.add_argument("output", help="output path (e.g. fleet-trace.json)")
    p.set_defaults(fn=cmd_fleet_trace_export)
    p = fsub.add_parser(
        "status",
        help="ownership map: per-shard owned-job counts, in-flight "
             "migrations with their protocol phase, and the last "
             "rebalance verdict",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_fleet_status)
    p = fsub.add_parser(
        "migrate",
        help="live-migrate one job to another shard: the source seals "
             "and drains it, the destination imports exactly-once, the "
             "ownership log journals the handoff (crash-safe at every "
             "phase; re-run with the same arguments to resume)",
    )
    _add_common(p)
    p.add_argument("job_id", type=int, nargs="?", default=None)
    p.add_argument("to_shard", type=int, nargs="?", default=None,
                   metavar="SHARD")
    p.add_argument("--recover", action="store_true",
                   help="re-drive every in-flight migration intent left "
                        "in the ownership log by a crashed driver, then "
                        "exit (no job/shard arguments needed)")
    p.set_defaults(fn=cmd_fleet_migrate)
    p = fsub.add_parser(
        "accounting",
        help="per-label usage rollup for every shard (task/cpu/gpu/wait "
             "seconds, crash retries) from each shard's ledger",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_fleet_accounting)
    p = fsub.add_parser(
        "profile",
        help="folded profiler stacks from every shard in one stream "
             "(equivalent to `hq server profile --shard all`)",
    )
    _add_common(p)
    p.add_argument("--seconds", type=float, default=0.0, metavar="N",
                   help="sample a fresh N-second window on each shard")
    p.add_argument("--format", choices=["folded", "json"],
                   default="folded")
    p.set_defaults(fn=cmd_fleet_profile)

    # alerts: SLO burn-rate alert state (ISSUE 18)
    p = sub.add_parser(
        "alerts",
        help="firing SLO burn-rate alerts + recent transitions "
             "(tick latency, submit-ack, queue age, restore duration, "
             "shard availability)",
    )
    _add_common(p)
    p.add_argument("--shard", default=None, metavar="K|all",
                   help="federation: which shard to query (default all)")
    p.set_defaults(fn=cmd_alerts)

    # doc + completion
    p = sub.add_parser("doc", help="show documentation topics")
    _add_common(p)
    p.add_argument("topic", nargs="?", default=None)
    p.set_defaults(fn=cmd_doc)
    p = sub.add_parser("generate-completion",
                       help="shell completion script")
    _add_common(p)
    p.add_argument("shell", nargs="?", default="bash",
                   choices=["bash", "zsh", "fish"])
    p.set_defaults(fn=cmd_generate_completion)

    return parser


def _parse_explain_target(args) -> tuple[int, int | None]:
    """`hq task explain <job>[.<task>]` (or legacy `<job> <task>`)."""
    target = str(args.target)
    if args.task_id is not None:
        return int(target), args.task_id
    if "." in target:
        job_s, _, task_s = target.partition(".")
        try:
            return int(job_s), int(task_s)
        except ValueError:
            fail(f"invalid task selector {target!r} "
                 "(expected <job> or <job>.<task>)")
    try:
        return int(target), None
    except ValueError:
        fail(f"invalid job id {target!r}")


def cmd_task_explain(args) -> None:
    job_id, task_id = _parse_explain_target(args)
    with _session(args) as session:
        result = session.request(
            {"op": "task_explain", "job_id": job_id, "task_id": task_id}
        )
    result.pop("op", None)
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(result)
        return
    task_label = f"{result.get('job', job_id)}.{result.get('task', task_id)}"
    out.message(f"task {task_label}: {result['state']}")
    # the verdict line: reason code + human detail + deferral age
    reason = result.get("reason")
    if reason:
        line = f"verdict: {reason}"
        deferred = result.get("deferred_ticks") or 0
        if deferred:
            line += f" (deferred for {deferred} consecutive tick(s))"
        out.message(line)
        if result.get("reason_detail"):
            out.message(f"  {result['reason_detail']}")
    if result.get("solver_backend"):
        line = f"solver backend: {result['solver_backend']}"
        if result.get("solver_backend_reason"):
            line += f" ({result['solver_backend_reason']})"
        if result.get("solver_pipelined"):
            line += " [pipelined]"
        out.message(line)
    pol = result.get("policy")
    if pol:
        pred = pol.get("prediction") or {}
        line = (
            f"policy: {pol.get('source')} "
            f"({pol.get('affinity_classes', 0)} affinity class(es), "
            f"boost range {pol.get('boost_range')}"
        )
        if pred.get("enabled"):
            line += f", predictor hit rate {pred.get('hit_rate', 0.0):.2f}"
        line += ")"
        out.message(line)
    if result["n_waiting_deps"]:
        out.message(f"waiting for {result['n_waiting_deps']} dependencies")
    workers = result["workers"]
    runnable = [w for w in workers if w["runnable"]]
    out.message(
        f"workers considered: {len(workers)}, "
        f"could run it now: {len(runnable)}"
    )
    for w in workers:
        if w["runnable"]:
            out.message(f"worker {w['id']} ({w['hostname']}): can run")
        else:
            for v in w["variants"]:
                for blocked in v["blocked"]:
                    out.message(
                        f"worker {w['id']} ({w['hostname']}) "
                        f"variant {v['variant']}: {blocked}"
                    )


def cmd_task_trace(args) -> None:
    """The task's assembled distributed trace: every span from client
    submit through journal commit, solve dispatch, worker spawn, run and
    completion uplink (`hq task trace <job>.<task>`)."""
    job_id, task_id = _parse_explain_target(args)
    with _session(args) as session:
        result = session.request(
            {"op": "task_trace", "job_id": job_id, "task_id": task_id or 0}
        )
    result.pop("op", None)
    out = make_output(args.output_mode)
    if args.output_mode == "json":
        out.value(result)
        return
    spans = result.get("spans") or []
    out.message(
        f"task {result['job']}.{result['task']} trace "
        f"{result['trace_id']} — {len(spans)} span(s), "
        f"{'closed' if result.get('closed') else 'open'}, "
        f"wall {result.get('wall_s', 0.0) * 1e3:.2f} ms"
    )
    if result.get("missing_hops") and result.get("closed"):
        out.message(
            "  missing hops: " + ", ".join(result["missing_hops"])
        )
    for note in result.get("annotations") or ():
        kind = note.get("kind")
        if kind == "lend":
            out.message(
                f"  fleet: ran on worker {note.get('worker')} borrowed "
                f"from shard {note.get('home_shard')} "
                f"(host shard {note.get('host_shard')})"
            )
        elif kind == "failover":
            out.message(
                f"  fleet: survived failover of shard "
                f"{note.get('shard')} (lease epoch "
                f"{note.get('lease_epoch')})"
            )
        else:
            out.message(f"  fleet: {note}")
    if not spans:
        return
    t_base = min(s["t0"] for s in spans)
    out.message(
        f"{'offset ms':>10} {'dur ms':>10}  "
        f"{'span':<16} {'proc':<12} inst"
    )
    for s in spans:
        out.message(
            f"{(s['t0'] - t_base) * 1e3:>10.2f} "
            f"{(s['t1'] - s['t0']) * 1e3:>10.2f}  "
            f"{s['name']:<16} {s['proc']:<12} {s['instance']}"
        )


def cmd_top(args) -> None:
    """Live cluster view fed by the subscribe RPC (push, not polling);
    a federation root renders the fleet view unless --shard focuses."""
    from hyperqueue_tpu_torch.client.top import run_top

    rc = run_top(
        _server_dir(args),
        interval=args.interval,
        once=args.once,
        output_mode=args.output_mode,
        shard=getattr(args, "shard", None),
    )
    if rc:
        raise SystemExit(rc)


def cmd_fleet_metrics_proxy(args) -> None:
    """`hq fleet metrics-proxy`: one scrape covers the fleet — every
    shard's exposition under a `shard` label, dead shards visible as
    hq_federation_shard_up 0."""
    from hyperqueue_tpu_torch.client.fleet import run_metrics_proxy

    try:
        run_metrics_proxy(_server_dir(args), args.port, host=args.host)
    except ValueError as e:
        fail(str(e))
    except KeyboardInterrupt:
        pass


def cmd_fleet_trace_export(args) -> None:
    """`hq fleet trace-export <out.json>`: the whole fleet as one
    Perfetto timeline, a row group per shard."""
    from hyperqueue_tpu_torch.client.fleet import export_fleet_trace

    try:
        trace = export_fleet_trace(_server_dir(args))
    except ValueError as e:
        fail(str(e))
    with open(args.output, "w") as f:
        json.dump(trace, f)
    meta = trace.get("metadata") or {}
    down = meta.get("down") or []
    make_output(args.output_mode).message(
        f"fleet trace written to {args.output} "
        f"({meta.get('shards', 0)} shard(s), "
        f"{len(trace.get('traceEvents') or ())} event(s)"
        + (f", DOWN: {down}" if down else "")
        + "); load at ui.perfetto.dev"
    )


def cmd_fleet_profile(args) -> None:
    """`hq fleet profile`: folded profiler stacks from every shard in one
    stream. On a classic server dir it degrades to a single-server
    profile (same convention as `hq fleet accounting`)."""
    fed = serverdir.load_federation(_server_dir(args))
    args.shard = "all" if fed is not None else None
    cmd_server_profile(args)


def cmd_fleet_status(args) -> None:
    """`hq fleet status`: the ownership map as operators read it —
    who owns what, what is mid-move, what the rebalancer last did."""
    from hyperqueue_tpu_torch.client.connection import ClientSession
    from hyperqueue_tpu_torch.client.fleet import shard_count_of
    from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

    root = _server_dir(args)
    try:
        n = shard_count_of(root)
    except ValueError as e:
        fail(str(e))
    omap = OwnershipStore(root).load()
    moved_in = omap.owned_counts()
    lines = [
        f"federation: {max(n, omap.shard_count)} shard(s) "
        f"(base {omap.base_shard_count}), "
        f"ownership epoch {omap.epoch}"
    ]
    for k in range(max(n, omap.shard_count)):
        shard_dir = serverdir.shard_path(root, k)
        try:
            with ClientSession(shard_dir, retry_window=2.0) as session:
                jobs = session.request({"op": "job_list"}).get("jobs", [])
            owned = len(jobs)
            live = sum(
                1 for j in jobs
                if j.get("status") in ("running", "waiting", "opened")
            )
            detail = f"{owned} job(s) owned, {live} active"
            if moved_in.get(k):
                detail += f", {moved_in[k]} migrated in"
        except (OSError, ClientError, FileNotFoundError) as e:
            detail = f"DOWN ({e})"
        lines.append(f"  shard {k}: {detail}")
    in_flight = omap.in_flight()
    if in_flight:
        lines.append("in-flight migrations:")
        for rec in in_flight:
            lines.append(
                f"  {rec['mig']}: job {rec['job']} shard {rec['from']} "
                f"-> {rec['to']} ({rec['phase']})"
            )
    else:
        lines.append("in-flight migrations: none")
    if omap.verdicts:
        v = omap.verdicts[-1]
        moved = v.get("moved")
        what = (f"moved job {moved}" if moved
                else "no move" + (f" (job {v['job']})" if v.get("job")
                                  else ""))
        lines.append(
            f"last rebalance: {what} shard {v.get('from')} -> "
            f"{v.get('to')} — {v.get('reason', '')}"
        )
    make_output(args.output_mode).message("\n".join(lines))


def cmd_fleet_migrate(args) -> None:
    """`hq fleet migrate <job> <shard>` (or `--recover`): drive the
    exactly-once live migration protocol from the CLI."""
    from hyperqueue_tpu_torch.server.federation import (
        MigrationError,
        drive_migration,
        recover_migrations,
    )

    root = _server_dir(args)
    out = make_output(args.output_mode)
    if args.recover:
        moves = recover_migrations(root)
        if not moves:
            out.message("no in-flight migrations to recover")
        for move in moves:
            out.message(
                f"recovered {move['mig']}: job {move['job']} shard "
                f"{move['from']} -> {move['to']} ({move['seconds']}s)"
            )
        return
    if args.job_id is None or args.to_shard is None:
        fail("usage: hq fleet migrate <job_id> <to_shard> "
             "(or hq fleet migrate --recover)")
    try:
        move = drive_migration(root, args.job_id, args.to_shard)
    except MigrationError as e:
        fail(str(e))
    except Exception as e:  # noqa: BLE001 - MigrationClaimed and friends
        fail(str(e))
    out.message(
        f"migrated job {move['job']}: shard {move['from']} -> "
        f"{move['to']} ({move['mig']}, {move['seconds']}s)"
    )


def cmd_job_submit_file(args) -> None:
    from hyperqueue_tpu_torch.client.jobfile import JobFileError, load_job_file

    try:
        job_desc = load_job_file(args.job_file, os.getcwd())
    except JobFileError as e:
        fail(str(e))
    with _session(args) as session:
        from hyperqueue_tpu_torch.transport.framing import attach_trace
        from hyperqueue_tpu_torch.utils.trace import new_trace_id

        tasks = job_desc.get("tasks") or []
        chunk_size = max(getattr(args, "chunk_size", 16384) or 0, 0)
        if chunk_size and len(tasks) > chunk_size:
            # big jobfile: stream the task graph in chunks (deps always
            # reference tasks defined ABOVE, so in-order chunking keeps
            # every dependency in an earlier-or-same chunk)
            from hyperqueue_tpu_torch.client.connection import SubmitStream

            stream = SubmitStream(session, {
                "name": job_desc["name"],
                "submit_dir": job_desc["submit_dir"],
                "max_fails": job_desc.get("max_fails"),
            })
            for start in range(0, len(tasks), chunk_size):
                stream.send_chunk(tasks=tasks[start:start + chunk_size])
            job_id, n_tasks = stream.finish()
            response = {"job_id": job_id, "n_tasks": n_tasks}
        else:
            response = session.request(attach_trace(
                {"op": "submit", "job": job_desc},
                new_trace_id(), sent_at=clock.now(),
            ))
        job_id = response["job_id"]
        out = make_output(args.output_mode)
        if args.output_mode == "quiet":
            out.value(job_id)
        else:
            out.message(
                f"Job submitted successfully, job ID: {job_id}"
                f" ({response['n_tasks']} tasks)"
            )
        if args.wait:
            info = session.request({"op": "job_wait", "job_ids": [job_id]})
            job = info["jobs"][0] if info["jobs"] else None
            if job is None or job["counters"]["failed"] or job["counters"]["canceled"]:
                raise SystemExit(1)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if getattr(args, "fn", None) is cmd_submit:  # `submit` or `job submit`
        if args.command and args.command[0] == "--":
            args.command = args.command[1:]
        # #HQ directives from the submitted script; explicit CLI args win
        # because they come later in the re-parsed argv
        from hyperqueue_tpu_torch.client.directives import (
            parse_directives,
            parse_directives_text,
            should_parse,
        )

        stdin_data = None
        tokens: list[str] = []
        if args.directives == "stdin":
            # the script arrives on stdin (used with --stdin); directives are
            # parsed from it rather than from the command path
            if not args.stdin:
                fail("--directives=stdin requires --stdin (the script is "
                     "read from standard input and passed to the task)")
            stdin_data = sys.stdin.buffer.read()
            tokens = parse_directives_text(stdin_data.decode(errors="replace"))
        elif args.command and should_parse(args.command[0], args.directives):
            tokens = parse_directives(args.command[0])
        if tokens:
            idx = argv.index("submit")
            args = build_parser().parse_args(
                argv[: idx + 1] + tokens + argv[idx + 1 :]
            )
            if args.command and args.command[0] == "--":
                args.command = args.command[1:]
        if stdin_data is not None:
            args._stdin_data = stdin_data
    try:
        args.fn(args)
    except (ClientError, ValueError) as e:
        # user-input errors (bad amounts, selectors, resource defs) must be
        # one clean line, not a traceback
        fail(str(e))
    except FileNotFoundError as e:
        fail(str(e))
    except BrokenPipeError:
        # `hq ... | head` closed the pipe: exit quietly like other CLIs.
        # Point stdout at devnull so interpreter shutdown's implicit flush
        # does not raise a second time.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        raise SystemExit(141)
    except KeyboardInterrupt:
        raise SystemExit(130)


if __name__ == "__main__":
    main()
