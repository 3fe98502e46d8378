"""`hq top`: live cluster view fed by the subscribe RPC.

Unlike the dashboard (which polls request/response RPCs on an interval),
top consumes the server's PUSH feed — one subscription delivers lifecycle
events as they happen plus a metric sample every refresh interval, so the
view updates without a single poll. The same feed is the programmatic
signal source for the autoscaler (queue depth, pending reasons, per-worker
load); top is its human face.

``--once`` prints a single sample (JSON under ``--output-mode json``) and
exits — the scriptable/testing entry point.
"""

from __future__ import annotations

import json
import sys
import time
from collections import deque
from pathlib import Path

# lifecycle kinds worth showing in the event ticker (worker overviews are
# high-frequency noise at a 2 s cadence)
_TICKER_SKIP = ("worker-overview",)


def _fmt_age(seconds: float) -> str:
    if seconds >= 3600:
        return f"{seconds / 3600:.1f}h"
    if seconds >= 60:
        return f"{seconds / 60:.1f}m"
    return f"{seconds:.0f}s"


def _render(sample: dict, ticker: deque, dropped: int) -> str:
    lines = []
    lines.append(
        f"hq top — up {_fmt_age(sample.get('uptime', 0.0))}, "
        f"{sample.get('n_workers', 0)} worker(s), "
        f"{sample.get('n_jobs', 0)} job(s), "
        f"tick {sample.get('tick', 0)}"
        + (f", last tick {sample['tick_last_ms']:.2f} ms"
           if sample.get("tick_last_ms") else "")
    )
    lines.append(
        f"tasks: {sample.get('running', 0)} running, "
        f"{sample.get('ready', 0)} ready, "
        f"{sample.get('mn_queued', 0)} gang-queued, "
        f"{sample.get('tasks_known', 0)} known"
    )
    job_counts = sample.get("job_counts") or {}
    if job_counts:
        lines.append(
            "jobs: " + ", ".join(
                f"{n} {status}" for status, n in sorted(job_counts.items())
            )
        )
    reasons = sample.get("pending_reasons") or {}
    if reasons:
        lines.append(
            "waiting: " + ", ".join(
                f"{n} {code}" for code, n in sorted(reasons.items())
            )
        )
    lag = sample.get("lag") or {}
    if lag:
        cells = []
        for plane in ("solve", "journal", "rpc", "fanout", "loop"):
            row = lag.get(plane)
            if row:
                cells.append(f"{plane} {row['last_ms']:.1f}/{row['max_ms']:.1f}")
        if cells:
            lines.append("loop lag ms (last/max): " + "  ".join(cells))
    if sample.get("stalls"):
        lines.append(f"reactor stalls captured: {sample['stalls']}")
    profile = sample.get("profile") or {}
    if profile:
        lines.append(
            "plane cpu%: " + "  ".join(
                f"{plane} {share * 100:.1f}"
                for plane, share in sorted(
                    profile.items(), key=lambda kv: -kv[1]
                )
            )
        )
    workers = sample.get("workers") or []
    if workers:
        lines.append("")
        lines.append(f"{'worker':>8} {'host':<20} {'running':>8} "
                     f"{'prefilled':>10} {'cpu%':>6} planes")
        for w in sorted(workers, key=lambda w: w["id"])[:32]:
            cpu = w.get("cpu")
            planes = w.get("planes") or {}
            plane_cell = " ".join(
                f"{p}:{v * 100:.0f}%"
                for p, v in sorted(planes.items(), key=lambda kv: -kv[1])
            )
            lines.append(
                (f"{w['id']:>8} {str(w.get('hostname', ''))[:20]:<20} "
                 f"{w.get('running', 0):>8} {w.get('prefilled', 0):>10} "
                 f"{cpu:>6.1f}" if cpu is not None else
                 f"{w['id']:>8} {str(w.get('hostname', ''))[:20]:<20} "
                 f"{w.get('running', 0):>8} {w.get('prefilled', 0):>10} "
                 f"{'-':>6}")
                + (f" {plane_cell}" if plane_cell else "")
            )
        if len(workers) > 32:
            lines.append(f"  … {len(workers) - 32} more worker(s)")
    if ticker:
        lines.append("")
        lines.append("recent events:")
        for rec in list(ticker)[-10:]:
            t = time.strftime("%H:%M:%S", time.localtime(rec.get("time", 0)))
            rest = {
                k: v for k, v in rec.items()
                if k not in ("time", "seq", "event", "desc", "metrics", "hw")
            }
            lines.append(f"  {t} {rec.get('event')} {rest}")
    if dropped:
        lines.append(f"(events dropped: {dropped})")
    return "\n".join(lines)


def _alert_badge(sample: dict | None, state: str) -> str:
    """SLO alert badge for one shard. A DOWN shard has no
    sample to carry its badge, but its very downness IS the
    shard-availability SLO breach — render that instead of a blank."""
    if sample is None:
        return "avail!" if state != "up" else "-"
    alerts = sample.get("alerts") or {}
    firing = alerts.get("firing", 0)
    if not firing:
        return "ok"
    worst = alerts.get("worst") or "page"
    mark = "!" if worst == "page" else "~"
    return f"{firing}{mark}{worst}"


def _fleet_row(shard: int, state: str, sample: dict | None) -> str:
    """One shard's line in the fleet table (DOWN shards render a row —
    that is the whole point; the client never crashes on a dead shard)."""
    badge = _alert_badge(sample, state)
    if sample is None:
        return f"{shard:>5} {state.upper():<9} {'-':>5} {'-':>7} " \
               f"{'-':>7} {'-':>7} {'-':>7} {'-':>6} {'-':>8} {'-':>5} " \
               f"{badge:>7}"
    fed = sample.get("federation") or {}
    lag = (sample.get("lag") or {}).get("loop") or {}
    label = "UP"
    if fed.get("promoted"):
        label = "UP*"  # promoted successor
    borrowed = fed.get("workers_borrowed", 0)
    return (
        f"{shard:>5} {label:<9} "
        f"{fed.get('lease_epoch', '-'):>5} "
        f"{sample.get('n_workers', 0):>7} "
        f"{borrowed:>7} "
        f"{sample.get('running', 0):>7} "
        f"{sample.get('ready', 0) + sample.get('mn_queued', 0):>7} "
        f"{len(sample.get('pending_reasons') or {}):>6} "
        + (f"{lag['last_ms']:>8.1f} " if lag.get("last_ms") is not None
           else f"{'-':>8} ")
        + f"{sample.get('alloc_quarantined', 0):>5} "
        + f"{badge:>7}"
    )


def _backlog_convergence(samples: dict) -> str | None:
    """One line tracking the rebalancer's target function: max/mean
    backlog ratio across live shards (the hysteresis band is 1.5x — the
    line makes a rebalance visibly converge under `hq top`)."""
    backlogs = {
        k: (s.get("ready", 0) + s.get("mn_queued", 0))
        for k, s in samples.items() if s is not None
    }
    if len(backlogs) < 2:
        return None
    mean = sum(backlogs.values()) / len(backlogs)
    hot = max(backlogs, key=backlogs.get)
    if mean <= 0:
        return "backlog: balanced (all empty)"
    ratio = backlogs[hot] / mean
    return (
        f"backlog: max {backlogs[hot]} (shard {hot}) mean {mean:.1f} "
        f"ratio {ratio:.2f}x"
        + (" — imbalanced (rebalance target >1.50x)" if ratio > 1.5
           else " — converged")
    )


def _render_fleet(states: dict, samples: dict, ticker: deque,
                  lend_flows: dict, ownership: dict | None = None) -> str:
    """The fleet view: per-shard health rows + backlog convergence +
    in-flight migrations + lending flows + merged event ticker.
    Everything but the ownership block comes off the FleetFeed — no
    polling; the ownership block is one lock-free log read per frame."""
    up = sum(1 for s in states.values() if s == "up")
    lines = [
        f"hq fleet — {len(states)} shard(s), {up} up",
        f"{'shard':>5} {'state':<9} {'epoch':>5} {'workers':>7} "
        f"{'borrow':>7} {'running':>7} {'backlog':>7} {'wait':>6} "
        f"{'lag ms':>8} {'quar':>5} {'alerts':>7}",
    ]
    for shard in sorted(states):
        state = "up" if states[shard] == "up" else "down"
        lines.append(_fleet_row(shard, state, samples.get(shard)))
    conv = _backlog_convergence(samples)
    if conv:
        lines.append(conv)
    if ownership:
        for rec in ownership.get("in_flight") or ():
            lines.append(
                f"migrating: job {rec['job']} shard {rec['from']} -> "
                f"{rec['to']} ({rec['phase']}, {rec['mig']})"
            )
        if ownership.get("moved"):
            lines.append(
                f"ownership: epoch {ownership.get('epoch', 0)}, "
                f"{ownership['moved']} job(s) on non-home shards"
            )
    if lend_flows:
        lines.append(
            "lend flows: " + "  ".join(
                f"{a}→{b} ×{n}"
                for (a, b), n in sorted(lend_flows.items())
            )
        )
    if ticker:
        lines.append("")
        lines.append("recent events:")
        for rec in list(ticker)[-10:]:
            t = time.strftime("%H:%M:%S", time.localtime(rec.get("time", 0)))
            rest = {
                k: v for k, v in rec.items()
                if k not in ("time", "seq", "event", "desc", "metrics",
                             "hw", "shard")
            }
            lines.append(
                f"  {t} [shard {rec.get('shard')}] "
                f"{rec.get('event')} {rest}"
            )
    return "\n".join(lines)


def _note_lend_flow(rec: dict, lend_flows: dict) -> None:
    """Fold one structured lend event into the flow counters: the
    lender's worker-lost carries `lent_to`, the borrower's
    worker-connected carries `lent_from` (no string parsing).
    Counted from the lender side only, so one move is one increment."""
    if rec.get("event") == "worker-lost" and rec.get("lent_to") is not None:
        key = (rec.get("shard"), rec["lent_to"])
        lend_flows[key] = lend_flows.get(key, 0) + 1


def run_fleet_top(server_dir: Path, interval: float = 1.0,
                  once: bool = False, output_mode: str = "cli") -> int:
    """`hq top` against a federation root: the whole fleet as one view,
    fed by one FleetFeed (a subscribe stream per shard, merged). A
    killed shard flips to DOWN and back to UP after its successor
    promotes — the view rides failovers, it never crashes on them."""
    from hyperqueue_tpu_torch.client.fleet import FleetFeed, fleet_snapshot

    def ownership_block() -> dict | None:
        from hyperqueue_tpu_torch.utils.ownership import OwnershipStore

        try:
            omap = OwnershipStore(server_dir).load()
        except OSError:
            return None
        return {
            "epoch": omap.epoch,
            "moved": len(omap.assignments),
            "in_flight": omap.in_flight(),
        }

    if once:
        samples = fleet_snapshot(server_dir, sample_interval=min(
            max(interval, 0.2), 1.0
        ))
        states = {
            k: ("up" if s is not None else "down")
            for k, s in samples.items()
        }
        if output_mode == "json":
            out = {
                str(k): (
                    {kk: vv for kk, vv in s.items() if kk != "op"}
                    if s is not None else None
                )
                for k, s in samples.items()
            }
            print(json.dumps({"shards": out}))
        else:
            print(_render_fleet(states, samples, deque(), {},
                                ownership_block()))
        return 0

    ticker: deque = deque(maxlen=64)
    lend_flows: dict = {}
    is_tty = sys.stdout.isatty()
    feed = FleetFeed(server_dir, sample_interval=max(interval, 0.2))
    try:
        with feed:
            for frame in feed.frames():
                op = frame.get("op")
                if op == "events":
                    for rec in frame.get("records") or ():
                        _note_lend_flow(rec, lend_flows)
                        if not str(rec.get("event", "")).startswith(
                            _TICKER_SKIP
                        ):
                            ticker.append(rec)
                elif op not in ("sample", "shard-down", "shard-up"):
                    continue
                view = _render_fleet(
                    dict(feed.states), dict(feed.last_sample), ticker,
                    lend_flows, ownership_block(),
                )
                if is_tty:
                    sys.stdout.write("\x1b[H\x1b[J" + view + "\n")
                else:
                    sys.stdout.write(view + "\n---\n")
                sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    return 0


def run_top(server_dir: Path, interval: float = 1.0, once: bool = False,
            output_mode: str = "cli", shard: int | None = None) -> int:
    """Drive the live view until interrupted (or one sample with --once).

    Against a federation root this is the FLEET view (all shards, DOWN
    rows included) unless ``--shard K`` focuses one shard — which uses
    the classic single-server view over that shard's subscribe feed."""
    from hyperqueue_tpu_torch.client.connection import subscribe
    from hyperqueue_tpu_torch.utils import serverdir

    fed = serverdir.load_federation(Path(server_dir))
    if shard is None and fed is not None:
        return run_fleet_top(server_dir, interval=interval, once=once,
                             output_mode=output_mode)
    if shard is not None:
        # the info|stats --shard convention: a typo'd selector fails
        # loudly instead of hanging on a nonexistent shard dir, and a
        # classic dir must not silently ignore the flag
        if fed is None:
            print(f"--shard needs a federation root; {server_dir} is a "
                  "classic server dir", file=sys.stderr)
            return 1
        count = int(fed["shard_count"])
        if not (0 <= shard < count):
            print(f"shard {shard} outside 0..{count - 1}", file=sys.stderr)
            return 1

    ticker: deque = deque(maxlen=64)
    last_sample: dict | None = None
    dropped = 0
    is_tty = sys.stdout.isatty()
    try:
        for msg in subscribe(
            server_dir,
            sample_interval=max(interval, 0.2),
            overviews=not once,
            shard=shard or 0,
        ):
            op = msg.get("op")
            if op == "events":
                for rec in msg.get("records") or ():
                    if not str(rec.get("event", "")).startswith(_TICKER_SKIP):
                        ticker.append(rec)
                continue
            if op == "sub_dropped":
                dropped = msg.get("dropped", 0)
                print("subscription dropped: this consumer fell behind "
                      "the server's bounded event queue", file=sys.stderr)
                return 1
            if op != "sample":
                continue  # sub_live handshake
            last_sample = msg
            if once:
                if output_mode == "json":
                    out = dict(msg)
                    out.pop("op", None)
                    print(json.dumps(out))
                else:
                    print(_render(msg, ticker, dropped))
                return 0
            frame = _render(msg, ticker, dropped)
            if is_tty:
                # home + clear-below: steady redraw without flicker
                sys.stdout.write("\x1b[H\x1b[J" + frame + "\n")
            else:
                sys.stdout.write(frame + "\n---\n")
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0
    # stream ended server-side
    if last_sample is None:
        print("subscription closed before the first sample", file=sys.stderr)
        return 1
    return 0
