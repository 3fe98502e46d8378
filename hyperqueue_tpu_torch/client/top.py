"""`hq top`: live cluster view fed by the subscribe RPC.

Unlike the dashboard (which polls request/response RPCs on an interval),
top consumes the server's PUSH feed — one subscription delivers lifecycle
events as they happen plus a metric sample every refresh interval, so the
view updates without a single poll. The same feed is the programmatic
signal source for the autoscaler (queue depth, pending reasons, per-worker
load); top is its human face.

``--once`` prints a single sample (JSON under ``--output-mode json``) and
exits — the scriptable/testing entry point. The fleet view over a
federation root comes with the federation plane (ROADMAP item 10).
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


def run_top(server_dir: Path, interval: float = 1.0, once: bool = False,
            output_mode: str = "cli", shard: int | None = None) -> int:
    """Drive the live view until interrupted (or one sample with --once).

    The fleet view of a federation root, and ``--shard K`` with it, come
    with the federation plane: a root refuses (item 10)."""
    from hyperqueue_tpu_torch.client.connection import subscribe
    from hyperqueue_tpu_torch.utils import serverdir

    serverdir.load_federation(Path(server_dir))
    if shard is not None:
        # the info|stats --shard convention: a classic dir must not
        # silently ignore the flag
        print(f"--shard needs a federation root; {server_dir} is a "
              "classic server dir", file=sys.stderr)
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
