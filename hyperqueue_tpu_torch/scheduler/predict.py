"""Per-task-class runtime prediction for the weighted scheduling objective.

Value-function scheduling (arxiv 2011.14486) weights the objective with
runtime predictions mined from history instead of gating on them: the
predictor keeps one exponentially-weighted moving average of observed task
runtimes per task class (the job name — array jobs share a name, so a class
accumulates across every sibling task), and the policy layer
(scheduler/policy.py) folds the expected remaining work into the priority
encoding as a bounded LPT boost.

Two feeds, same table:

* LIVE: the server's EventBridge observes every task-finished runtime as it
  commits (server/bootstrap.py), so the EWMA tracks the cluster while it
  runs.
* OFFLINE: `seed_from_journal` replays an event journal
  (events/journal.py Journal.read_all) and pairs each task-started record's
  `started_at` stamp with its task-finished commit time, so a fresh server
  starts with the previous run's learned runtimes instead of a cold table.

The predictor is deliberately tiny and deterministic: a dict of floats
folded in event order. Both feeds produce identical tables for identical
event streams.
"""

from __future__ import annotations


class RuntimePredictor:
    """EWMA runtime table keyed by task class (job name).

    Hit-rate telemetry: `predict` counts how often a lookup had data, so an
    operator can see whether the prediction term is informed or still cold.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._ewma: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._hits = 0
        self._misses = 0
        self.seeded_from: str | None = None
        self.seeded_samples = 0

    def observe(self, label: str, runtime_s: float) -> None:
        if not label or runtime_s is None or runtime_s < 0:
            return
        runtime_s = float(runtime_s)
        prev = self._ewma.get(label)
        if prev is None:
            self._ewma[label] = runtime_s
        else:
            self._ewma[label] = prev + self.alpha * (runtime_s - prev)
        self._counts[label] = self._counts.get(label, 0) + 1

    def predict(self, label: str) -> float | None:
        val = self._ewma.get(label)
        if val is None:
            self._misses += 1
        else:
            self._hits += 1
        return val

    def peek(self, label: str) -> float | None:
        """`predict` without touching the hit-rate counters (stats paths)."""
        return self._ewma.get(label)

    def hit_rate(self) -> float:
        asked = self._hits + self._misses
        return (self._hits / asked) if asked else 0.0

    def n_classes(self) -> int:
        return len(self._ewma)

    def stats(self) -> dict:
        out = {
            "classes": self.n_classes(),
            "observations": sum(self._counts.values()),
            "hit_rate": round(self.hit_rate(), 4),
        }
        if self.seeded_from is not None:
            out["seeded_from"] = self.seeded_from
            out["seeded_samples"] = self.seeded_samples
        return out

    def seed_from_journal(self, path: str) -> int:
        """Replay a journal offline and fold every completed task's runtime
        into the table. Returns the number of samples folded.

        Pairing: `job-submitted` maps job id -> class label (desc name);
        `task-started` stamps (job, task) with its `started_at`;
        `task-finished` closes the pair at the record's commit time. The
        worker-side trace stamps (spawned/exited) are preferred when both
        ride the finish record — they exclude the uplink/commit latency.
        Unpaired or malformed records are skipped, not fatal: a salvaged
        journal tail must not kill policy loading.
        """
        from hyperqueue_tpu_torch.events.journal import Journal

        names: dict[int, str] = {}
        started: dict[tuple[int, int], float] = {}
        folded = 0
        for rec in Journal.read_all(path, salvage=True):
            kind = rec.get("event")
            if kind == "job-submitted":
                desc = rec.get("desc") or {}
                names[rec.get("job")] = desc.get("name", "job")
            elif kind == "task-started":
                key = (rec.get("job"), rec.get("task"))
                started[key] = rec.get("started_at") or rec.get("time", 0.0)
            elif kind == "task-finished":
                key = (rec.get("job"), rec.get("task"))
                t0 = started.pop(key, None)
                label = names.get(rec.get("job"))
                trace = rec.get("trace") or {}
                spawned = trace.get("spawned_at")
                exited = trace.get("exited_at")
                if spawned and exited and exited >= spawned:
                    runtime = exited - spawned
                elif t0 is not None:
                    runtime = rec.get("time", 0.0) - t0
                else:
                    continue
                if label and runtime >= 0:
                    self.observe(label, runtime)
                    folded += 1
        self.seeded_from = str(path)
        self.seeded_samples += folded
        return folded
