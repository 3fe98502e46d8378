"""Per-task-class runtime prediction for the weighted scheduling objective.

Value-function scheduling (arxiv 2011.14486) weights the objective with
runtime predictions mined from history instead of gating on them: the
predictor keeps one exponentially-weighted moving average of observed task
runtimes per task class (the job name — array jobs share a name, so a class
accumulates across every sibling task), and the policy layer
(scheduler/policy.py) folds the expected remaining work into the priority
encoding as a bounded LPT boost.

The live feed is `observe`, called with each finished task's runtime. The
offline feed, `seed_from_journal`, replays the server's event journal, which
belongs to the host-plane slice of this package; until that slice lands it
raises NotImplementedError.

The predictor is deliberately tiny and deterministic: a dict of floats
folded in event order.
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
        """Replay a server journal into the table (not ported yet)."""
        raise NotImplementedError(
            "seeding the predictor from a journal needs the event journal, "
            "which comes with the host-plane slice"
        )
