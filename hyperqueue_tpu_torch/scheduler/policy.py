"""Scheduling policy: heterogeneity weights, fairness, runtime prediction.

The fused solve (ops/assign.py via models/greedy.py) maximizes raw placement
count; this module is the objective on top of that mechanism:

* **Heterogeneity weights** (Gavel, arxiv 2008.09213): a per-(task-class,
  worker-class) throughput/affinity matrix `S`. Task class = the "+"-joined
  sorted resource names of the request's first variant ("nodes" for
  multi-node gangs); worker class = the worker's group. The matrix folds
  into the solve's visit-class ordering (host_visit_classes keys on
  (-affinity, waste)), so high-throughput workers are water-filled first,
  and a zero weight is a hard exclusion (the policy mask zeroes the worker's
  capacity and gang membership in the cut-scan kernel).

* **Fairness**: per-job dominant-resource deficit from an accounting ledger,
  folded into the priority encoding as a bounded boost (weighted max-min):
  a job whose dominant share sits under the 1/n fair share jumps ahead of up
  to `max_boost` earlier-submitted jobs (scheduler/queues.py BLEVEL_STRIDE
  arithmetic). The per-tick Jain index of instantaneous running usage is
  kept as telemetry. The ledger is duck-typed: anything with `.rows`
  (job_id -> {"resource_seconds": {...}, "label": ...}) and `.open_runs`
  ((job, task) -> {"usage": {...}}).

* **Runtime prediction** (scheduler/predict.py): per-task-class runtime
  EWMAs weight the priority encoding with expected remaining work (LPT):
  classes predicted longest get the largest bounded boost.

Policy file (`PolicyTable.from_file`, TOML; `PolicyTable.from_plain` takes
the same tables as a dict):

    [affinity."cpus"]        # task class (see above)
    "*"    = 1.0             # default worker-class weight
    fast   = 2.0             # worker group "fast"
    slow   = 0.0             # 0 = hard exclusion

    [fairness]
    enabled   = true
    max_boost = 4            # priority-encoding jump bound

    [prediction]
    enabled      = true
    max_boost    = 4
    ewma_alpha   = 0.3
    seed_journal = "/path/to/journal"   # optional offline seed

Everything here is host-side numpy/dict work computed once per tick; the
only thing that crosses into the kernel is the (B, W) affinity matrix and
its derived mask.
"""

from __future__ import annotations

import os

import numpy as np

from hyperqueue_tpu_torch.scheduler.queues import decode_sched_job

DEFAULT_MAX_BOOST = 4
DEFAULT_EWMA_ALPHA = 0.3


def task_class(variants, resource_map) -> str:
    """Stable class label for a request: "nodes" for multi-node gangs, else
    the sorted "+"-joined resource names of the FIRST variant (the user's
    preferred shape — variants of one request share a class)."""
    v0 = variants.variants[0]
    if v0.n_nodes > 0:
        return "nodes"
    names = resource_map.names()
    parts = sorted(
        names[e.resource_id] if e.resource_id < len(names)
        else f"res{e.resource_id}"
        for e in v0.entries
    )
    return "+".join(parts) if parts else "none"


class PolicyTable:
    """Parsed, validated policy config (TOML file, plain data or flat)."""

    def __init__(
        self,
        affinity: dict | None = None,
        fairness_enabled: bool = False,
        fairness_max_boost: int = DEFAULT_MAX_BOOST,
        prediction_enabled: bool = False,
        prediction_max_boost: int = DEFAULT_MAX_BOOST,
        ewma_alpha: float = DEFAULT_EWMA_ALPHA,
        seed_journal: str | None = None,
        source: str = "builtin",
    ):
        # {task_class: {worker_class_or_*: weight}}
        self.affinity = affinity or {}
        self.fairness_enabled = bool(fairness_enabled)
        self.fairness_max_boost = max(int(fairness_max_boost), 0)
        self.prediction_enabled = bool(prediction_enabled)
        self.prediction_max_boost = max(int(prediction_max_boost), 0)
        self.ewma_alpha = float(ewma_alpha)
        self.seed_journal = seed_journal
        self.source = source

    @classmethod
    def from_file(cls, path: str) -> "PolicyTable":
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
        return cls.from_plain(data, source=str(path))

    @classmethod
    def from_plain(cls, data: dict, source: str = "plain") -> "PolicyTable":
        """The policy file's tables ("affinity", "fairness", "prediction")
        as a dict, validated as from_file validates them."""
        affinity = {}
        for tclass, row in (data.get("affinity") or {}).items():
            if not isinstance(row, dict):
                raise ValueError(
                    f"policy file {source}: [affinity.\"{tclass}\"] must be "
                    "a table of worker-class = weight entries"
                )
            parsed = {}
            for wclass, weight in row.items():
                w = float(weight)
                if w < 0:
                    raise ValueError(
                        f"policy file {source}: affinity weight for "
                        f"({tclass!r}, {wclass!r}) is negative"
                    )
                parsed[wclass] = w
            affinity[tclass] = parsed
        fair = data.get("fairness") or {}
        pred = data.get("prediction") or {}
        return cls(
            affinity=affinity,
            fairness_enabled=fair.get("enabled", False),
            fairness_max_boost=fair.get("max_boost", DEFAULT_MAX_BOOST),
            prediction_enabled=pred.get("enabled", False),
            prediction_max_boost=pred.get("max_boost", DEFAULT_MAX_BOOST),
            ewma_alpha=pred.get("ewma_alpha", DEFAULT_EWMA_ALPHA),
            seed_journal=pred.get("seed_journal"),
            source=source,
        )

    def has_row(self, tclass: str) -> bool:
        return tclass in self.affinity or "*" in self.affinity

    def weight(self, tclass: str, wclass: str) -> float:
        row = self.affinity.get(tclass)
        if row is None:
            row = self.affinity.get("*")
        if row is None:
            return 1.0
        w = row.get(wclass)
        if w is None:
            w = row.get("*", 1.0)
        return float(w)


class TickPolicyContext:
    """One tick's resolved policy inputs, aligned to the solve's worker
    order: per-rq affinity rows for assemble_solve_inputs, per-job priority
    boosts for the batch sort. Built once per tick by PolicyState."""

    __slots__ = ("rows", "boosts")

    def __init__(self, rows: dict, boosts: dict):
        self.rows = rows      # rq_id -> (W,) float32 row (aligned)
        self.boosts = boosts  # job_id -> int boost (>= 1 entries only)

    def affinity_for(self, rq_id: int):
        return self.rows.get(rq_id)

    def boost_for(self, job_id: int) -> int:
        return self.boosts.get(job_id, 0)

    def boost_for_sched(self, sched: int) -> int:
        return self.boosts.get(decode_sched_job(sched), 0)

    def __bool__(self) -> bool:
        return bool(self.rows) or bool(self.boosts)


class PolicyState:
    """Live policy engine: owns the table, the runtime predictor, and the
    fairness fold over the accounting ledger; produces one
    TickPolicyContext per scheduling tick and the policy's telemetry."""

    def __init__(self, table: PolicyTable, predictor=None, ledger=None,
                 job_name=None, live_jobs=None):
        self.table = table
        self.predictor = predictor
        self.ledger = ledger
        # job_id -> display name; the predictor's class key. Falls back to
        # the ledger row label when no resolver is injected.
        self._job_name = job_name
        # () -> iterable of job ids with unfinished tasks; lets the Jain
        # fold count STARVED jobs (work pending, zero usage) at 0
        self._live_jobs = live_jobs
        self.last_boost_range = (0, 0)
        self.last_jain: float | None = None
        self._jain_sum = 0.0
        self._jain_ticks = 0
        self._class_cache: dict[int, str] = {}

    # -- per-tick context -------------------------------------------------
    def tick_context(self, workers_by_id, rq_map, resource_map, worker_ids,
                     batches):
        """Resolve this tick's affinity rows + priority boosts.

        workers_by_id: worker_id -> object with a `group` attribute;
        worker_ids: the solve's worker order (the affinity rows
        index-align with it); batches: the tick's batch list (the active
        job/rq universe). Returns a TickPolicyContext, or None when the
        policy has no effect this tick (the flat fast path).
        """
        rows: dict[int, np.ndarray] = {}
        if self.table.affinity and worker_ids and batches:
            wclasses = []
            for wid in worker_ids:
                w = workers_by_id.get(wid)
                wclasses.append(getattr(w, "group", "") or "default")
            row_cache: dict[str, np.ndarray | None] = {}
            for b in batches:
                if b.rq_id in rows:
                    continue
                tclass = self._task_class_of(b.rq_id, rq_map, resource_map)
                if tclass is None or not self.table.has_row(tclass):
                    continue
                row = row_cache.get(tclass)
                if row is None and tclass not in row_cache:
                    vals = np.fromiter(
                        (self.table.weight(tclass, wc) for wc in wclasses),
                        dtype=np.float32, count=len(wclasses),
                    )
                    # a uniform positive row cannot reorder or exclude
                    row = (
                        vals
                        if (vals.min() != vals.max() or vals.min() <= 0)
                        else None
                    )
                    row_cache[tclass] = row
                if row is not None:
                    rows[b.rq_id] = row
        boosts = self._job_boosts(batches)
        if not rows and not boosts:
            return None
        return TickPolicyContext(rows, boosts)

    def _task_class_of(self, rq_id, rq_map, resource_map):
        cached = self._class_cache.get(rq_id)
        if cached is not None:
            return cached
        try:
            tclass = task_class(rq_map.get_variants(rq_id), resource_map)
        except (KeyError, IndexError):
            return None
        self._class_cache[rq_id] = tclass
        return tclass

    def _resolve_name(self, job_id: int) -> str | None:
        if self._job_name is not None:
            try:
                name = self._job_name(job_id)
            except Exception:  # noqa: BLE001 - telemetry, not control flow
                name = None
            if name:
                return name
        if self.ledger is not None:
            row = self.ledger.rows.get(job_id)
            if row:
                return row.get("label")
        return None

    def _job_boosts(self, batches) -> dict[int, int]:
        """Bounded per-job priority boosts: fairness deficit + predicted
        LPT, each capped by its own max_boost. Deterministic: pure folds
        over the ledger and predictor tables in sorted job order."""
        active = sorted({
            decode_sched_job(b.priority[1]) for b in (batches or [])
        })
        boosts: dict[int, int] = {}
        if not active:
            self.last_boost_range = (0, 0)
            return boosts
        if (
            self.table.fairness_enabled
            and self.ledger is not None
            and len(active) > 1
            and self.table.fairness_max_boost > 0
        ):
            usage = {}
            totals: dict[str, float] = {}
            for j in active:
                row = self.ledger.rows.get(j)
                rs = (row.get("resource_seconds") or {}) if row else {}
                usage[j] = rs
                for r, amt in rs.items():
                    totals[r] = totals.get(r, 0.0) + amt
            fair = 1.0 / len(active)
            for j in active:
                share = 0.0
                for r, amt in usage[j].items():
                    tot = totals.get(r, 0.0)
                    if tot > 0:
                        share = max(share, amt / tot)
                if share < fair:
                    boost = int(round(
                        self.table.fairness_max_boost * (1.0 - share / fair)
                    ))
                    if boost > 0:
                        boosts[j] = boost
        if (
            self.table.prediction_enabled
            and self.predictor is not None
            and self.table.prediction_max_boost > 0
        ):
            preds = {}
            for j in active:
                name = self._resolve_name(j)
                if name is None:
                    continue
                p = self.predictor.predict(name)
                if p is not None and p > 0:
                    preds[j] = p
            if preds:
                pmax = max(preds.values())
                if pmax > 0:
                    for j, p in preds.items():
                        boost = int(round(
                            self.table.prediction_max_boost * (p / pmax)
                        ))
                        if boost > 0:
                            boosts[j] = boosts.get(j, 0) + boost
        if boosts:
            vals = boosts.values()
            self.last_boost_range = (min(vals), max(vals))
        else:
            self.last_boost_range = (0, 0)
        return boosts

    # -- fairness telemetry ----------------------------------------------
    def observe_jain(self) -> float | None:
        """Jain fairness index of the instantaneous running usage per job,
        folded from the ledger's open runs. Jobs that still have unfinished
        tasks but hold NOTHING right now count at zero usage. None when
        nothing is running; folded into the time-averaged stat only when at
        least one job holds resources."""
        if self.ledger is None:
            return None
        per_job: dict[int, float] = {}
        for (job, _task), run in self.ledger.open_runs.items():
            amount = sum((run.get("usage") or {}).values())
            per_job[job] = per_job.get(job, 0.0) + amount
        if not any(v > 0 for v in per_job.values()):
            return None
        if self._live_jobs is not None:
            try:
                for j in self._live_jobs():
                    per_job.setdefault(j, 0.0)
            except Exception:  # noqa: BLE001 - telemetry, not control flow
                pass
        xs = [v for v in per_job.values() if v >= 0]
        s = sum(xs)
        s2 = sum(x * x for x in xs)
        jain = (s * s) / (len(xs) * s2) if s2 > 0 else 1.0
        self.last_jain = jain
        self._jain_sum += jain
        self._jain_ticks += 1
        return jain

    # -- surfaces ---------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "source": self.table.source,
            "affinity_classes": len(self.table.affinity),
            "fairness": {
                "enabled": self.table.fairness_enabled,
                "max_boost": self.table.fairness_max_boost,
            },
            "prediction": {
                "enabled": self.table.prediction_enabled,
                "max_boost": self.table.prediction_max_boost,
            },
            "boost_range": list(self.last_boost_range),
        }
        if self.predictor is not None:
            out["prediction"].update(self.predictor.stats())
        if self._jain_ticks:
            out["jain"] = {
                "last": round(self.last_jain, 4),
                "avg": round(self._jain_sum / self._jain_ticks, 4),
                "ticks": self._jain_ticks,
            }
        return out


def build_policy(policy_file: str | None, ledger=None, job_name=None,
                 live_jobs=None):
    """Parse a policy file, build the predictor (seeding it offline when the
    table names an existing `seed_journal`), and return a PolicyState — or
    None when no policy file is given (the flat objective)."""
    if not policy_file:
        return None
    from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor

    table = PolicyTable.from_file(policy_file)
    predictor = None
    if table.prediction_enabled:
        predictor = RuntimePredictor(alpha=table.ewma_alpha)
        if table.seed_journal and os.path.exists(table.seed_journal):
            predictor.seed_from_journal(table.seed_journal)
    return PolicyState(
        table, predictor=predictor, ledger=ledger, job_name=job_name,
        live_jobs=live_jobs,
    )
