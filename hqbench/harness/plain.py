"""A cell's inputs as plain data, made from its configuration, its traffic
mix and the run's seed.

The shapes (the multiset of worker sizes, how many tasks of each class and
priority) come from the `shape_seed` of the configuration and of the mix,
so that every run seed does the same work; the run seed only permutes
them: which worker id gets which size, which task id gets which class and
priority. The same seed gives the same inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

U = 10_000  # resource fractions per unit
INF_TIME = 2**31 - 1
# mixed with the run seed into numpy's SeedSequence, which takes integers of
# any size, so that the seeds of other programs give other streams
SEED_SALT = 0x68716265


def seed_rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator for the run seed (any integer) and a stream salt."""
    return np.random.default_rng([int(seed) % (1 << 64), SEED_SALT, *salt])


@dataclass
class Plain:
    """Everything a run and its reference start from."""

    resources: list            # resource names, "cpus" first
    classes: list              # per class: list of variants, each a list
                               # of (resource name, amount) pairs
    class_weights: np.ndarray  # (C,) how often traffic draws each class
    workers: list              # (worker_id, [amount per resource], slots)
    # the initial backlog: per (job, class, user priority) the sorted
    # job-local task ids, in order of first appearance
    backlog: list = field(default_factory=list)  # (job, cls, prio, ids)
    n_jobs: int = 0


def request_classes(spec: dict, resources: list):
    """(classes, weights) from a configuration's `requests`:
    {"classes": [[{name: units, ...}, ...], ...]}, the variants of each
    class, each class drawn alike."""
    classes = [[[(name, int(round(units * U)))
                 for name, units in variant.items()]
                for variant in variants]
               for variants in spec["classes"]]
    for variants in classes:
        for variant in variants:
            for name, _amount in variant:
                if name not in resources:
                    raise ValueError(f"request names {name!r}, not a "
                                     f"resource of {resources}")
    return classes, np.full(len(classes), 1.0 / len(classes))


def worker_rows(spec: dict, resources: list, seed: int) -> list:
    """(worker_id, amounts, task slots) rows, ids 1..count. The multiset of
    sizes comes from the spec's shape seed; the run seed permutes it over
    the ids."""
    rng = np.random.default_rng(int(spec["shape_seed"]))
    n = int(spec["count"])
    sizes = []
    for _ in range(n):
        sizes.append([int(rng.choice(spec["choices"][name])) * U
                      for name in resources])
    order = seed_rng(seed, 1).permutation(n)
    cap = int(spec["task_slots_cap"])
    return [(wid, sizes[k], min(sizes[k][0] // U, cap))
            for wid, k in zip(range(1, n + 1), order.tolist())]


def make_plain(config: dict, mix: dict, seed: int) -> Plain:
    resources = list(config["resources"])
    classes, weights = request_classes(config["requests"], resources)
    plain = Plain(resources=resources, classes=classes,
                  class_weights=weights,
                  workers=worker_rows(config["workers"], resources, seed))
    backlog = mix.get("backlog")
    if backlog:
        plain.backlog, plain.n_jobs = backlog_groups(backlog, weights, seed)
    return plain


def backlog_groups(spec: dict, weights: np.ndarray, seed: int):
    """The initial backlog: `tasks` tasks over `jobs` jobs, each of a class
    drawn by the weights and of a user priority in [0, user_priorities).
    The multiset of (class, priority) is the shape seed's; the run seed
    permutes which job-local id gets which. Returns ([(job, class,
    priority, sorted ids)], n_jobs)."""
    n = int(spec["tasks"])
    n_jobs = int(spec.get("jobs", 1))
    rng = np.random.default_rng(int(spec["shape_seed"]))
    cls = rng.choice(len(weights), size=n, p=weights)
    prio = rng.integers(0, int(spec["user_priorities"]), size=n)
    perm = seed_rng(seed, 2).permutation(n)
    cls, prio = cls[perm], prio[perm]
    # job-local ids 1..n per job, jobs take consecutive slices
    job = (np.arange(n) * n_jobs) // n + 1
    local = np.arange(n) - np.searchsorted(job, job, side="left") + 1
    key = (job.astype(np.int64) * len(weights) + cls) * 1024 + prio
    # groups in order of first appearance, ids ascending within a group
    _u, first, inverse = np.unique(key, return_index=True,
                                   return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    g = rank[inverse]
    by = np.lexsort((local, g))
    bounds = np.searchsorted(g[by], np.arange(len(order) + 1))
    groups = []
    for k in range(len(order)):
        sl = by[bounds[k]:bounds[k + 1]]
        i = sl[0]
        groups.append((int(job[i]), int(cls[i]), int(prio[i]),
                       local[sl].astype(np.int64)))
    return groups, n_jobs
