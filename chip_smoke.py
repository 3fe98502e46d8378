#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (the cut-scan, the sync probe and the
sharded cut-scan) and its native host core (the task queue, the host scan)
from the sources in this checkout, holds each kernel bit-exact against its
plain PyTorch version, drives consecutive north-star scheduling ticks
(1,024 workers, 1M ready tasks, 128 sampled request classes, 4 priority
levels) through the port's run_tick, then the same north star in fused mode
(gang rows, worker groups and a policy), then the server's own solve seam,
single-block and sharded (`--scheduler multichip`), then the north star
with min-utilization workers, then `--scheduler milp` with its degraded
tick, then the server's tick itself (reactor.schedule) over the north star
held as lazy array chunks, plain and fused, and prints timings.

Phases:
  1. the card (nvidia-smi name and power limit) and the builds, all started
     together: nvcc for each kernel source, g++ for the native host scan;
  2. the kernel against its plain version on the card, exact on counts,
     free and nt_free, over a bench-shaped instance and random small, odd,
     ALL-policy, min_time-masked, negative-free and wide (several workers
     per thread) cases, then the gang-row and policy-mask branches (K1g)
     on the solver tests' gang and weighted generators at bench width, odd
     and wide worker counts, 1, 8 and W worker groups, infeasible gangs and
     gangs behind rows that touched every idle worker; then the edge cases
     of the redesign (the widest resident shape and one worker more, caps
     summing past 2^31, negative free rows, needs at both ends of
     [1, 2^31), R = 8 with padding, M = 16, runs of one visit-class row
     with and without gang rows, a mask row that changes every batch, and
     batches whose V x R step inputs a ring of whole batches could not
     hold: V = 2,048 at W = R = 64, R = 2,066 and R = 867 with every option
     at W = 16,384 (one step a ring chunk), and R = 4,200 and R = 2,048 with
     every option (the direct layout)).
     Each case runs in the instantiation the layout picks (the wrapper
     must count it there) and, where that is the resident one, in the
     global one too; both must have been held;
  2b. the sharded kernel (K2) against its plain version and against K1 on
     the same inputs, exact on counts, free and nt_free: the K1 cases over
     2, 4 and 8 shards of the card, the K1g cases over 4, gang rows whose
     chosen group straddles a shard boundary over 2, 4 and 8, 32,768
     workers (ALL-policy; gang rows and a mask) over 4, twice K1's width,
     against the plain version only, the bench instance and a K1g case over
     16 and 32 shards (32: past any cluster) and the V x R edge cases over
     4. Each case runs in the exchange (cluster or grid) and instantiation
     the wrapper picks (it must count that launch) and in every other one
     that fits, through the forced entry; every variant and both exchanges
     through the wrapper must have been held;
  3. the main path: ticks through run_tick with GreedyCutScanModel on the
     card; each tick's counts are checked against the plain version on the
     same padded inputs and its assignments against the workers' capacity,
     and the kernel must launch exactly once per tick; every tick's counts
     are also mapped through the per-cell Python takes on a copy of the
     queues, which must give the assignments of the native one-call
     map-take (mapping_check, with both times);
  4. timings: per-tick wall time and phases, the kernel's time from CUDA
     events, its plain version's time, its bounds, and the device's busy
     time and idle share over a steady window of three more ticks under
     torch.profiler; the per-step floor (one scan and its barriers, the
     int64 three-barrier scan's beside the redesign's) and where a step's
     time goes (k1_step_split: each instantiation, and the step with the
     worker state in registers);
  5. the fused path: the north-star tasks over 8 jobs, the workers in 8
     groups of 128, 16 gang rows of 2-16 nodes per tick, gang_ok from
     idleness and a policy table (weights 2.0 on some groups, 0.0 on some
     (task class, group) pairs, prediction boosts from a predictor fed by
     observe()) through run_tick(gang_ok=, group_ids=, policy=); each tick
     is checked as in phase 3, and every gang row must be all-or-nothing
     on idle members of one group, no excluded pair may receive a task and
     the kernel must launch once, with its gang and mask inputs;
  6. fused timings as in phase 4 (with k1g_step_split), the kernel's
     prologue alone (the visit order of every visit-class row), and the
     two glue steps of the solve
     timed alone: the dirty-row index_copy_ (K3) and the counts slice and
     pinned copy to the host (K4);
  7. the sync probe (K5): the kernel against its plain version on
     arange(256) and on seeded int32 that overflow the sum, exact; its
     device time (profiler), its latency bound (the profiled time of an
     empty kernel of the same launch shape), its plain version's and
     `(v * 2).sum()`'s time, and the probe's round trip;
  8. the server path: the default north star as a server Core of 1,024
     Worker.create'd workers, solved as `hq server start` solves it:
     SolverWatchdog(GreedyCutScanModel(backend="auto")) with the resident
     paranoid check every 4th device solve and the tick cache's every 4th
     tick; the watchdog of a card model has no host fallback, so a kernel
     fault raises. The sync probe is resolved first
     (device_sync_ms(wait_s=30)), then 8 synchronous ticks
     (tick_cache.sync, run_tick over the dense snapshot, a random quarter
     of the workers finish), then 16 pipelined ticks in the server's order
     (take_result, sync, dispatch; a paranoid tick drains and solves
     synchronously). Every solve's counts are held against the plain
     version, every tick must solve on the device with valid assignments,
     the watchdog must read no failure, timeout or degraded tick, the
     residency no invalidation, the tick cache one full rebuild; then the
     tick medians over all steady ticks, over the non-paranoid ones and,
     pipelined, over the ticks that map one solve and dispatch the next,
     the device's idle share over 3 profiled ticks, the cost model's
     EWMAs, and the host solves the cost model weighs against the kernel
     (the numpy twin and the native scan, timed at the same north-star
     inputs and held equal to the kernel's counts);
  9. the multichip path: phase 8's seam around
     SolverWatchdog(MultichipModel(devices=[cuda] * 4)), the north star in
     4 shards of 256 workers, as `hq server start --scheduler multichip`
     builds it: 8 synchronous and 8 pipelined ticks, every solve's counts
     held against K2's plain version; it fails on a solve whose
     backend_reason is not "multichip-mesh", a K1 launch, a K2 launch that
     did not run the cluster exchange, any watchdog failure, timeout or
     degraded tick, or a residency invalidation; then its medians and the
     device's idle share over 3 profiled ticks;
 10. K2's device time at the multichip path's last synchronous tick, K1's
     at the same inputs, its plain version's, the exchanges' floors (one
     block scan plus one cluster or grid barrier over 4 blocks: the
     cluster_step_latency line) and the latency bound (executed steps times
     the floor of the picked exchange); then k2_step_split, us per step of
     every K2 variant at those inputs;
 11. the mu path: the north star as a Core whose first 8 workers have
     min_utilization 0.5 (one allocation that must pack or idle), 4 ticks
     through run_tick with GreedyCutScanModel on the card over
     Core.worker_rows(): the tick cache must decline the snapshot, K1 solves
     the unfloored workers (held against its plain version, one launch a
     tick) and the host search (_solve_mu_workers, timed per worker from
     here) the floored ones, each of which must receive cpu work of 0 or
     at least its floor; the floored workers finish their tasks after each
     tick. Logs the phases, the search's ms per tick and per worker and its
     node-budget warnings (mu_tick, mu_ticks);
 12. the milp path: 24 workers of 4-16 cpus (4 floored), 2,000 tasks in 28
     batches, through SolverWatchdog(MilpModel(), fallback=
     GreedyCutScanModel(backend="device")): 3 armed ticks through the joint
     program (the floors inside the MILP, no K1), one tick whose deadline is
     forced to a tenth of the fastest MILP (the MILP's own limit set to
     1 s): degraded to K1 with the floored rows zeroed, the floored workers
     receiving nothing; then 2 benched ticks through the carve-out. Every K1
     solve is held against its plain version, every floor checked, and the
     last tick's decision records (build_unplaced_entries) against
     oracle.explain_unplaced on its dense inputs (milp_reasons).
 13. the reactor path: the server's tick itself, reactor.schedule, over
     the default north star held as the server holds an array submit:
     lazy_core_from_plain, one job of 1M lazy ids in chunks of 16,384, a
     JobManager behind the lazy store; SolverWatchdog(GreedyCutScanModel(
     backend="auto")), the resident paranoid check and the tick cache's
     every 4th tick, prefill on, the sync probe resolved first. A
     recording Comm and an EventSink that forwards to the JobManager; the
     workers answer between ticks (ReactorHarness). 8 synchronous ticks,
     3 under torch.profiler (the device's idle share), then 8 pipelined
     ones. Every solve is held against the plain version; it fails on a
     Core.sanity_check failure (every 4th tick, walking every materialized
     task), a compute message for a task not ASSIGNED or prefilled on that
     worker, lazy ready plus materialized READY tasks other than the
     queues' total_ready, a job whose lazy and materialized tasks are not
     what was submitted, a tick without its flight record or whose
     record's counts are not the messages sent, a "decision-record
     assembly failed" log line, a host tick, any watchdog failure, or a
     second tick-cache rebuild. Tick 0 (up to 512 prefilled tasks per
     worker) is logged on its own and left out of the medians;
 14. the reactor_fused path: the fused north star (8 jobs, 8 groups of 128
     workers) as lazy chunks, the 16 gang tasks of gang_tasks submitted as
     Tasks through on_new_tasks, core.fused_solve and the fused path's
     policy, 8 ticks on GreedyCutScanModel(backend="device") with prefill;
     the checks of phase 13 (Core.sanity_check aside), K1g held against
     its plain version, every gang all-or-nothing on idle members of one
     group, no excluded (class, group) pair in the solve's placements, and
     one job paused before tick 4 (its chunks held, a queue-paused entry
     with the held count on each paused tick, none of its tasks placed)
     and resumed before tick 6 (everything held back in the queues).

On every path before the reactor paths the queues must be the native
ones, and every mapping of a tick without gang rows must pop its ids
through hq_map_take (counted; the fused path's gang ticks take per cell in
Python, as the JAX package's do); the reactor paths' classes hold lazy
tasks, so their mappings take per cell in Python and materialize each id,
as the JAX package's do. The mapping line sets the paths' mapping medians
side by side.

Every profiled kernel time comes from a window whose every launch is held
against the plain version's outputs, exact; a window in which the profiler
records no time for the kernel is logged (profiler_empty_window, with what
it did record) and profiled again, at most twice; the profiler_windows line
counts both.

Each server tick prints its backend and backend_reason: "device-cuda" with
"sync-within-budget" (first solve: no measurement yet, the probe's round
trip fits DISPATCH_LATENCY_BUDGET_MS) or "cost-model" (the measured device
time per shape beats the host's, or the host was never measured); a
"host-*" backend fails the run.

Each kernel's registers, spills and shared memory (nvcc -Xptxas -v) are on
a "ptxas" line per source. The main paths (default, fused, server) must run
every cut-scan solve in the resident instantiation.

The third-to-last line is the kernels JSON (K1, K1g, K5, K2), the
second-to-last the card;
the last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM data-sheet peaks, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # non-tensor rate; the int32 rate is not above it

N_TICKS = 8
SEED = 42
U = 10_000
INF = 2**31 - 1

# threads of the cut-scan's block, as the kernel library reports it
THREADS = None

# the server path: synchronous ticks, then pipelined ones
N_SERVER_TICKS = 8
N_SERVER_PIPELINED_TICKS = 16
# the multichip path: the north star over shards of one card (256 workers
# each), 8 synchronous ticks, then pipelined ones
N_SHARDS = 4
N_MULTICHIP_PIPELINED_TICKS = 8

# the mu path: the north star with N_MU_WORKERS of its workers one
# allocation that must pack or idle (min_utilization MU), N_MU_TICKS ticks
N_MU_TICKS = 4
N_MU_WORKERS = 8
MU = 0.5
# the milp path, at the size models/milp.py documents ("tens of workers x
# dozens of batches"): N_MILP_FLOORED of its workers floored, armed ticks,
# one tick past a forced deadline, then benched ticks
N_MILP_WORKERS = 24
N_MILP_FLOORED = 4
N_MILP_TASKS = 2000
N_MILP_CLASSES = 8
MILP_WORKER_CPUS = (4, 8, 16)
N_MILP_ARMED_TICKS = 3
N_MILP_BENCHED_TICKS = 2

# the fused path: the JAX server's MAX_FUSED_GANG_ROWS gang rows per tick
N_FUSED_TICKS = 8
MAX_FUSED_GANG_ROWS = 16
N_JOBS = 8
N_GROUPS = 8
N_GANG_TASKS = 160
# the reactor paths (phases 13 and 14)
N_REACTOR_TICKS = 8
N_REACTOR_PIPELINED_TICKS = 8
N_REACTOR_FUSED_TICKS = 8
REACTOR_PAUSED_JOB = 2
REACTOR_PAUSE_TICK = 4
REACTOR_RESUME_TICK = 6
# weights 2.0 on some groups, 0.0 (exclusion) on some (task class, group)
# pairs, and runtime-prediction boosts
FUSED_POLICY = {
    "affinity": {
        "cpus+mem": {"*": 1.0, "g0": 2.0, "g1": 2.0, "g7": 0.0},
        "cpus+gpus+mem": {"*": 1.0, "g2": 2.0, "g5": 0.0},
        "nodes": {"*": 1.0, "g3": 2.0, "g6": 0.0},
    },
    "prediction": {"enabled": True, "max_boost": 4},
}


def log(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# -- instances ---------------------------------------------------------------

def bench_instance(n_workers=1024, n_tasks=1_000_000, n_r=8, n_b=256, n_v=2,
                   seed=SEED):
    """Kernel inputs shaped like the repository's kernel benchmark: 1k
    heterogeneous workers (cpus, gpus on a quarter of them, memory, tpus),
    1M ready tasks over 256 batches of two variants each."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )
    from hyperqueue_tpu_torch.scheduler.tick import _range_compress
    from hyperqueue_tpu_torch.utils.constants import INF_TIME

    rng = np.random.default_rng(seed)
    free = np.zeros((n_workers, n_r), dtype=np.int64)
    free[:, 0] = rng.choice([32, 64, 128], size=n_workers) * U
    gpu_boxes = rng.random(n_workers) < 0.25
    free[:, 1] = np.where(gpu_boxes, rng.choice([4, 8], size=n_workers), 0) * U
    free[:, 2] = rng.choice([256, 512, 1024], size=n_workers) * U
    free[:, 3] = rng.integers(0, 2, size=n_workers) * 4 * U
    nt_free = np.minimum(free[:, 0] // U, 256)
    lifetime = np.full(n_workers, INF_TIME)
    needs = np.zeros((n_b, n_v, n_r), dtype=np.int64)
    needs[:, 0, 0] = rng.choice([1, 2, 4, 8], size=n_b) * U
    needs[:, 0, 1] = np.where(rng.random(n_b) < 0.3,
                              rng.choice([5000, U], size=n_b), 0)
    needs[:, 0, 2] = rng.choice([1, 4, 16], size=n_b) * U
    needs[:, 1, 0] = needs[:, 0, 0] * 2
    needs[:, 1, 2] = needs[:, 0, 2]
    sizes = rng.multinomial(n_tasks, np.ones(n_b) / n_b)
    min_time = np.zeros((n_b, n_v))
    _range_compress(needs, free)
    scarcity = scarcity_weights(free.sum(axis=0))
    class_m, order_ids = host_visit_classes(free, needs, scarcity)
    case = dict(free=free, nt_free=nt_free, lifetime=lifetime, needs=needs,
                sizes=sizes, min_time=min_time, class_m=class_m,
                order_ids=order_ids)
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def random_case(seed, n_w, n_r, n_b, n_v, with_all):
    """Random kernel inputs with negative free, min_time-masked workers,
    absent variants, padding rows and, optionally, ALL-policy requests."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    rng = np.random.default_rng(seed)
    total = rng.integers(0, 9, size=(n_w, n_r)) * U
    free = total - rng.integers(0, 5, size=(n_w, n_r)) * (U // 2)
    needs = rng.integers(0, 4, size=(n_b, n_v, n_r)) * (U // 2)
    needs[rng.random((n_b, n_v)) < 0.2] = 0
    sizes = rng.integers(0, 4 * n_w // n_b + 3, size=n_b)
    sizes[rng.random(n_b) < 0.2] = 0
    min_time = np.where(rng.random((n_b, n_v)) < 0.3,
                        rng.integers(1, 7200, size=(n_b, n_v)), 0)
    min_time[(needs == 0).all(axis=2)] = INF
    case = {
        "nt_free": rng.integers(-2, 12, size=n_w),
        "lifetime": np.where(rng.random(n_w) < 0.3,
                             rng.integers(0, 7200, size=n_w), INF),
        "sizes": sizes, "min_time": min_time,
    }
    if with_all:
        all_mask = (rng.random((n_b, n_v, n_r)) < 0.25).astype(np.int32)
        needs[all_mask > 0] = 0
        idle = rng.random(n_w) < 0.5
        free[idle] = total[idle]
        case.update(total=total, all_mask=all_mask)
    free[-1, 0] = -(U // 2)
    case.update(free=free, needs=needs)
    scarcity = scarcity_weights(np.maximum(free, 0).sum(axis=0))
    case["class_m"], case["order_ids"] = host_visit_classes(
        free, needs, scarcity, all_mask=case.get("all_mask")
    )
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def north_star_state(n_workers=1024, n_tasks=1_000_000, n_classes=128,
                     seed=SEED, n_jobs=1, n_groups=1,
                     worker_cpus=(32, 64, 128)):
    """The north-star tick state as plain data, with the distribution of
    the repository's tick benchmark: request classes of 1/2/4/8 cpus, a
    gpu share on 30% and a cpu-only fallback variant on half of them,
    1M ready tasks spread over the classes at 4 priority levels, and 1,024
    workers of 32/64/128 cpus, some with 4 or 8 gpus. With n_jobs > 1 the
    tasks are spread over that many jobs (scheduler priority = the job's
    encoded submission order), with n_groups > 1 the workers form groups
    g0, g1, ... of consecutive workers; `worker_cpus` are the workers'
    sizes."""
    from hyperqueue_tpu_torch.ids import make_task_id
    from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority
    from hyperqueue_tpu_torch.utils.constants import INF_TIME

    rng = np.random.default_rng(seed)
    classes, index_of, class_ids = [], {}, []
    for _ in range(n_classes):
        n_cpus = int(rng.choice([1, 2, 4, 8]))
        entries = [("cpus", n_cpus * U, "compact")]
        if rng.random() < 0.3:
            entries.append(("gpus", int(rng.choice([U // 2, U])), "compact"))
        mem = int(rng.choice([1, 4, 16])) * U
        entries.append(("mem", mem, "compact"))
        variants = [{"entries": entries}]
        if rng.random() < 0.5:
            variants.append({"entries": [("cpus", 2 * n_cpus * U, "compact"),
                                         ("mem", mem, "compact")]})
        key = json.dumps(variants)
        if key not in index_of:  # equal requests intern to one class
            index_of[key] = len(classes)
            classes.append(variants)
        class_ids.append(index_of[key])
    class_ids = np.asarray(class_ids)
    class_of = class_ids[rng.integers(0, n_classes, size=n_tasks)]
    prio_of = rng.integers(0, 4, size=n_tasks)
    if n_jobs == 1:
        tasks = [
            (make_task_id(1, t), c, (p, 0))
            for t, (c, p) in enumerate(zip(class_of.tolist(),
                                           prio_of.tolist()))
        ]
    else:
        job_of = np.random.default_rng(seed + 7).integers(
            1, n_jobs + 1, size=n_tasks)
        sched = {j: encode_sched_priority(j) for j in range(1, n_jobs + 1)}
        tasks = [
            (make_task_id(j, t), c, (p, sched[j]))
            for t, (c, p, j) in enumerate(zip(
                class_of.tolist(), prio_of.tolist(), job_of.tolist()))
        ]
    workers = []
    for wid in range(1, n_workers + 1):
        n_cpus = int(rng.choice(worker_cpus))
        free = [n_cpus * U, int(rng.choice([0, 0, 0, 4, 8])) * U,
                int(rng.choice([256, 512, 1024])) * U]
        group = f"g{(wid - 1) * n_groups // n_workers}" if n_groups > 1 \
            else "default"
        workers.append((wid, free, min(n_cpus, 256), INF_TIME, list(free),
                        group))
    return ["cpus", "gpus", "mem"], classes, tasks, workers


def gang_tasks(n_classes, n_jobs=N_JOBS, n_gangs=N_GANG_TASKS, seed=SEED):
    """Multi-node gang tasks of 2-16 nodes over the jobs, as plain data:
    the 15 gang classes (one per node count, appended after n_classes
    ordinary ones) and (gang_task, rq_id, priority, n_nodes) rows. The
    gangs carry the top user priority of the tasks (3): a gang row sorts
    ahead of ordinary rows of its own user priority only, and below the
    top one the deep backlog touches every idle worker first."""
    from hyperqueue_tpu_torch.ids import make_task_id
    from hyperqueue_tpu_torch.scheduler.queues import encode_sched_priority

    rng = np.random.default_rng(seed + 11)
    classes = [[{"entries": [], "n_nodes": n}] for n in range(2, 17)]
    gangs = []
    for i in range(n_gangs):
        n = int(rng.integers(2, 17))
        job = int(rng.integers(1, n_jobs + 1))
        gangs.append((make_task_id(job, 2_000_000 + i), n_classes + n - 2,
                      (3, encode_sched_priority(job)), n))
    return classes, gangs


# -- the gang-row and policy-mask cases (K1g) --------------------------------

def _onehot(gids, n_g):
    onehot = np.zeros((len(gids), n_g), np.int32)
    member = gids >= 0
    onehot[np.flatnonzero(member), gids[member]] = 1
    return onehot


def solver_gang_case(seed, n_w, n_r, n_b, n_v, n_g, n_gang_rows=16,
                     with_mask=False, gang_sizes=(2, 17)):
    """tests/test_solver.py's gang generator (test_gang_rows_numpy_matches_
    jax_and_hold_invariants) at a given width: gang rows of 2-16 nodes,
    half the workers idle, n_g groups; with_mask adds the weighted
    generator's affinity (zeros, fractional and > 1 weights), which keys
    the visit classes and gives the policy mask."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    rng = np.random.default_rng(seed)
    free = rng.integers(0, 8, size=(n_w, n_r)) * U
    needs = rng.integers(0, 3, size=(n_b, n_v, n_r)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    sizes = rng.integers(0, 12, size=n_b)
    case = {
        "free": free,
        "nt_free": rng.integers(0, 10, size=n_w),
        "lifetime": np.where(rng.random(n_w) < 0.2, 100, INF),
        "needs": needs, "sizes": sizes,
        "min_time": np.where(rng.random((n_b, n_v)) < 0.2, 3600, 0),
    }
    if n_gang_rows:
        gang_nodes = np.zeros(n_b, np.int64)
        rows = rng.choice(n_b, size=n_gang_rows, replace=False)
        gang_nodes[rows] = rng.integers(*gang_sizes, size=n_gang_rows)
        sizes[rows] = 1
        case.update(gang_nodes=gang_nodes,
                    gang_ok=rng.integers(0, 2, size=n_w),
                    group_onehot=_onehot(rng.integers(0, n_g, size=n_w),
                                         n_g))
    affinity = None
    if with_mask:
        affinity = rng.choice(np.array([0.0, 0.5, 1.0, 2.0, 4.0]),
                              size=(n_b, n_w))
        case["policy_mask"] = (affinity > 0).astype(np.int32)
    scarcity = scarcity_weights(free.sum(axis=0))
    case["class_m"], case["order_ids"] = host_visit_classes(
        free, needs, scarcity, affinity=affinity)
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def fused_random_case(seed, n_w, n_r, n_b, n_v, n_g):
    """random_case with gang rows (a quarter of the rows, 1-16 nodes), 60%
    idle workers in n_g groups (5% in none) and an affinity with zeros that
    keys the visit classes and gives the policy mask."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    case = random_case(seed, n_w, n_r, n_b, n_v, False)
    rng = np.random.default_rng(seed + 77)
    affinity = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32),
                          size=(n_b, n_w), p=[0.2, 0.2, 0.4, 0.2])
    scarcity = scarcity_weights(np.maximum(case["free"], 0).sum(axis=0))
    case["class_m"], case["order_ids"] = host_visit_classes(
        case["free"], case["needs"], scarcity, affinity=affinity)
    gids = np.where(rng.random(n_w) < 0.95,
                    rng.integers(0, n_g, size=n_w), -1)
    case.update(
        policy_mask=(affinity > 0).astype(np.int32),
        gang_nodes=np.where(rng.random(n_b) < 0.25,
                            rng.integers(1, 17, size=n_b), 0),
        gang_ok=(rng.random(n_w) < 0.6).astype(np.int32),
        group_onehot=_onehot(gids, n_g),
    )
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def touched_case(n_w=1024, n_g=8, touch=None):
    """Gang rows behind an ordinary row that places one task on each of the
    first `touch` workers (one 3-cpu task fits per 4-cpu worker); all
    workers idle, 8 gang rows of 4-64 nodes. touch=None touches all."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    n_b = 9
    touch = n_w if touch is None else touch
    free = np.full((n_w, 1), 4 * U)
    needs = np.zeros((n_b, 1, 1), np.int64)
    needs[0, 0, 0] = 3 * U
    sizes = np.ones(n_b, np.int64)
    sizes[0] = touch
    gang_nodes = np.array([0, 4, 8, 16, 32, 64, 4, 8, 16])
    case = {
        "free": free, "nt_free": np.full(n_w, 4),
        "lifetime": np.full(n_w, INF), "needs": needs, "sizes": sizes,
        "min_time": np.zeros((n_b, 1)), "gang_nodes": gang_nodes,
        "gang_ok": np.ones(n_w),
        "group_onehot": _onehot(np.arange(n_w) * n_g // n_w, n_g),
    }
    case["class_m"], case["order_ids"] = host_visit_classes(
        free, needs, scarcity_weights(free.sum(axis=0)))
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


def k1g_cases():
    """name -> kernel inputs of every K1g case."""
    cases = {
        "gang_solver_1024x8x256x2_G8":
            solver_gang_case(500, 1024, 8, 256, 2, 8),
        "mask_solver_1024x8x256x2":
            solver_gang_case(900, 1024, 8, 256, 2, 8, n_gang_rows=0,
                             with_mask=True),
        "gang_mask_solver_1024x8x256x2_G8":
            solver_gang_case(1300, 1024, 8, 256, 2, 8, with_mask=True),
        "gang_infeasible_1024x8x256x2_G64":
            solver_gang_case(1700, 1024, 8, 256, 2, 64, with_mask=True,
                             gang_sizes=(17, 33)),
        "gang_after_touch_all_1024_G8": touched_case(),
        "gang_after_touch_half_1024_G8": touched_case(touch=512),
    }
    for i, shape in enumerate([
        (1021, 3, 37, 2, 5), (1024, 4, 64, 2, 1024), (4096, 4, 64, 2, 8),
        (16384, 3, 32, 2, 1), (16384, 3, 32, 2, 8), (16384, 3, 32, 2, 16384),
    ]):
        name = "gang_mask_" + "x".join(map(str, shape[:4])) + (
            f"_G{shape[4]}")
        cases[name] = fused_random_case(2000 + i, *shape)
    return cases


# -- the redesign's edge cases (K1 and K1g) ---------------------------------
# (tests/test_torch_cuda.py holds the kernel to the same cases)

def with_classes(case, n_m, seed, runs=False):
    """The case with M random visit-class rows (every class of [0, 16) in
    use) and random rows per step; with `runs`, in runs of 8 equal rows."""
    rng = np.random.default_rng(seed)
    n_w = case["free"].shape[0]
    n_b, n_v = case["min_time"].shape
    case["class_m"] = rng.integers(0, 16, size=(n_m, n_w)).astype(np.int32)
    oid = rng.integers(0, n_m, size=n_b * n_v)
    if runs:
        oid = np.repeat(oid[::8], 8)[:n_b * n_v]
    case["order_ids"] = oid.reshape(n_b, n_v).astype(np.int32)
    return case


# The K1 edge cases: the widest resident shape and one worker more
# (global), with and without ALL-policy; caps that sum past 2^31 with sizes
# near 2^31 - 1; negative free and nt_free rows; needs at both ends of
# [1, 2^31) against free across the int32 range; R = 8 with padded
# resources; M = 16 rows; runs of one visit-class row (no closing barrier)
# over three workers a thread; R = 64 at W = 16,384, whose global layout
# fits only with a shorter step ring; and batches whose V x R step inputs a
# ring of whole batches could not hold: V = 2,048 at W = R = 64 (chunks end
# inside batches), R = 2,066 at W = 16,384 (one step a chunk) and R = 4,200
# (not even one step fits: the direct layout).
K1_EDGE_CASES = ("limit", "limit_plus_1", "limit_all", "limit_all_plus_1",
                 "caps_past_2_31", "negative_free_rows", "need_range_ends",
                 "r8_padded", "m16", "m_runs", "r64_w16384",
                 "vr_w64_r64_v2048", "vr_w16384_r2066",
                 "vr_direct_w16384_r4200")


def wide_inputs_case(seed, n_w, n_r, n_b, n_v, with_all, n_m=16):
    """A case with many resources or variants: each variant requests the
    first resource and about four others, one task's worth each, and every
    worker has 1-8 tasks' worth of every resource, so tasks fit; M
    visit-class rows."""
    rng = np.random.default_rng(seed)
    free = rng.integers(1, 9, size=(n_w, n_r)).astype(np.int32) * 100
    needs = (rng.random((n_b, n_v, n_r)) < min(0.05, 4 / n_r)).astype(
        np.int32) * 100
    needs[:, :, 0] = 100
    case = {"free": free,
            "nt_free": rng.integers(0, 6, size=n_w).astype(np.int32),
            "lifetime": np.full(n_w, INF, np.int32), "needs": needs,
            "sizes": rng.integers(1, 2000, size=n_b).astype(np.int32),
            "min_time": np.zeros((n_b, n_v), np.int32)}
    if with_all:
        case["total"] = free.copy()
        case["all_mask"] = (rng.random((n_b, n_v, n_r)) < 0.01).astype(
            np.int32)
    return with_classes(case, n_m, seed)


def k1_edge_case(name):
    """Kernel inputs of the K1 edge case `name` (see K1_EDGE_CASES)."""
    from hyperqueue_tpu_torch.ops.assign import largest_resident_w

    top = 2**31 - 1
    if name in ("limit", "limit_plus_1", "limit_all", "limit_all_plus_1"):
        all_policy = "all" in name
        w = largest_resident_w(4, 2, 3, 0, all_policy)
        w += name.endswith("plus_1")
        return with_classes(random_case(w, w, 4, 24, 2, all_policy), 3, w)
    if name == "caps_past_2_31":
        case = random_case(5, 64, 2, 12, 2, False)
        rng = np.random.default_rng(5)
        case["free"][:, 0] = top - rng.integers(0, 1000, size=64)
        case["free"][::7] = -rng.integers(1, 1000, size=(10, 2))
        case["nt_free"][:] = top - rng.integers(0, 3, size=64)
        case["needs"][:] = rng.integers(1, 4, size=case["needs"].shape)
        case["needs"][:, :, 1] = 0
        case["min_time"][:] = 0
        case["sizes"][:] = top - rng.integers(0, 1000, size=12)
        return with_classes(case, 3, 5)
    if name == "negative_free_rows":
        case = random_case(6, 1000, 3, 40, 2, False)
        rng = np.random.default_rng(6)
        rows = rng.random(1000) < 0.3
        case["free"][rows] = -rng.integers(0, top, size=(rows.sum(), 3))
        case["nt_free"][rng.random(1000) < 0.1] = -5
        return case
    if name == "need_range_ends":
        case = random_case(7, 1024, 4, 64, 2, False)
        rng = np.random.default_rng(7)
        ends = np.array([1, 2, 3, 5, 7, 2**15, 2**16 + 1, 2**30 - 1, 2**30,
                         2**30 + 1, top - 2, top - 1, top], np.int64)
        needs = rng.choice(ends, size=case["needs"].shape)
        needs[rng.random(needs.shape) < 0.3] = 0
        case["needs"] = needs.astype(np.int32)
        case["free"] = rng.integers(-top, top, size=(1024, 4),
                                    endpoint=True).astype(np.int32)
        case["free"][rng.random((1024, 4)) < 0.3] = top
        case["nt_free"][:] = 1 << 20
        case["sizes"][:] = rng.integers(1, 1 << 24, size=64)
        case["min_time"][:] = 0
        return with_classes(case, 4, 7)
    if name == "r8_padded":
        case = random_case(8, 1000, 8, 48, 2, True)
        for key in ("free", "total"):
            case[key][:, 3:] = 0
        for key in ("needs", "all_mask"):
            case[key][:, :, 3:] = 0
        return case
    if name == "m16":
        return with_classes(random_case(9, 2000, 4, 64, 2, False), 16, 9)
    if name == "m_runs":
        return with_classes(random_case(10, 3000, 4, 128, 2, False), 2, 10,
                            runs=True)
    if name == "r64_w16384":
        # each variant requests a few of the 64 resources, so tasks fit
        case = random_case(11, 16384, 64, 40, 2, False)
        rng = np.random.default_rng(11)
        case["needs"][rng.random(case["needs"].shape) < 0.9] = 0
        return with_classes(case, 3, 11)
    if name == "vr_w64_r64_v2048":
        return wide_inputs_case(12, 64, 64, 3, 2048, False, n_m=1)
    if name == "vr_w16384_r2066":
        return wide_inputs_case(13, 16384, 2066, 3, 2, False)
    if name == "vr_direct_w16384_r4200":
        return wide_inputs_case(14, 16384, 4200, 3, 2, False)
    raise KeyError(name)


# The K1g edge cases: the widest resident fused shape (gang rows, 8 groups,
# a mask, M = 7) and one worker more, a policy-mask row that changes every
# batch, runs of one visit-class row broken by gang rows, and R = 32 at
# W = 16,384 with ALL-policy, gang rows over 16,384 groups and a mask,
# whose global layout fits only with a shorter step ring; R = 867 at
# W = 16,384 with ALL-policy, 16,384 groups, gang rows, a mask and M = 16,
# past a ring of whole batches (one step a chunk), and R = 2,048 with the
# same options (the direct layout).
K1G_EDGE_CASES = ("limit", "limit_plus_1", "mask_every_batch",
                  "m_runs_broken_by_gangs", "r32_all_w16384_G16384",
                  "vr_w16384_r867_all_G16384",
                  "vr_direct_w16384_r2048_all_G16384")


def k1g_edge_case(name):
    """Kernel inputs of the K1g edge case `name` (see K1G_EDGE_CASES)."""
    from hyperqueue_tpu_torch.ops.assign import largest_resident_w

    if name in ("limit", "limit_plus_1"):
        w = largest_resident_w(4, 2, 7, 8, False, True, True)
        w += name == "limit_plus_1"
        return with_classes(fused_random_case(w, w, 4, 32, 2, 8), 7, w)
    if name == "mask_every_batch":
        case = random_case(21, 1024, 4, 96, 2, False)
        rng = np.random.default_rng(21)
        case["policy_mask"] = (rng.random((96, 1024)) < 0.7).astype(np.int32)
        return with_classes(case, 3, 21)
    if name == "m_runs_broken_by_gangs":
        case = fused_random_case(22, 2048, 4, 120, 2, 8)
        del case["policy_mask"]
        case = with_classes(case, 2, 22, runs=True)
        gang = np.zeros(120, np.int32)
        gang[5::9] = np.arange(1, 15)[: len(gang[5::9])]
        case["gang_nodes"] = gang
        return case
    if name == "r32_all_w16384_G16384":
        n_w, n_g = 16384, 16384
        case = random_case(23, n_w, 32, 24, 2, True)
        rng = np.random.default_rng(23)
        case["needs"][rng.random(case["needs"].shape) < 0.85] = 0
        gids = np.where(rng.random(n_w) < 0.95,
                        rng.integers(0, n_g, size=n_w), -1)
        case.update(
            policy_mask=(rng.random((24, n_w)) < 0.8).astype(np.int32),
            gang_nodes=np.where(rng.random(24) < 0.25,
                                rng.integers(1, 3, size=24), 0
                                ).astype(np.int32),
            gang_ok=(rng.random(n_w) < 0.6).astype(np.int32),
            group_onehot=_onehot(gids, n_g),
        )
        return case
    if name in ("vr_w16384_r867_all_G16384",
                "vr_direct_w16384_r2048_all_G16384"):
        n_w = n_g = 16384
        n_r, seed = (867, 24) if "r867" in name else (2048, 25)
        n_b = 6
        case = wide_inputs_case(seed, n_w, n_r, n_b, 2, True)
        rng = np.random.default_rng(seed)
        gids = np.where(rng.random(n_w) < 0.95,
                        rng.integers(0, n_g, size=n_w), -1)
        case.update(
            policy_mask=(rng.random((n_b, n_w)) < 0.8).astype(np.int32),
            gang_nodes=np.array([0, 2, 0, 0, 3, 0], np.int32),
            gang_ok=(rng.random(n_w) < 0.6).astype(np.int32),
            group_onehot=_onehot(gids, n_g),
        )
        return case
    raise KeyError(name)


# -- the sharded solve's cases (K2) -------------------------------------------

def pad_workers(case, n_shards):
    """The case with inert workers appended up to a multiple of n_shards
    (no free resources, no task slot, no lifetime, class 0, not idle, in no
    group, masked), as the model pads W."""
    extra = -case["free"].shape[0] % n_shards
    if not extra:
        return case
    out = dict(case)
    for key in ("free", "nt_free", "lifetime", "total", "gang_ok",
                "group_onehot"):
        if key in case:
            out[key] = np.concatenate(
                [case[key], np.zeros((extra,) + case[key].shape[1:],
                                     np.int32)])
    for key in ("class_m", "policy_mask"):
        if key in case:
            out[key] = np.concatenate(
                [case[key], np.zeros((case[key].shape[0], extra), np.int32)],
                axis=1)
    return out


def straddle_case(n_w=1024, n_shards=4):
    """Gang rows whose chosen group crosses shard boundaries: group 0 holds
    the workers around the first boundary, group 1 the middle half (less
    group 0), group 2 the rest; all idle, with ordinary rows between the
    gang rows (gangs of 50, 20, 300, 2,000 and 7 nodes)."""
    from hyperqueue_tpu_torch.ops.assign import (
        host_visit_classes,
        scarcity_weights,
    )

    rng = np.random.default_rng(31)
    size = n_w // n_shards
    gids = np.full(n_w, 2)
    gids[n_w // 4 + 24:3 * n_w // 4] = 1
    gids[size - 40:size + 24] = 0
    n_b = 12
    free = rng.integers(1, 8, size=(n_w, 2)) * U
    needs = rng.integers(0, 3, size=(n_b, 1, 2)) * (U // 2)
    needs[:, 0, 0] = np.maximum(needs[:, 0, 0], U)
    gang_nodes = np.zeros(n_b, np.int64)
    gang_nodes[[0, 3, 5, 8, 11]] = [50, 20, 300, 2000, 7]
    sizes = np.where(gang_nodes > 0, 1, rng.integers(0, 200, size=n_b))
    case = {"free": free, "nt_free": rng.integers(1, 6, size=n_w),
            "lifetime": np.full(n_w, INF), "needs": needs, "sizes": sizes,
            "min_time": np.zeros((n_b, 1)), "gang_nodes": gang_nodes,
            "gang_ok": np.ones(n_w), "group_onehot": _onehot(gids, 3)}
    case["class_m"], case["order_ids"] = host_visit_classes(
        free, needs, scarcity_weights(free.sum(axis=0)))
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in case.items()}


# the V x R edge cases that K2 runs too, over 4 shards
K2_VR_CASES = ("vr_w64_r64_v2048", "vr_w16384_r2066", "vr_direct_w16384_r4200")
K2G_VR_CASES = ("vr_w16384_r867_all_G16384",
                "vr_direct_w16384_r2048_all_G16384")


def k2_cases(k1_cases, k1g):
    """name -> (kernel inputs, shards) of every K2 case: the K1 cases over
    2, 4 and 8 shards, the K1g cases over 4, the straddling gangs over 2, 4
    and 8, 32,768 workers (ALL-policy; gang rows and a mask) over 4, the
    bench instance and the first K1g case over 16 and 32 shards (32 is past
    any cluster: the grid exchange), and the V x R edge cases over 4."""
    cases = {}
    for name, case in k1_cases.items():
        for n in (2, 4, 8):
            cases[f"{name}_D{n}"] = (pad_workers(case, n), n)
    for name, case in k1g.items():
        cases[f"{name}_D4"] = (pad_workers(case, 4), 4)
    for n in (2, 4, 8):
        cases[f"gang_straddle_1024_D{n}"] = (straddle_case(n_shards=n), n)
    cases["all_32768x3x8x2_D4"] = (random_case(76, 32768, 3, 8, 2, True), 4)
    cases["gang_mask_32768x3x8x2_G8_D4"] = (
        fused_random_case(77, 32768, 3, 8, 2, 8), 4)
    first_k1g = next(iter(k1g))
    for n in (16, 32):
        cases[f"bench_1024x8x256x2_D{n}"] = (bench_instance(), n)
        cases[f"{first_k1g}_D{n}"] = (pad_workers(k1g[first_k1g], n), n)
    for name in K2_VR_CASES:
        cases[f"{name}_D4"] = (k1_edge_case(name), 4)
    for name in K2G_VR_CASES:
        cases[f"{name}_D4"] = (k1g_edge_case(name), 4)
    return cases


# -- checks ------------------------------------------------------------------

KEYS = ("free", "nt_free", "lifetime", "needs", "sizes", "min_time",
        "class_m", "order_ids")
OPTIONAL = ("total", "all_mask", "gang_nodes", "gang_ok", "group_onehot",
            "policy_mask")


def to_device(case, device):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
            .to(device) for k, v in case.items()
            if v is not None and not k.startswith("_")}


def _args(t):
    return [t[k] for k in KEYS], {k: t.get(k) for k in OPTIONAL}


def kernel_vs_plain(case, device, checked=None) -> int:
    """Run the kernel (through its wrapper, in the instantiation the layout
    picks) and its plain version on the same inputs on the card, then the
    other instantiation too where it fits (cut_scan_forced, uncounted);
    raises unless counts, free and nt_free agree exactly, or unless the
    wrapper counted exactly one launch of the instantiation it picked.
    Adds the instantiations checked to `checked` (name -> cases). Returns
    the largest absolute difference (0)."""
    import torch

    from hyperqueue_tpu_torch.ops import assign

    t = to_device(case, device)
    args, opt = _args(t)
    ref = assign.greedy_cut_scan_reference(*args, **opt)
    n_w, n_r = case["free"].shape
    n_g = case["group_onehot"].shape[1] if "group_onehot" in case else 0
    layout = assign.cut_scan_layout(
        n_w, n_r, case["min_time"].shape[1], case["class_m"].shape[0], n_g,
        "total" in case, "gang_nodes" in case, "policy_mask" in case)
    picked = layout["instantiation"]
    f = assign.greedy_cut_scan
    before = (f.resident_launches, f.global_launches)
    state = (t["free"].clone(), t["nt_free"].clone())
    runs = {picked: (assign.greedy_cut_scan(*args, **opt), t["free"],
                     t["nt_free"])}
    resident = picked == "resident"
    want = (before[0] + resident, before[1] + (not resident))
    if (f.resident_launches, f.global_launches) != want:
        raise AssertionError(f"the wrapper picked {picked} but counted "
                             f"{(f.resident_launches, f.global_launches)} "
                             f"after {before}")
    if resident:
        runs["global"] = (assign.cut_scan_forced(*state, *args[2:], **opt,
                                                 resident=False), *state)
    torch.cuda.synchronize()
    err = 0
    for kind, got_all in runs.items():
        for name, got, want in zip(("counts", "free", "nt_free"), got_all,
                                   ref):
            diff = int((got.to(torch.int64) - want.to(torch.int64))
                       .abs().max())
            if diff != 0:
                raise AssertionError(
                    f"kernel ({kind}) and plain version differ on {name} "
                    f"(max abs diff {diff})")
            err = max(err, diff)
        if checked is not None:
            checked[kind] = checked.get(kind, 0) + 1
    return err


K2_VARIANTS = [(ex, res) for ex in ("cluster", "grid")
               for res in (True, False)]


def case_shape(case):
    """(W, R, V, M, G, ALL-policy, gang rows, mask) of a case's inputs, in
    the layouts' argument order."""
    n_w, n_r = case["free"].shape
    n_g = case["group_onehot"].shape[1] if "group_onehot" in case else 0
    return (n_w, n_r, case["min_time"].shape[1], case["class_m"].shape[0],
            n_g, "total" in case, "gang_nodes" in case,
            "policy_mask" in case)


def k2_layout(case, n_shards):
    """The exchange and instantiation the sharded wrapper picks for these
    inputs (the kernel library's own layout and occupancy query)."""
    from hyperqueue_tpu_torch.parallel import solve

    n_w, *rest = case_shape(case)
    return solve.sharded_layout(n_w, n_shards, *rest, native=True)


def k2_variant_fits(case, n_shards, exchange, resident) -> bool:
    """Whether the sharded kernel takes these inputs in this variant: a
    resident layout within the shared-memory limit, a cluster of
    n_shards blocks that the card fits (the library's occupancy query); a
    grid the blocks of which the card holds at once (all our cases)."""
    from hyperqueue_tpu_torch.parallel import solve

    lib, _record = solve._sharded_scan_lib()
    n_w, *rest = case_shape(case)
    shape = [n_w // n_shards] + [int(x) for x in rest]
    if resident and lib.hq_sharded_smem_bytes(*shape, 1) > \
            lib.hq_sharded_smem_limit():
        return False
    if exchange == "cluster":
        return n_shards <= lib.hq_sharded_max_cluster(*shape, int(resident))
    return True


def k2_name(exchange, resident) -> str:
    return f"{exchange}/{'resident' if resident else 'global'}"


def sharded_vs_plain(case, device, n_shards, checked=None) -> int:
    """Run K2 over n_shards shards of the card through its wrapper (the
    exchange and instantiation its layout picks; it must count exactly that
    launch), then through the forced entry (uncounted) in
    every other variant that fits, beside its plain version and, where K1
    takes the width, K1, on the same inputs; raises unless counts, free and
    nt_free agree exactly. Adds the variants held to `checked` (name ->
    cases; "wrapper/<exchange>" for the wrapper's picks). Returns the
    largest absolute difference (0)."""
    import torch

    from hyperqueue_tpu_torch.ops.assign import (
        MAX_KERNEL_WORKERS,
        greedy_cut_scan,
    )
    from hyperqueue_tpu_torch.parallel import solve

    mesh = solve.make_worker_mesh([device] * n_shards)
    t = to_device(case, device)
    args, opt = _args(t)
    pristine = (t["free"].clone(), t["nt_free"].clone())
    want = {"plain": solve.sharded_cut_scan_reference(mesh, *args, **opt)}
    n_w, n_r = case["free"].shape
    if n_w <= MAX_KERNEL_WORKERS:
        state = (t["free"].clone(), t["nt_free"].clone())
        want["K1"] = (greedy_cut_scan(*state, *args[2:], **opt), *state)
    layout = k2_layout(case, n_shards)
    f = solve.sharded_cut_scan
    before = {k: getattr(f, k) for k in solve.LAUNCH_COUNTS}
    counts = solve.sharded_cut_scan(mesh, *args, **opt)
    got = {k: getattr(f, k) - before[k] for k in solve.LAUNCH_COUNTS}
    resident = layout["instantiation"] == "resident"
    expect = {"launches": 1,
              "cluster_launches": int(layout["exchange"] == "cluster"),
              "grid_launches": int(layout["exchange"] == "grid"),
              "resident_launches": int(resident),
              "global_launches": int(not resident)}
    if got != expect:
        raise AssertionError(f"the wrapper picked {layout} but counted {got}")
    picked = (layout["exchange"], resident)
    runs = {"wrapper/" + k2_name(*picked): (counts, t["free"], t["nt_free"])}
    for variant in K2_VARIANTS:
        if variant == picked or not k2_variant_fits(case, n_shards,
                                                    *variant):
            continue
        state = (pristine[0].clone(), pristine[1].clone())
        ex, res = variant
        runs[k2_name(*variant)] = (solve.sharded_cut_scan_forced(
            mesh, *state, *args[2:], **opt, exchange=ex, resident=res),
            *state)
    torch.cuda.synchronize()
    for kind, got_all in runs.items():
        for other, ref in want.items():
            for name, g, w in zip(("counts", "free", "nt_free"), got_all,
                                  ref):
                diff = int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max())
                if diff != 0:
                    raise AssertionError(
                        f"K2 ({kind}) and {other} differ on {name} (max "
                        f"abs diff {diff})")
        if checked is not None:
            key = kind.replace("wrapper/", "") if kind.startswith(
                "wrapper/") else kind
            checked[key] = checked.get(key, 0) + 1
            if kind.startswith("wrapper/"):
                wk = "wrapper/" + layout["exchange"]
                checked[wk] = checked.get(wk, 0) + 1
    return 0


class RecordingModel:
    """Passes every solve to the model and keeps its inputs and counts, so
    each tick can be checked after it ran."""

    def __init__(self, model):
        self.model = model
        self.calls = []

    def __getattr__(self, name):
        # only reached for attributes not set here: the model's
        return getattr(self.model, name)

    def solve(self, **kwargs):
        counts = self.model.solve(**kwargs)
        # a copy: the counts array is a view of the model's pinned host
        # buffer, which a kept reference would stop the allocator reusing
        self.calls.append((kwargs, counts.copy()))
        return counts


def padded_inputs(model, kwargs):
    """The kernel's padded inputs of one recorded solve (the model's own
    prepare), with the live (B, V, W) extents."""
    prep = model.prepare(**kwargs)
    case = {"free": prep["free_p"], "nt_free": prep["nt_p"],
            "lifetime": prep["life_p"], "needs": prep["needs_p"],
            "sizes": prep["sizes_p"], "min_time": prep["mt_p"],
            "class_m": prep["class_m"], "order_ids": prep["order_ids"],
            "total": prep["total_p"], "all_mask": prep["amask_p"],
            "gang_nodes": prep["gang_p"], "gang_ok": prep["gok_p"],
            "group_onehot": prep["goh_p"], "policy_mask": prep["pmask_p"]}
    return {k: np.array(v, dtype=np.int32) for k, v in case.items()
            if v is not None}, prep["extents"]


def check_tick_against_plain(model, kwargs, counts, device, tick,
                             plain=None):
    """The same padded inputs through the plain version on the card (K1's
    unless `plain` is given); raises unless the counts agree. Returns the
    padded case with the plain counts under "_counts"."""
    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_reference

    case, (n_b, n_v, n_w) = padded_inputs(model, kwargs)
    args, opt = _args(to_device(case, device))
    plain = plain or greedy_cut_scan_reference
    ref = plain(*args, **opt)[0].cpu().numpy()
    if not np.array_equal(ref[:n_b, :n_v, :n_w], counts):
        raise AssertionError(f"tick {tick}: counts differ from the plain "
                             "version")
    case["_counts"] = ref
    case["_extents"] = (n_b, n_v, n_w)
    return case


def executed_steps(case) -> int:
    """Steps the kernel runs: one per gang row, and the (batch, variant)
    steps of ordinary rows that start with tasks left to place (it skips
    the rest)."""
    counts = case["_counts"]
    gang = case.get("gang_nodes")
    n = 0
    for b in range(case["sizes"].shape[0]):
        if gang is not None and gang[b] > 0:
            n += 1
            continue
        remaining = int(case["sizes"][b])
        for v in range(case["needs"].shape[1]):
            if remaining > 0:
                n += 1
            remaining -= int(counts[b, v].sum())
    return n


def bounds(case, steps, step_latency_ms):
    """The least time the card could take for the kernel's work: bytes
    (inputs read once, outputs written once) over the HBM rate, and integer
    operations (per executed step and worker: one division and one compare
    per resource, ten more for capacity, prefix and update) over the
    card's non-tensor rate. The scan is sequential, so its binding floor is
    the latency bound: one block-wide scan plus barrier per step, over the
    steps this run's data executes (the kernel skips a step with no tasks
    left) and over all steps (B*V, a gang row counting one)."""
    n_w, n_r = case["free"].shape
    in_bytes = sum(v.nbytes for k, v in case.items() if not k.startswith("_"))
    out_bytes = case["_counts"].nbytes + case["free"].nbytes \
        + case["nt_free"].nbytes
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = steps * n_w * (2 * n_r + 10)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    n_b, n_v = case["min_time"].shape
    n_gang = int((case["gang_nodes"] > 0).sum()) if "gang_nodes" in case \
        else 0
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": in_bytes + out_bytes, "ops": ops,
        "latency_bound_ms": steps * step_latency_ms,
        "latency_bound_all_steps_ms":
            ((n_b - n_gang) * n_v + n_gang) * step_latency_ms,
    }


def time_kernel(case, device, reps=50, solve=None):
    """Mean ms of one call of the kernel's wrapper (K1's unless `solve` is
    given) at these inputs, by CUDA events over `reps` back-to-back calls
    (each on its own copy of the state it updates in place), and the host's
    mean ms to issue one of those calls (perf_counter, no wait): where the
    two are about equal, the host sets the pace. With gang rows this
    includes the wrapper's group one-hot check, which reads a flag back."""
    import torch

    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan

    solve = solve or greedy_cut_scan
    t = to_device(case, device)
    states = [(t["free"].clone(), t["nt_free"].clone())
              for _ in range(reps + 5)]
    args, opt = _args(t)
    rest = args[2:]
    for f, n in states[:5]:
        solve(f, n, *rest, **opt)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for f, n in states[5:]:
        solve(f, n, *rest, **opt)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


# profiled kernel windows in this run, and those in which the profiler
# recorded no time for the kernel
PROFILED = {"windows": 0, "empty": 0}
# a case's plain outputs, by the id of its free array (kept alive beside)
_PLAIN: dict = {}


def plain_outputs(case, device):
    """The plain version's (counts, free, nt_free) at a case's inputs on the
    card, computed once per case. K1's, which K2's plain version equals on
    every case (phase 2b)."""
    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_reference

    hit = _PLAIN.get(id(case["free"]))
    if hit is None or hit[0] is not case["free"]:
        args, opt = _args(to_device(case, device))
        hit = (case["free"], greedy_cut_scan_reference(*args, **opt))
        _PLAIN[id(case["free"])] = hit
    return hit[1]


def kernel_device_ms(case, device, reps=20, solve=None,
                     kernel="cut_scan_kernel") -> float:
    """Mean device ms of the kernel `kernel` alone at these inputs, launched
    by `solve` (K1's wrapper by default): the profiler's (CUPTI) kernel time
    over `reps` launches, each of which must equal the plain version exactly
    (counts, free, nt_free). A window in which the profiler records no time
    for the kernel is logged with what it did record and profiled again, at
    most twice, before the measurement fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan

    solve = solve or greedy_cut_scan
    want = plain_outputs(case, device)
    t = to_device(case, device)
    args, opt = _args(t)
    for attempt in range(3):
        states = [(t["free"].clone(), t["nt_free"].clone())
                  for _ in range(reps + 2)]
        for f, n in states[:2]:
            solve(f, n, *args[2:], **opt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs = [(solve(f, n, *args[2:], **opt), f, n)
                    for f, n in states[2:]]
            torch.cuda.synchronize()
        for out in outs:
            for name, got, ref in zip(("counts", "free", "nt_free"), out,
                                      want):
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"a profiled {kernel} launch differs from the "
                        f"plain version on {name}")
        PROFILED["windows"] += 1
        averages = prof.key_averages()
        events = [e for e in averages if kernel in e.key]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            return total_us / 1e3 / reps
        PROFILED["empty"] += 1
        timed = sorted(averages, key=lambda e: -e.device_time_total)[:6]
        log("profiler_empty_window", kernel=kernel, attempt=attempt,
            kernel_events=[(e.key, e.count) for e in events],
            device_events=[(e.key, e.count, e.device_time_total)
                           for e in timed if e.device_time_total > 0],
            events=len(prof.events()))
    raise AssertionError(f"the profiler saw no {kernel} time")


def time_plain(case, device, reps=3, plain=None) -> float:
    import torch

    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_reference

    plain = plain or greedy_cut_scan_reference
    args, opt = _args(to_device(case, device))
    plain(*args, **opt)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        plain(*args, **opt)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_timing(case, device, step_lat):
    """The kernel's times and bounds at one tick's padded inputs, with the
    visit-class table's rows (M) and the prologue's own time."""
    import torch

    from hyperqueue_tpu_torch.ops.assign import prologue_ms

    kernel_case = {k: v for k, v in case.items() if not k.startswith("_")}
    steps = executed_steps(case)
    class_m = torch.from_numpy(case["class_m"]).to(device)
    wrapper_ms, host_ms = time_kernel(kernel_case, device)
    return {
        "ms": kernel_device_ms(kernel_case, device),
        "wrapper_ms": wrapper_ms, "wrapper_host_ms": host_ms,
        "plain_ms": time_plain(kernel_case, device),
        "steps": steps,
        "M": int(case["class_m"].shape[0]),
        "prologue_ms": prologue_ms(class_m, resident=True),
        "shape": list(case["_counts"].shape),
        **bounds(case, steps, step_lat),
    }


def step_split(case, device, timing, registers=True):
    """Where a step's time goes, in us per executed step at these inputs:
    the solve's own kernel (the profiler's time) and every instantiation
    that fits (cut_scan_variant_ms, CUDA events) over the executed steps;
    with `registers`, also the step with the worker state in registers
    (ops/assign.step_split_ms, per (threads, arithmetic, scan) variant;
    R = 4 and W <= 1024 only)."""
    from hyperqueue_tpu_torch.ops import assign

    t = to_device({k: v for k, v in case.items() if not k.startswith("_")},
                  device)
    args, opt = _args(t)
    steps = timing["steps"]
    out = {"steps": steps, "threads": THREADS,
           "solve_step_us": timing["ms"] / steps * 1e3}
    fits = assign.cut_scan_layout(
        *case["free"].shape, case["min_time"].shape[1],
        case["class_m"].shape[0],
        case["group_onehot"].shape[1] if "group_onehot" in case else 0,
        "total" in case, "gang_nodes" in case,
        "policy_mask" in case)["instantiation"] == "resident"
    out["full_step_us"] = {
        kind: assign.cut_scan_variant_ms(
            *args, **opt, resident=kind == "resident") / steps * 1e3
        for kind in (("resident", "global") if fits else ("global",))
    }
    if registers:
        ms = assign.step_split_ms(t["free"], t["nt_free"], t["lifetime"],
                                  t["needs"], t["sizes"], t["min_time"])
        out["register_step_us"] = {"x".join(map(str, k)): v / steps * 1e3
                                   for k, v in ms.items()}
    return out


def ptxas_usage(log_text):
    """Per compiled kernel in an nvcc -Xptxas -v log: registers, spill
    bytes and shared memory, keyed by the kernel's name and template
    arguments."""
    import re

    usage, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            core = re.search(r"([a-z_]+_kernel)((?:I(?:L[ib]\d+E)+E)?)",
                             m.group(1))
            name = core.group(1) if core else m.group(1)
            args = re.findall(r"L[ib](\d+)E", core.group(2)) if core else []
            if args:
                name += "<" + ",".join(args) + ">"
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and "spill_stores" not in usage[name]:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            usage[name].update(registers=int(m.group(1)),
                               static_smem=int(m.group(2) or 0))
    return usage


def k2_floors(device, n_shards, steps=4096):
    """us per step of one saturating block scan plus one exchange barrier
    over n_shards shard blocks, per exchange (cluster_step_latency_ms,
    grid_step_latency_ms)."""
    from hyperqueue_tpu_torch.parallel import solve

    return {kind: fn(steps, n_shards, device) * 1e3
            for kind, fn in (("cluster", solve.cluster_step_latency_ms),
                             ("grid", solve.grid_step_latency_ms))}


def k2_timing(case, device, n_shards, floors, step_lat):
    """K2's times and bounds at one tick's padded inputs over n_shards
    shards, beside K1's device time at the same inputs. The bytes and
    operations are K1's (the same function); the latency bound is the
    executed steps times the floor of the exchange the wrapper picks (one
    block scan plus one exchange barrier)."""
    from functools import partial

    from hyperqueue_tpu_torch.parallel import solve

    mesh = solve.make_worker_mesh([device] * n_shards)
    kernel_case = {k: v for k, v in case.items() if not k.startswith("_")}
    steps = executed_steps(case)
    layout = k2_layout(kernel_case, n_shards)
    floor_ms = floors[layout["exchange"]] / 1e3
    k2 = partial(solve.sharded_cut_scan, mesh)
    b = bounds(case, steps, floor_ms)
    wrapper_ms, host_ms = time_kernel(kernel_case, device, solve=k2)
    return {
        "ms": kernel_device_ms(kernel_case, device, solve=k2,
                               kernel="sharded_scan_kernel"),
        "k1_ms": kernel_device_ms(kernel_case, device),
        "wrapper_ms": wrapper_ms, "wrapper_host_ms": host_ms,
        "plain_ms": time_plain(
            kernel_case, device, reps=1,
            plain=partial(solve.sharded_cut_scan_reference, mesh)),
        "steps": steps, "shards": n_shards,
        "M": int(case["class_m"].shape[0]),
        "shape": list(case["_counts"].shape),
        "exchange": layout["exchange"],
        "instantiation": layout["instantiation"],
        "threads": int(solve._sharded_scan_lib()[0]
                       .hq_sharded_block_threads()),
        "step_floor_us": floor_ms * 1e3,
        "k1_latency_bound_ms": steps * step_lat,
        **b,
    }


def k2_step_split(case, device, n_shards, timing, reps=20):
    """us per executed step of every K2 variant that fits at these inputs
    (forced launches, the profiler's kernel time over `reps` launches),
    beside the wrapper's."""
    from functools import partial

    from hyperqueue_tpu_torch.parallel import solve

    kernel_case = {k: v for k, v in case.items() if not k.startswith("_")}
    steps = timing["steps"]
    mesh = solve.make_worker_mesh([device] * n_shards)
    out = {"steps": steps, "shards": n_shards,
           "solve_step_us": timing["ms"] / steps * 1e3, "step_us": {}}
    for ex, res in K2_VARIANTS:
        if not k2_variant_fits(kernel_case, n_shards, ex, res):
            continue
        forced = partial(solve.sharded_cut_scan_forced, mesh, exchange=ex,
                         resident=res)
        out["step_us"][k2_name(ex, res)] = kernel_device_ms(
            kernel_case, device, reps=reps, solve=forced,
            kernel="sharded_scan_kernel") / steps * 1e3
    return out


def check_assignments(assignments, rows, rq_map, seen):
    """Every task is assigned once and no worker goes over its free
    resources or task slots (gang sentinels, variant -1, are checked by
    check_gangs)."""
    by_id = {row.worker_id: row for row in rows}
    used, slots = {}, {}
    for task_id, worker_id, rq_id, variant in assignments:
        if variant < 0:
            continue
        if task_id in seen:
            raise AssertionError(f"task {task_id} assigned twice")
        seen.add(task_id)
        u = used.setdefault(worker_id, [0] * len(by_id[worker_id].free))
        for e in rq_map.get_variants(rq_id).variants[variant].entries:
            u[e.resource_id] += e.amount
        slots[worker_id] = slots.get(worker_id, 0) + 1
    for worker_id, u in used.items():
        row = by_id[worker_id]
        if (any(a > f for a, f in zip(u, row.free))
                or slots[worker_id] > row.nt_free):
            raise AssertionError(f"worker {worker_id} over-committed")


def check_gangs(assignments, gang_batches, rows, idle, excluded):
    """Every gang row is all-or-nothing on idle members of one group that
    take nothing else this tick; returns the gangs placed. `excluded`:
    (task class "nodes", group) pairs the policy gives weight 0."""
    index_of = {row.worker_id: i for i, row in enumerate(rows)}
    members: dict = {}
    ordinary_workers = set()
    for task, worker, _rq, variant in assignments:
        if variant < 0:
            members.setdefault(task, []).append(worker)
        else:
            ordinary_workers.add(worker)
    want = {b.gang_task: b.gang_nodes for b in gang_batches}
    taken = set()
    for task, workers in members.items():
        if task not in want or len(workers) != want[task]:
            raise AssertionError(f"gang {task} placed on {len(workers)} "
                                 "workers, not all or nothing")
        groups = {rows[index_of[w]].group for w in workers}
        if len(groups) != 1:
            raise AssertionError(f"gang {task} spans groups {groups}")
        if ("nodes", groups.pop()) in excluded:
            raise AssertionError(f"gang {task} on an excluded group")
        for w in workers:
            if not idle[index_of[w]] or w in taken or w in ordinary_workers:
                raise AssertionError(f"gang {task} member {w} not idle "
                                     "and free")
            taken.add(w)
    return set(members)


def check_exclusions(assignments, rows, classes_of, excluded):
    by_id = {row.worker_id: row for row in rows}
    for _task, worker, rq_id, _variant in assignments:
        if (classes_of[rq_id], by_id[worker].group) in excluded:
            raise AssertionError(f"rq {rq_id} placed on worker {worker} "
                                 "of a group its policy excludes")


def advance(assignments, rows, rq_map, totals, nt0, rng) -> None:
    """Start the assigned tasks on the worker rows (a gang member is taken
    whole), then let a random quarter of the workers finish all their
    tasks."""
    by_id = {row.worker_id: row for row in rows}
    for _task, worker_id, rq_id, variant in assignments:
        row = by_id[worker_id]
        if variant < 0:
            row.free[:] = [0] * len(row.free)
            row.nt_free = 0
            continue
        for e in rq_map.get_variants(rq_id).variants[variant].entries:
            row.free[e.resource_id] -= e.amount
        row.nt_free -= 1
    done = rng.random(len(rows)) < 0.25
    for i in np.nonzero(done)[0]:
        rows[i].free[:] = totals[i]
        rows[i].nt_free = nt0[i]


def profiled_window(one_tick, n_ticks=3, kernel="cut_scan_kernel"):
    """A short steady window of `n_ticks` calls of one_tick() (each runs,
    checks and applies a tick, as the path does) under torch.profiler: the
    window's wall ms and the device's busy ms and the kernel's ms in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            one_tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events
                    if kernel in e.key) / 1e3
    if kernel_ms <= 0:
        raise AssertionError(f"the profiler saw no {kernel} time")
    return wall_ms, busy_ms, kernel_ms


def tick_summary(tick_ms, tick_phases, card):
    steady = tick_ms[1:]
    return dict(
        wall_ms=tick_ms, steady_median_ms=float(np.median(steady)),
        steady_min_ms=float(np.min(steady)),
        steady_max_ms=float(np.max(steady)),
        phases_median_ms={
            k: float(np.median([p.get(k, 0.0) for p in tick_phases[1:]]))
            for k in ("assemble", "solve_host_prep", "solve_dispatch",
                      "device_sync", "mapping")
        },
        card=card)


def window_summary(wall_ms, busy_ms, kernel_ms, n_window, steady_median_ms,
                   card):
    # the profiler lengthens the host's side of a tick, so the idle share
    # is given against both the profiled window and the unprofiled ticks
    busy_per_tick = busy_ms / n_window
    return dict(
        ticks=n_window, wall_ms=wall_ms, device_busy_ms=busy_ms,
        kernel_ms=kernel_ms, device_busy_per_tick_ms=busy_per_tick,
        device_idle_share_of_window=1 - busy_ms / wall_ms,
        device_idle_share_of_steady_median=(
            1 - busy_per_tick / steady_median_ms),
        card=card)


def time_glue(model, padded_shape, live_shape, device, reps=200):
    """K3 and K4 alone at the main path's shapes, CUDA events over `reps`
    calls each. K3: the dirty-row index_copy_ of free, nt_free and lifetime
    into the resident tensors, at the last tick's dirty-row count. K4: the
    slice of the padded counts to the live extents (.contiguous()), and the
    pinned copies of the counts and the state after the solve to the host.
    Bounds: bytes over the HBM rate; the pinned copies' bytes over the
    host link's rate, measured with a 256 MiB pinned copy."""
    import torch

    res = model._res
    pw, pr = res.free.shape
    dirty = max(res.dirty_rows_last, 1)

    def events_ms(fn, n=reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    free, nt, life = (res.free.clone(), res.nt_free.clone(),
                      res.lifetime.clone())
    idx = torch.randperm(pw, device=device)[:dirty].sort().values
    src_f = torch.ones((dirty, pr), dtype=torch.int32, device=device)
    src_n = torch.ones(dirty, dtype=torch.int32, device=device)

    def k3():
        free.index_copy_(0, idx, src_f)
        nt.index_copy_(0, idx, src_n)
        life.index_copy_(0, idx, src_n)

    k3_ms = events_ms(k3)
    # each index read once per copy, each source row read, each row written
    k3_bytes = 3 * idx.numel() * 8 + 2 * dirty * (pr + 2) * 4

    n_b, n_v, n_w = live_shape
    padded = torch.zeros(padded_shape, dtype=torch.int32, device=device)
    k4_slice_ms = events_ms(
        lambda: padded[:n_b, :n_v, :n_w].contiguous())
    live_bytes = n_b * n_v * n_w * 4
    live = padded[:n_b, :n_v, :n_w].contiguous()
    pinned = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
              for x in (live, res.free, res.nt_free)]

    def k4_copy():
        for dst, src in zip(pinned, (live, res.free, res.nt_free)):
            dst.copy_(src, non_blocking=True)

    k4_copy_ms = events_ms(k4_copy)
    copy_bytes = sum(p.numel() * p.element_size() for p in pinned)
    big = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    big_host = torch.empty(big.shape, dtype=torch.uint8, pin_memory=True)
    big_ms = events_ms(lambda: big_host.copy_(big, non_blocking=True), 5)
    link_bytes_per_s = big.numel() / (big_ms / 1e3)
    return {
        "K3": {"ms": k3_ms, "library_ms": k3_ms, "dirty_rows": dirty,
               "bytes": k3_bytes,
               "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"},
        "K4": {"slice_ms": k4_slice_ms, "library_ms": k4_slice_ms,
               "slice_bytes": 2 * live_bytes,
               "slice_bound_ms": 2 * live_bytes / HBM_BYTES_PER_S * 1e3,
               "copy_ms": k4_copy_ms, "copy_bytes": copy_bytes,
               "link_bytes_per_s": link_bytes_per_s,
               "copy_bound_ms": copy_bytes / link_bytes_per_s * 1e3,
               "bound_by": "bytes"},
    }


# -- the sync probe (K5) -----------------------------------------------------

def k5_cases():
    """name -> int32 input of every K5 case: the probe's own arange(256)
    and seeded int32 over the whole range, whose sums overflow."""
    cases = {"arange_256": np.arange(256, dtype=np.int32)}
    for n in (256, 1000, 1, 0, 1 << 20):
        cases[f"random_{n}"] = np.random.default_rng(n).integers(
            -2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    return cases


def k5_phase(device, card):
    """Phase 7: K5 against its plain version on the card (exact), its
    device time, its plain version's and the library call's time, and the
    probe's round trip."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hyperqueue_tpu_torch.ops import probe

    max_err = 0
    for name, v in k5_cases().items():
        t = torch.from_numpy(v).to(device)
        got = probe.sync_probe(t)
        want = probe.sync_probe_reference(t)
        torch.cuda.synchronize()
        exact = 2 * int(v.astype(np.int64).sum())
        err = max(abs(int(got) - int(want)),
                  abs(int(got) - ((exact + 2**31) % 2**32 - 2**31)))
        if err:
            raise AssertionError(f"K5 case {name}: kernel {int(got)}, plain "
                                 f"{int(want)}, wrapped sum of 2v")
        max_err = max(max_err, err)
    v = torch.arange(probe.PROBE_SIZE, dtype=torch.int32, device=device)

    def events_ms(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    wrapper_ms = events_ms(lambda: probe.sync_probe(v))
    plain_ms = events_ms(lambda: probe.sync_probe_reference(v))
    library_ms = events_ms(lambda: (v * 2).sum())
    reps = 200
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            probe.sync_probe(v)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "sync_probe_kernel" in e.key]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise AssertionError("the profiler saw no sync_probe_kernel time")
    # the latency bound: a kernel of the probe's launch shape that does
    # nothing, profiled the same way
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            probe.empty_launch(device)
        torch.cuda.synchronize()
    empty_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if "empty_kernel" in e.key)
    if empty_us <= 0:
        raise AssertionError("the profiler saw no empty_kernel time")
    round_trips = [probe.sync_round_trip_ms(device) for _ in range(5)]
    in_bytes, out_bytes = probe.PROBE_SIZE * 4, 4
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = 2 * probe.PROBE_SIZE  # one multiply and one add per element
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    timing = {
        "ms": device_us / 1e3 / reps, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "latency_bound_ms": empty_us / 1e3 / reps,
        "bytes": in_bytes + out_bytes, "ops": ops,
        "round_trip_ms": round_trips,
        "round_trip_min_ms": min(round_trips),
        "round_trip_median_ms": float(np.median(round_trips)),
    }
    log("k5", cases=sorted(k5_cases()), max_abs_err=max_err, **timing,
        card=card)
    return max_err, timing


# -- the server path ---------------------------------------------------------

class RecordingSeam:
    """Passes every solve to the watchdog and keeps its inputs and counts;
    a pipelined solve's counts are kept when its handle is read. Every
    other attribute is the watchdog's (and through it the model's)."""

    def __init__(self, watchdog):
        self.watchdog = watchdog
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.watchdog, name)

    @staticmethod
    def _copy(kwargs):
        # the dense snapshot's arrays belong to the tick cache, which
        # rewrites them in place at its next sync; the counts are views of
        # the model's pinned host buffers, which a kept reference would
        # stop the allocator reusing
        return {k: None if v is None else np.array(v, copy=True)
                for k, v in kwargs.items()}

    def solve(self, **kwargs):
        counts = self.watchdog.solve(**kwargs)
        self.calls.append((self._copy(kwargs), counts.copy()))
        return counts

    def solve_async(self, **kwargs):
        handle = self.watchdog.solve_async(**kwargs)
        calls, inputs = self.calls, self._copy(kwargs)

        class Handle:
            def result(self):
                counts = handle.result()
                calls.append((inputs, counts.copy()))
                return counts

        return Handle()


def server_path(card, device, model, tag="server", n_sync=N_SERVER_TICKS,
                n_pipelined=N_SERVER_PIPELINED_TICKS):
    """Phases 8 and 9: the server's solve seam at the north star, around
    `model`: GreedyCutScanModel(backend="auto") (K1, tag "server") or a
    MultichipModel over shards of the card (K2, tag "multichip", every
    solve "multichip-mesh", held against K2's plain version). Returns the
    launches of the kernels in its ticks, the per-tick summaries, the last
    synchronous tick's inputs and counts, and a closure that runs one more
    synchronous tick."""
    from functools import partial

    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.models import greedy
    from hyperqueue_tpu_torch.models.multichip import MultichipModel
    from hyperqueue_tpu_torch.ops import assign, probe
    from hyperqueue_tpu_torch.parallel import solve
    from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
    from hyperqueue_tpu_torch.scheduler.tick import create_batches, run_tick
    from hyperqueue_tpu_torch.scheduler.tick_cache import paranoid_check
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    mesh = isinstance(model, MultichipModel) and model._get_mesh()
    if mesh:
        kernel, reason = "sharded_scan", "multichip-mesh"
        plain = partial(solve.sharded_cut_scan_reference, mesh)
    else:
        kernel, reason, plain = "cut_scan", None, None
    t0 = time.perf_counter()
    core = core_from_plain(*north_star_state())
    log(f"{tag}_state", workers=len(core.workers),
        ready_tasks=core.queues.total_ready(), classes=len(core.rq_map),
        shards=len(mesh) if mesh else 1,
        seconds=round(time.perf_counter() - t0, 3))
    check_native_queues(core.queues, tag)
    model.paranoid_resident = 4
    core.paranoid_tick = 4
    watchdog = SolverWatchdog(model)
    seam = RecordingSeam(watchdog)
    rng = np.random.default_rng(SEED + 4)
    running: dict = {}   # worker_id -> [(task, rq_id, variant)]
    seen: set = set()
    result = {"ticks": [], "paranoid_ticks": 0}
    # as the server does once it has started: freeze everything allocated
    # so far out of the collector's generations, so that an old-generation
    # collection never re-traverses the start-up state inside a tick; the
    # collector's pauses in each tick are still counted (phase "gc")
    gc.collect()
    gc.freeze()
    gc_time = {"ms": 0.0, "t0": None}

    def on_gc(stage, _info):
        if stage == "start":
            gc_time["t0"] = time.perf_counter()
        elif gc_time["t0"] is not None:
            gc_time["ms"] += (time.perf_counter() - gc_time["t0"]) * 1e3
            gc_time["t0"] = None

    gc.callbacks.append(on_gc)

    def start(assignments):
        rows = {w.worker_id: w for w in core.workers.values()}
        check_assignments(assignments, list(rows.values()), core.rq_map,
                          seen)
        for task, wid, rq_id, variant in assignments:
            w = core.workers[wid]
            w.assign(task, core.variant_amounts(rq_id, variant, w))
            running.setdefault(wid, []).append((task, rq_id, variant))

    def finish_quarter():
        for w in core.workers.values():
            if rng.random() < 0.25:
                for task, rq_id, variant in running.pop(w.worker_id, []):
                    w.unassign(task, core.variant_amounts(rq_id, variant, w))

    def check_solves(first_call, tick):
        for kwargs, counts in seam.calls[first_call:]:
            check_tick_against_plain(model, kwargs, counts, device, tick,
                                     plain)
        return len(seam.calls)

    def one_tick(pipeline=None, record=True):
        core.tick_counter += 1
        paranoid_now = core.tick_counter % core.paranoid_tick == 0
        phases, decisions, solve_phases = {}, [], []
        gc_time["ms"] = 0.0
        t0 = time.perf_counter()
        mapped = []
        if pipeline is not None and pipeline.pending is not None:
            decision: dict = {}
            take = pipeline.drain if paranoid_now else pipeline.take_result
            first_call = len(seam.calls)
            mapped = take(model=seam, phases=phases, decision=decision)
            decisions.append(decision["solver"])
            solve_phases.append(dict(model.last_phases))
            t1 = time.perf_counter()
            gc_ms = gc_time["ms"]
            start(mapped)
            if record:
                # held against the plain version before the next dispatch
                # reuses the model's padded buffers
                check_solves(first_call, core.tick_counter)
            # applying and checking are not the tick's own time
            t0 += time.perf_counter() - t1
            gc_time["ms"] = gc_ms
        t_sync = time.perf_counter()
        snap = core.tick_cache.sync(core)
        phases["tick_cache_sync"] = (time.perf_counter() - t_sync) * 1e3
        batches = create_batches(core.queues)
        if paranoid_now:
            t_par = time.perf_counter()
            paranoid_check(core, snap, batches, core.rq_map,
                           core.resource_map)
            result["paranoid_ticks"] += 1
            # a debug check, not part of the tick's time
            t0 += time.perf_counter() - t_par
        decision = {}
        this_pipeline = None if paranoid_now else pipeline
        first_call = len(seam.calls)
        out = run_tick(core.queues, None, core.rq_map, core.resource_map,
                       seam, batches=batches, dense=snap,
                       key_cache=core.tick_cache, phases=phases,
                       decision=decision, pipeline=this_pipeline)
        wall_ms = (time.perf_counter() - t0) * 1e3
        phases["gc"] = gc_time["ms"]
        if decision.get("solver", {}).get("status") != "pipelined":
            decisions.append(decision["solver"])
            solve_phases.append(dict(model.last_phases))
        for d in decisions:
            if (d["backend"] != "device-cuda" or d["status"] != "ok"
                    or reason not in (None, d["backend_reason"])):
                raise AssertionError(f"{tag} tick {core.tick_counter} "
                                     f"solved on {d['backend']} "
                                     f"({d['backend_reason']}), status "
                                     f"{d['status']}")
        start(out)
        if record:
            check_solves(first_call, core.tick_counter)  # a synchronous one
            result["ticks"].append(dict(
                tick=core.tick_counter,
                run="sync" if pipeline is None else "pipelined",
                paranoid=paranoid_now,
                dispatched_async=this_pipeline is not None,
                assigned=len(out) + len(mapped), wall_ms=wall_ms,
                phases=phases, solve_phases=solve_phases,
                solves=[(d["backend"], d["backend_reason"])
                        for d in decisions],
                dispatched=(model.last_backend, model.last_backend_reason)
                if this_pipeline is not None else None))
            log(f"{tag}_tick", **result["ticks"][-1],
                resident=model.resident_stats(),
                tick_cache=core.tick_cache.counters(), card=card)
        finish_quarter()
        return out

    # counts to 0 just before the path; the probe starts here, as the
    # server's first solve would start it
    assign.reset_launch_counts()
    solve.reset_launch_counts()
    probe.sync_probe.launches = 0
    takes = NATIVE_TAKES["n"]
    sync_ms = greedy.device_sync_ms(wait_s=30)
    if greedy.probe_error() is not None:
        raise AssertionError(f"sync probe failed: {greedy.probe_error()!r}")
    if sync_ms is None or not np.isfinite(sync_ms):
        raise AssertionError(f"sync probe did not resolve: {sync_ms}")
    log(f"{tag}_probe", device_sync_ms=sync_ms, card=card)
    for _ in range(n_sync):
        one_tick()
    sync_calls = len(seam.calls)
    pipeline = TickPipeline()
    core.tick_pipeline = pipeline
    for _ in range(n_pipelined):
        one_tick(pipeline)
    if pipeline.pending is not None:  # the last dispatch, mapped here
        first_call = len(seam.calls)
        start(pipeline.drain(model=seam))
        check_solves(first_call, core.tick_counter)
    launches = {"cut_scan": assign.greedy_cut_scan.launches,
                "cut_scan_resident": assign.greedy_cut_scan.resident_launches,
                "cut_scan_global": assign.greedy_cut_scan.global_launches,
                "cut_scan_gang": assign.greedy_cut_scan.gang_launches,
                "sharded_scan": solve.sharded_cut_scan.launches,
                "sharded_scan_cluster":
                    solve.sharded_cut_scan.cluster_launches,
                "sharded_scan_grid": solve.sharded_cut_scan.grid_launches,
                "sharded_scan_resident":
                    solve.sharded_cut_scan.resident_launches,
                "sync_probe": probe.sync_probe.launches}
    native_ticks = NATIVE_TAKES["n"] - takes
    gc.callbacks.remove(on_gc)
    # checks of the whole path
    stats = watchdog.stats()
    res = model.resident_stats()
    if (stats["failures"], stats["timeouts"], stats["degraded_ticks"],
            stats["skipped_ticks"]) != (0, 0, 0, 0):
        raise AssertionError(f"watchdog degraded: {stats}")
    if res["invalidations"] != 0 or res["delta_uploads"] < 1:
        raise AssertionError(f"residency: {res}")
    if core.tick_cache.full_rebuilds != 1:
        raise AssertionError(f"tick cache: {core.tick_cache.counters()}")
    if model.paranoid_checks < 2 or result["paranoid_ticks"] < 2:
        raise AssertionError("paranoid checks did not run")
    n_solves = len(seam.calls)
    if native_ticks != n_solves:
        # every solve's counts are mapped once, through hq_map_take
        raise AssertionError(f"{tag} path: {native_ticks} native takes for "
                             f"{n_solves} solves")
    if launches[kernel] != n_solves + model.paranoid_checks:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times "
                             f"for {n_solves} solves and "
                             f"{model.paranoid_checks} paranoid checks")
    if mesh and (launches["sharded_scan_cluster"] != launches["sharded_scan"]
                 or launches["sharded_scan_grid"]):
        # 4 shards of 256 are one cluster: every solve runs that exchange
        raise AssertionError(f"{tag} path: not every K2 launch ran the "
                             f"cluster exchange: {launches}")
    other = "cut_scan" if mesh else "sharded_scan"
    if ((not mesh and launches["sync_probe"] < 1)
            or launches["cut_scan_gang"] or launches[other]
            or launches["cut_scan_global"]
            or launches["cut_scan_resident"] != launches["cut_scan"]):
        # at the north star every K1 solve runs the resident instantiation
        raise AssertionError(f"{tag} path launches {launches}")
    result.update(
        launches=launches, solves=n_solves, sync_solves=sync_calls,
        native_take_ticks=native_ticks,
        paranoid_checks=model.paranoid_checks, watchdog=stats,
        resident=res, tick_cache=core.tick_cache.counters(),
        pipeline=pipeline.stats(), device_sync_ms=sync_ms,
        cost_model={kind: [{"shape_key": list(key), "ms": ms}
                           for key, ms in table.items()]
                    for kind, table in model._cost.items()},
    )
    log(f"{tag}_checks", **{k: v for k, v in result.items()
                            if k != "ticks"}, card=card)
    last_kwargs, last_counts = seam.calls[sync_calls - 1]

    def steady_tick(pipelined=False):
        # as a checked tick, without the plain version (whose device time
        # would count as the tick's); a synchronous tick first maps a
        # solve that a pipelined one left pending
        if not pipelined and pipeline.pending is not None:
            start(pipeline.drain(model=seam))
        one_tick(pipeline if pipelined else None, record=False)

    return result, model, (last_kwargs, last_counts), steady_tick


def path_summary(result):
    """Per-phase medians of a server_path run's steady ticks (all but the
    first of each run), synchronous and pipelined."""
    summary = {}
    for label in ("sync", "pipelined"):
        group = [t for t in result["ticks"] if t["run"] == label]
        steady = group[1:]
        names = sorted({k for t in steady for k in t["phases"]})
        summary[label] = dict(
            ticks=len(group), wall_ms=[t["wall_ms"] for t in group],
            steady_median_ms=float(np.median([t["wall_ms"]
                                              for t in steady])),
            # a paranoid tick drains the pipeline and solves synchronously
            steady_non_paranoid_median_ms=float(np.median(
                [t["wall_ms"] for t in steady if not t["paranoid"]])),
            phases_median_ms={
                k: float(np.median([t["phases"].get(k, 0.0)
                                    for t in steady])) for k in names})
    # the pipeline's own cycle: ticks that mapped the pending solve and
    # dispatched the next (not a paranoid tick, nor the one after its
    # drain, which has nothing to map)
    cycle = [t["wall_ms"] for t in result["ticks"]
             if t["dispatched_async"] and t["solves"]]
    summary["pipelined"].update(
        cycle_ticks=len(cycle), steady_cycle_median_ms=float(np.median(cycle)))
    return summary


def host_op_profile(one_tick, n_ticks=3, top=10):
    """The host side of `n_ticks` calls of one_tick() under torch.profiler:
    the ops and CUDA runtime calls with the most self CPU time, in ms per
    tick, and the device's busy ms per tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            one_tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ranked = sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]
    return {
        "ticks": n_ticks, "wall_ms_per_tick": wall_ms / n_ticks,
        "device_busy_ms_per_tick": sum(e.self_device_time_total
                                       for e in events) / 1e3 / n_ticks,
        "top_self_cpu_ms_per_tick": [
            [e.key, e.self_cpu_time_total / 1e3 / n_ticks, e.count]
            for e in ranked],
    }


def host_solves(model, kwargs, counts, card):
    """The cost model's host alternatives at one north-star solve's padded
    inputs: the numpy twin and the native scan, each timed (host clock,
    best of 3) and held equal to the kernel's counts."""
    from hyperqueue_tpu_torch.ops.assign import greedy_cut_scan_numpy
    from hyperqueue_tpu_torch.utils.native import native_cut_scan

    prep = model.prepare(**kwargs)
    n_b, n_v, n_w = prep["extents"]
    args = (prep["free_p"], prep["nt_p"], prep["life_p"], prep["needs_p"],
            prep["sizes_p"], prep["mt_p"], prep["class_m"],
            prep["order_ids"])
    out = {}
    for name, fn in (
        ("host_numpy", lambda: greedy_cut_scan_numpy(*args)[0]),
        ("host_native", lambda: native_cut_scan(*args)),
    ):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        if got is None:
            raise AssertionError(f"{name}: the native library is missing")
        if not np.array_equal(got[:n_b, :n_v, :n_w], counts):
            raise AssertionError(f"{name} counts differ from the kernel's")
        out[name] = {"ms": min(times), "all_ms": times}
    log("server_host_solves", shape=[n_b, n_v, n_w], **out, card=card)
    return out


# -- min-utilization workers and the MILP --------------------------------------

def mu_state(n_floored=N_MU_WORKERS, mu=MU, **kwargs):
    """north_star_state (kwargs passed on) with its first `n_floored`
    workers given min_utilization `mu`."""
    resources, classes, tasks, workers = north_star_state(**kwargs)
    workers = [w + (mu,) if i < n_floored else w
               for i, w in enumerate(workers)]
    return resources, classes, tasks, workers


def milp_state():
    """The milp path's cluster: N_MILP_WORKERS workers of 4-16 cpus, the
    first N_MILP_FLOORED with min_utilization MU, N_MILP_TASKS tasks over
    the north star's first N_MILP_CLASSES sampled classes."""
    return mu_state(n_floored=N_MILP_FLOORED, n_workers=N_MILP_WORKERS,
                    n_tasks=N_MILP_TASKS, n_classes=N_MILP_CLASSES,
                    worker_cpus=MILP_WORKER_CPUS)


def check_floors(assignments, floors, rq_map, tag):
    """Every floored worker (worker id -> its cpu floor at the tick's
    start) received cpu work of 0 or at least its floor; returns the cpu
    work of each."""
    cpu = dict.fromkeys(floors, 0)
    for _task, worker, rq_id, variant in assignments:
        if worker in cpu:
            for e in rq_map.get_variants(rq_id).variants[variant].entries:
                if e.resource_id == 0:
                    cpu[worker] += e.amount
    short = {w: c for w, c in cpu.items() if 0 < c < floors[w]}
    if short:
        raise AssertionError(f"{tag}: floored workers under their floor: "
                             f"{short} (floors {floors})")
    return cpu


class CoreRunner:
    """Starts a tick's assignments on a Core's workers; finish() ends every
    task of the floored workers (so that each tick has floors to meet) and
    of a random quarter of the others."""

    def __init__(self, core, seed):
        self.core = core
        self.rng = np.random.default_rng(seed)
        self.running: dict = {}

    def start(self, assignments):
        core = self.core
        for task, wid, rq_id, variant in assignments:
            w = core.workers[wid]
            w.assign(task, core.variant_amounts(rq_id, variant, w))
            self.running.setdefault(wid, []).append((task, rq_id, variant))

    def finish(self, floored):
        core = self.core
        for w in core.workers.values():
            if w.worker_id in floored or self.rng.random() < 0.25:
                for task, rq_id, variant in self.running.pop(w.worker_id,
                                                             []):
                    w.unassign(task, core.variant_amounts(rq_id, variant, w))


def mu_path(card, device, seen):
    """Phase 11: N_MU_TICKS north-star ticks over a Core with N_MU_WORKERS
    min-utilization workers: the tick cache declines the snapshot, run_tick
    solves the unfloored workers with K1 and the floored ones with the host
    search (_solve_mu_workers, timed per worker from here). Returns the
    K1 launches and the per-tick summaries."""
    import logging

    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.scheduler import tick
    from hyperqueue_tpu_torch.scheduler.tick import run_tick

    t0 = time.perf_counter()
    core = core_from_plain(*mu_state())
    log("mu_state", workers=len(core.workers),
        floored=sum(w.configuration.min_utilization > 0
                    for w in core.workers.values()),
        min_utilization=MU, ready_tasks=core.queues.total_ready(),
        classes=len(core.rq_map), seconds=round(time.perf_counter() - t0, 3))
    check_native_queues(core.queues, "mu")
    model = GreedyCutScanModel(device="cuda", backend="device")
    recorder = RecordingModel(model)
    runner = CoreRunner(core, SEED + 6)
    search: list = []
    real = tick._solve_mu_workers

    def timed(queues, mu_rows, rq_map, resource_map):
        # one row at a time, in the order the search takes them: the same
        # takes, each worker's search timed alone
        out = []
        for row in sorted(mu_rows, key=lambda r: r.worker_id):
            t = time.perf_counter()
            out += real(queues, [row], rq_map, resource_map)
            search[-1].append((time.perf_counter() - t) * 1e3)
        return out

    class BudgetHits(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.n = 0

        def emit(self, record):
            if "budget" in record.getMessage():
                self.n += 1

    hits = BudgetHits()
    tick_logger = logging.getLogger(tick.__name__)
    tick_logger.addHandler(hits)
    tick._solve_mu_workers = timed
    ticks = []
    assign.reset_launch_counts()
    takes = NATIVE_TAKES["n"]
    try:
        for t in range(N_MU_TICKS):
            if core.tick_cache.sync(core) is not None:
                raise AssertionError("the tick cache served a snapshot "
                                     "with min-utilization workers")
            rows = core.worker_rows()
            floors = {r.worker_id: r.cpu_floor for r in rows
                      if r.cpu_floor > 0}
            search.append([])
            hits_before = hits.n
            before = assign.greedy_cut_scan.launches
            phases: dict = {}
            t0 = time.perf_counter()
            assignments = run_tick(core.queues, rows, core.rq_map,
                                   core.resource_map, recorder,
                                   phases=phases)
            wall_ms = (time.perf_counter() - t0) * 1e3
            if assign.greedy_cut_scan.launches != before + 1:
                raise AssertionError(f"mu tick {t}: K1 launched "
                                     f"{assign.greedy_cut_scan.launches - before}"
                                     " times, expected once")
            check_assignments(assignments, rows, core.rq_map, seen)
            cpu = check_floors(assignments, floors, core.rq_map,
                               f"mu tick {t}")
            kwargs, counts = recorder.calls[-1]
            main = [a for a in assignments if a[1] not in floors]
            if (counts.sum() != len(main)
                    or kwargs["free"].shape[0] != len(rows) - len(floors)):
                raise AssertionError(f"mu tick {t}: the main solve did not "
                                     "run over the unfloored workers")
            check_tick_against_plain(model, kwargs, counts, device,
                                     f"mu {t}")
            ticks.append(dict(
                tick=t, assigned=len(assignments),
                mu_assigned=len(assignments) - len(main),
                floored=len(floors),
                floored_receiving=sum(c > 0 for c in cpu.values()),
                wall_ms=wall_ms, phases=phases,
                mu_search_ms=sum(search[-1]),
                mu_search_ms_per_worker=search[-1],
                budget_hits=hits.n - hits_before))
            log("mu_tick", **ticks[-1], resident=model.resident_stats(),
                card=card)
            runner.start(assignments)
            runner.finish(floors)
    finally:
        tick._solve_mu_workers = real
        tick_logger.removeHandler(hits)
    launches = assign.greedy_cut_scan.launches
    native_ticks = NATIVE_TAKES["n"] - takes
    if (launches != N_MU_TICKS or assign.greedy_cut_scan.gang_launches
            or assign.greedy_cut_scan.resident_launches != N_MU_TICKS
            or native_ticks != N_MU_TICKS):
        raise AssertionError(f"mu path: K1 launched {launches} times "
                             f"({assign.greedy_cut_scan.resident_launches} "
                             f"resident), {native_ticks} native takes, in "
                             f"{N_MU_TICKS} ticks")
    steady = ticks[1:]
    per_worker = [ms for t in ticks for ms in t["mu_search_ms_per_worker"]]
    summary = dict(
        ticks=N_MU_TICKS, launches=launches, native_take_ticks=native_ticks,
        wall_ms=[t["wall_ms"] for t in ticks],
        steady_median_ms=float(np.median([t["wall_ms"] for t in steady])),
        phases_median_ms={
            k: float(np.median([t["phases"].get(k, 0.0) for t in steady]))
            for k in ("assemble", "solve_host_prep", "solve_dispatch",
                      "device_sync", "mapping")},
        mu_search_ms=[t["mu_search_ms"] for t in ticks],
        mu_search_median_ms_per_worker=float(np.median(per_worker)),
        mu_search_max_ms_per_worker=float(np.max(per_worker)),
        floored_searches=len(per_worker),
        budget_hits=sum(t["budget_hits"] for t in ticks), card=card)
    log("mu_ticks", **summary)
    return summary


def reason_check(core, rows, batches, assignments, prio_of, degraded,
                 card):
    """The decision records of a tick's leftover batches against the
    oracle: build_unplaced_entries over the Core after the tick, and
    oracle.explain_unplaced over the tick's dense inputs (every worker row,
    the batches in solve order) and counts made from its assignments. A
    degraded tick's watchdog-fallback reads as the oracle's
    solver-deferred. Returns both reason counts (tasks per reason)."""
    from hyperqueue_tpu_torch.scheduler import decision, oracle
    from hyperqueue_tpu_torch.scheduler.tick import (
        assemble_solve_inputs,
        create_batches,
    )

    batches = list(batches)
    kw = assemble_solve_inputs(rows, batches, core.rq_map, core.resource_map)
    index = {(b.rq_id, b.priority): i for i, b in enumerate(batches)}
    column = {r.worker_id: i for i, r in enumerate(rows)}
    counts = np.zeros(kw["needs"].shape[:2] + (len(rows),), dtype=np.int64)
    for task, worker, rq_id, variant in assignments:
        counts[index[(rq_id, prio_of[task])], variant, column[worker]] += 1
    n_r = len(core.resource_map)
    totals = [[core.workers[r.worker_id].resources.amount(rid)
               for rid in range(n_r)] for r in rows]
    reasons = oracle.explain_unplaced(
        *(kw[k].tolist() for k in ("free", "nt_free", "lifetime", "needs",
                                   "sizes", "min_time")),
        counts.tolist(), total=totals)
    want = {(b.rq_id, b.priority): (reason, b.size - int(counts[i].sum()))
            for i, (b, reason) in enumerate(zip(batches, reasons)) if reason}
    left = [b for b in create_batches(core.queues) if b.size > 0]
    entries = decision.build_unplaced_entries(core, left, {},
                                              degraded=degraded)
    if len(left) > decision.MAX_UNPLACED_ENTRIES:
        raise AssertionError("more leftover batches than one record holds")
    got = {}
    for b, entry in zip(left, entries):
        reason = entry["reason"]
        if degraded and reason == decision.REASON_WATCHDOG_FALLBACK:
            reason = decision.REASON_SOLVER_DEFERRED
        got[(b.rq_id, b.priority)] = (reason, entry["count"])
    if got != want:
        raise AssertionError(f"decision records {got} disagree with the "
                             f"oracle {want}")
    record_counts, oracle_counts = {}, {}
    for entry in entries:
        record_counts[entry["reason"]] = (record_counts.get(entry["reason"], 0)
                                          + entry["count"])
    for reason, n in want.values():
        oracle_counts[reason] = oracle_counts.get(reason, 0) + n
    log("milp_reasons", leftover_batches=len(left),
        reason_counts=record_counts, oracle_reason_counts=oracle_counts,
        degraded=degraded, card=card)
    return record_counts, oracle_counts


def milp_path(card, device, seen):
    """Phase 12: `--scheduler milp` at its documented size, as the server
    builds it: SolverWatchdog(MilpModel(), fallback=GreedyCutScanModel(
    backend="device")). N_MILP_ARMED_TICKS armed ticks through the joint
    program (the floors inside the MILP, no K1); one tick whose deadline is
    forced below the MILP's measured time (and the MILP's own limit to 1 s,
    so the stranded solve ends soon): degraded to K1 with the floored rows
    zeroed; then N_MILP_BENCHED_TICKS benched ticks through the carve-out
    (K1 over the unfloored workers, the host search over the floored). Every
    K1 solve is held against its plain version; the last tick's decision
    records against the oracle. Returns the K1 launches and a summary."""
    from hyperqueue_tpu_torch.convert import core_from_plain
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.models.milp import MilpModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.scheduler.tick import create_batches, run_tick
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    import scipy.optimize  # noqa: F401 - imported before the timed solves

    plain = milp_state()
    core = core_from_plain(*plain)
    prio_of = {int(task): (int(u), int(s)) for task, _c, (u, s) in plain[2]}
    check_native_queues(core.queues, "milp")
    milp = MilpModel()
    primary = RecordingModel(milp)
    fallback_model = GreedyCutScanModel(device="cuda", backend="device")
    fallback = RecordingModel(fallback_model)
    watchdog = SolverWatchdog(primary, fallback=fallback)
    runner = CoreRunner(core, SEED + 7)
    log("milp_state", workers=len(core.workers), floored=N_MILP_FLOORED,
        ready_tasks=core.queues.total_ready(), classes=len(core.rq_map),
        batches=len(create_batches(core.queues)),
        worker_cpus=list(MILP_WORKER_CPUS), card=card)
    ticks, milp_ms = [], []
    assign.reset_launch_counts()
    takes = NATIVE_TAKES["n"]
    schedule = (["armed"] * N_MILP_ARMED_TICKS + ["forced"]
                + ["benched"] * N_MILP_BENCHED_TICKS)
    for t, kind in enumerate(schedule):
        if kind == "forced":
            watchdog.timeout_s = min(milp_ms) / 1e3 / 10
            milp.time_limit_secs = 1.0
        if watchdog.supports_cpu_floor != (kind != "benched"):
            raise AssertionError(f"milp tick {t} ({kind}): "
                                 f"supports_cpu_floor "
                                 f"{watchdog.supports_cpu_floor}")
        rows = core.worker_rows()
        floors = {r.worker_id: r.cpu_floor for r in rows if r.cpu_floor > 0}
        if len(floors) != N_MILP_FLOORED:
            raise AssertionError(f"milp tick {t}: floors {floors}")
        batches = create_batches(core.queues)
        before = assign.greedy_cut_scan.launches
        n_primary, n_fallback = len(primary.calls), len(fallback.calls)
        phases, decision = {}, {}
        t0 = time.perf_counter()
        out = run_tick(core.queues, rows, core.rq_map, core.resource_map,
                       watchdog, batches=batches, phases=phases,
                       decision=decision)
        wall_ms = (time.perf_counter() - t0) * 1e3
        solver = decision["solver"]
        k1 = assign.greedy_cut_scan.launches - before
        check_assignments(out, rows, core.rq_map, seen)
        cpu = check_floors(out, floors, core.rq_map, f"milp tick {t}")
        if kind == "armed":
            if (solver["status"] != "ok" or k1
                    or len(fallback.calls) != n_fallback
                    or len(primary.calls) != n_primary + 1):
                raise AssertionError(f"milp tick {t}: not a joint solve: "
                                     f"{solver}, K1 {k1}")
            kwargs, _counts = primary.calls[-1]
            if (np.asarray(kwargs["cpu_floor"]) > 0).sum() != len(floors):
                raise AssertionError(f"milp tick {t}: the MILP did not get "
                                     "the floors")
            milp_ms.append(solver["solve_ms"])
        else:
            kwargs, counts = fallback.calls[-1]
            if (solver["status"] != "fallback" or k1 != 1
                    or len(fallback.calls) != n_fallback + 1
                    or counts.sum() != sum(1 for a in out
                                           if a[1] not in floors)):
                raise AssertionError(f"milp tick {t} ({kind}): {solver}, "
                                     f"K1 {k1}")
            ids = [r.worker_id for r in rows]
            if kind == "forced":
                zeroed = [i for i, w in enumerate(ids) if w in floors]
                if (kwargs["free"][zeroed].any()
                        or kwargs["nt_free"][zeroed].any()
                        or any(a[1] in floors for a in out)):
                    raise AssertionError(f"milp tick {t}: the floored rows "
                                         "were not zeroed")
            elif kwargs["free"].shape[0] != len(rows) - len(floors):
                raise AssertionError(f"milp tick {t}: the benched tick did "
                                     "not carve the floored workers out")
            check_tick_against_plain(fallback_model, kwargs, counts, device,
                                     f"milp {t}")
        ticks.append(dict(tick=t, kind=kind, status=solver["status"],
                          solve_ms=solver["solve_ms"], wall_ms=wall_ms,
                          assigned=len(out), k1_launches=k1,
                          floored_cpu_work=sorted(cpu.values()),
                          phases=phases))
        log("milp_tick", **ticks[-1], watchdog=watchdog.stats(), card=card)
        runner.start(out)
        if t == len(schedule) - 1:
            reasons = reason_check(core, rows, batches, out, prio_of,
                                   solver["status"] == "fallback", card)
        runner.finish(floors)
    stats = watchdog.stats()
    launches = assign.greedy_cut_scan.launches
    native_ticks = NATIVE_TAKES["n"] - takes
    if ((stats["timeouts"], stats["failures"], stats["degraded_ticks"],
         stats["skipped_ticks"]) != (1, 0, 1 + N_MILP_BENCHED_TICKS, 0)
            or launches != 1 + N_MILP_BENCHED_TICKS):
        raise AssertionError(f"milp path: watchdog {stats}, K1 {launches}")
    summary = dict(ticks=len(schedule), launches=launches,
                   native_take_ticks=native_ticks, milp_ms=milp_ms,
                   milp_median_ms=float(np.median(milp_ms)),
                   armed_wall_ms=[t["wall_ms"] for t in ticks
                                  if t["kind"] == "armed"],
                   forced_timeout_s=watchdog.timeout_s,
                   reason_counts=reasons[0], oracle_reason_counts=reasons[1],
                   watchdog=stats, card=card)
    log("milp_ticks", **summary)
    return summary


# -- the native queue and its one-call map-take -------------------------------

# ticks whose non-gang take went through hq_map_take (install_native_takes)
NATIVE_TAKES = {"n": 0}


def install_native_takes() -> None:
    """Count, in NATIVE_TAKES, every mapping whose takes went through the
    native hq_map_take (scheduler/tick._native_map_take returned ids)."""
    from hyperqueue_tpu_torch.scheduler import tick

    real = tick._native_map_take

    def counted(*args):
        out = real(*args)
        if out is not None:
            NATIVE_TAKES["n"] += 1
        return out

    tick._native_map_take = counted


def check_native_queues(queues, tag) -> None:
    from hyperqueue_tpu_torch.utils.native import NativeTaskQueue

    kinds = {type(q).__name__ for _rq, q in queues.items()}
    if not queues.items() or any(not isinstance(q, NativeTaskQueue)
                                 for _rq, q in queues.items()):
        raise AssertionError(f"{tag} path: queues are {kinds}, not native")


def python_queues(plain):
    """The plain state's tasks in Python TaskQueues (the per-cell take
    path), in the order tick_state_from_plain adds them."""
    from hyperqueue_tpu_torch.scheduler.queues import TaskQueue, TaskQueues

    queues = TaskQueues()
    for rq_id in range(len(plain[1])):
        queues._queues[rq_id] = TaskQueue()
    for task_id, class_index, (user, sched) in plain[2]:
        queues.add(int(class_index), (int(user), int(sched)), int(task_id))
    return queues


def capture_mapping():
    """Keep the next mapping's batches, worker ids and counts (a copy)."""
    from hyperqueue_tpu_torch.scheduler import tick

    real = tick._map_counts
    box: dict = {}

    def once(queues, batches, worker_ids, counts, phases=None):
        tick._map_counts = real
        box.update(batches=list(batches), worker_ids=list(worker_ids),
                   counts=np.array(counts, copy=True))
        return real(queues, batches, worker_ids, counts, phases=phases)

    tick._map_counts = once
    return box


def mapping_check(mapped, py_queues, assignments) -> float:
    """The same counts mapped through the per-cell Python takes on a copy
    of the queues: the same assignments as hq_map_take's. Returns the
    per-cell mapping's ms."""
    from hyperqueue_tpu_torch.scheduler import tick

    takes = NATIVE_TAKES["n"]
    t0 = time.perf_counter()
    per_cell = tick._map_counts(py_queues, mapped["batches"],
                                mapped["worker_ids"], mapped["counts"])
    per_cell_ms = (time.perf_counter() - t0) * 1e3
    if NATIVE_TAKES["n"] != takes:
        raise AssertionError("the Python queues' copy took natively")
    if per_cell != assignments:
        raise AssertionError("hq_map_take and the per-cell takes map the "
                             "same counts to different assignments")
    return per_cell_ms


# -- main --------------------------------------------------------------------

def main_path(card, device, seen):
    """Phase 3: the default tick, N_TICKS ticks through run_tick. Returns
    the model, the per-tick wall ms and phases, the last tick's padded
    case, the launches and a closure that runs one more tick."""
    from hyperqueue_tpu_torch.convert import tick_state_from_plain
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.scheduler.tick import run_tick

    t0 = time.perf_counter()
    plain = north_star_state()
    resource_map, rq_map, queues, rows = tick_state_from_plain(*plain)
    log("state", workers=len(rows), ready_tasks=queues.total_ready(),
        classes=len(rq_map), seconds=round(time.perf_counter() - t0, 3))
    check_native_queues(queues, "default")
    # the per-cell Python path's queues: a copy that every tick's counts
    # are mapped through too, so it stays equal to the native queues
    py_queues = python_queues(plain)
    del plain  # 1M task tuples the collector would traverse in each tick
    per_cell_ms = []
    totals = [list(row.total) for row in rows]
    nt0 = [row.nt_free for row in rows]
    model = GreedyCutScanModel(device="cuda", backend="device")
    recorder = RecordingModel(model)
    rng = np.random.default_rng(SEED + 1)
    tick_ms, tick_phases, last_case = [], [], None
    assign.reset_launch_counts()
    takes = NATIVE_TAKES["n"]
    for tick in range(N_TICKS):
        before = assign.greedy_cut_scan.launches
        phases: dict = {}
        mapped = capture_mapping()
        t0 = time.perf_counter()
        assignments = run_tick(queues, rows, rq_map, resource_map, recorder,
                               phases=phases)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        tick_phases.append(phases)
        per_cell_ms.append(mapping_check(mapped, py_queues, assignments))
        if assign.greedy_cut_scan.launches != before + 1:
            raise AssertionError(f"tick {tick} launched the kernel "
                                 f"{assign.greedy_cut_scan.launches - before}"
                                 " times, expected once")
        check_assignments(assignments, rows, rq_map, seen)
        kwargs, counts = recorder.calls[-1]
        if counts.sum() != len(assignments):
            raise AssertionError("assignments do not match the counts")
        last_case = check_tick_against_plain(model, kwargs, counts, device,
                                             tick)
        log("tick", tick=tick, assigned=len(assignments),
            batches=int(counts.shape[0]), wall_ms=tick_ms[-1], phases=phases,
            resident=model.resident_stats(), card=card)
        advance(assignments, rows, rq_map, totals, nt0, rng)
    launches = assign.greedy_cut_scan.launches
    if (launches != N_TICKS or assign.greedy_cut_scan.gang_launches
            or assign.greedy_cut_scan.resident_launches != N_TICKS):
        raise AssertionError(
            f"main path launched the kernel {launches} times "
            f"({assign.greedy_cut_scan.resident_launches} resident) in "
            f"{N_TICKS} ticks")
    native_ticks = NATIVE_TAKES["n"] - takes
    if native_ticks != N_TICKS:
        raise AssertionError(f"default path: {native_ticks} of {N_TICKS} "
                             "ticks mapped through hq_map_take")
    native_ms = [p["mapping"] for p in tick_phases]
    log("mapping_check", ticks=N_TICKS, native_take_ticks=native_ticks,
        native_ms=native_ms, per_cell_ms=per_cell_ms,
        native_steady_median_ms=float(np.median(native_ms[1:])),
        per_cell_steady_median_ms=float(np.median(per_cell_ms[1:])),
        card=card)

    def one_tick():
        a = run_tick(queues, rows, rq_map, resource_map, model)
        check_assignments(a, rows, rq_map, seen)
        advance(a, rows, rq_map, totals, nt0, rng)

    return model, tick_ms, tick_phases, last_case, launches, one_tick


def fused_path(card, device, seen):
    """Phase 5: the fused tick, N_FUSED_TICKS ticks through
    run_tick(gang_ok=, group_ids=, policy=). Returns the per-tick wall ms
    and phases, the last tick's padded case, the K1g launches, the visit-
    class rows M per tick and a closure that runs one more tick."""
    from hyperqueue_tpu_torch.convert import (
        group_ids,
        policy_table_from_plain,
        tick_state_from_plain,
    )
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.scheduler.policy import PolicyState, task_class
    from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor
    from hyperqueue_tpu_torch.scheduler.tick import (
        Batch,
        create_batches,
        run_tick,
    )

    t0 = time.perf_counter()
    resources, classes, tasks, workers = north_star_state(
        n_jobs=N_JOBS, n_groups=N_GROUPS)
    gang_classes, pending = gang_tasks(len(classes))
    resource_map, rq_map, queues, rows = tick_state_from_plain(
        resources, classes + gang_classes, tasks, workers)
    table = policy_table_from_plain(FUSED_POLICY)
    predictor = RuntimePredictor(alpha=table.ewma_alpha)
    feed = np.random.default_rng(SEED + 3)
    for _ in range(4):
        for job in range(1, N_JOBS + 1):
            predictor.observe(f"job{job}", float(feed.uniform(1, 600)))
    policy = PolicyState(table, predictor=predictor,
                         job_name=lambda job: f"job{job}")
    classes_of = [task_class(rq_map.get_variants(rq), resource_map)
                  for rq in range(len(rq_map))]
    excluded = {(tclass, group)
                for tclass, row in FUSED_POLICY["affinity"].items()
                for group, weight in row.items() if weight == 0.0}
    gids = group_ids(rows)
    worker_ids = [row.worker_id for row in rows]
    by_id = {row.worker_id: row for row in rows}
    log("fused_state", workers=len(rows), ready_tasks=queues.total_ready(),
        classes=len(rq_map), jobs=N_JOBS, groups=int(gids.max()) + 1,
        gang_tasks=len(pending), seconds=round(time.perf_counter() - t0, 3))
    totals = [list(row.total) for row in rows]
    nt0 = [row.nt_free for row in rows]
    model = GreedyCutScanModel(device="cuda", backend="device")
    recorder = RecordingModel(model)
    rng = np.random.default_rng(SEED + 2)
    state = {"pending": pending}

    def tick_inputs():
        idle = np.array([row.free == totals[i] and row.nt_free == nt0[i]
                         for i, row in enumerate(rows)], np.int32)
        gang_batches = [
            Batch(rq_id=rq, priority=prio, size=1, gang_task=task,
                  gang_nodes=n)
            for task, rq, prio, n in state["pending"][:MAX_FUSED_GANG_ROWS]
        ]
        batches = create_batches(queues) + gang_batches
        ctx = policy.tick_context(by_id, rq_map, resource_map, worker_ids,
                                  batches)
        return idle, gang_batches, batches, ctx

    def finish(assignments, idle, gang_batches):
        check_assignments(assignments, rows, rq_map, seen)
        placed = check_gangs(assignments, gang_batches, rows, idle, excluded)
        check_exclusions(assignments, rows, classes_of, excluded)
        state["pending"] = [g for g in state["pending"] if g[0] not in placed]
        advance(assignments, rows, rq_map, totals, nt0, rng)
        return placed

    check_native_queues(queues, "fused")
    tick_ms, tick_phases, m_rows, last_case = [], [], [], None
    assign.reset_launch_counts()
    takes, plain_ticks = NATIVE_TAKES["n"], 0
    for tick in range(N_FUSED_TICKS):
        idle, gang_batches, batches, ctx = tick_inputs()
        plain_ticks += not gang_batches
        before = (assign.greedy_cut_scan.launches,
                  assign.greedy_cut_scan.gang_launches)
        phases: dict = {}
        t0 = time.perf_counter()
        assignments = run_tick(queues, rows, rq_map, resource_map, recorder,
                               batches=batches, phases=phases, gang_ok=idle,
                               group_ids=gids, policy=ctx)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        tick_phases.append(phases)
        after = (assign.greedy_cut_scan.launches,
                 assign.greedy_cut_scan.gang_launches)
        if after != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"fused tick {tick}: launches "
                                 f"{before} -> {after}, expected one launch "
                                 "with gang and mask inputs")
        kwargs, counts = recorder.calls[-1]
        last_case = check_tick_against_plain(model, kwargs, counts, device,
                                             tick)
        if "policy_mask" not in last_case:
            raise AssertionError(f"fused tick {tick}: the mask is not live")
        placed = finish(assignments, idle, gang_batches)
        m_rows.append(int(last_case["class_m"].shape[0]))
        log("fused_tick", tick=tick, assigned=len(assignments),
            batches=len(batches), gang_rows=len(gang_batches),
            gangs_placed=len(placed), idle_workers=int(idle.sum()),
            M=m_rows[-1], boosts=ctx.boosts if ctx else {},
            wall_ms=tick_ms[-1], phases=phases,
            resident=model.resident_stats(), card=card)
    launches = assign.greedy_cut_scan.gang_launches
    if (launches != N_FUSED_TICKS
            or assign.greedy_cut_scan.resident_launches != N_FUSED_TICKS):
        raise AssertionError(
            f"fused path launched the kernel {launches} times "
            f"({assign.greedy_cut_scan.resident_launches} resident) in "
            f"{N_FUSED_TICKS} ticks")
    # a tick with gang rows takes per cell in Python, as the JAX package's
    native_ticks = NATIVE_TAKES["n"] - takes
    if native_ticks != plain_ticks:
        raise AssertionError(f"fused path: {native_ticks} native takes for "
                             f"{plain_ticks} ticks without gang rows")
    log("native_mapping", path="fused", ticks=N_FUSED_TICKS,
        ticks_without_gang_rows=plain_ticks, native_take_ticks=native_ticks,
        card=card)

    def one_tick():
        idle, gang_batches, batches, ctx = tick_inputs()
        a = run_tick(queues, rows, rq_map, resource_map, model,
                     batches=batches, gang_ok=idle, group_ids=gids,
                     policy=ctx)
        finish(a, idle, gang_batches)

    return tick_ms, tick_phases, last_case, launches, m_rows, one_tick


# -- the reactor paths ---------------------------------------------------------

class ReactorComm:
    """The reactor's Comm: records the compute messages of the current tick
    and every retract and cancel."""

    def __init__(self):
        self.compute = []
        self.retracts = []
        self.cancels = []

    def send_compute(self, worker_id, tasks):
        self.compute.append((worker_id, tasks))

    def send_cancel(self, worker_id, task_ids):
        self.cancels.append((worker_id, list(task_ids)))

    def send_retract(self, worker_id, task_refs):
        self.retracts.append((worker_id, list(task_refs)))

    def ask_for_scheduling(self):
        pass


class JobSink:
    """The reactor's EventSink: forwards task news to the JobManager, as
    the JAX server's EventBridge does (without its journal and trace
    spans). No task may fail or be canceled and no worker may be lost on
    these paths."""

    def __init__(self, core, jobs):
        from hyperqueue_tpu_torch.ids import task_id_job

        self.core = core
        self.jobs = jobs
        self.job_of = task_id_job

    def on_task_started(self, task_id, instance_id, worker_ids, variant=0,
                        wtrace=None):
        task = self.core.tasks.get(task_id)
        self.jobs.on_task_started(
            self.job_of(task_id), task_id, worker_ids,
            started_at=(task.t_started if task else 0.0) or None)

    def on_task_restarted(self, task_id):
        self.jobs.on_task_restarted(self.job_of(task_id), task_id)

    def on_task_finished(self, task_id, wtrace=None):
        self.jobs.on_task_finished(self.job_of(task_id), task_id)

    def on_task_failed(self, task_id, message, wtrace=None):
        raise AssertionError(f"task {task_id} failed: {message}")

    def on_task_canceled(self, task_id):
        raise AssertionError(f"task {task_id} canceled")

    def on_worker_new(self, worker):
        pass

    def on_worker_lost(self, worker_id, reason):
        raise AssertionError(f"worker {worker_id} lost: {reason}")


class DecisionLog(logging.Handler):
    """Keeps the reactor's log records that say a tick's decision record
    could not be assembled (the reactor logs and goes on)."""

    NAME = "hyperqueue_tpu_torch.server.reactor"

    def __init__(self):
        super().__init__()
        self.failures = []
        logging.getLogger(self.NAME).addHandler(self)

    def emit(self, record):
        if "decision-record assembly failed" in record.getMessage():
            self.failures.append(record.getMessage())

    def close(self):
        logging.getLogger(self.NAME).removeHandler(self)
        super().close()


class ReactorHarness:
    """Drives reactor.schedule over a lazy server core as the server loop
    and its workers would, and checks every tick.

    Between ticks: each compute message is answered with on_task_running
    (a prefilled task joins its worker's FIFO backlog instead); a random
    quarter of the workers finish all their running tasks; each of those
    starts its backlog in FIFO order while the next task fits what the
    finished tasks released (and the worker's free resources and task
    slots); each retract is answered through on_retract_response (ok while
    the task is still in the backlog). A worker starts its backlog only
    into released resources: the rest of its free resources belong to a
    pipelined solve still in flight, which maps at the next tick against
    the free resources it was dispatched with."""

    def __init__(self, tag, core, jobs, seam, checker, device, card,
                 submitted, seed):
        from hyperqueue_tpu_torch.server import reactor

        self.tag, self.core, self.jobs, self.seam = tag, core, jobs, seam
        # every solve on the device given, none on the host
        self.backend = f"device-{device.type}"
        self.checker, self.device, self.card = checker, device, card
        self.submitted = submitted
        self.reactor = reactor
        self.comm = ReactorComm()
        self.events = JobSink(core, jobs)
        self.rng = np.random.default_rng(seed)
        self.running: dict = {}   # worker_id -> [task ids]
        self.backlog: dict = {}   # worker_id -> {task id: None}, FIFO
        self.retracts_seen = 0
        self.ticks: list = []
        self.decision_log = DecisionLog()
        # as the server does once it has started (see server_path)
        gc.collect()
        gc.freeze()
        self.gc = {"ms": 0.0, "t0": None}
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, stage, _info):
        if stage == "start":
            self.gc["t0"] = time.perf_counter()
        elif self.gc["t0"] is not None:
            self.gc["ms"] += (time.perf_counter() - self.gc["t0"]) * 1e3
            self.gc["t0"] = None

    def close(self):
        gc.callbacks.remove(self._on_gc)
        gc.unfreeze()
        self.decision_log.close()

    def check_solves(self, first_call):
        """Every solve recorded since `first_call` against the plain
        version on the same padded inputs (the checker model pads them, so
        the model's own buffers, which a pipelined solve may still read,
        stay untouched)."""
        for kwargs, counts in self.seam.calls[first_call:]:
            check_tick_against_plain(self.checker, kwargs, counts,
                                     self.device, self.core.tick_counter)

    def tick(self, run="sync", record=True, check=None):
        """One reactor tick, its checks and the workers' answers; returns
        the tick's summary. `check(msgs, idle_before)` adds a path's own
        checks; record=False leaves the solves' plain check to the caller
        (a profiled window must not count the plain version's time)."""
        from hyperqueue_tpu_torch.server.task import TaskState

        core = self.core
        idle_before = {wid for wid, w in core.workers.items()
                       if w.is_idle() and not w.draining}
        self.comm.compute = []
        first_call = len(self.seam.calls)
        materialized = core.lazy.materialized_total
        self.gc["ms"] = 0.0
        t0 = time.perf_counter()
        self.reactor.schedule(core, self.comm, self.events, self.seam)
        wall_ms = (time.perf_counter() - t0) * 1e3
        gc_ms = self.gc["ms"]
        msgs = self.comm.compute
        n_msgs = sum(len(m) for _w, m in msgs)
        t1 = time.perf_counter()
        if record:
            self.check_solves(first_call)
        if self.decision_log.failures:
            raise AssertionError(f"{self.tag}: "
                                 f"{self.decision_log.failures[0]}")
        rec = core.flight.latest()
        if rec is None or rec["tick"] != core.tick_counter:
            # the recorder drops an idle tick: nothing placed, nothing left
            if (n_msgs or core.queues.total_ready() or core.mn_queue
                    or core.paused_held):
                raise AssertionError(f"{self.tag} tick {core.tick_counter} "
                                     "has no flight record")
            rec = {"counts": dict.fromkeys(
                ("assigned", "gang_assigned", "prefilled", "ready_left",
                 "paused"), 0), "solver": {"status": "idle"},
                "phases": core.tick_stats.last_ms}
        counts = rec["counts"]
        if (counts["assigned"] + counts["gang_assigned"]
                + counts["prefilled"]) != n_msgs:
            raise AssertionError(f"{self.tag} tick {core.tick_counter}: "
                                 f"record counts {counts}, {n_msgs} "
                                 "messages sent")
        solver = rec["solver"]
        if (solver.get("status") not in ("ok", "pipelined", "idle")
                or (solver.get("status") == "ok"
                    and solver.get("backend") != self.backend)):
            raise AssertionError(f"{self.tag} tick {core.tick_counter} "
                                 f"solved {solver}")
        for wid, batch in msgs:
            w = core.workers[wid]
            for m in batch:
                task = core.tasks.get(m["id"])
                ok = (task is not None and task.state is TaskState.ASSIGNED
                      and task.instance_id == m["instance"])
                if ok and "node_ids" in m:
                    ok = bool(task.mn_workers) and task.mn_workers[0] == wid
                elif ok:
                    ok = task.assigned_worker == wid and (
                        m["id"] in w.prefilled_tasks if task.prefilled
                        else m["id"] in w.assigned_tasks)
                if not ok:
                    raise AssertionError(f"{self.tag}: message for task "
                                         f"{m['id']} on worker {wid}")
        if check is not None:
            check(msgs, idle_before)
        self._start_messages(msgs)
        self._start_backlog(self._finish_quarter())
        self.answer_retracts()
        sanity = bool(core.paranoid_tick
                      and core.tick_counter % core.paranoid_tick == 0)
        if sanity:
            core.sanity_check()
        self._check_counts()
        summary = dict(
            tick=core.tick_counter, run=run, wall_ms=wall_ms,
            phases=rec["phases"], gc_ms=gc_ms, messages=n_msgs,
            assigned=counts["assigned"],
            gang_assigned=counts["gang_assigned"],
            prefilled=counts["prefilled"],
            materialized=core.lazy.materialized_total - materialized,
            ready_left=counts["ready_left"], paused=counts["paused"],
            solver={k: solver.get(k) for k in ("status", "backend",
                                              "backend_reason")},
            sanity_checked=sanity,
            harness_ms=(time.perf_counter() - t1) * 1e3)
        if record:
            self.ticks.append(summary)
            log(f"{self.tag}_tick", **summary, card=self.card)
        return summary

    def _start_messages(self, msgs):
        core = self.core
        for wid, batch in msgs:
            for m in batch:
                if core.tasks[m["id"]].prefilled:
                    self.backlog.setdefault(wid, {})[m["id"]] = None
                else:
                    self.reactor.on_task_running(core, self.events, m["id"],
                                                 m["instance"])
                    self.running.setdefault(wid, []).append(m["id"])

    def _finish_quarter(self):
        """Returns worker_id -> [resources released, slots released]."""
        core = self.core
        released: dict = {}
        for wid in sorted(core.workers):
            if self.rng.random() < 0.25:
                w = core.workers[wid]
                for tid in self.running.pop(wid, []):
                    task = core.tasks[tid]
                    if not task.mn_workers:
                        got = released.setdefault(
                            wid, [[0] * len(w.free), 0])
                        for rid, a in core.variant_amounts(
                                task.rq_id, task.assigned_variant, w):
                            got[0][rid] += a
                        got[1] += 1
                    self.reactor.on_task_finished(
                        core, self.comm, self.events, tid,
                        task.instance_id)
        return released

    def _start_backlog(self, released):
        core = self.core
        for wid, (room, slots) in released.items():
            queued = self.backlog.get(wid, {})
            w = core.workers[wid]
            while queued:
                tid = next(iter(queued))
                task = core.tasks[tid]
                if not (task.prefilled and task.assigned_worker == wid):
                    del queued[tid]  # retracted and placed again meanwhile
                    continue
                amounts = core.variant_amounts(task.rq_id,
                                               task.assigned_variant, w)
                if slots <= 0 or w.nt_free <= 0 or w.mn_task or any(
                        min(w.free[rid], room[rid]) < a
                        for rid, a in amounts):
                    break
                for rid, a in amounts:
                    room[rid] -= a
                slots -= 1
                del queued[tid]
                self.reactor.on_task_running(core, self.events, tid,
                                             task.instance_id)
                self.running.setdefault(wid, []).append(tid)

    def answer_retracts(self):
        for wid, refs in self.comm.retracts[self.retracts_seen:]:
            queued = self.backlog.get(wid, {})
            for tid, instance in refs:
                ok = tid in queued
                queued.pop(tid, None)
                self.reactor.on_retract_response(self.core, self.comm, tid,
                                                 ok, instance)
        self.retracts_seen = len(self.comm.retracts)
        if self.comm.cancels:
            raise AssertionError(f"{self.tag}: cancels {self.comm.cancels}")

    def _check_counts(self):
        from hyperqueue_tpu_torch.server.task import TaskState

        core = self.core
        held = sum(len(h) for h in core.paused_held.values())
        ready = sum(1 for t in core.tasks.values()
                    if t.state is TaskState.READY)
        mn_ready = sum(1 for tid in core.mn_queue
                       if core.tasks[tid].state is TaskState.READY)
        if core.lazy.ready + ready - held - mn_ready \
                != core.queues.total_ready():
            raise AssertionError(
                f"{self.tag}: lazy {core.lazy.ready} + materialized "
                f"{ready - held - mn_ready} != {core.queues.total_ready()}")
        for job_id, job in self.jobs.jobs.items():
            if job.n_lazy + len(job.tasks) != self.submitted[job_id]:
                raise AssertionError(
                    f"{self.tag}: job {job_id} holds {job.n_lazy} lazy and "
                    f"{len(job.tasks)} tasks of {self.submitted[job_id]}")

    def medians(self):
        """Steady medians (tick 0 left out) of the phases, per run."""
        out = {}
        for run in ("sync", "pipelined"):
            ticks = [t for t in self.ticks[1:] if t["run"] == run]
            if not ticks:
                continue
            names = sorted({k for t in ticks for k in t["phases"]})
            out[run] = dict(
                ticks=len(ticks),
                wall_median_ms=float(np.median([t["wall_ms"]
                                                for t in ticks])),
                phases_median_ms={k: float(np.median(
                    [t["phases"].get(k, 0.0) for t in ticks]))
                    for k in names},
                **{f"{k}_median": float(np.median([t[k] for t in ticks]))
                   for k in ("messages", "materialized", "prefilled",
                             "gc_ms")})
        return out


def reactor_path(card, device):
    """Phase 13: reactor.schedule over the default north star held as lazy
    array chunks (lazy_core_from_plain: one job, chunks of 16,384 ids), as
    `hq server start` runs it: SolverWatchdog(GreedyCutScanModel(
    backend="auto")) with the resident paranoid check and the tick cache's
    (and Core.sanity_check's) every 4th tick, prefill on. The sync probe is
    resolved first; then N_REACTOR_TICKS synchronous ticks, 3 more under
    torch.profiler (their solves held against the plain version after the
    window), and N_REACTOR_PIPELINED_TICKS pipelined ones (more while a
    solve is still pending). Returns the path's summary."""
    from hyperqueue_tpu_torch.convert import lazy_core_from_plain
    from hyperqueue_tpu_torch.models import greedy
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign, probe
    from hyperqueue_tpu_torch.parallel import solve
    from hyperqueue_tpu_torch.scheduler.pipeline import TickPipeline
    from hyperqueue_tpu_torch.scheduler.watchdog import SolverWatchdog

    t0 = time.perf_counter()
    plain = north_star_state()
    core, jobs = lazy_core_from_plain(*plain)
    submitted = {1: len(plain[2])}
    del plain
    log("reactor_state", workers=len(core.workers),
        ready_tasks=core.queues.total_ready(), lazy=core.lazy.stats(),
        classes=len(core.rq_map), seconds=round(time.perf_counter() - t0, 3),
        card=card)
    model = GreedyCutScanModel(device="cuda", backend="auto")
    model.paranoid_resident = 4
    core.paranoid_tick = 4
    watchdog = SolverWatchdog(model)
    seam = RecordingSeam(watchdog)
    checker = GreedyCutScanModel(device="cuda", backend="device")
    # counts to 0 just before the path; the probe starts here, as the
    # server's first solve would start it
    assign.reset_launch_counts()
    solve.reset_launch_counts()
    probe.sync_probe.launches = 0
    greedy._reset_probe_for_tests()
    sync_ms = greedy.device_sync_ms(wait_s=30)
    if greedy.probe_error() is not None or sync_ms is None:
        raise AssertionError(f"sync probe: {sync_ms}, "
                             f"{greedy.probe_error()!r}")
    h = ReactorHarness("reactor", core, jobs, seam, checker, device, card,
                       submitted, SEED + 5)
    try:
        for _ in range(N_REACTOR_TICKS):
            h.tick()
        n_window = 3
        first_call = len(seam.calls)
        window = profiled_window(lambda: h.tick(record=False), n_window)
        h.check_solves(first_call)
        window = window_summary(*window, n_window,
                                h.medians()["sync"]["wall_median_ms"], card)
        core.tick_pipeline = TickPipeline()
        n = 0
        while n < N_REACTOR_PIPELINED_TICKS or (
                core.tick_pipeline.pending is not None and n < 16):
            h.tick(run="pipelined")
            n += 1
        if core.tick_pipeline.pending is not None:
            raise AssertionError("reactor path: a solve is still pending")
    finally:
        h.close()
    launches = {"cut_scan": assign.greedy_cut_scan.launches,
                "cut_scan_resident": assign.greedy_cut_scan.resident_launches,
                "cut_scan_gang": assign.greedy_cut_scan.gang_launches,
                "sharded_scan": solve.sharded_cut_scan.launches,
                "sync_probe": probe.sync_probe.launches}
    stats = watchdog.stats()
    if (stats["failures"], stats["timeouts"], stats["degraded_ticks"],
            stats["skipped_ticks"]) != (0, 0, 0, 0):
        raise AssertionError(f"reactor path: watchdog degraded: {stats}")
    if core.tick_cache.full_rebuilds > 1:
        raise AssertionError(f"reactor path: tick cache "
                             f"{core.tick_cache.counters()}")
    n_solves = len(seam.calls)
    if (launches["cut_scan"] != n_solves + model.paranoid_checks
            or launches["cut_scan_resident"] != launches["cut_scan"]
            or launches["cut_scan_gang"] or launches["sharded_scan"]
            or launches["sync_probe"] < 1 or n_solves < 1):
        raise AssertionError(f"reactor path launches {launches} for "
                             f"{n_solves} solves and "
                             f"{model.paranoid_checks} paranoid checks")
    summary = dict(
        ticks=len(h.ticks), first_tick=h.ticks[0], medians=h.medians(),
        profiled_window=window, launches=launches, solves=n_solves,
        paranoid_checks=model.paranoid_checks, watchdog=stats,
        tick_cache=core.tick_cache.counters(), lazy=core.lazy.stats(),
        materialized_tasks=len(core.tasks), device_sync_ms=sync_ms,
        retracts=sum(len(r) for _w, r in h.comm.retracts))
    log("reactor_ticks", **summary, card=card)
    return summary


def reactor_fused_path(card, device):
    """Phase 14: reactor.schedule in fused mode over the fused north star
    held as lazy chunks (8 jobs, 8 groups of 128 workers), with the 16 gang
    tasks of gang_tasks submitted through on_new_tasks, core.fused_solve
    and the fused path's policy, on GreedyCutScanModel(backend="device"),
    prefill on. Job REACTOR_PAUSED_JOB is paused before tick
    REACTOR_PAUSE_TICK and resumed before tick REACTOR_RESUME_TICK. Returns
    the path's summary."""
    from hyperqueue_tpu_torch.convert import (
        lazy_core_from_plain,
        policy_table_from_plain,
    )
    from hyperqueue_tpu_torch.ids import task_id_job, task_id_task
    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.scheduler.policy import PolicyState, task_class
    from hyperqueue_tpu_torch.scheduler.predict import RuntimePredictor
    from hyperqueue_tpu_torch.server import reactor
    from hyperqueue_tpu_torch.server.protocol import rqv_from_wire
    from hyperqueue_tpu_torch.server.task import Task

    t0 = time.perf_counter()
    resources, classes, tasks, workers = north_star_state(
        n_jobs=N_JOBS, n_groups=N_GROUPS)
    gang_classes, gangs = gang_tasks(len(classes),
                                     n_gangs=MAX_FUSED_GANG_ROWS)
    core, jobs = lazy_core_from_plain(resources, classes + gang_classes,
                                      tasks, workers)
    submitted: dict = {}
    for tid, _c, _p in tasks:
        submitted[task_id_job(tid)] = submitted.get(task_id_job(tid), 0) + 1
    del tasks
    gang_nodes, gang_list = {}, []
    for tid, rq, prio, n in gangs:
        # the gang's request as the server receives it
        if core.intern_rqv(rqv_from_wire({"variants": [{"n_nodes": n}]},
                                         core.resource_map)) != rq:
            raise AssertionError(f"the gang class of {n} nodes is not {rq}")
        jobs.attach_task(jobs.jobs[task_id_job(tid)], task_id_task(tid))
        submitted[task_id_job(tid)] += 1
        gang_nodes[tid] = n
        gang_list.append(Task(task_id=tid, rq_id=rq, priority=prio))
    table = policy_table_from_plain(FUSED_POLICY)
    predictor = RuntimePredictor(alpha=table.ewma_alpha)
    feed = np.random.default_rng(SEED + 3)
    for _ in range(4):
        for job in range(1, N_JOBS + 1):
            predictor.observe(f"job{job}", float(feed.uniform(1, 600)))
    core.policy = PolicyState(table, predictor=predictor,
                              job_name=lambda job: f"job{job}")
    core.fused_solve = True
    classes_of = [task_class(core.rq_map.get_variants(rq),
                             core.resource_map)
                  for rq in range(len(core.rq_map))]
    excluded = {(tclass, group)
                for tclass, row in FUSED_POLICY["affinity"].items()
                for group, weight in row.items() if weight == 0.0}
    model = GreedyCutScanModel(device="cuda", backend="device")
    seam = RecordingSeam(model)
    checker = GreedyCutScanModel(device="cuda", backend="device")
    assign.reset_launch_counts()
    h = ReactorHarness("reactor_fused", core, jobs, seam, checker, device,
                       card, submitted, SEED + 6)
    reactor.on_new_tasks(core, h.comm, gang_list)
    log("reactor_fused_state", workers=len(core.workers),
        ready_tasks=core.queues.total_ready(), lazy=core.lazy.stats(),
        gang_tasks=len(core.mn_queue), jobs=N_JOBS, groups=N_GROUPS,
        seconds=round(time.perf_counter() - t0, 3), card=card)
    placed_gangs: set = set()
    state = {"paused": False}

    def check(msgs, idle_before):
        """The paused job places nothing; the solve places no task on a
        group its policy excludes; each gang is all-or-nothing on idle members of one
        group that receive nothing else this tick."""
        sent_to = {wid for wid, batch in msgs if batch}
        taken: set = set()
        for wid, batch in msgs:
            for m in batch:
                if state["paused"] and task_id_job(m["id"]) \
                        == REACTOR_PAUSED_JOB:
                    raise AssertionError(f"paused job placed {m['id']}")
                if "node_ids" not in m:
                    task = core.tasks[m["id"]]
                    # prefill reads no policy (as in the JAX reactor): the
                    # exclusion binds the solve's placements
                    if not task.prefilled and (
                            classes_of[task.rq_id],
                            core.workers[wid].group) in excluded:
                        raise AssertionError(f"rq {task.rq_id} on worker "
                                             f"{wid} of an excluded group")
                    continue
                nodes = set(m["node_ids"])
                groups = {core.workers[n].group for n in nodes}
                if (len(nodes) != gang_nodes[m["id"]] or len(groups) != 1
                        or ("nodes", groups.pop()) in excluded
                        or not nodes <= idle_before or nodes & taken
                        or (nodes - {wid}) & sent_to):
                    raise AssertionError(f"gang {m['id']} on {nodes} is "
                                         "not all-or-nothing on idle "
                                         "members of one group")
                taken |= nodes
                placed_gangs.add(m["id"])

    def waiting():
        return core.queues.total_ready() + len(core.mn_queue)

    pause: dict = {"queue_paused_counts": []}
    try:
        for tick in range(N_REACTOR_FUSED_TICKS):
            if tick == REACTOR_PAUSE_TICK:
                held, n_retracts = reactor.pause_jobs(
                    core, h.comm, [REACTOR_PAUSED_JOB])
                segs = [s for s in core.lazy.per_job.get(
                    REACTOR_PAUSED_JOB, []) if s.remaining]
                if held <= 0 or not segs or any(s.in_queue for s in segs):
                    raise AssertionError(f"pause held {held}; the job's "
                                         "chunks are not all held")
                pause.update(held=held, retracts=n_retracts,
                             lazy_held=core.lazy.held)
                state["paused"] = True
                h.answer_retracts()
            if tick == REACTOR_RESUME_TICK:
                before = waiting()
                held = core.lazy.held + sum(
                    len(v) for v in core.paused_held.values())
                released = reactor.resume_jobs(core, h.comm,
                                               [REACTOR_PAUSED_JOB])
                if (released != held or core.lazy.held or core.paused_held
                        or waiting() - before != released):
                    raise AssertionError(f"resume released {released} of "
                                         f"{held} held")
                pause.update(released=released)
                state["paused"] = False
            h.tick(check=check)
            if state["paused"]:
                entries = [e["count"] for e in core.flight.latest()
                           ["unplaced"] if e["reason"] == "queue-paused"
                           and e["job"] == REACTOR_PAUSED_JOB]
                want = len(core.paused_held.get(REACTOR_PAUSED_JOB, ()))
                if entries != ([want] if want else []):
                    raise AssertionError(f"queue-paused entries {entries}, "
                                         f"{want} held")
                pause["queue_paused_counts"].append(entries)
    finally:
        h.close()
    if not pause["queue_paused_counts"] or \
            not pause["queue_paused_counts"][0]:
        raise AssertionError("the paused job's first tick has no "
                             "queue-paused entry")
    n_solves = len(seam.calls)
    gang_row_solves = sum(1 for kwargs, _c in seam.calls
                          if kwargs.get("gang_nodes") is not None
                          and np.any(kwargs["gang_nodes"] > 0))
    launches = {"cut_scan": assign.greedy_cut_scan.launches,
                "cut_scan_resident": assign.greedy_cut_scan.resident_launches,
                "cut_scan_gang": assign.greedy_cut_scan.gang_launches}
    # the policy's mask is live on every tick, so every launch runs the
    # K1g branches; gang rows ride the solves while gangs wait
    if (launches["cut_scan"] != n_solves or gang_row_solves < 1
            or launches["cut_scan_gang"] != n_solves
            or launches["cut_scan_resident"] != n_solves
            or not placed_gangs):
        raise AssertionError(f"reactor_fused path launches {launches} for "
                             f"{n_solves} solves ({gang_row_solves} with "
                             f"gang rows), gangs placed {len(placed_gangs)}")
    summary = dict(
        ticks=len(h.ticks), first_tick=h.ticks[0], medians=h.medians(),
        launches=launches, solves=n_solves, gang_row_solves=gang_row_solves,
        gangs_placed=len(placed_gangs), pause=pause,
        lazy=core.lazy.stats(), materialized_tasks=len(core.tasks),
        retracts=sum(len(r) for _w, r in h.comm.retracts))
    log("reactor_fused_ticks", **summary, card=card)
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from functools import partial

    from hyperqueue_tpu_torch.models.greedy import GreedyCutScanModel
    from hyperqueue_tpu_torch.models.multichip import MultichipModel
    from hyperqueue_tpu_torch.ops import assign
    from hyperqueue_tpu_torch.ops.build import load_library
    from hyperqueue_tpu_torch.parallel import solve
    from hyperqueue_tpu_torch.utils.native import load_native

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    install_native_takes()

    # phase 1: the card and the builds, all started together
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log("card", card=card, kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        builds = {name: pool.submit(load_library, name)
                  for name in ("cut_scan", "sync_probe", "sharded_scan")}
        native = pool.submit(load_native)
        records = {name: f.result()[1] for name, f in builds.items()}
        if native.result() is None:
            raise AssertionError("the native host scan did not build")
    build_s = time.perf_counter() - t0
    for name, record in records.items():
        ptxas = [ln.strip() for ln in record["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log("build", kernel=name, seconds=round(record["seconds"], 3),
            compiled=record["compiled"], ptxas=ptxas, card=card)
        log("ptxas", source=name, kernels=ptxas_usage(record["ptxas"]),
            card=card)
    global THREADS
    THREADS = int(load_library("cut_scan")[0].hq_cut_scan_block_threads())
    log("builds", wall_seconds=round(build_s, 3), native="hqcore",
        card=card)

    # phase 2: the kernel against its plain version, K1 then K1g cases,
    # each in the instantiation its layout picks and, where the resident
    # one is picked, in the global one too
    max_err = 0
    cases = {"bench_1024x8x256x2": bench_instance()}
    shapes = [(8, 4, 8, 2), (13, 3, 5, 3), (100, 2, 9, 1), (1000, 4, 40, 2),
              (1500, 2, 17, 3), (4096, 4, 24, 2), (16384, 3, 6, 2)]
    for i, shape in enumerate(shapes):
        for with_all in (False, True):
            name = "x".join(map(str, shape)) + ("_all" if with_all else "")
            cases[name] = random_case(100 + i, *shape, with_all)
    edges = {name: k1_edge_case(name) for name in K1_EDGE_CASES}
    checked: dict = {}
    for name, case in {**cases, **edges}.items():
        try:
            max_err = max(max_err, kernel_vs_plain(case, device, checked))
        except AssertionError as e:
            raise AssertionError(f"K1 case {name}: {e}") from e
    log("kernel_vs_plain", cases=sorted(cases), edge_cases=sorted(edges),
        instantiations_checked=checked, max_abs_err=max_err, card=card)
    max_err_g = 0
    k1g_inputs = k1g_cases()
    checked_g: dict = {}
    k1g_edges = {name: k1g_edge_case(name) for name in K1G_EDGE_CASES}
    for name, case in {**k1g_inputs, **k1g_edges}.items():
        try:
            max_err_g = max(max_err_g,
                            kernel_vs_plain(case, device, checked_g))
        except AssertionError as e:
            raise AssertionError(f"K1g case {name}: {e}") from e
        gang = case.get("gang_nodes")
        log("kernel_vs_plain_k1g", case=name, M=int(case["class_m"].shape[0]),
            gang_rows=0 if gang is None else int((gang > 0).sum()),
            max_abs_err=max_err_g, card=card)
    for inst in ("resident", "global"):
        if not checked.get(inst) or not checked_g.get(inst):
            raise AssertionError(f"the {inst} instantiation was not held "
                                 f"against the plain version: {checked}, "
                                 f"{checked_g}")
    log("kernel_vs_plain_k1g_summary", instantiations_checked=checked_g,
        max_abs_err=max_err_g, card=card)

    # phase 2b: the sharded kernel against its plain version and K1, each
    # case in the variant the wrapper picks and in every other that fits
    max_err_k2 = 0
    t0 = time.perf_counter()
    sharded = k2_cases(cases, k1g_inputs)
    checked_k2: dict = {}
    for name, (case, n_shards) in sharded.items():
        try:
            max_err_k2 = max(max_err_k2, sharded_vs_plain(
                case, device, n_shards, checked_k2))
        except AssertionError as e:
            raise AssertionError(f"K2 case {name}: {e}") from e
    missing = [k2_name(*v) for v in K2_VARIANTS
               if not checked_k2.get(k2_name(*v))]
    missing += [f"wrapper/{ex}" for ex in ("cluster", "grid")
                if not checked_k2.get(f"wrapper/{ex}")]
    if missing:
        raise AssertionError(f"K2 variants never held: {missing}; "
                             f"{checked_k2}")
    log("sharded_vs_plain", cases=sorted(sharded),
        variants_checked=checked_k2, max_abs_err=max_err_k2,
        seconds=round(time.perf_counter() - t0, 3), card=card)

    # phase 3: the main path, ticks through run_tick on the card
    seen: set = set()
    model, tick_ms, tick_phases, last_case, launches, one_tick = \
        main_path(card, device, seen)

    # phase 4: timings at the main path's shapes (the last tick's inputs)
    step_lat = assign.scan_step_latency_ms(4096, device)
    legacy_lat = assign.scan_step_latency_ms(4096, device, legacy=True)
    log("step_floor", scan_us=step_lat * 1e3, int64_scan_us=legacy_lat * 1e3,
        threads=THREADS, card=card)
    k1 = kernel_timing(last_case, device, step_lat)
    log("timing", kernel="cut_scan", step_scan_latency_ms=step_lat, **k1,
        card=card)
    log("k1_step_split", **step_split(last_case, device, k1), card=card)
    ticks = tick_summary(tick_ms, tick_phases, card)
    log("ticks", **ticks)
    n_window = 3
    log("profiled_window", **window_summary(
        *profiled_window(one_tick, n_window), n_window,
        ticks["steady_median_ms"], card))
    glue = time_glue(model, last_case["_counts"].shape,
                     last_case["_extents"], device)
    log("glue", **glue, card=card)

    # phase 5: the fused path
    # (a state of its own, whose task ids may repeat the main path's)
    f_ms, f_phases, f_case, f_launches, m_rows, f_one_tick = fused_path(
        card, device, set())

    # phase 6: fused timings
    k1g = kernel_timing(f_case, device, step_lat)
    log("timing", kernel="cut_scan_gang", step_scan_latency_ms=step_lat,
        **k1g, card=card)
    log("k1g_step_split", **step_split(f_case, device, k1g, registers=False),
        card=card)
    f_ticks = tick_summary(f_ms, f_phases, card)
    log("fused_ticks", M=m_rows, **f_ticks)
    log("fused_profiled_window", **window_summary(
        *profiled_window(f_one_tick, n_window), n_window,
        f_ticks["steady_median_ms"], card))

    # phase 7: the sync probe (K5)
    max_err_p, k5 = k5_phase(device, card)

    # phase 8: the server path, its profiled window and host solves
    server, s_model, (s_kwargs, s_counts), s_tick = server_path(
        card, device, GreedyCutScanModel(device="cuda", backend="auto"))
    server_summary = path_summary(server)
    log("server_ticks", **server_summary, card=card)
    log("server_host_ops", run="pipelined",
        **host_op_profile(lambda: s_tick(True)), card=card)
    s_tick()  # maps the last pipelined solve, outside the windows
    log("server_profiled_window", **window_summary(
        *profiled_window(s_tick, n_window), n_window,
        server_summary["sync"]["steady_median_ms"], card))
    log("server_host_ops", run="sync", **host_op_profile(s_tick),
        card=card)
    hosts = host_solves(s_model, s_kwargs, s_counts, card)
    log("server_cost_model", cost_model=server["cost_model"],
        host_numpy_ms=hosts["host_numpy"]["ms"],
        host_native_ms=hosts["host_native"]["ms"], card=card)

    # phase 9: the multichip path, the server's seam around MultichipModel
    # over N_SHARDS shards of the card
    m_model = MultichipModel(devices=[device] * N_SHARDS)
    multi, m_model, (m_kwargs, m_counts), m_tick = server_path(
        card, device, m_model, tag="multichip",
        n_pipelined=N_MULTICHIP_PIPELINED_TICKS)
    m_summary = path_summary(multi)
    log("multichip_ticks", shards=N_SHARDS, **m_summary, card=card)
    m_tick()  # maps the last pipelined solve, outside the window
    log("multichip_profiled_window", **window_summary(
        *profiled_window(m_tick, n_window, kernel="sharded_scan_kernel"),
        n_window, m_summary["sync"]["steady_median_ms"], card))

    # phase 10: K2's timings at the multichip path's shapes (its last
    # synchronous tick), beside K1's at the same inputs
    mesh = m_model._get_mesh()
    m_case = check_tick_against_plain(
        m_model, m_kwargs, m_counts, device, "timing",
        partial(solve.sharded_cut_scan_reference, mesh))
    floors = k2_floors(device, N_SHARDS)
    log("cluster_step_latency", shards=N_SHARDS, floor_us=floors,
        scan_us=step_lat * 1e3, card=card)
    k2 = k2_timing(m_case, device, N_SHARDS, floors, step_lat)
    log("timing", kernel="sharded_scan", step_scan_latency_ms=step_lat,
        **k2, card=card)
    log("k2_step_split", **k2_step_split(m_case, device, N_SHARDS, k2),
        card=card)

    # phase 11: min-utilization workers at the north star (K1 and the host
    # search); phase 12: `--scheduler milp` with its degraded tick
    mu = mu_path(card, device, set())
    milp = milp_path(card, device, set())

    # phases 13 and 14: the server's tick itself, reactor.schedule over the
    # north star held as lazy array chunks, then in fused mode
    react = reactor_path(card, device)
    react_fused = reactor_fused_path(card, device)
    log("mapping", native=True,
        default_median_ms=ticks["phases_median_ms"]["mapping"],
        server_sync_median_ms=server_summary["sync"]["phases_median_ms"]
        ["mapping"],
        server_pipelined_median_ms=server_summary["pipelined"]
        ["phases_median_ms"]["mapping"],
        multichip_sync_median_ms=m_summary["sync"]["phases_median_ms"]
        ["mapping"],
        mu_median_ms=mu["phases_median_ms"]["mapping"],
        # lazy classes take per cell in Python and materialize each id
        reactor_sync_median_ms=react["medians"]["sync"]["phases_median_ms"]
        ["mapping"],
        reactor_pipelined_median_ms=react["medians"]["pipelined"]
        ["phases_median_ms"]["mapping"],
        native_take_ticks={"server": server["native_take_ticks"],
                           "multichip": multi["native_take_ticks"],
                           "mu": mu["native_take_ticks"],
                           "milp": milp["native_take_ticks"]},
        card=card)

    kernels = []
    for name, replaces, launch_count, err, timing, held in (
        ("cut_scan", "hyperqueue_tpu/ops/assign.py:398", launches, max_err,
         k1, checked),
        ("cut_scan_gang", "hyperqueue_tpu/ops/assign.py:246", f_launches,
         max_err_g, k1g, checked_g),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "hyperqueue_tpu_torch/csrc/cut_scan.cu",
            "replaces": replaces,
            "launches": launch_count,
            "max_abs_err": err,
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
            "latency_bound_ms": timing["latency_bound_ms"],
            "latency_bound_all_steps_ms":
                timing["latency_bound_all_steps_ms"],
            "wrapper_ms": timing["wrapper_ms"],
            "server_launches": server["launches"]["cut_scan"]
            if name == "cut_scan" else 0,
            "mu_launches": mu["launches"] if name == "cut_scan" else 0,
            "milp_launches": milp["launches"] if name == "cut_scan" else 0,
            "reactor_launches": react["launches"]["cut_scan"]
            if name == "cut_scan" else 0,
            # a fused reactor tick without gang rows launches plain K1
            "reactor_fused_launches": react_fused["launches"]["cut_scan_gang"]
            if name == "cut_scan_gang"
            else react_fused["launches"]["cut_scan"]
            - react_fused["launches"]["cut_scan_gang"],
            # every launch of the path ran this instantiation (checked)
            "instantiation": "resident",
            "launches_by_instantiation": {"resident": launch_count,
                                          "global": 0},
            "cases_held_by_instantiation": held,
            "threads": THREADS,
            "step_floor_us": step_lat * 1e3,
            "int64_step_floor_us": legacy_lat * 1e3,
        })
    kernels.append({
        "name": "sync_probe",
        "route": "cuda",
        "source": "hyperqueue_tpu_torch/csrc/sync_probe.cu",
        "replaces": "hyperqueue_tpu/models/greedy.py:85",
        "launches": server["launches"]["sync_probe"],
        "max_abs_err": max_err_p,
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "latency_bound_ms": k5["latency_bound_ms"],
        "wrapper_ms": k5["wrapper_ms"],
        "round_trip_ms": k5["round_trip_min_ms"],
        "reactor_launches": react["launches"]["sync_probe"],
    })
    kernels.append({
        "name": "sharded_scan",
        "route": "cuda",
        "source": "hyperqueue_tpu_torch/csrc/sharded_scan.cu",
        "replaces": "hyperqueue_tpu/parallel/solve.py:231",
        "launches": multi["launches"]["sharded_scan"],
        "max_abs_err": max_err_k2,
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "latency_bound_ms": k2["latency_bound_ms"],
        "latency_bound_all_steps_ms": k2["latency_bound_all_steps_ms"],
        "wrapper_ms": k2["wrapper_ms"],
        "k1_ms": k2["k1_ms"],
        "shards": N_SHARDS,
        "exchange": k2["exchange"],
        "instantiation": k2["instantiation"],
        "threads": k2["threads"],
        "step_floor_us": k2["step_floor_us"],
        # every launch of the path ran the cluster exchange (checked)
        "launches_by_exchange": {
            "cluster": multi["launches"]["sharded_scan_cluster"],
            "grid": multi["launches"]["sharded_scan_grid"]},
        "launches_by_instantiation": {
            "resident": multi["launches"]["sharded_scan_resident"],
            "global": multi["launches"]["sharded_scan"]
            - multi["launches"]["sharded_scan_resident"]},
        "cases_held_by_variant": checked_k2,
        "floor_us": floors,
    })
    log("profiler_windows", **PROFILED, card=card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
